// Banded global two-piece affine fill with a row-run traceback: one warp
// per job, four band lanes a thread.
//
// Replaces vacmap_tpu/ops/affine_pallas.py::_fill_tb_kernel_banded (:423),
// launched there by _fill_and_rowruns_banded (:659 -> pallas_call :690).
// Same scoring, op priority and output planes as fill_full.cu, over an
// offset-space band: lane u of row i holds column j = i + base + u,
// base = min(0, dq) - (W - |dq|) / 2 (floor), dq = q_len - t_len.  The
// query plane arrives band-aligned (qshift[v] = q[base + v], make_qshift),
// so row i reads qshift[i-1+u].  The diagonal move is lane-aligned, the
// deletion move is a one-lane shift of the previous row and the insertion
// move is the in-row prefix max.  ESCALATE (ex bit 7 of every lane) is set
// when the traceback touches a band edge lane, or when an interior
// band-edge cell is the row maximum while the column beyond it is a real
// matrix cell; the caller re-runs those jobs full-width.  The band's known
// suboptimality (a staircase optimum outside the band whose traceback
// never touches an edge) is reproduced as the reference has it, not
// fixed: the planes must be the reference's, byte for byte.
//
// What bounds it on an H100: the latency of one job, not bytes or
// operations (those bounds are 1/40 of its time or less).  A job is t_len
// dependent rows, then a walk of t_len dependent steps, and a launch (about
// 16 jobs from the executor) takes as long as its longest job; a row is
// a few hundred instructions issued in order by one warp around a chain
// of 7 dependent shuffle levels.  So the design keeps a job on one warp
// with nothing to wait for but its own chain:
//  - lane l holds band lanes 4l .. 4l+3 of H, E1 and E2 in registers.  The
//    deletion move is a register move plus one __shfl_down_sync per state;
//    the insertion move's prefix maxima are an in-thread max over four
//    lanes, a 5-step __shfl_up_sync scan of the thread totals and one more
//    shuffle for the exclusive value.  A block is one warp, so there is no
//    block barrier anywhere;
//  - the cell bytes and the ESCALATE row test of row i are made while row
//    i + 1 runs (the test is two broadcasts and one __reduce_or_sync vote),
//    so that they fill the stalls of row i + 1's chain;
//  - the target and the band-aligned query plane are staged in the warp's
//    slice of shared memory once; each row's four query bytes are one
//    funnel shift of two aligned words, loaded a row ahead;
//  - the per-cell bytes (T x W: 32 KB at T = 256, 64 KB at T = 512) never
//    leave the SM: lane l stores its four as one word, 128 contiguous
//    bytes a row;
//  - lane 0 walks the traceback out of shared memory, reading the next
//    row's two candidate bytes (diagonal, deletion) a row ahead, so that
//    only an insertion run waits on a load; then the warp writes both
//    planes.
// Measured (PERF.md): about 0.37 us a row, fill and walk, on one NVIDIA
// H100 80GB HBM3 at 700 W; fewer shuffle levels with more shuffles,
// packed int16 maxima, a one-loop walk and unrolling were slower.
// Floating point: every add and subtract keeps the plain version's
// operands and order; only maxima are taken in another order, which is
// exact.  Character planes stay uint8 (a base code 4 mismatches
// everything, as on the host); values are f32 with NEG = -1e9 as in the
// reference.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e9f;
constexpr int kW = 128;              // band lanes
constexpr int kPer = kW / 32;        // band lanes a thread
constexpr int kMaxT = 1024;
constexpr unsigned kAll = 0xffffffffu;

struct Scoring {
  float mat, mis, e1, e2, o1, o2, o1e1, o2e2;
};

// The block's dynamic shared memory: the cell bytes (a spare row, then T
// rows of W), the band-aligned query plane (T + W bytes, padded
// for the two-word reads a row ahead), the target, and the lo / ex planes
// of the walk.
__host__ __device__ constexpr int pad16(int n) { return (n + 15) & ~15; }
__host__ __device__ constexpr int q_bytes(int T) { return pad16(T + kW + 8); }
__host__ __device__ constexpr size_t slice_bytes(int T) {
  return (size_t)(T + 1) * kW + q_bytes(T) + 3 * pad16(T + 1);
}

__device__ __forceinline__ float gapf(const Scoring& sc, float l) {
  return fminf(sc.o1 + sc.e1 * l, sc.o2 + sc.e2 * l);
}

__device__ __forceinline__ bool at_edge(int u) { return u <= 0 || u >= kW - 1; }

// qs[o .. o+3] of the staged plane, byte k in bits 8k..8k+7
__device__ __forceinline__ uint32_t q_word(const uint8_t* qsh, int o) {
  const uint32_t* p = reinterpret_cast<const uint32_t*>(qsh + (o & ~3));
  return __funnelshift_r(p[0], p[1], 8 * (o & 3));
}

// v of the lane d below, or fill where there is none
__device__ __forceinline__ float shfl_up_or(float v, int d, float fill) {
  unsigned r;
  asm("{\n\t.reg .pred p;\n\t"
      "shfl.sync.up.b32 %0|p, %1, %2, 0, 0xffffffff;\n\t"
      "@!p mov.b32 %0, %3;\n\t}"
      : "=&r"(r)
      : "r"(__float_as_uint(v)), "r"(d), "r"(__float_as_uint(fill)));
  return __uint_as_float(r);
}

// Maxima of a and b over the lanes below this one (NEG for lane 0): a
// 5-step scan in which a lane below the offset reads its own value, then
// one shuffle for the exclusive value.  Max is exact in any order.
__device__ __forceinline__ void exclusive_max2(float& a, float& b) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    a = fmaxf(a, __shfl_up_sync(kAll, a, o));
    b = fmaxf(b, __shfl_up_sync(kAll, b, o));
  }
  a = shfl_up_or(a, 1, kNeg);
  b = shfl_up_or(b, 1, kNeg);
}

// One row's values that its cell bytes and edge test need once the row is
// done: H, E1, E2 are the row's own (the next row's previous row), the
// rest are kept for them.  The bytes and the test of row i are made while
// row i + 1 runs, so that their shuffles, votes and compares fill the
// stalls of row i + 1's dependent chain (a warp issues in order).
struct Row {
  float H[kPer], E1[kPer], E2[kPer], diag[kPer], F1[kPer], F2[kPer];
  uint32_t ebits;  // the E1 / E2 extension bits (8, 16) of each lane's byte
};

// Cell bytes of row r (1-based; row 0 writes the spare row) and its
// edge-competitive flag: a band-edge cell whose neighbour beyond the band
// is a real matrix cell attains the row maximum.  H[0] >= max exactly when
// no lane's H exceeds H[0] (likewise for lane W-1), so two broadcasts and
// one vote replace the row maximum.
__device__ __forceinline__ void row_bytes(const Row& w, int r, int lane,
                                          int base, int ql,
                                          const Scoring& sc,
                                          uint32_t* bitw, unsigned& fflag) {
  const float F1u = __shfl_up_sync(kAll, w.F1[kPer - 1], 1);
  const float F2u = __shfl_up_sync(kAll, w.F2[kPer - 1], 1);
  uint32_t word = w.ebits;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const float F1l = k ? w.F1[k - 1] : (lane == 0 ? kNeg : F1u);
    const float F2l = k ? w.F2[k - 1] : (lane == 0 ? kNeg : F2u);
    int op = 4;  // DIAG > E1 > E2 > F1 > F2
    if (w.H[k] == w.F1[k]) op = 3;
    if (w.H[k] == w.E2[k]) op = 2;
    if (w.H[k] == w.E1[k]) op = 1;
    if (w.H[k] == w.diag[k]) op = 0;
    int bb = op;
    if (w.F1[k] == F1l - sc.e1) bb |= 32;
    if (w.F2[k] == F2l - sc.e2) bb |= 64;
    word |= (uint32_t)bb << (8 * k);
  }
  bitw[r * 32 + lane] = word;
  const float h_first = __shfl_sync(kAll, w.H[0], 0);
  const float h_last = __shfl_sync(kAll, w.H[kPer - 1], 31);
  float hmax = w.H[0];
#pragma unroll
  for (int k = 1; k < kPer; ++k) hmax = fmaxf(hmax, w.H[k]);
  const unsigned m = __reduce_or_sync(
      kAll, (hmax > h_first ? 1u : 0u) | (hmax > h_last ? 2u : 0u) |
                (hmax > kNeg / 2 ? 4u : 0u));
  const unsigned lc = (r + base) >= 2, rc = (r + base + kW) <= ql;
  fflag |= (r > 0) & (m >> 2) & ((lc & ~m) | (rc & ~(m >> 1)));
}

__global__ void __launch_bounds__(32)
fill_banded_kernel(const uint8_t* __restrict__ tT,
                   const uint8_t* __restrict__ qs,
                   const int* __restrict__ lens, uint8_t* __restrict__ planes,
                   int T, Scoring sc) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  uint8_t* bits = smem;  // row r at r * kW
  uint32_t* bitw = reinterpret_cast<uint32_t*>(bits);
  uint8_t* qsh = bits + (size_t)(T + 1) * kW;
  uint8_t* tsh = qsh + q_bytes(T);
  uint8_t* lo_sh = tsh + pad16(T + 1);
  uint8_t* ex_sh = lo_sh + pad16(T + 1);

  int tl = lens[2 * b], ql = lens[2 * b + 1];
  tl = tl < 0 ? 0 : (tl > T ? T : tl);
  ql = ql < 0 ? 0 : ql;
  const int dq = ql - tl;
  const int adq = dq < 0 ? -dq : dq;
  const int base = (dq < 0 ? dq : 0) - ((kW - adq) >> 1);  // floor division
  const uint8_t* tTb = tT + (size_t)b * T;
  const uint8_t* qsb = qs + (size_t)b * (T + kW);
#pragma unroll 4
  for (int v = lane; v < T + kW; v += 32) qsh[v] = qsb[v];
#pragma unroll 4
  for (int v = lane; v < tl; v += 32) tsh[v] = tTb[v];
  __syncwarp();

  // row 0: H(0, j) for j = base + u, u = 4 lane + k
  const int u0 = kPer * lane;
  Row w;
  float jf[kPer];  // column of each lane at the current row, as a float
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j0 = base + u0 + k;
    w.H[k] = (j0 >= 0 && j0 <= ql)
                 ? (j0 == 0 ? 0.0f : -gapf(sc, (float)j0))
                 : kNeg;
    w.E1[k] = w.E2[k] = w.diag[k] = w.F1[k] = w.F2[k] = kNeg;
    jf[k] = (float)j0;
  }
  w.ebits = 0;
  unsigned fflag = 0;  // bit 0: the edge-competitive flag
  float h0_prev = -0.0f;  // H(i-1, 0); H(0, 0) = -gapT[0]
  uint32_t qw = q_word(qsh, u0);
  int tc = tsh[0];

  for (int i = 1; i <= tl; ++i) {
    // the next row's characters, a row ahead (past t_len: read, unused)
    const uint32_t qw_next = q_word(qsh, i + u0);
    const int tc_next = tsh[i];
    // H, E1, E2 of (i-1, j): lane u+1 of the previous row
    const float Hd = __shfl_down_sync(kAll, w.H[0], 1);
    const float E1d = __shfl_down_sync(kAll, w.E1[0], 1);
    const float E2d = __shfl_down_sync(kAll, w.E2[0], 1);
    const float h0_cur = -gapf(sc, (float)i);
    const float h0_term = (i + base) <= 0 ? h0_cur : kNeg;
    const int tmatch = tc < 4 ? tc : 256;  // code 4 matches nothing
    const int jm0 = i + base + u0;
    Row n;
    n.ebits = 0;
    float H0[kPer], je1[kPer], je2[kPer], c1[kPer], c2[kPer];
    bool valid[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const bool last = k == kPer - 1;
      const float Hs = last ? (lane == 31 ? kNeg : Hd) : w.H[k + 1];
      const float E1s = last ? (lane == 31 ? kNeg : E1d) : w.E1[k + 1];
      const float E2s = last ? (lane == 31 ? kNeg : E2d) : w.E2[k + 1];
      const int jm = jm0 + k;
      valid[k] = jm >= 1 && jm <= ql;
      const int qc = (qw >> (8 * k)) & 255;
      const float sub = qc == tmatch ? sc.mat : sc.mis;
      // left of column 1 the previous row's lane holds NEG already
      const float diag_in = jm == 1 ? h0_prev : w.H[k];
      n.diag[k] = diag_in + sub;
      const float e1x = E1s - sc.e1, e2x = E2s - sc.e2;
      n.E1[k] = fmaxf(e1x, Hs - sc.o1e1);
      n.E2[k] = fmaxf(e2x, Hs - sc.o2e2);
      if (n.E1[k] == e1x) n.ebits |= 8u << (8 * k);
      if (n.E2[k] == e2x) n.ebits |= 16u << (8 * k);
      const float h = fmaxf(n.diag[k], fmaxf(n.E1[k], n.E2[k]));
      H0[k] = valid[k] ? h : kNeg;
      jf[k] += 1.0f;  // exact: |j| < 2^24
      je1[k] = jf[k] * sc.e1;
      je2[k] = jf[k] * sc.e2;
      // inclusive max over this thread's lanes of G = H0 + j e
      const float g1 = valid[k] ? H0[k] + je1[k] : kNeg;
      const float g2 = valid[k] ? H0[k] + je2[k] : kNeg;
      c1[k] = k ? fmaxf(c1[k - 1], g1) : g1;
      c2[k] = k ? fmaxf(c2[k - 1], g2) : g2;
    }
    // the insertion move: maxima of G over the lanes to the left, the
    // thread's own lanes folded with the column-0 term first
    float x1 = c1[kPer - 1], x2 = c2[kPer - 1];
    exclusive_max2(x1, x2);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const float P1 = fmaxf(x1, k ? fmaxf(c1[k - 1], h0_term) : h0_term);
      const float P2 = fmaxf(x2, k ? fmaxf(c2[k - 1], h0_term) : h0_term);
      n.F1[k] = (P1 - je1[k]) - sc.o1;
      n.F2[k] = (P2 - je2[k]) - sc.o2;
      const float h = fmaxf(H0[k], fmaxf(n.F1[k], n.F2[k]));
      n.H[k] = valid[k] ? h : kNeg;
    }
    row_bytes(w, i - 1, lane, base, ql, sc, bitw, fflag);
    w = n;
    h0_prev = h0_cur;
    qw = qw_next;
    tc = tc_next;
  }
  row_bytes(w, tl, lane, base, ql, sc, bitw, fflag);
  __syncwarp();  // every row's bytes are visible to lane 0

  if (lane == 0) {
    // row-run traceback from (t_len, q_len) in band coordinates
    int j = ql, s = 0, flag = 0;
    int uu = j - tl - base;  // band lane of (r, j)
    int bj = (unsigned)uu < kW ? bits[(size_t)tl * kW + uu] : 0;
    for (int r = tl; r >= 1; --r) {
      const uint8_t* brow = bits + (size_t)r * kW;
      // the next row's byte, read ahead: a diagonal keeps the lane, a
      // deletion moves one lane right (row 0 is the spare row)
      int next_m = (unsigned)uu < kW ? brow[uu - kW] : 0;
      int next_d = (unsigned)(uu + 1) < kW ? brow[uu + 1 - kW] : 0;
      flag |= j > 0 && at_edge(uu);
      int n_ins = 0;
      if (s == 0 && j > 0 && (bj & 7) >= 3) {  // an insertion run
        int eff = bj & 7;
        do {
          const int rs = (bj & (eff == 3 ? 32 : 64)) ? eff : 0;
          --j;
          ++n_ins;
          --uu;
          bj = (unsigned)uu < kW ? brow[uu] : 0;
          flag |= j > 0 && at_edge(uu);
          eff = rs > 0 ? rs : (bj & 7);
        } while (j > 0 && eff >= 3);
        next_m = (unsigned)uu < kW ? brow[uu - kW] : 0;
        next_d = (unsigned)(uu + 1) < kW ? brow[uu + 1 - kW] : 0;
      }
      // the row's exit op, from the byte the run stopped on
      const int eff = s > 0 ? s : (bj & 7);
      const bool forced = j <= 0;
      const bool is_m = !forced && eff == 0;
      s = (!forced && (eff == 1 || eff == 2) && (bj & (eff << 3))) ? eff : 0;
      lo_sh[r - 1] = (uint8_t)(n_ins & 255);
      ex_sh[r - 1] = (uint8_t)((is_m ? 1 : 0) | ((n_ins >> 8) << 1));
      j -= is_m;
      uu += !is_m;
      bj = is_m ? next_m : next_d;
    }
    fflag |= flag;
  }
  __syncwarp();  // lane 0's planes are visible to the warp
  const uint8_t esc = __shfl_sync(kAll, fflag ? 128 : 0, 0);
  uint8_t* out = planes + (size_t)b * 2 * T;
  for (int r = lane; r < T; r += 32) {
    const bool live = r < tl;
    out[r] = live ? lo_sh[r] : 0;
    out[T + r] = (uint8_t)((live ? ex_sh[r] : 0) | esc);
  }
}

}  // namespace

// tT (B, T) uint8, qs (B, T + 128) uint8 band-aligned query plane, lens
// (B, 2) int32 (t_len, q_len) -> planes (B, 2T) uint8 with ESCALATE in ex
// bit 7.  T <= 1024.  One job (one warp) a block: 1, 2 and 3 jobs a block
// measured alike (PERF.md), a job's row chain being the time.  Returns a
// cudaError_t (0 = launched).
extern "C" int fill_banded_launch(const void* tT, const void* qs,
                                  const void* lens, void* planes, int B,
                                  int T, int match, int mismatch, int o1,
                                  int e1, int o2, int e2, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (T <= 0 || T > kMaxT) return (int)cudaErrorInvalidValue;
  const size_t smem = slice_bytes(T);  // 135,488 B at T = 1024
  Scoring sc;
  sc.mat = (float)match;
  sc.mis = (float)mismatch;
  sc.e1 = (float)e1;
  sc.e2 = (float)e2;
  sc.o1 = (float)o1;
  sc.o2 = (float)o2;
  sc.o1e1 = (float)(o1 + e1);
  sc.o2e2 = (float)(o2 + e2);
  cudaError_t err = cudaFuncSetAttribute(
      fill_banded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fill_banded_kernel<<<B, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tT), static_cast<const uint8_t*>(qs),
      static_cast<const int*>(lens), static_cast<uint8_t*>(planes), T, sc);
  return (int)cudaGetLastError();
}
