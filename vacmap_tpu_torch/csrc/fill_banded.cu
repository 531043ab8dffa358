// Banded global two-piece affine fill with a row-run traceback: one block
// of W = 128 threads per job, band lane u on thread u.
//
// Replaces vacmap_tpu/ops/affine_pallas.py::_fill_tb_kernel_banded,
// launched there by _fill_and_rowruns_banded.  Same scoring, op priority
// and output planes as fill_full.cu, over an offset-space band: lane u of
// row i holds column j = i + base + u, base = min(0, dq) - (W - |dq|) / 2
// (floor), dq = q_len - t_len.  The query plane arrives band-aligned
// (qshift[v] = q[base + v], make_qshift), so row i reads qshift[i-1+u].
// The diagonal move is lane-aligned, the deletion move is a one-lane
// shift of the previous row and the insertion move is the in-row prefix
// max.  ESCALATE (ex bit 7 of every lane) is set when the traceback
// touches a band edge lane, or when an interior band-edge cell is the row
// maximum while the column beyond it is a real matrix cell; the caller
// re-runs those jobs full-width.  The band's known suboptimality (a
// staircase optimum outside the band whose traceback never touches an
// edge) is reproduced as the reference has it, not fixed: the planes
// must be the reference's, byte for byte.
//
// What bounds it on an H100: like the full kernel, a chain of t_len
// dependent rows, each with two 128-lane prefix maxima, a row maximum and
// a one-lane shift, so the latency per row is four barriers; one block
// keeps only 4 warps busy.  The per-cell bytes (T x W: 32 KB at T = 256,
// 64 KB at T = 512, opt-in dynamic shared memory) never leave the SM,
// and thread 0 walks the traceback out of shared memory.  Character
// planes stay uint8 (a base code 4 mismatches everything, as on the
// host); values are f32 with NEG = -1e9 as in the reference.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e9f;
constexpr int kW = 128;
constexpr int kWarps = kW / 32;
constexpr int kMaxT = 1024;

struct Scoring {
  float mat, mis, e1, e2, o1, o2, o1e1, o2e2;
};

__device__ __forceinline__ float gapf(const Scoring& sc, float l) {
  return fminf(sc.o1 + sc.e1 * l, sc.o2 + sc.e2 * l);
}

__device__ __forceinline__ bool at_edge(int u) { return u <= 0 || u >= kW - 1; }

__global__ void __launch_bounds__(kW)
fill_banded_kernel(const uint8_t* __restrict__ tT,
                   const uint8_t* __restrict__ qs,
                   const int* __restrict__ lens, uint8_t* __restrict__ planes,
                   int T, Scoring sc) {
  extern __shared__ uint8_t bits[];  // (T, W) per-cell traceback bytes
  __shared__ float Hsh[kW], E1sh[kW], E2sh[kW];
  __shared__ float scan1[kW], scan2[kW];
  __shared__ float Fsh1[kW], Fsh2[kW];
  __shared__ float wmax1[kWarps], wmax2[kWarps], wrow[kWarps];
  __shared__ uint8_t lo_sh[kMaxT], ex_sh[kMaxT];
  __shared__ int esc_sh;

  const int b = blockIdx.x;
  const int u = threadIdx.x;
  const int lane = u & 31;
  const int warp = u >> 5;
  int tl = lens[2 * b], ql = lens[2 * b + 1];
  tl = tl < 0 ? 0 : (tl > T ? T : tl);
  ql = ql < 0 ? 0 : ql;
  const int dq = ql - tl;
  const int adq = dq < 0 ? -dq : dq;
  const int base = (dq < 0 ? dq : 0) - ((kW - adq) >> 1);  // floor division
  const uint8_t* tTb = tT + (size_t)b * T;
  const uint8_t* qsb = qs + (size_t)b * (T + kW);

  // row 0: H(0, j) for j = base + u
  const int j0 = base + u;
  float H = (j0 >= 0 && j0 <= ql)
                ? (j0 == 0 ? 0.0f : -gapf(sc, (float)j0))
                : kNeg;
  float E1 = kNeg, E2 = kNeg;
  Hsh[u] = H;
  E1sh[u] = E1;
  E2sh[u] = E2;
  for (int r = u; r < T; r += kW) {
    lo_sh[r] = 0;
    ex_sh[r] = 0;
  }
  int fflag = 0;  // meaningful in thread 0
  __syncthreads();

  for (int i = 1; i <= tl; ++i) {
    const int j_mat = i + base + u;
    const bool jvalid = j_mat >= 1 && j_mat <= ql;
    const float h0_prev = (i == 1) ? -0.0f : -gapf(sc, (float)(i - 1));
    const float h0_cur = -gapf(sc, (float)i);
    const int tchar = tTb[i - 1];
    const int qc = qsb[i - 1 + u];
    const float sub = (qc == tchar && tchar < 4) ? sc.mat : sc.mis;
    const float diag_in = j_mat == 1 ? h0_prev : (j_mat > 1 ? H : kNeg);
    const float diag = diag_in + sub;
    // H, E1, E2 of (i-1, j): lane u+1 of the previous row
    const float Hs = u < kW - 1 ? Hsh[u + 1] : kNeg;
    const float E1s = u < kW - 1 ? E1sh[u + 1] : kNeg;
    const float E2s = u < kW - 1 ? E2sh[u + 1] : kNeg;
    const float E1n = fmaxf(E1s - sc.e1, Hs - sc.o1e1);
    const float E2n = fmaxf(E2s - sc.e2, Hs - sc.o2e2);
    float H0 = fmaxf(diag, fmaxf(E1n, E2n));
    H0 = jvalid ? H0 : kNeg;
    const float jf = (float)j_mat;
    const float je1 = jf * sc.e1, je2 = jf * sc.e2;
    // column-0 gap jumps only while column 0 is inside the band
    const float h0_term = (i + base) <= 0 ? h0_cur : kNeg;
    float g1 = jvalid ? H0 + je1 : kNeg;
    float g2 = jvalid ? H0 + je2 : kNeg;
    for (int o = 1; o < 32; o <<= 1) {
      const float n1 = __shfl_up_sync(0xffffffffu, g1, o);
      const float n2 = __shfl_up_sync(0xffffffffu, g2, o);
      if (lane >= o) {
        g1 = fmaxf(g1, n1);
        g2 = fmaxf(g2, n2);
      }
    }
    if (lane == 31) {
      wmax1[warp] = g1;
      wmax2[warp] = g2;
    }
    __syncthreads();  // (A) previous-row reads done, warp maxima visible
    for (int w = 0; w < warp; ++w) {
      g1 = fmaxf(g1, wmax1[w]);
      g2 = fmaxf(g2, wmax2[w]);
    }
    scan1[u] = g1;
    scan2[u] = g2;
    __syncthreads();  // (B)
    const float P1 = fmaxf(u == 0 ? kNeg : scan1[u - 1], h0_term);
    const float P2 = fmaxf(u == 0 ? kNeg : scan2[u - 1], h0_term);
    const float F1 = (P1 - je1) - sc.o1;
    const float F2 = (P2 - je2) - sc.o2;
    float Hn = fmaxf(H0, fmaxf(F1, F2));
    Hn = jvalid ? Hn : kNeg;
    Fsh1[u] = F1;
    Fsh2[u] = F2;
    Hsh[u] = Hn;
    E1sh[u] = E1n;
    E2sh[u] = E2n;
    float m = Hn;
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) wrow[warp] = m;
    __syncthreads();  // (C)
    const float F1l = u == 0 ? kNeg : Fsh1[u - 1];
    const float F2l = u == 0 ? kNeg : Fsh2[u - 1];
    int op = 4;
    if (Hn == F1) op = 3;
    if (Hn == E2n) op = 2;
    if (Hn == E1n) op = 1;
    if (Hn == diag) op = 0;
    int bb = op;
    if (E1n == E1s - sc.e1) bb |= 8;
    if (E2n == E2s - sc.e2) bb |= 16;
    if (F1 == F1l - sc.e1) bb |= 32;
    if (F2 == F2l - sc.e2) bb |= 64;
    bits[(size_t)(i - 1) * kW + u] = (uint8_t)bb;
    if (u == 0) {
      // edge-competitive flag: a band-edge cell whose neighbour beyond the
      // band is a real matrix cell attains the row maximum
      float rowmax = wrow[0];
      for (int w = 1; w < kWarps; ++w) rowmax = fmaxf(rowmax, wrow[w]);
      const bool lc = (i + base) >= 2;
      const bool rc = (i + base + kW) <= ql;
      const bool edge_hit =
          (lc && Hsh[0] >= rowmax) || (rc && Hsh[kW - 1] >= rowmax);
      if (rowmax > kNeg / 2 && edge_hit) fflag = 1;
    }
    H = Hn;
    // (A) of the next row orders these shared reads before the next
    // row's writes
  }
  __syncthreads();  // every row's bytes are visible to thread 0

  if (u == 0) {
    // row-run traceback from (t_len, q_len) in band coordinates
    int j = ql, s = 0, flag = 0;
    for (int r = tl; r >= 1; --r) {
      const uint8_t* brow = bits + (size_t)(r - 1) * kW;
      int n_ins = 0;
      if (s == 0) {  // insertion run (E-state rows skip it)
        int rs = 0;
        while (j > 0) {
          const int uu = j - r - base;
          if (at_edge(uu)) flag = 1;
          const int bj = (uu >= 0 && uu < kW) ? brow[uu] : 0;
          const int eff = rs > 0 ? rs : (bj & 7);
          if (eff < 3) break;
          rs = (bj & (eff == 3 ? 32 : 64)) ? eff : 0;
          --j;
          ++n_ins;
        }
      }
      const int uu = j - r - base;
      if (j > 0 && at_edge(uu)) flag = 1;
      const int bj = (uu >= 0 && uu < kW) ? brow[uu] : 0;
      const int eff = s > 0 ? s : (bj & 7);
      const bool forced = j <= 0;
      const bool is_m = !forced && eff == 0;
      const int extbit = 8 << (eff - 1 > 0 ? eff - 1 : 0);
      s = (!forced && eff >= 1 && eff <= 2 && (bj & extbit)) ? eff : 0;
      if (is_m) --j;
      lo_sh[r - 1] = (uint8_t)(n_ins & 255);
      ex_sh[r - 1] = (uint8_t)((is_m ? 1 : 0) | ((n_ins >> 8) << 1));
    }
    esc_sh = (flag || fflag) ? 128 : 0;
  }
  __syncthreads();
  uint8_t* out = planes + (size_t)b * 2 * T;
  const int esc = esc_sh;
  for (int r = u; r < T; r += kW) {
    out[r] = lo_sh[r];
    out[T + r] = (uint8_t)(ex_sh[r] | esc);
  }
}

}  // namespace

// tT (B, T) uint8, qs (B, T + 128) uint8 band-aligned query plane, lens
// (B, 2) int32 (t_len, q_len) -> planes (B, 2T) uint8 with ESCALATE in ex
// bit 7.  T <= 1024.  Returns a cudaError_t (0 = launched).
extern "C" int fill_banded_launch(const void* tT, const void* qs,
                                  const void* lens, void* planes, int B,
                                  int T, int match, int mismatch, int o1,
                                  int e1, int o2, int e2, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (T <= 0 || T > kMaxT) return (int)cudaErrorInvalidValue;
  Scoring sc;
  sc.mat = (float)match;
  sc.mis = (float)mismatch;
  sc.e1 = (float)e1;
  sc.e2 = (float)e2;
  sc.o1 = (float)o1;
  sc.o2 = (float)o2;
  sc.o1e1 = (float)(o1 + e1);
  sc.o2e2 = (float)(o2 + e2);
  const size_t smem = (size_t)T * kW;
  cudaError_t err = cudaFuncSetAttribute(
      fill_banded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fill_banded_kernel<<<B, kW, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tT), static_cast<const uint8_t*>(qs),
      static_cast<const int*>(lens), static_cast<uint8_t*>(planes), T, sc);
  return (int)cudaGetLastError();
}
