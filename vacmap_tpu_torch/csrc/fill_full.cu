// Full-width global two-piece affine fill with a row-run traceback: one
// thread block per job, one thread per column.
//
// Replaces vacmap_tpu/ops/affine_pallas.py::_fill_tb_kernel (DP body in
// _fill_body), launched there by _fill_and_rowruns.  Scoring: match 2,
// mismatch -4, gap cost min(4 + 2l, 24 + l); op priority DIAG > E1 > E2
// > F1 > F2; ext flags 8/16/32/64.  Output per job: one (2N,) uint8 row,
// lanes [0, N) lo = n_ins & 255 and [N, 2N) ex = is_diag | (n_ins >> 8)
// << 1 for matrix row l+1 at lane l (the planes native.decode_rowruns
// reads).
//
// What bounds it on an H100: the fill is a chain of N dependent rows, and
// each row needs two prefix maxima across all N columns (the horizontal
// gap F = prefix max of H0 + j*e), so the latency per row is a block-wide
// scan plus three barriers; the arithmetic (about 40 f32 ops per cell) is
// small.  The traceback needs one byte per cell: 64 KB at N = 256, 256 KB
// at N = 512, more than a block's shared memory at 512.  The design:
//   * the column's vertical state (E1, E2) stays in registers; the
//     previous row's H is exchanged through shared memory for the
//     diagonal move; the two prefix maxima are warp-shuffle scans joined
//     through shared memory (max is exact, so any order agrees with the
//     reference's log-step rolls);
//   * the per-cell bytes go to device memory (coalesced N-byte row
//     stores; the wrapper allocates them and chunks the batch so one
//     launch stays under 1 GiB), where they stay in L2 for the walk;
//   * after the fill, thread 0 walks the row-run traceback from (t_len,
//     q_len) and the block writes the planes.  Rows past t_len are not
//     filled: no output depends on them.
// Values are f32 with the reference's NEG = -1e9 so that unreachable
// cells round exactly as there (the plane bytes are compared exactly).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e9f;
constexpr int kMaxN = 1024;
constexpr int kMaxWarps = kMaxN / 32;

struct Scoring {
  float mat, mis, e1, e2, o1, o2, o1e1, o2e2;
};

__device__ __forceinline__ float gapf(const Scoring& sc, float l) {
  return fminf(sc.o1 + sc.e1 * l, sc.o2 + sc.e2 * l);
}

// The row's exit op (one diag or del) after its insertion run; updates
// the traceback state s and returns is_diag.
__device__ __forceinline__ bool exit_op(int b, int j, int& s) {
  const int eff = s > 0 ? s : (b & 7);
  const bool forced = j <= 0;
  const bool is_m = !forced && eff == 0;
  const int extbit = 8 << (eff - 1 > 0 ? eff - 1 : 0);
  s = (!forced && eff >= 1 && eff <= 2 && (b & extbit)) ? eff : 0;
  return is_m;
}

__global__ void fill_full_kernel(const uint8_t* __restrict__ tT,
                                 const uint8_t* __restrict__ tQ,
                                 const int* __restrict__ lens,
                                 uint8_t* __restrict__ bits,
                                 uint8_t* __restrict__ planes, int N,
                                 Scoring sc) {
  __shared__ float Hsh[kMaxN];
  __shared__ float scan1[kMaxN], scan2[kMaxN];
  __shared__ float Fsh1[kMaxN], Fsh2[kMaxN];
  __shared__ float wmax1[kMaxWarps], wmax2[kMaxWarps];
  __shared__ uint8_t lo_sh[kMaxN], ex_sh[kMaxN];

  const int b = blockIdx.x;
  const int t = threadIdx.x;  // lane l = t holds column j = t + 1
  const int lane = t & 31;
  const int warp = t >> 5;
  int tl = lens[2 * b], ql = lens[2 * b + 1];
  tl = tl < 0 ? 0 : (tl > N ? N : tl);
  ql = ql < 0 ? 0 : (ql > N ? N : ql);
  const uint8_t* tTb = tT + (size_t)b * N;
  const int qc = tQ[(size_t)b * N + t];
  uint8_t* bitsb = bits + (size_t)b * N * N;
  const float jf = (float)(t + 1);
  const float je1 = jf * sc.e1, je2 = jf * sc.e2;

  float H = -gapf(sc, jf);  // H(0, j)
  float E1 = kNeg, E2 = kNeg;
  Hsh[t] = H;
  lo_sh[t] = 0;
  ex_sh[t] = 0;
  __syncthreads();

  for (int i = 1; i <= tl; ++i) {
    const float h0_prev = (i == 1) ? -0.0f : -gapf(sc, (float)(i - 1));
    const float h0_cur = -gapf(sc, (float)i);
    const int tchar = tTb[i - 1];
    const float sub = (qc == tchar && tchar < 4) ? sc.mat : sc.mis;
    const float diag = (t == 0 ? h0_prev : Hsh[t - 1]) + sub;
    const float E1n = fmaxf(E1 - sc.e1, H - sc.o1e1);
    const float E2n = fmaxf(E2 - sc.e2, H - sc.o2e2);
    const float H0 = fmaxf(diag, fmaxf(E1n, E2n));
    // inclusive prefix max of G = H0 + j*e along the row
    float g1 = H0 + je1, g2 = H0 + je2;
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
    __syncthreads();  // (A) Hsh reads done, warp maxima visible
    for (int w = 0; w < warp; ++w) {
      g1 = fmaxf(g1, wmax1[w]);
      g2 = fmaxf(g2, wmax2[w]);
    }
    scan1[t] = g1;
    scan2[t] = g2;
    __syncthreads();  // (B)
    const float P1 = fmaxf(t == 0 ? kNeg : scan1[t - 1], h0_cur);
    const float P2 = fmaxf(t == 0 ? kNeg : scan2[t - 1], h0_cur);
    const float F1 = (P1 - je1) - sc.o1;
    const float F2 = (P2 - je2) - sc.o2;
    const float Hn = fmaxf(H0, fmaxf(F1, F2));
    Fsh1[t] = F1;
    Fsh2[t] = F2;
    Hsh[t] = Hn;
    __syncthreads();  // (C)
    const float F1l = t == 0 ? kNeg : Fsh1[t - 1];
    const float F2l = t == 0 ? kNeg : Fsh2[t - 1];
    int op = 4;
    if (Hn == F1) op = 3;
    if (Hn == E2n) op = 2;
    if (Hn == E1n) op = 1;
    if (Hn == diag) op = 0;
    int bb = op;
    if (E1n == E1 - sc.e1) bb |= 8;
    if (E2n == E2 - sc.e2) bb |= 16;
    if (F1 == F1l - sc.e1) bb |= 32;
    if (F2 == F2l - sc.e2) bb |= 64;
    bitsb[(size_t)(i - 1) * N + t] = (uint8_t)bb;
    H = Hn;
    E1 = E1n;
    E2 = E2n;
  }
  __syncthreads();  // the bits of every row are visible to thread 0

  if (t == 0) {
    // row-run traceback from (t_len, q_len) in state H
    int j = ql, s = 0;
    for (int r = tl; r >= 1; --r) {
      const uint8_t* brow = bitsb + (size_t)(r - 1) * N;
      int n_ins = 0;
      if (s == 0) {  // insertion run (E-state rows skip it)
        int rs = 0;
        while (j > 0) {
          const int bj = brow[j - 1];
          const int eff = rs > 0 ? rs : (bj & 7);
          if (eff < 3) break;
          // F-run continuation flag lives at the current cell
          rs = (bj & (eff == 3 ? 32 : 64)) ? eff : 0;
          --j;
          ++n_ins;
        }
      }
      const int bj = j > 0 ? brow[j - 1] : 0;
      const bool is_m = exit_op(bj, j, s);
      if (is_m) --j;
      lo_sh[r - 1] = (uint8_t)(n_ins & 255);
      ex_sh[r - 1] = (uint8_t)((is_m ? 1 : 0) | ((n_ins >> 8) << 1));
    }
  }
  __syncthreads();
  uint8_t* out = planes + (size_t)b * 2 * N;
  out[t] = lo_sh[t];
  out[N + t] = ex_sh[t];
}

}  // namespace

// tT, tQ (B, N) uint8 character planes, lens (B, 2) int32 (t_len, q_len),
// bits (B, N, N) uint8 scratch -> planes (B, 2N) uint8.  N % 32 == 0,
// N <= 1024.  Returns a cudaError_t (0 = launched).
extern "C" int fill_full_launch(const void* tT, const void* tQ,
                                const void* lens, void* bits, void* planes,
                                int B, int N, int match, int mismatch, int o1,
                                int e1, int o2, int e2, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (N <= 0 || N > kMaxN || (N & 31)) return (int)cudaErrorInvalidValue;
  Scoring sc;
  sc.mat = (float)match;
  sc.mis = (float)mismatch;
  sc.e1 = (float)e1;
  sc.e2 = (float)e2;
  sc.o1 = (float)o1;
  sc.o2 = (float)o2;
  sc.o1e1 = (float)(o1 + e1);
  sc.o2e2 = (float)(o2 + e2);
  fill_full_kernel<<<B, N, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tT), static_cast<const uint8_t*>(tQ),
      static_cast<const int*>(lens), static_cast<uint8_t*>(bits),
      static_cast<uint8_t*>(planes), N, sc);
  return (int)cudaGetLastError();
}
