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
//   * the fill itself is fill_rows.cuh (shared with fill_scan.cu);
//   * the per-cell bytes go to device memory (coalesced N-byte row
//     stores; the wrapper allocates them and chunks the batch so one
//     launch stays under 1 GiB), where they stay in L2 for the walk;
//   * after the fill, thread 0 walks the row-run traceback from (t_len,
//     q_len) and the block writes the planes.
// Values are f32 with the reference's NEG = -1e9 so that unreachable
// cells round exactly as there (the plane bytes are compared exactly).

#include "fill_rows.cuh"

namespace {

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
  __shared__ FillShared sm;
  __shared__ uint8_t lo_sh[kMaxN], ex_sh[kMaxN];

  const int b = blockIdx.x;
  const int t = threadIdx.x;  // lane l = t holds column j = t + 1
  const int tl = clamp_len(lens[2 * b], N);
  const int ql = clamp_len(lens[2 * b + 1], N);
  uint8_t* bitsb = bits + (size_t)b * N * N;
  lo_sh[t] = 0;
  ex_sh[t] = 0;
  fill_rows(tT + (size_t)b * N, tQ[(size_t)b * N + t], tl, N, sc, sm, bitsb);

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
  fill_full_kernel<<<B, N, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tT), static_cast<const uint8_t*>(tQ),
      static_cast<const int*>(lens), static_cast<uint8_t*>(bits),
      static_cast<uint8_t*>(planes), N,
      make_scoring(match, mismatch, o1, e1, o2, e2));
  return (int)cudaGetLastError();
}
