// Full-width global two-piece affine fill with a lockstep op-by-op
// traceback: one thread block per job, one thread per column for the
// fill, then one thread per job for the walk.
//
// Replaces vacmap_tpu/ops/affine_pallas.py::_fill_and_traceback: its
// Pallas kernel _fill_kernel (body _fill_body), which writes an (N, B, N)
// traceback-bits table, and the XLA lax.scan after it, which walks every
// job's path in 2N steps and packs one 2-bit op per step.  The output is
// the same (2N/4, B) uint8 stream, byte for byte: step s = 4g + k of job b
// in bits 2k..2k+1 of byte (g, b); ops 0 = M, 1 = I, 2 = D, emitted from
// the alignment end back to (0, 0), then 3 after the path is done.
//
// The walk (affine_pallas.py:329-357), unlike fill_full.cu's row-run walk,
// moves one cell per step and handles the matrix edges by forcing: with i
// (target) exhausted it drains the query as I, with j exhausted the target
// as D, and a run's continuation state lives only inside the matrix.
//
// What bounds it on an H100: the fill is fill_full.cu's (fill_rows.cuh:
// N dependent rows of block-wide prefix maxima); the walk is 2N dependent
// byte loads from the job's (N, N) table, which stays in L2 after the
// fill, by one thread.  Only the bytes this job wrote are read, and the
// wrapper chunks the batch so one launch's table stays under 1 GiB.  The
// packed bytes are collected in shared memory and written by the block.

#include "fill_rows.cuh"

namespace {

__global__ void fill_scan_kernel(const uint8_t* __restrict__ tT,
                                 const uint8_t* __restrict__ tQ,
                                 const int* __restrict__ t_len,
                                 const int* __restrict__ q_len,
                                 uint8_t* __restrict__ bits,
                                 uint8_t* __restrict__ packed, int N, int ld,
                                 Scoring sc) {
  __shared__ FillShared sm;
  __shared__ uint8_t ops_sh[kMaxN / 2];  // 2N steps, 4 per byte

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int tl = clamp_len(t_len[b], N);
  const int ql = clamp_len(q_len[b], N);
  uint8_t* bitsb = bits + (size_t)b * N * N;
  fill_rows(tT + (size_t)b * N, tQ[(size_t)b * N + t], tl, N, sc, sm, bitsb);

  if (t == 0) {
    int i = tl, j = ql, state = 0;
    unsigned acc = 0;
    for (int s = 0; s < 2 * N; ++s) {
      int emit = 3, di = 0, dj = 0, nstate = 0;
      if (i > 0 && j > 0) {
        const int bv = bitsb[(size_t)(i - 1) * N + (j - 1)];
        const int eff = state > 0 ? state : (bv & 7);
        const bool is_diag = eff == 0;
        const bool is_del = eff == 1 || eff == 2;
        const bool is_ins = eff == 3 || eff == 4;
        emit = is_diag ? 0 : (is_ins ? 1 : 2);
        di = (is_diag || is_del) ? 1 : 0;
        dj = (is_diag || is_ins) ? 1 : 0;
        const int ext_bit = 8 << (eff - 1 > 0 ? eff - 1 : 0);
        nstate = ((is_del || is_ins) && (bv & ext_bit)) ? eff : 0;
      } else if (j <= 0 && i > 0) {  // query exhausted: drain target as D
        emit = 2;
        di = 1;
      } else if (i <= 0 && j > 0) {  // target exhausted: drain query as I
        emit = 1;
        dj = 1;
      }
      acc |= (unsigned)emit << (2 * (s & 3));
      if ((s & 3) == 3) {
        ops_sh[s >> 2] = (uint8_t)acc;
        acc = 0;
      }
      i -= di;
      j -= dj;
      state = nstate;
    }
  }
  __syncthreads();
  for (int g = t; g < N / 2; g += blockDim.x)
    packed[(size_t)g * ld + b] = ops_sh[g];
}

}  // namespace

// tT, tQ (B, N) uint8 character planes, t_len, q_len (B,) int32, bits
// (B, N, N) uint8 scratch -> packed (2N/4, ld) uint8, job b in column b
// (the caller offsets packed to its first column; ld >= B).  N % 32 == 0,
// N <= 1024.  Returns a cudaError_t (0 = launched).
extern "C" int fill_scan_launch(const void* tT, const void* tQ,
                                const void* t_len, const void* q_len,
                                void* bits, void* packed, int B, int N, int ld,
                                int match, int mismatch, int o1, int e1,
                                int o2, int e2, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (N <= 0 || N > kMaxN || (N & 31) || ld < B)
    return (int)cudaErrorInvalidValue;
  fill_scan_kernel<<<B, N, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tT), static_cast<const uint8_t*>(tQ),
      static_cast<const int*>(t_len), static_cast<const int*>(q_len),
      static_cast<uint8_t*>(bits), static_cast<uint8_t*>(packed), N, ld,
      make_scoring(match, mismatch, o1, e1, o2, e2));
  return (int)cudaGetLastError();
}
