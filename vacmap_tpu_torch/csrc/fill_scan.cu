// Full-width global two-piece affine fill with a lockstep op-by-op
// traceback: one warp per 128 columns of a job for the fill, then one
// thread for the walk, one job a block.
//
// Replaces vacmap_tpu/ops/affine_pallas.py::_fill_and_traceback (:291):
// its Pallas kernel _fill_kernel (:166, body _fill_body :73, pallas_call
// :307), which writes an (N, B, N) traceback-bits table, and the XLA
// lax.scan after it (:324-364), which walks every job's path in 2N steps
// and packs one 2-bit op per step.  The output is the same (2N/4, B)
// uint8 stream, byte for byte: step s = 4g + k of job b in bits 2k..2k+1
// of byte (g, b); ops 0 = M, 1 = I, 2 = D, emitted from the alignment end
// back to (0, 0), then 3 after the path is done.
//
// The walk, unlike fill_full.cu's row-run walk, moves one cell per step
// and handles the matrix edges by forcing: with i (target) exhausted it
// drains the query as I, with j exhausted the target as D, and a run's
// continuation state lives only inside the matrix.
//
// What bounds it on an H100: one job's chain, as for fill_full.cu: tl
// dependent rows of the fill (fill_rows.cuh's anti-diagonal wavefront,
// which gives the reference's bytes exactly), then 2N dependent walk
// steps, each a byte load from the job's (N, N) table, which the fill
// leaves in L2.  The walk was a fifth to a quarter of the kernel this one
// replaces (PERF.md), so it stays as it was: thread 0 reads the table in
// device memory, and the packed bytes are collected in shared memory and
// written by the warp.  The wrapper chunks the batch so one launch's
// table stays under 1 GiB.

#include "fill_rows.cuh"

namespace {

// The op stream of one job from (tl, ql) into ops_sh (N / 2 bytes).
// One thread runs it.
__device__ __forceinline__ void walk_ops(const uint8_t* __restrict__ bitsb,
                                         int tl, int ql, int N,
                                         uint8_t* ops_sh) {
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

template <int C>
__global__ void __launch_bounds__(32 * kMaxN / (32 * kMaxCols))
fill_scan_kernel(const uint8_t* __restrict__ tT, const uint8_t* __restrict__ tQ,
                 const int* __restrict__ t_len, const int* __restrict__ q_len,
                 uint8_t* __restrict__ bits, uint8_t* __restrict__ packed,
                 int N, int ld, Scoring sc) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout L = layout(N, blockDim.x >> 5, 0, N / 2);
  const int b = blockIdx.x;
  const int tl = clamp_len(t_len[b], N);
  const int ql = clamp_len(q_len[b], N);
  uint8_t* bitsb = bits + (size_t)b * N * N;
  int4* xch = reinterpret_cast<int4*>(smem + L.xch);
  int* ready = reinterpret_cast<int*>(smem + L.ready);
  stage(tT + (size_t)b * N, N, sc, smem + L.tsh, xch, ready);
  fill_rows<C>(tQ + (size_t)b * N, smem + L.tsh, tl, N, sc, xch, ready,
               bitsb);
  __syncthreads();  // every warp's bytes are in the table
  if (threadIdx.x >= 32) return;

  uint8_t* ops_sh = smem + L.out;
  if (threadIdx.x == 0) walk_ops(bitsb, tl, ql, N, ops_sh);
  __syncwarp();
  for (int g = threadIdx.x; g < N / 2; g += 32)
    packed[(size_t)g * ld + b] = ops_sh[g];
}

template <int C>
cudaError_t launch_cols(int c, const void* tT, const void* tQ,
                        const void* t_len, const void* q_len, void* bits,
                        void* packed, int B, int N, int ld, const Scoring& sc,
                        cudaStream_t stream) {
  if constexpr (C > kMaxCols) {
    return cudaErrorInvalidValue;
  } else {
    if (c != C)
      return launch_cols<2 * C>(c, tT, tQ, t_len, q_len, bits, packed, B, N,
                                ld, sc, stream);
    const int W = warps_a_job(N);
    const int smem = layout(N, W, 0, N / 2).total;
    cudaError_t err = cudaFuncSetAttribute(
        fill_scan_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    fill_scan_kernel<C><<<B, 32 * W, smem, stream>>>(
        static_cast<const uint8_t*>(tT), static_cast<const uint8_t*>(tQ),
        static_cast<const int*>(t_len), static_cast<const int*>(q_len),
        static_cast<uint8_t*>(bits), static_cast<uint8_t*>(packed), N, ld,
        sc);
    return cudaGetLastError();
  }
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
  return (int)launch_cols<1>(cols_a_lane(N), tT, tQ, t_len, q_len, bits,
                             packed, B, N, ld,
                             make_scoring(match, mismatch, o1, e1, o2, e2),
                             static_cast<cudaStream_t>(stream));
}
