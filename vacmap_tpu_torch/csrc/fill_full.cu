// Full-width global two-piece affine fill with a row-run traceback: one
// warp per 128 columns of a job for the fill, one warp for the walk, one
// job a block.
//
// Replaces vacmap_tpu/ops/affine_pallas.py::_fill_tb_kernel (:172, body
// _fill_body :73), launched there by _fill_and_rowruns (:739 ->
// pallas_call :767).  Scoring: match 2, mismatch -4, gap cost
// min(4 + 2l, 24 + l); op priority DIAG > E1 > E2 > F1 > F2; ext flags
// 8/16/32/64.  Output per job: one (2N,) uint8 row, lanes [0, N) lo =
// n_ins & 255 and [N, 2N) ex = is_diag | (n_ins >> 8) << 1 for matrix
// row l+1 at lane l (the planes native.decode_rowruns reads).
//
// What bounds it on an H100: one job's chain, not bytes or operations (a
// launch from the executor holds four jobs and lasts as long as the
// longest).  The chain is tl dependent rows, then a walk of up to
// tl + ql dependent steps.  The design:
//   * the fill is fill_rows.cuh's anti-diagonal wavefront (shared with
//     fill_scan.cu): four columns a lane, a row a step in each lane, the
//     warps of a job handing their last column on through shared memory,
//     no scan and no barrier inside it; F by its recurrence in int32
//     maxima, which gives the reference's bytes exactly (see there);
//   * the per-cell bytes go to device memory (a row's C bytes a lane in
//     one store; the wrapper allocates the table and chunks the batch so
//     one launch's table stays under 1 GiB), where they stay in L2;
//   * warp 0 then walks the row-run traceback from (t_len, q_len), every
//     lane alike, from a ring of rows in shared memory that cp.async
//     fills a few chunks of rows ahead (fill_rows.cuh::RowRing), so a
//     step is a shared-memory read and not an L2 round trip, and each
//     row's first byte is read while the row before ends; then the warp
//     writes the planes.

#include "fill_rows.cuh"

namespace {

// Row-run traceback from (tl, ql) in state H over the ring's rows; the
// planes of row r go to lo_sh[r - 1], ex_sh[r - 1].  Every lane of the
// warp runs it.  The byte a row starts on is read while the row before
// ends: both candidates (a diagonal keeps the column, a deletion moves
// one right) before the exit op picks one, so that only an insertion run
// waits on a read.
__device__ __forceinline__ void walk_rowruns(const RowRing& ring, int tl,
                                             int ql, uint8_t* lo_sh,
                                             uint8_t* ex_sh) {
  ring.start(tl);
  ring.enter(tl, tl);
  const uint8_t* brow = ring.row(tl);
  int j = ql, s = 0;
  int bj = j > 0 ? brow[j - 1] : 0;
  for (int r = tl; r >= 1; --r) {
    int n_ins = 0;
    if (s == 0 && j > 0 && (bj & 7) >= 3) {  // an insertion run
      int eff = bj & 7;
      do {
        // the F-run continuation flag lives at the current cell
        const int rs = (bj & (eff == 3 ? 32 : 64)) ? eff : 0;
        --j;
        ++n_ins;
        bj = j > 0 ? brow[j - 1] : 0;
        eff = rs > 0 ? rs : (bj & 7);
      } while (j > 0 && eff >= 3);
    }
    // the next row's two candidates, read before the exit op decides
    const uint8_t* next = ring.row(r > 1 ? r - 1 : r);
    const int next_m = j >= 2 ? next[j - 2] : 0;
    const int next_d = j >= 1 ? next[j - 1] : 0;
    // the row's exit op (one diag or del), from the byte the run stopped on
    const int eff = s > 0 ? s : (bj & 7);
    const bool forced = j <= 0;
    const bool is_m = !forced && eff == 0;
    s = (!forced && (eff == 1 || eff == 2) && (bj & (eff << 3))) ? eff : 0;
    lo_sh[r - 1] = (uint8_t)(n_ins & 255);
    ex_sh[r - 1] = (uint8_t)((is_m ? 1 : 0) | ((n_ins >> 8) << 1));
    j -= is_m;
    bj = is_m ? next_m : next_d;
    if (r > 1) {
      ring.enter(r - 1, tl);
      brow = next;
    }
  }
  ring.finish();
}

template <int C>
__global__ void __launch_bounds__(32 * kMaxN / (32 * kMaxCols))
fill_full_kernel(const uint8_t* __restrict__ tT, const uint8_t* __restrict__ tQ,
                 const int* __restrict__ lens, uint8_t* __restrict__ bits,
                 uint8_t* __restrict__ planes, int N, Scoring sc) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout L = layout(N, blockDim.x >> 5, ring_bytes(N), 2 * N);
  const int b = blockIdx.x;
  const int tl = clamp_len(lens[2 * b], N);
  const int ql = clamp_len(lens[2 * b + 1], N);
  uint8_t* bitsb = bits + (size_t)b * N * N;
  int4* xch = reinterpret_cast<int4*>(smem + L.xch);
  int* ready = reinterpret_cast<int*>(smem + L.ready);
  stage(tT + (size_t)b * N, N, sc, smem + L.tsh, xch, ready);
  fill_rows<C>(tQ + (size_t)b * N, smem + L.tsh, tl, N, sc, xch, ready,
               bitsb);
  __syncthreads();  // every warp's bytes are in the table
  if (threadIdx.x >= 32) return;

  uint8_t* lo_sh = smem + L.out;
  uint8_t* ex_sh = lo_sh + N;
  if (tl > 0) {
    const RowRing ring{smem + L.ring, bitsb, N};
    walk_rowruns(ring, tl, ql, lo_sh, ex_sh);
  }
  __syncwarp();
  uint8_t* out = planes + (size_t)b * 2 * N;
  for (int r = threadIdx.x; r < N; r += 32) {
    const bool live = r < tl;
    out[r] = live ? lo_sh[r] : 0;
    out[N + r] = live ? ex_sh[r] : 0;
  }
}

template <int C>
cudaError_t launch_cols(int c, const void* tT, const void* tQ,
                        const void* lens, void* bits, void* planes, int B,
                        int N, const Scoring& sc, cudaStream_t stream) {
  if constexpr (C > kMaxCols) {
    return cudaErrorInvalidValue;
  } else {
    if (c != C)
      return launch_cols<2 * C>(c, tT, tQ, lens, bits, planes, B, N, sc,
                                stream);
    const int W = warps_a_job(N);
    const int smem = layout(N, W, ring_bytes(N), 2 * N).total;
    cudaError_t err = cudaFuncSetAttribute(
        fill_full_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    fill_full_kernel<C><<<B, 32 * W, smem, stream>>>(
        static_cast<const uint8_t*>(tT), static_cast<const uint8_t*>(tQ),
        static_cast<const int*>(lens), static_cast<uint8_t*>(bits),
        static_cast<uint8_t*>(planes), N, sc);
    return cudaGetLastError();
  }
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
  return (int)launch_cols<1>(cols_a_lane(N), tT, tQ, lens, bits, planes, B, N,
                             make_scoring(match, mismatch, o1, e1, o2, e2),
                             static_cast<cudaStream_t>(stream));
}
