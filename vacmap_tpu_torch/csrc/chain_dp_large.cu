// Warm-start (frontier-carry) chaining DP for large N: tiled over rows,
// the whole card per problem, one launch per call.
//
// Replaces vacmap_tpu/ops/chain_jax.py::chain_scores_batch_warm (an XLA
// lax.scan over anchor index i), the device chain of the asm streaming
// path: B = 1, one call per 100 kb block of contig.  A block of unique
// sequence at assembly-like divergence has a few thousand anchors (its
// co-diagonal seeds merge) and a frontier of a few; a block of repeats or
// of diverged sequence keeps up to about 18,000 minimizer anchors plus
// the carried frontier, N = 2^15 and up.  The first n_warm rows
// are frozen: their S is warm_S as given and their P codes (<= -2) pass
// through; they are candidates but are never scored.  Rows at or past
// n_valid keep warm_S and get P = -1.  Every other row i gets
// S[i] = max(len_i, max_j test(i, j)) over the candidates j < n_valid
// with barrier_j < barrier_i, and P[i] = the winner under the
// (test, S[j], j) lexicographic maximum.  With n_warm = 0 and warm_S = 0
// this is chain_scores_batch without the refund ledger, which serves the
// cold DP above chain_dp.cu's shared-memory limit of 8192 anchors.
//
// Precondition (the layout's contract, checked by the wrapper): rows in
// [n_warm, n_valid) are sorted by barrier, so a candidate of row i has
// j < i.  Frozen rows are in no order (the frontier is sorted by score);
// they all lie below n_warm <= i, so the same cut holds for them.
//
// What bounds it on an H100: operations.  One problem is N^2 / 2 pair
// scores (5.4e8 at N = 32,768) of about 80 f32 and int operations each,
// against 2.6 MB of input and output; and the recurrence is sequential
// in i, so one block would use one SM of 132, and N anchors no longer fit
// its shared memory (640 KB at N = 32,768).
//
// Design: one persistent cooperative kernel (cudaLaunchCooperativeKernel,
// at most kBlocksPerSM resident blocks an SM), rows in tiles of kTile
// (chain_tile.cuh), anchors and S in device memory, served from L2.  Per
// tile [i0, i0 + kTile), between grid barriers:
//   * scan: every j < i0 holds its final S.  The card's warps share the
//     items (problem, chunk of kChunk candidates, row): lanes stride over
//     the chunk, three redux.sync reduce the warp, one partial best
//     (test, S[j], j) per (row, chunk) goes to device memory.
//   * finish: one block per problem reduces each row's partials over the
//     chunks (one warp per row), computes the S-free records of the
//     in-tile pairs with all its threads, and one warp walks the tile
//     (chain_tile.cuh).  better() is a total order, so splitting the
//     reduction changes no result.
// S and the partial bests change during the launch: they are read with
// __ldcg (L2), never through the read-only path.

#include <cooperative_groups.h>

#include "chain_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 256;      // candidates per scan item
// tile rows, block threads and resident blocks an SM: chosen by
// measurement on an H100 among 32 / 64 rows, 256 / 512 / 1024 threads and
// 1 / 2 / 4 blocks (a tile costs two grid barriers, so the larger tile
// wins here)
constexpr int kTile = 64;
constexpr int kTilePairs = tile_pairs(kTile);
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSM = 1;

template <int V>
__global__ void __launch_bounds__(kThreads)
chain_warm_kernel(const int4* __restrict__ anchors,
                  const int* __restrict__ n_valid,
                  const int* __restrict__ n_warm,
                  const float* __restrict__ skip_i,
                  const int* __restrict__ maxdiff_i,
                  const float* __restrict__ warm_S,
                  const int* __restrict__ warm_P, float* S, int* P,
                  Best* partial, int B, int N, int row_lo, int row_hi,
                  int n_chunk_max, float kcoef, int maxgap, float skipcost) {
  __shared__ __align__(16) Terms rec[kTilePairs];
  __shared__ int4 sA[kTile];
  __shared__ float sS[kTile];
  __shared__ int sP[kTile];
  __shared__ float sSkip[kTile];
  __shared__ int sMd[kTile];
  __shared__ Best sPart[kTile];
  __shared__ float lut[kLog2Lut];
  const ChainParams prm{kcoef, maxgap, skipcost, lut};

  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gwarp = blockIdx.x * kWarps + warp;
  const int n_gwarps = gridDim.x * kWarps;
  fill_log2_lut(lut, tid, kThreads);

  // S = warm_S everywhere; P = warm_P on the frozen rows, -1 elsewhere
  const size_t total = (size_t)B * N;
  for (size_t idx = (size_t)blockIdx.x * kThreads + tid; idx < total;
       idx += (size_t)gridDim.x * kThreads) {
    const int b = (int)(idx / N);
    const int i = (int)(idx % N);
    S[idx] = warm_S[idx];
    P[idx] = i < n_warm[b] ? warm_P[idx] : -1;
  }
  grid.sync();

  for (int i0 = row_lo; i0 < row_hi; i0 += kTile) {
    const int n_chunks = (i0 + kChunk - 1) / kChunk;
    // scan: items (problem, chunk, row), the row fastest
    const int items = B * n_chunks * kTile;
    for (int item = gwarp; item < items; item += n_gwarps) {
      const int r = item % kTile;
      const int c = (item / kTile) % n_chunks;
      const int b = item / (kTile * n_chunks);
      const size_t row = (size_t)b * N;
      const int nv = clampi(n_valid[b], 0, N);
      const int nw = clampi(n_warm[b], 0, N);
      const int i = i0 + r;
      if (i < nw || i >= nv) continue;  // the finish reads no partial of it
      const int4 ai = anchors[row + i];
      const int bar_i = barrier_of<V>(ai);
      const float skip = skip_i[row + i];
      const int md = maxdiff_i[row + i];
      const int lim = i0 < nv ? i0 : nv;
      const int j_hi = (c + 1) * kChunk < lim ? (c + 1) * kChunk : lim;
      Best best = no_best();
      for (int j = c * kChunk + lane; j < j_hi; j += 32) {
        const int4 aj = anchors[row + j];
        if (!(barrier_of<V>(aj) < bar_i)) continue;
        const float Sj = __ldcg(S + row + j);
        const Terms t = pair_terms<V>(ai, aj, skip, md, prm);
        take(best, apply_terms(Sj, t, skip), Sj, j);
      }
      best = warp_best(best);
      if (lane == 0)
        partial[((size_t)b * kTile + r) * n_chunk_max + c] = best;
    }
    if (n_chunks > 0) grid.sync();

    // finish: one block per problem
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
      const size_t row = (size_t)b * N;
      const int nv = clampi(n_valid[b], 0, N);
      const int nw = clampi(n_warm[b], 0, N);
      const int r_lo = clampi(nw - i0, 0, kTile);
      const int r_hi = clampi(nv - i0, 0, kTile);
      if (r_lo >= r_hi) continue;  // uniform over the block
      if (tid < r_hi) {
        sA[tid] = anchors[row + i0 + tid];
        sS[tid] = __ldcg(S + row + i0 + tid);
        sSkip[tid] = skip_i[row + i0 + tid];
        sMd[tid] = maxdiff_i[row + i0 + tid];
      }
      for (int r = r_lo + warp; r < r_hi; r += kWarps) {
        Best best = no_best();
        const Best* p = partial + ((size_t)b * kTile + r) * n_chunk_max;
        for (int c = lane; c < n_chunks; c += 32)
          take(best, __ldcg(&p[c].t), __ldcg(&p[c].s), __ldcg(&p[c].j));
        best = warp_best(best);
        if (lane == 0) sPart[r] = best;
      }
      __syncthreads();
      tile_records<V>(rec, sA, sSkip, sMd, r_lo, r_hi, prm, tid, kThreads);
      __syncthreads();
      if (warp == 0) {
        tile_walk<V, kTile, false>(rec, sA, sSkip, sMd, sPart, sS, sP, i0,
                                   r_lo, r_hi, lane, prm, nullptr, nullptr,
                                   nullptr, nullptr, nullptr);
        for (int r = r_lo + lane; r < r_hi; r += 32) {
          S[row + i0 + r] = sS[r];
          P[row + i0 + r] = sP[r];
        }
      }
      __syncthreads();
    }
    grid.sync();
  }
}

template <int V>
cudaError_t launch_tiles(const void* anchors, const void* n_valid,
                         const void* n_warm, const void* skip_i,
                         const void* maxdiff_i, const void* warm_S,
                         const void* warm_P, void* S, void* P, void* partial,
                         int B, int N, int row_lo, int row_hi, float kcoef,
                         int maxgap, float skipcost, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, chain_warm_kernel<V>, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  // every block must be resident for the grid barrier
  const int blocks = sms * (per_sm < kBlocksPerSM ? per_sm : kBlocksPerSM);
  int n_chunk_max = (N + kChunk - 1) / kChunk;
  void* args[] = {&anchors, &n_valid, &n_warm,      &skip_i,  &maxdiff_i,
                  &warm_S,  &warm_P,  &S,           &P,       &partial,
                  &B,       &N,       &row_lo,      &row_hi,  &n_chunk_max,
                  &kcoef,   &maxgap,  &skipcost};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&chain_warm_kernel<V>), dim3(blocks),
      dim3(kThreads), args, 0, stream);
}

}  // namespace

// Bytes of scratch (the per-row, per-chunk partial bests) that
// chain_dp_warm_launch needs for a (B, N) problem.
extern "C" long long chain_dp_warm_scratch_bytes(int B, int N) {
  const long long n_chunk_max = (N + kChunk - 1) / kChunk;
  return (long long)B * kTile * n_chunk_max * (long long)sizeof(Best);
}

// anchors (B, N, 4) int32, n_valid and n_warm (B,) int32, skip_i (B, N)
// f32, maxdiff_i (B, N) int32, warm_S (B, N) f32, warm_P (B, N) int32 ->
// S (B, N) f32, P (B, N) int32.  scratch: chain_dp_warm_scratch_bytes.
// Rows [row_lo, row_hi) are scored: row_lo <= every n_warm, row_hi >=
// every n_valid.  variant: 0 global, 1 global_nocov, 2 refund (scored
// without the ledger, as the reference's warm scan does), 3 fine,
// 4 mismatch.  Returns a cudaError_t (0 = the launch was accepted).
extern "C" int chain_dp_warm_launch(const void* anchors, const void* n_valid,
                                    const void* n_warm, const void* skip_i,
                                    const void* maxdiff_i, const void* warm_S,
                                    const void* warm_P, void* S, void* P,
                                    void* scratch, int B, int N, int row_lo,
                                    int row_hi, int variant, float kcoef,
                                    int maxgap, float skipcost,
                                    void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  if (row_lo < 0 || row_hi > N) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VACMAP_LAUNCH(V)                                                    \
  return (int)launch_tiles<V>(anchors, n_valid, n_warm, skip_i, maxdiff_i, \
                              warm_S, warm_P, S, P, scratch, B, N, row_lo, \
                              row_hi, kcoef, maxgap, skipcost, s)
  switch (variant) {
    case kGlobal: VACMAP_LAUNCH(kGlobal);
    case kGlobalNocov: VACMAP_LAUNCH(kGlobalNocov);
    case kRefund: VACMAP_LAUNCH(kRefund);
    case kFine: VACMAP_LAUNCH(kFine);
    case kMismatch: VACMAP_LAUNCH(kMismatch);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VACMAP_LAUNCH
}
