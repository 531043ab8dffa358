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
// Row order.  The tile cut needs the rows in [n_warm, n_valid) sorted by
// barrier, so that a candidate of row i has j < i (frozen rows are in no
// order, the frontier is sorted by score, but they all lie below
// n_warm <= i).  Every caller's rows are; the reference does not ask it.
// While the kernel copies warm_S into S, it checks each problem's order
// and flags the problems that are not sorted.  Those take no part in the
// tiles: after the tile loop one block takes each of them row by row over
// every candidate j < n_valid (rows_any_order: frozen rows as candidates,
// S of rows not yet reached still at warm_S), which is the reference's
// scan.  The rows to score, [min n_warm, max n_valid), are read from
// device memory too, so the wrapper launches without a read-back.
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

#include <atomic>

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
constexpr int kVariants = 5;
constexpr int kMaxDevices = 64;

// A problem not sorted by barrier past its frozen rows, row by row over
// every candidate, as the reference's scan.  One block; two block
// barriers per row.  S holds warm_S on every row not yet scored.
template <int V>
__device__ void rows_any_order(const int4* __restrict__ A, float* S, int* P,
                               const float* __restrict__ skip_i,
                               const int* __restrict__ maxdiff_i, int nw,
                               int nv, const ChainParams& prm) {
  __shared__ Best red[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = nw; i < nv; ++i) {
    const int4 ai = A[i];
    const int bar_i = barrier_of<V>(ai);
    const float skip = skip_i[i];
    const int md = maxdiff_i[i];
    Best best = no_best();
    for (int j = tid; j < nv; j += kThreads) {
      const int4 aj = A[j];
      if (!(barrier_of<V>(aj) < bar_i)) continue;
      const float Sj = __ldcg(S + j);
      const Terms t = pair_terms<V>(ai, aj, skip, md, prm);
      take(best, apply_terms(Sj, t, skip), Sj, j);
    }
    best = warp_best(best);
    if (lane == 0) red[warp] = best;
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < kWarps; ++w) take(best, red[w].t, red[w].s, red[w].j);
      const float l_i = (float)ai.w;
      const bool has_pred = best.t > l_i;
      S[i] = has_pred ? best.t : l_i;
      P[i] = has_pred ? best.j : -1;
    }
    __syncthreads();
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
chain_warm_kernel(const int4* __restrict__ anchors,
                  const int* __restrict__ n_valid,
                  const int* __restrict__ n_warm,
                  const float* __restrict__ skip_i,
                  const int* __restrict__ maxdiff_i,
                  const float* __restrict__ warm_S,
                  const int* __restrict__ warm_P, float* S, int* P,
                  int* unsorted, Best* partial, int B, int N, int n_chunk_max,
                  float kcoef, int maxgap, float skipcost) {
  __shared__ __align__(16) Terms rec[kTilePairs];
  __shared__ int4 sA[kTile];
  __shared__ float sS[kTile];
  __shared__ int sP[kTile];
  __shared__ float sSkip[kTile];
  __shared__ int sMd[kTile];
  __shared__ Best sPart[kTile];
  __shared__ float lut[kLog2Lut];
  __shared__ int sRows[2];
  const ChainParams prm{kcoef, maxgap, skipcost, lut};

  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gwarp = blockIdx.x * kWarps + warp;
  const int n_gwarps = gridDim.x * kWarps;
  fill_log2_lut(lut, tid, kThreads);

  // the rows to score, [min n_warm, max n_valid), the same in every block
  if (tid == 0) {
    sRows[0] = N;
    sRows[1] = 0;
  }
  __syncthreads();
  for (int b = tid; b < B; b += kThreads) {
    atomicMin(&sRows[0], clampi(n_warm[b], 0, N));
    atomicMax(&sRows[1], clampi(n_valid[b], 0, N));
  }
  // S = warm_S everywhere; P = warm_P on the frozen rows, -1 elsewhere;
  // and each problem's barrier order over [n_warm, n_valid) (unsorted is
  // zeroed before the launch; every writer stores the same 1)
  const size_t total = (size_t)B * N;
  for (size_t idx = (size_t)blockIdx.x * kThreads + tid; idx < total;
       idx += (size_t)gridDim.x * kThreads) {
    const int b = (int)(idx / N);
    const int i = (int)(idx % N);
    const int nw = clampi(n_warm[b], 0, N);
    S[idx] = warm_S[idx];
    P[idx] = i < nw ? warm_P[idx] : -1;
    if (i > nw && i < n_valid[b] &&
        barrier_of<V>(anchors[idx]) < barrier_of<V>(anchors[idx - 1]))
      unsorted[b] = 1;
  }
  grid.sync();
  const int row_lo = sRows[0];
  const int row_hi = sRows[1];

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
      // the finish reads no partial of it
      if (i < nw || i >= nv || __ldcg(unsorted + b)) continue;
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
      // uniform over the block
      if (r_lo >= r_hi || __ldcg(unsorted + b)) continue;
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

  // the problems that are not sorted, one block each; no grid barrier
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    if (!__ldcg(unsorted + b)) continue;  // uniform over the block
    const size_t row = (size_t)b * N;
    rows_any_order<V>(anchors + row, S + row, P + row, skip_i + row,
                      maxdiff_i + row, clampi(n_warm[b], 0, N),
                      clampi(n_valid[b], 0, N), prm);
  }
}

// Resident blocks of the cooperative grid per (device, variant), asked
// of the runtime once (the query also loads the kernel's module); 0 =
// not yet asked.
std::atomic<int> g_blocks[kMaxDevices][kVariants];

template <int V>
cudaError_t grid_blocks(int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices) {
    *blocks = g_blocks[dev][V].load(std::memory_order_relaxed);
    if (*blocks > 0) return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, chain_warm_kernel<V>, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  // every block must be resident for the grid barrier
  *blocks = sms * (per_sm < kBlocksPerSM ? per_sm : kBlocksPerSM);
  if (dev < kMaxDevices)
    g_blocks[dev][V].store(*blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

// the unsorted flags (B ints, 16-byte aligned), then the partial bests
size_t flag_bytes(int B) { return ((size_t)B * sizeof(int) + 15) / 16 * 16; }

template <int V>
cudaError_t launch_tiles(const void* anchors, const void* n_valid,
                         const void* n_warm, const void* skip_i,
                         const void* maxdiff_i, const void* warm_S,
                         const void* warm_P, void* S, void* P, void* scratch,
                         int B, int N, float kcoef, int maxgap,
                         float skipcost, cudaStream_t stream) {
  int blocks = 0;
  cudaError_t err = grid_blocks<V>(&blocks);
  if (err != cudaSuccess) return err;
  void* unsorted = scratch;
  void* partial = static_cast<char*>(scratch) + flag_bytes(B);
  err = cudaMemsetAsync(unsorted, 0, (size_t)B * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  int n_chunk_max = (N + kChunk - 1) / kChunk;
  void* args[] = {&anchors, &n_valid, &n_warm,   &skip_i,      &maxdiff_i,
                  &warm_S,  &warm_P,  &S,        &P,           &unsorted,
                  &partial, &B,       &N,        &n_chunk_max, &kcoef,
                  &maxgap,  &skipcost};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&chain_warm_kernel<V>), dim3(blocks),
      dim3(kThreads), args, 0, stream);
}

}  // namespace

// Bytes of scratch (the unsorted flags and the per-row, per-chunk
// partial bests) that chain_dp_warm_launch needs for a (B, N) problem.
extern "C" long long chain_dp_warm_scratch_bytes(int B, int N) {
  const long long n_chunk_max = (N + kChunk - 1) / kChunk;
  return (long long)flag_bytes(B) +
         (long long)B * kTile * n_chunk_max * (long long)sizeof(Best);
}

#define VACMAP_VARIANTS(X)                                            \
  switch (variant) {                                                  \
    case kGlobal: X(kGlobal);                                         \
    case kGlobalNocov: X(kGlobalNocov);                               \
    case kRefund: X(kRefund);                                         \
    case kFine: X(kFine);                                             \
    case kMismatch: X(kMismatch);                                     \
    default: return (int)cudaErrorInvalidValue;                       \
  }

// The current device's grid size for a variant, asked of the runtime now
// rather than at the first launch.  Returns a cudaError_t.
extern "C" int chain_dp_warm_prepare(int variant) {
  int blocks = 0;
#define VACMAP_PREPARE(V) return (int)grid_blocks<V>(&blocks)
  VACMAP_VARIANTS(VACMAP_PREPARE)
#undef VACMAP_PREPARE
}

// anchors (B, N, 4) int32, n_valid and n_warm (B,) int32, skip_i (B, N)
// f32, maxdiff_i (B, N) int32, warm_S (B, N) f32, warm_P (B, N) int32 ->
// S (B, N) f32, P (B, N) int32.  scratch: chain_dp_warm_scratch_bytes.
// Rows in any order.  variant: 0 global, 1 global_nocov, 2 refund (scored
// without the ledger, as the reference's warm scan does), 3 fine,
// 4 mismatch.  Returns a cudaError_t (0 = the launch was accepted).
extern "C" int chain_dp_warm_launch(const void* anchors, const void* n_valid,
                                    const void* n_warm, const void* skip_i,
                                    const void* maxdiff_i, const void* warm_S,
                                    const void* warm_P, void* S, void* P,
                                    void* scratch, int B, int N, int variant,
                                    float kcoef, int maxgap, float skipcost,
                                    void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VACMAP_LAUNCH(V)                                                    \
  return (int)launch_tiles<V>(anchors, n_valid, n_warm, skip_i, maxdiff_i, \
                              warm_S, warm_P, S, P, scratch, B, N, kcoef,  \
                              maxgap, skipcost, s)
  VACMAP_VARIANTS(VACMAP_LAUNCH)
#undef VACMAP_LAUNCH
}
#undef VACMAP_VARIANTS
