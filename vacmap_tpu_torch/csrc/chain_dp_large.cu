// Warm-start (frontier-carry) chaining DP for large N: tiled over rows,
// many blocks per problem.
//
// Replaces vacmap_tpu/ops/chain_jax.py::chain_scores_batch_warm (an XLA
// lax.scan over anchor index i), the device chain of the asm streaming
// path: B = 1, one call per 100 kb block of contig.  A block of unique
// sequence at assembly-like divergence has a few hundred anchors (its
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
// in i, so one block (chain_dp.cu's design) would use one SM of 132, and
// N anchors no longer fit its shared memory (640 KB at N = 32,768).
// Design: rows go in tiles of kTile.  For a tile [i0, i0 + kTile) every
// j < i0 already holds its final S, so kernel "scan" spreads those
// candidates over the card: one block per chunk of kChunk candidates
// (held in shared memory) and group of rows, one warp per row, lanes
// striding over the chunk, a shuffle reduction, and one partial best
// (test, S[j], j) per (row, chunk) in device memory.  Kernel "finish",
// one block per problem, first reduces each row's partials over the
// chunks (one warp per row), then one warp walks the tile's rows in
// order, adding the candidates inside the tile, whose S it keeps in
// shared memory.  better() is a total order, so splitting the reduction
// changes no result.  Anchors and S live in device memory and are served
// from L2 (20 B an anchor).  The cost: 2 * N / kTile launches per call
// and a serial walk of N rows by one warp, which is what the time is.

#include "chain_pair.cuh"

namespace {

constexpr int kTile = 64;           // rows finished per tile
constexpr int kChunk = 256;         // candidates per scan block
constexpr int kRowsPerBlock = 16;   // rows per scan block
constexpr int kScanThreads = 128;   // 4 warps, 4 rows each
constexpr int kFinishThreads = 256;
static_assert(kTile % kRowsPerBlock == 0, "row groups tile the tile");

struct Best {
  float t;
  float s;
  int j;
};

__device__ __forceinline__ Best no_best() {
  return Best{-INFINITY, -INFINITY, -1};
}

__device__ __forceinline__ void take(Best& b, float t, float s, int j) {
  if (better(t, s, j, b.t, b.s, b.j)) {
    b.t = t;
    b.s = s;
    b.j = j;
  }
}

// the warp's best, valid in lane 0
__device__ __forceinline__ Best warp_best(Best b) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ot = __shfl_down_sync(0xffffffffu, b.t, off);
    const float os = __shfl_down_sync(0xffffffffu, b.s, off);
    const int oj = __shfl_down_sync(0xffffffffu, b.j, off);
    take(b, ot, os, oj);
  }
  return b;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// S = warm_S everywhere; P = warm_P on the frozen rows, -1 elsewhere
__global__ void warm_init_kernel(const float* __restrict__ warm_S,
                                 const int* __restrict__ warm_P,
                                 const int* __restrict__ n_warm,
                                 float* __restrict__ S, int* __restrict__ P,
                                 int N, size_t total) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int b = (int)(idx / N);
  const int i = (int)(idx % N);
  S[idx] = warm_S[idx];
  P[idx] = i < n_warm[b] ? warm_P[idx] : -1;
}

// One candidate of row i (barrier bar_i) folded into best.
template <int V>
__device__ __forceinline__ void fold(Best& best, int4 ai, int bar_i,
                                     float skip, int md, int4 aj, float Sj,
                                     int j, float kcoef, int maxgap,
                                     float skipcost) {
  constexpr bool local = (V == kFine || V == kMismatch);
  const int bar_j = aj.x + (local ? aj.w : 0);
  if (!(bar_j < bar_i)) return;
  const Pair p = pair_score<V>(ai, aj, Sj, skip, md, kcoef, maxgap, skipcost);
  take(best, p.test, Sj, j);
}

// grid (chunks of candidates below i0, row groups of the tile, B)
template <int V>
__global__ void __launch_bounds__(kScanThreads)
chain_tile_scan_kernel(const int4* __restrict__ anchors,
                       const int* __restrict__ n_valid,
                       const int* __restrict__ n_warm,
                       const float* __restrict__ skip_i,
                       const int* __restrict__ maxdiff_i,
                       const float* __restrict__ S, Best* __restrict__ partial,
                       int N, int i0, int n_chunk_max, float kcoef,
                       int maxgap, float skipcost) {
  __shared__ int4 sA[kChunk];
  __shared__ float sS[kChunk];
  constexpr bool local = (V == kFine || V == kMismatch);
  const int b = blockIdx.z;
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row = (size_t)b * N;
  const int nv = clampi(n_valid[b], 0, N);
  const int nw = clampi(n_warm[b], 0, N);
  const int j_lo = c * kChunk;
  const int lim = i0 < nv ? i0 : nv;
  const int j_hi = j_lo + kChunk < lim ? j_lo + kChunk : lim;
  const int cnt = j_hi > j_lo ? j_hi - j_lo : 0;
  for (int j = tid; j < cnt; j += kScanThreads) {
    sA[j] = anchors[row + j_lo + j];
    sS[j] = S[row + j_lo + j];
  }
  __syncthreads();
  for (int r = warp; r < kRowsPerBlock; r += kScanThreads / 32) {
    const int rt = blockIdx.y * kRowsPerBlock + r;  // row within the tile
    const int i = i0 + rt;
    Best best = no_best();
    if (i >= nw && i < nv) {  // uniform over the warp
      const int4 ai = anchors[row + i];
      const int bar_i = ai.x + (local ? ai.w : 0);
      const float skip = skip_i[row + i];
      const int md = maxdiff_i[row + i];
      for (int j = lane; j < cnt; j += 32)
        fold<V>(best, ai, bar_i, skip, md, sA[j], sS[j], j_lo + j, kcoef,
                maxgap, skipcost);
      best = warp_best(best);
    }
    if (lane == 0)
      partial[((size_t)b * kTile + rt) * n_chunk_max + c] = best;
  }
}

// grid (B): finishes rows [i0, i0 + kTile) in order
template <int V>
__global__ void __launch_bounds__(kFinishThreads)
chain_tile_finish_kernel(const int4* __restrict__ anchors,
                         const int* __restrict__ n_valid,
                         const int* __restrict__ n_warm,
                         const float* __restrict__ skip_i,
                         const int* __restrict__ maxdiff_i,
                         const Best* __restrict__ partial, float* S, int* P,
                         int N, int i0, int n_chunks, int n_chunk_max,
                         float kcoef, int maxgap, float skipcost) {
  __shared__ int4 sA[kTile];
  __shared__ float sS[kTile];
  __shared__ Best sBest[kTile];
  constexpr bool local = (V == kFine || V == kMismatch);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row = (size_t)b * N;
  const int nv = clampi(n_valid[b], 0, N);
  const int nw = clampi(n_warm[b], 0, N);
  for (int r = tid; r < kTile; r += kFinishThreads) {
    const int i = i0 + r;
    sA[r] = i < N ? anchors[row + i] : make_int4(0, 0, 0, 0);
    sS[r] = i < N ? S[row + i] : 0.0f;
  }
  for (int r = warp; r < kTile; r += kFinishThreads / 32) {
    Best best = no_best();
    const Best* p = partial + ((size_t)b * kTile + r) * n_chunk_max;
    for (int c = lane; c < n_chunks; c += 32) take(best, p[c].t, p[c].s, p[c].j);
    best = warp_best(best);
    if (lane == 0) sBest[r] = best;
  }
  __syncthreads();
  if (warp != 0) return;
  for (int r = 0; r < kTile; ++r) {
    const int i = i0 + r;
    if (i >= nv) break;
    if (i < nw) continue;
    const int4 ai = sA[r];
    const int bar_i = ai.x + (local ? ai.w : 0);
    const float skip = skip_i[row + i];
    const int md = maxdiff_i[row + i];
    Best best = lane == 0 ? sBest[r] : no_best();
    for (int jr = lane; jr < r; jr += 32)
      fold<V>(best, ai, bar_i, skip, md, sA[jr], sS[jr], i0 + jr, kcoef,
              maxgap, skipcost);
    best = warp_best(best);
    if (lane == 0) {
      const float l_i = (float)ai.w;
      const bool has_pred = best.t > l_i;
      const float S_i = has_pred ? best.t : l_i;
      sS[r] = S_i;
      S[row + i] = S_i;
      P[row + i] = has_pred ? best.j : -1;
    }
    __syncwarp();
  }
}

template <int V>
cudaError_t launch_tiles(const void* anchors, const void* n_valid,
                         const void* n_warm, const void* skip_i,
                         const void* maxdiff_i, void* S, void* P,
                         void* partial, int B, int N, int row_lo, int row_hi,
                         float kcoef, int maxgap, float skipcost,
                         cudaStream_t stream) {
  const int n_chunk_max = (N + kChunk - 1) / kChunk;
  for (int i0 = row_lo; i0 < row_hi; i0 += kTile) {
    const int n_chunks = (i0 + kChunk - 1) / kChunk;
    if (n_chunks > 0) {
      chain_tile_scan_kernel<V>
          <<<dim3(n_chunks, kTile / kRowsPerBlock, B), kScanThreads, 0,
             stream>>>(
              static_cast<const int4*>(anchors),
              static_cast<const int*>(n_valid),
              static_cast<const int*>(n_warm),
              static_cast<const float*>(skip_i),
              static_cast<const int*>(maxdiff_i),
              static_cast<const float*>(S), static_cast<Best*>(partial), N,
              i0, n_chunk_max, kcoef, maxgap, skipcost);
    }
    chain_tile_finish_kernel<V><<<B, kFinishThreads, 0, stream>>>(
        static_cast<const int4*>(anchors), static_cast<const int*>(n_valid),
        static_cast<const int*>(n_warm), static_cast<const float*>(skip_i),
        static_cast<const int*>(maxdiff_i),
        static_cast<const Best*>(partial), static_cast<float*>(S),
        static_cast<int*>(P), N, i0, n_chunks, n_chunk_max, kcoef, maxgap,
        skipcost);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
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
// 4 mismatch.  Returns a cudaError_t (0 = every launch accepted).
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
  const size_t total = (size_t)B * N;
  warm_init_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(warm_S), static_cast<const int*>(warm_P),
      static_cast<const int*>(n_warm), static_cast<float*>(S),
      static_cast<int*>(P), N, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
#define VACMAP_LAUNCH(V)                                                     \
  return (int)launch_tiles<V>(anchors, n_valid, n_warm, skip_i, maxdiff_i,  \
                              S, P, scratch, B, N, row_lo, row_hi, kcoef,   \
                              maxgap, skipcost, s)
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
