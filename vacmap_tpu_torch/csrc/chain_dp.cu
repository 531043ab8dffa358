// Batched non-linear chaining DP: one thread block cluster per read.
//
// Replaces vacmap_tpu/ops/chain_jax.py::chain_scores_batch (an XLA
// lax.scan over anchor index i; the Pallas chain kernels were deleted).
// S[i] = max(len_i, max_j test(i, j)) over the valid anchors j of an
// earlier barrier group, P[i] = the winning j under the (test, S[j], j)
// lexicographic maximum; S = 0, P = -1 for i >= n_valid.
//
// What bounds it on an H100: operations, and before them latency.  One
// read is N^2 / 2 pair evaluations (about 80 f32 and int operations; the
// logs come from a table almost always, chain_pair.cuh) against 28 bytes
// an anchor, and the recurrence is sequential in i: a row can chain to
// the row before it, so one warp's walk (about 0.2 us a row, measured) is
// the floor of a read's time.  A row-at-a-time kernel pays a block-wide
// reduction per row and uses one SM a read; the executor's local launches
// have 8 to 16 reads.
//
// Design.  Anchors (16 B) and the running S (4 B) of the whole read stay
// in shared memory, 160 KB at N = 8192 (opt-in dynamic shared memory; with
// the tile's records and partial bests about 172 KB of the 227 KB a block
// may use).  Rows are finished in tiles of kTile (chain_tile.cuh):
//   * scan: for a tile [i0, i0 + kTile) every j < i0 holds its final S.
//     Each warp takes rows of the tile, its lanes stride over j, and the
//     warp reduces its own row with three redux.sync: no block barrier per
//     row.  On a sorted read no j >= i is visited.
//   * a launch spreads one read over a thread block cluster of 1, 2, 4 or
//     8 CTAs (the launch function picks the largest with B x C <= 132
//     SMs).  Every CTA keeps the whole read in its own shared memory and
//     scans an interleaved 1/C of the candidates; it writes one partial
//     best per row into CTA 0's shared memory (distributed shared memory).
//   * walk: the CTAs share the S-free records of the in-tile pairs and
//     write them into CTA 0, where one warp walks the tile
//     (chain_tile.cuh) and pushes the finished S into every CTA's copy.
//     Two cluster barriers per tile.
// The tile's skip_i / maxdiff_i are loaded once per tile.  The refund
// ledgers (variant "refund") live in device memory, the tile's own in
// shared memory.
//
// Sortedness is a precondition of the tile cut that the reference does
// not have (its scan lets an unsorted j > i count with S = 0).  Every CTA
// checks its read's barrier order while it loads the anchors; a read that
// is not sorted takes the row-at-a-time loop on CTA 0 (rows_any_order:
// every candidate, one block reduction per row), which gives the
// reference's result.  No read-back, no error: the check costs one pass
// over shared memory.
//
// The pair scoring, and the f32 rules that keep P in agreement with the
// reference, are in chain_pair.cuh.

#include <cooperative_groups.h>

#include <mutex>

#include "chain_tile.cuh"

namespace cg = cooperative_groups;

namespace {

// tile rows and block threads: chosen by measurement on an H100 among
// 32 / 64 / 128 rows and 256 / 512 / 1024 threads (one row a warp at 32
// rows and 1024 threads; 64 registers a thread, no spills)
constexpr int kTile = 32;
constexpr int kTilePairs = tile_pairs(kTile);
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;  // the portable cluster size limit
constexpr int kSMs = 132;       // H100 SXM; only steers the cluster size

// The shared-memory limit is an attribute of the kernel, not of a launch:
// a thread that lowers it between another thread's setting and that
// thread's launch makes the launch fail (cudaErrorLaunchOutOfResources,
// from the occupancy query).  Threads that chain at once (the local chain
// DP's concurrent dispatches) take this lock from the setting to the launch.
std::mutex g_launch_mutex;

// dynamic shared memory: anchors, records, S, partial bests, tile rows
__host__ __device__ constexpr size_t smem_bytes(int N) {
  return (size_t)N * (sizeof(int4) + sizeof(float)) +
         kTilePairs * sizeof(Terms) + kMaxCluster * kTile * sizeof(Best) +
         kTile * (2 * sizeof(float) + 2 * sizeof(int) + sizeof(float)) +
         kLog2Lut * sizeof(float);
}

// The read in any order: row by row over every candidate, as the
// reference's scan.  One block; two block barriers per row.
template <int V>
__device__ void rows_any_order(const int4* A, float* S,
                               const float* __restrict__ skip_i,
                               const int* __restrict__ maxdiff_i,
                               float* __restrict__ S_out,
                               int* __restrict__ P_out, float* fixed_pen,
                               float* pre_pen, int nv,
                               const ChainParams& prm) {
  __shared__ Best red[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int j = tid; j < nv; j += kThreads) S[j] = 0.0f;
  __syncthreads();
  for (int i = 0; i < nv; ++i) {
    const int4 ai = A[i];
    const int bar_i = barrier_of<V>(ai);
    const float skip = skip_i[i];
    const int md = maxdiff_i[i];
    Best best = no_best();
    for (int j = tid; j < nv; j += kThreads) {
      const int4 aj = A[j];
      if (!(barrier_of<V>(aj) < bar_i)) continue;
      const float Sj = S[j];
      const Terms t = pair_terms<V>(ai, aj, skip, md, prm);
      float v = apply_terms(Sj, t, skip);
      if (V == kRefund) {
        const float fp = fixed_pen[j];
        if ((t.flags & kColinear) && fp < 0.0f && fp + t.bonus >= 0.0f)
          v = v + pre_pen[j];
      }
      take(best, v, Sj, j);
    }
    best = warp_best(best);
    if (lane == 0) red[warp] = best;
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < kWarps; ++w) take(best, red[w].t, red[w].s, red[w].j);
      const float l_i = (float)ai.w;
      const bool has_pred = best.t > l_i;
      const float S_i = has_pred ? best.t : l_i;
      S[i] = S_i;
      S_out[i] = S_i;
      P_out[i] = has_pred ? best.j : -1;
      if (V == kRefund) {
        // ledger of the winning predecessor (P = -1 reads index 0, as the
        // reference's clip does; the result is then discarded)
        const int pw = has_pred ? best.j : 0;
        const Terms w = pair_terms<V>(ai, A[pw], skip, md, prm);
        const float fpj = fixed_pen[pw];
        const float ppj = pre_pen[pw];
        const bool col = (w.flags & kColinear) != 0u;
        const bool cont = (fpj < 0.0f) && (fpj + w.bonus < 0.0f);
        const float nfp = col ? (cont ? fpj + w.bonus : 0.0f) : (-skip + w.bonus);
        const float npp = col ? (cont ? ppj : 0.0f) : skip;
        fixed_pen[i] = has_pred ? nfp : 0.0f;
        pre_pen[i] = has_pred ? npp : 0.0f;
      }
    }
    __syncthreads();
  }
}

// grid (B * C), cluster (C): read b = blockIdx.x / C
template <int V>
__global__ void __launch_bounds__(kThreads, 1)
chain_dp_kernel(const int4* __restrict__ anchors,
                const int* __restrict__ n_valid,
                const float* __restrict__ skip_i,
                const int* __restrict__ maxdiff_i, float* __restrict__ S_out,
                int* __restrict__ P_out, float* fixed_pen, float* pre_pen,
                int N, float kcoef, int maxgap, float skipcost) {
  extern __shared__ __align__(16) unsigned char smem[];
  int4* A = reinterpret_cast<int4*>(smem);
  Terms* rec = reinterpret_cast<Terms*>(A + N);
  float* S = reinterpret_cast<float*>(rec + kTilePairs);
  Best* part = reinterpret_cast<Best*>(S + N);
  float* tSkip = reinterpret_cast<float*>(part + kMaxCluster * kTile);
  int* tMd = reinterpret_cast<int*>(tSkip + kTile);
  int* tP = tMd + kTile;
  float* tFp = reinterpret_cast<float*>(tP + kTile);
  float* tPp = tFp + kTile;
  float* lut = tPp + kTile;
  const ChainParams prm{kcoef, maxgap, skipcost, lut};

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row = (size_t)b * N;
  const int nv = clampi(n_valid[b], 0, N);
  skip_i += row;
  maxdiff_i += row;
  S_out += row;
  P_out += row;
  if (V == kRefund) {
    fixed_pen += row;
    pre_pen += row;
  }

  for (int j = tid; j < nv; j += kThreads) A[j] = anchors[row + j];
  fill_log2_lut(lut, tid, kThreads);
  if (rank == 0) {
    for (int j = nv + tid; j < N; j += kThreads) {
      S_out[j] = 0.0f;
      P_out[j] = -1;
    }
  }
  __syncthreads();
  int bad = 0;
  for (int j = 1 + tid; j < nv; j += kThreads)
    bad |= barrier_of<V>(A[j]) < barrier_of<V>(A[j - 1]);
  if (__syncthreads_or(bad)) {
    // every CTA of the cluster sees the same anchors and decides alike
    if (rank == 0)
      rows_any_order<V>(A, S, skip_i, maxdiff_i, S_out, P_out, fixed_pen,
                        pre_pen, nv, prm);
    return;
  }

  // every CTA of the cluster runs before its shared memory is written
  cluster.sync();
  Best* part0 = cluster.map_shared_rank(part, 0);
  Terms* rec0 = cluster.map_shared_rank(rec, 0);
  for (int i0 = 0; i0 < nv; i0 += kTile) {
    const int r_hi = nv - i0 < kTile ? nv - i0 : kTile;
    if (tid < r_hi) {
      tSkip[tid] = skip_i[i0 + tid];
      tMd[tid] = maxdiff_i[i0 + tid];
    }
    __syncthreads();
    // scan: this CTA's share of the candidates below the tile
    for (int r = warp; r < r_hi; r += kWarps) {
      const int4 ai = A[i0 + r];
      const int bar_i = barrier_of<V>(ai);
      const float skip = tSkip[r];
      const int md = tMd[r];
      Best best = no_best();
      for (int j = rank * 32 + lane; j < i0; j += 32 * C) {
        const int4 aj = A[j];
        if (!(barrier_of<V>(aj) < bar_i)) continue;
        const float Sj = S[j];
        const Terms t = pair_terms<V>(ai, aj, skip, md, prm);
        float v = apply_terms(Sj, t, skip);
        if (V == kRefund) {
          // written by CTA 0 on another SM: read past this SM's L1
          const float fp = __ldcg(fixed_pen + j);
          if ((t.flags & kColinear) && fp < 0.0f && fp + t.bonus >= 0.0f)
            v = v + __ldcg(pre_pen + j);
        }
        take(best, v, Sj, j);
      }
      best = warp_best(best);
      if (lane == 0) part0[rank * kTile + r] = best;
    }
    // the in-tile records, every CTA its share, into CTA 0
    tile_records<V>(rec0, A + i0, tSkip, tMd, 0, r_hi, prm,
                    rank * kThreads + tid, C * kThreads);
    cluster.sync();
    if (rank == 0 && warp == 0) {
      // each row's best below the tile, over the CTAs' partial bests
      for (int r = lane; r < r_hi; r += 32) {
        Best best = part[r];
        for (int k = 1; k < C; ++k)
          take(best, part[k * kTile + r].t, part[k * kTile + r].s,
               part[k * kTile + r].j);
        part[r] = best;
      }
      __syncwarp();
      tile_walk<V, kTile, V == kRefund>(rec, A + i0, tSkip, tMd, part, S + i0,
                                        tP, i0, 0, r_hi, lane, prm, A, tFp,
                                        tPp, fixed_pen, pre_pen);
      for (int r = lane; r < r_hi; r += 32) {
        const float S_i = S[i0 + r];
        S_out[i0 + r] = S_i;
        P_out[i0 + r] = tP[r];
        for (int k = 1; k < C; ++k) cluster.map_shared_rank(S, k)[i0 + r] = S_i;
      }
    }
    // the finished S (and, for refund, the ledgers in device memory) reach
    // every CTA; no CTA leaves while its shared memory may be written
    cluster.sync();
  }
}

template <int V>
cudaError_t launch(const void* anchors, const void* n_valid,
                   const void* skip_i, const void* maxdiff_i, void* S,
                   void* P, void* fixed_pen, void* pre_pen, int B, int N,
                   float kcoef, int maxgap, float skipcost, int cluster,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(N);
  std::lock_guard<std::mutex> hold(g_launch_mutex);
  cudaError_t err = cudaFuncSetAttribute(
      chain_dp_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  int C = cluster;
  if (C <= 0) {
    // the largest cluster that keeps B x C within the card's SMs
    C = kMaxCluster;
    while (C > 1 && B * C > kSMs) C >>= 1;
  }
  if (C > kMaxCluster || (C & (C - 1))) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a cluster needs its CTAs resident together: halve it until one fits
  for (;; C >>= 1) {
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3((unsigned)B * C);
    int fits = 0;
    err = cudaOccupancyMaxActiveClusters(&fits, chain_dp_kernel<V>, &cfg);
    if (err == cudaSuccess && fits > 0) break;
    if (C == 1) return err != cudaSuccess ? err : cudaErrorLaunchOutOfResources;
    (void)cudaGetLastError();
  }
  return cudaLaunchKernelEx(
      &cfg, chain_dp_kernel<V>, static_cast<const int4*>(anchors),
      static_cast<const int*>(n_valid), static_cast<const float*>(skip_i),
      static_cast<const int*>(maxdiff_i), static_cast<float*>(S),
      static_cast<int*>(P), static_cast<float*>(fixed_pen),
      static_cast<float*>(pre_pen), N, kcoef, maxgap, skipcost);
}

}  // namespace

// anchors (B, N, 4) int32, n_valid (B,) int32, skip_i (B, N) f32,
// maxdiff_i (B, N) int32 -> S (B, N) f32, P (B, N) int32.  fixed_pen and
// pre_pen are zeroed (B, N) f32 scratch, used by variant 2 (refund) only.
// variant: 0 global, 1 global_nocov, 2 refund, 3 fine, 4 mismatch.
// cluster: CTAs per read (1, 2, 4 or 8), or 0 to let the launch choose
// from B.  Returns a cudaError_t (0 = launched).
extern "C" int chain_dp_launch(const void* anchors, const void* n_valid,
                               const void* skip_i, const void* maxdiff_i,
                               void* S, void* P, void* fixed_pen,
                               void* pre_pen, int B, int N, int variant,
                               float kcoef, int maxgap, float skipcost,
                               int cluster, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VACMAP_LAUNCH(V)                                                    \
  return (int)launch<V>(anchors, n_valid, skip_i, maxdiff_i, S, P,         \
                        fixed_pen, pre_pen, B, N, kcoef, maxgap, skipcost, \
                        cluster, s)
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
