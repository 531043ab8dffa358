// Batched non-linear chaining DP: one thread block per read.
//
// Replaces vacmap_tpu/ops/chain_jax.py::chain_scores_batch (an XLA
// lax.scan over anchor index i; the Pallas chain kernels were deleted).
// S[i] = max(len_i, max_j test(i, j)) over the valid anchors j of an
// earlier barrier group, P[i] = the winning j under the (test, S[j], j)
// lexicographic maximum; S = 0, P = -1 for i >= n_valid.
//
// What bounds it on an H100: the recurrence is sequential in i and each
// step is a reduction over all N candidates, so the work is N^2 pair
// evaluations per read (about 80 f32 and int ops, one or two precise
// logs each) and the latency is one block-wide reduction per i.  The
// design keeps the whole read on chip: the anchors (16 B each) and the
// running S (4 B each) sit in shared memory, 160 KB at N = 8192 (opt-in
// dynamic shared memory, under the 227 KB ceiling), so the N^2 inner
// loop never touches device memory.  Threads stride over j; each keeps
// its own best (test, S, j) and one warp-shuffle plus shared-memory
// reduction per i picks the winner.  The parallelism is across reads
// (grid) and across j (block); a batch of 16 reads uses 16 SMs.  The
// refund ledgers (variant "refund") live in device memory.
//
// f32 rules, so that P agrees with the reference: every formula keeps the
// reference's operation order, logf/log2f are the precise versions, and
// the library is compiled with -fmad=false and without fast math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;  // chain_jax.NEG
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum Variant { kGlobal = 0, kGlobalNocov = 1, kRefund = 2, kFine = 3,
               kMismatch = 4 };

struct Pair {
  float test;
  bool colinear;
  int bonus;
};

// chain_jax._extra_penalty
__device__ __forceinline__ float extra_penalty(int gapcost) {
  const float g = fmaxf((float)gapcost, 1.0f);
  const float gf = (float)gapcost;
  return fminf(36.0f, fminf(30.0f + 0.5f * logf(g),
                            fminf(10.0f, gf / 100.0f) +
                                fminf(30.0f, gf / 1000.0f)));
}

// chain_jax._gapcost_colinear (kcoef = f32(0.01 * kmersize))
__device__ __forceinline__ float gapcost_colinear(int gapcost, float kcoef,
                                                  bool local) {
  if (!(gapcost > 0)) return 0.0f;
  const float g = fmaxf((float)gapcost, 1.0f);
  const float lg = log2f(g);
  const float coef = (local && gapcost > 10) ? 2.0f : 0.5f;
  return kcoef * (float)gapcost + coef * lg;
}

// chain_jax._pair_scores for one (i, j) pair.  Only the branch that
// `where(colinear, col, sv)` keeps is evaluated.
template <int V>
__device__ __forceinline__ Pair pair_score(int4 ai, int4 aj, float Sj,
                                           float skip, int md, float kcoef,
                                           int maxgap, float skipcost) {
  constexpr bool local = (V == kFine || V == kMismatch);
  const int r_i = ai.x, y_i = ai.y, s_i = ai.z, l_i = ai.w;
  const int r_j = aj.x, y_j = aj.y, s_j = aj.z, l_j = aj.w;
  const int raw_readgap = r_i - r_j - l_j;
  const bool neg = raw_readgap < 0;
  const int bonus = neg ? (r_i + l_i - r_j - l_j) : l_i;
  const int overlap = r_j + l_j - r_i;
  const int readgap = raw_readgap > 0 ? raw_readgap : 0;
  const bool same = s_j == s_i;
  const bool plus = s_i == 1;
  const bool j_minus = s_j == -1;
  int refgap;
  if (V == kGlobalNocov) {
    // asm-mode opposite-strand geometry
    const int nov = r_i - r_j;
    if (neg) {
      refgap = same ? (plus ? y_i + overlap - (y_j + l_j) : y_j - (y_i + bonus))
                    : (j_minus ? y_i + l_j - nov - y_j : y_i + l_i - y_j - nov);
    } else {
      refgap = same ? (plus ? y_i - y_j - l_j : y_j - y_i - l_i)
                    : (j_minus ? y_i - y_j : y_i + l_i - y_j - l_j);
    }
  } else {
    if (neg) {
      refgap = same ? (plus ? y_i + overlap - (y_j + l_j) : y_j - (y_i + bonus))
                    : (j_minus ? y_i + overlap - y_j + 1
                               : y_i + bonus - 1 - (y_j + l_j));
    } else {
      refgap = same ? (plus ? y_i - y_j - l_j : y_j - y_i - l_i)
                    : (j_minus ? y_i - y_j + 1 : y_i + l_i - 1 - y_j - l_j);
    }
  }
  const int d = readgap - refgap;
  const int gapcost = d < 0 ? -d : d;
  const bool colinear =
      same && (refgap >= 0) && (readgap <= maxgap) && (gapcost <= md);

  const float bonus_f = (float)bonus;
  float test;
  if (colinear) {
    float col = (Sj + bonus_f) - gapcost_colinear(gapcost, kcoef, local);
    if (V == kFine) {
      const float rg = (float)(readgap < 99 ? readgap : 99);
      col = col - (readgap > 0 ? 0.1f * log2f(rg + 1.0f) : 0.0f);
    } else if (V == kMismatch) {
      const float rgf = (float)readgap;
      const float lrg =
          readgap >= 30 ? 0.5f * rgf : 0.1f * log2f(rgf + 1.0f);
      col = col - (readgap > 0 ? lrg : 0.0f);
    }
    test = col;
  } else {
    if (V == kGlobal || V == kGlobalNocov) {
      test = ((Sj - skip) + bonus_f) - extra_penalty(gapcost);
    } else if (V == kRefund) {
      test = (Sj + bonus_f) - skip;
    } else if (V == kFine) {
      const float pen =
          (same ? skipcost : fminf(50.0f, skipcost)) + extra_penalty(gapcost);
      test = (Sj + bonus_f) - pen;
    } else {  // mismatch
      const float gc = (float)(gapcost < 99999 ? gapcost : 99999);
      test = (Sj + bonus_f) - (skipcost + 0.5f * log2f(gc + 1.0f));
    }
  }
  if (local && neg && bonus <= 0) test = kNeg;
  return Pair{test, colinear, bonus};
}

// (t, s, j) lexicographic "greater than": the reference's argmax with
// ties broken by the larger S[j], then the larger j
__device__ __forceinline__ bool better(float t, float s, int j, float bt,
                                       float bs, int bj) {
  return t > bt || (t == bt && (s > bs || (s == bs && j > bj)));
}

template <int V>
__global__ void __launch_bounds__(kThreads)
chain_dp_kernel(const int4* __restrict__ anchors,
                const int* __restrict__ n_valid,
                const float* __restrict__ skip_i,
                const int* __restrict__ maxdiff_i, float* __restrict__ S_out,
                int* __restrict__ P_out, float* fixed_pen, float* pre_pen,
                int N, float kcoef, int maxgap, float skipcost) {
  extern __shared__ __align__(16) unsigned char smem[];
  int4* A = reinterpret_cast<int4*>(smem);
  float* S = reinterpret_cast<float*>(A + N);
  __shared__ float red_t[kWarps];
  __shared__ float red_s[kWarps];
  __shared__ int red_j[kWarps];

  constexpr bool local = (V == kFine || V == kMismatch);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row = (size_t)b * N;
  int nv = n_valid[b];
  nv = nv < 0 ? 0 : (nv > N ? N : nv);

  for (int j = tid; j < N; j += kThreads) {
    A[j] = anchors[row + j];
    S[j] = 0.0f;
  }
  for (int j = nv + tid; j < N; j += kThreads) {
    S_out[row + j] = 0.0f;
    P_out[row + j] = -1;
  }
  __syncthreads();

  for (int i = 0; i < nv; ++i) {
    const int4 ai = A[i];
    const int bar_i = ai.x + (local ? ai.w : 0);
    const float skip = skip_i[row + i];
    const int md = maxdiff_i[row + i];
    float bt = -INFINITY, bs = -INFINITY;
    int bj = -1;
    for (int j = tid; j < nv; j += kThreads) {
      const int4 aj = A[j];
      const int bar_j = aj.x + (local ? aj.w : 0);
      if (!(bar_j < bar_i)) continue;
      const float Sj = S[j];
      const Pair p = pair_score<V>(ai, aj, Sj, skip, md, kcoef, maxgap,
                                   skipcost);
      float t = p.test;
      if (V == kRefund) {
        const float fp = fixed_pen[row + j];
        if (p.colinear && fp < 0.0f && fp + (float)p.bonus >= 0.0f)
          t = t + pre_pen[row + j];
      }
      if (better(t, Sj, j, bt, bs, bj)) {
        bt = t;
        bs = Sj;
        bj = j;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ot = __shfl_down_sync(0xffffffffu, bt, off);
      const float os = __shfl_down_sync(0xffffffffu, bs, off);
      const int oj = __shfl_down_sync(0xffffffffu, bj, off);
      if (better(ot, os, oj, bt, bs, bj)) {
        bt = ot;
        bs = os;
        bj = oj;
      }
    }
    if (lane == 0) {
      red_t[warp] = bt;
      red_s[warp] = bs;
      red_j[warp] = bj;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < kWarps; ++w) {
        if (better(red_t[w], red_s[w], red_j[w], bt, bs, bj)) {
          bt = red_t[w];
          bs = red_s[w];
          bj = red_j[w];
        }
      }
      const float l_i = (float)ai.w;
      const bool has_pred = bt > l_i;
      const float S_i = has_pred ? bt : l_i;
      const int P_i = has_pred ? bj : -1;
      S[i] = S_i;
      S_out[row + i] = S_i;
      P_out[row + i] = P_i;
      if (V == kRefund) {
        // ledger of the winning predecessor (P = -1 reads index 0, as the
        // reference's clip does; the result is then discarded)
        const int pw = has_pred ? bj : 0;
        const Pair q = pair_score<V>(ai, A[pw], S[pw], skip, md, kcoef,
                                     maxgap, skipcost);
        const float wb = (float)q.bonus;
        const float fpj = fixed_pen[row + pw];
        const float ppj = pre_pen[row + pw];
        const bool cont = (fpj < 0.0f) && (fpj + wb < 0.0f);
        const float nfp = q.colinear ? (cont ? fpj + wb : 0.0f) : (-skip + wb);
        const float npp = q.colinear ? (cont ? ppj : 0.0f) : skip;
        fixed_pen[row + i] = has_pred ? nfp : 0.0f;
        pre_pen[row + i] = has_pred ? npp : 0.0f;
      }
    }
    __syncthreads();
  }
}

template <int V>
cudaError_t launch(const void* anchors, const void* n_valid,
                   const void* skip_i, const void* maxdiff_i, void* S,
                   void* P, void* fixed_pen, void* pre_pen, int B, int N,
                   float kcoef, int maxgap, float skipcost,
                   cudaStream_t stream) {
  const size_t smem = (size_t)N * (sizeof(int4) + sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      chain_dp_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  chain_dp_kernel<V><<<B, kThreads, smem, stream>>>(
      static_cast<const int4*>(anchors), static_cast<const int*>(n_valid),
      static_cast<const float*>(skip_i), static_cast<const int*>(maxdiff_i),
      static_cast<float*>(S), static_cast<int*>(P),
      static_cast<float*>(fixed_pen), static_cast<float*>(pre_pen), N, kcoef,
      maxgap, skipcost);
  return cudaGetLastError();
}

}  // namespace

// anchors (B, N, 4) int32, n_valid (B,) int32, skip_i (B, N) f32,
// maxdiff_i (B, N) int32 -> S (B, N) f32, P (B, N) int32.  fixed_pen and
// pre_pen are zeroed (B, N) f32 scratch, used by variant 2 (refund) only.
// variant: 0 global, 1 global_nocov, 2 refund, 3 fine, 4 mismatch.
// Returns a cudaError_t (0 = launched).
extern "C" int chain_dp_launch(const void* anchors, const void* n_valid,
                               const void* skip_i, const void* maxdiff_i,
                               void* S, void* P, void* fixed_pen,
                               void* pre_pen, int B, int N, int variant,
                               float kcoef, int maxgap, float skipcost,
                               void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kGlobal:
      return (int)launch<kGlobal>(anchors, n_valid, skip_i, maxdiff_i, S, P,
                                  fixed_pen, pre_pen, B, N, kcoef, maxgap,
                                  skipcost, s);
    case kGlobalNocov:
      return (int)launch<kGlobalNocov>(anchors, n_valid, skip_i, maxdiff_i,
                                       S, P, fixed_pen, pre_pen, B, N, kcoef,
                                       maxgap, skipcost, s);
    case kRefund:
      return (int)launch<kRefund>(anchors, n_valid, skip_i, maxdiff_i, S, P,
                                  fixed_pen, pre_pen, B, N, kcoef, maxgap,
                                  skipcost, s);
    case kFine:
      return (int)launch<kFine>(anchors, n_valid, skip_i, maxdiff_i, S, P,
                                fixed_pen, pre_pen, B, N, kcoef, maxgap,
                                skipcost, s);
    case kMismatch:
      return (int)launch<kMismatch>(anchors, n_valid, skip_i, maxdiff_i, S,
                                    P, fixed_pen, pre_pen, B, N, kcoef,
                                    maxgap, skipcost, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
