// Banded two-piece affine DP over a batch of pairs: one warp a pair.
//
// Replaces the lax.scan over target rows (vacmap_tpu/ops/affine_jax.py:162)
// of _affine_batch (:51): row i of pair b holds band lanes l = 0 .. W-1 at
// column j = l + i + dlo[b].  Global mode (GLOB) writes every row's
// traceback bytes, a (B, T, W) plane, rows past t_len included; the
// extension mode writes none and returns the best cell, its row and
// column and the z-drop flag.  Same values, masks, op priority (DIAG > E2
// > E1 > F2 > F1) and flag bits as the reference's step (:85-156) and the
// plain version, ops/affine_batch.py::affine_batch_ref.
//
// What bounds it on an H100: the latency of one pair, not bytes or
// operations.  A pair is T dependent rows (up to 32,768 in the extension
// mode), and each row waits on a cross-lane prefix max (the insertion
// move) and a cross-lane argmax (the row's best) before the next row can
// use either; a launch takes as long as its longest pair.  The plane is
// W bytes a row (64 MB at B = 64, T = 4096, W = 256: 20 us of the card's
// memory rate).  So the design keeps a pair on one warp with nothing to
// wait for but its own chain:
//  - thread t holds band lanes K t .. K t + K-1 (K = W / 32: 1, 4, 8 or
//    16) of H, E1 and E2 in registers; the deletion move's up-shift (lane
//    l+1 to l) is K-1 register moves and one __shfl_down_sync a state;
//  - the insertion move's prefix maxima (F1, F2) are the reference's
//    cummax form: an in-thread inclusive max over K lanes, a 5-step
//    __shfl_up_sync scan of the thread totals, one more shuffle for the
//    exclusive value.  Max is exact in any order;
//  - the row's best is an in-thread argmax and a 5-step __shfl_xor_sync
//    butterfly that keeps the lowest lane among equal maxima (argmax's
//    first index, :137), so every lane holds it;
//  - the query is staged in shared memory once (at most 48 KB, the
//    reference's clipped reads as clamped indices); the target byte of
//    the next row is loaded a row ahead;
//  - each row's W bytes leave as one vector store a thread (K bytes),
//    so a warp writes the row in one contiguous transaction;
//  - in the extension mode a warp stops at t_len, or once its pair is
//    dead: after that row best, best_i and best_j cannot change (:138-148).
// Floating point: every add and subtract keeps the reference's operands
// and order (build flag -fmad=false, no fast-math intrinsics), so cells
// masked with NEG = -1e9 round exactly as there (-1e9 + 2 is -1e9 in
// float32); only maxima are taken in another order, which is exact.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e9f;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kMaxQ = 48 * 1024;
// traceback op codes and flag bits (ops/affine_ref.py)
constexpr uint32_t kDiag = 0, kDel1 = 1, kDel2 = 2, kIns1 = 3, kIns2 = 4;
constexpr uint32_t kE1X = 8, kE2X = 16, kF1X = 32, kF2X = 64;

struct Params {
  float mat, mis, o1, e1, o2, e2, zdrop;
  int T, Q, zdrop_on;
};

// K bytes (packed four to a word) to dst as one store
template <int K>
__device__ __forceinline__ void store_row(uint8_t* dst,
                                          const uint32_t (&w)[(K + 3) / 4]) {
  if constexpr (K == 1) {
    *dst = (uint8_t)w[0];
  } else if constexpr (K == 4) {
    *reinterpret_cast<uint32_t*>(dst) = w[0];
  } else if constexpr (K == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  } else {
    static_assert(K == 16, "K is 1, 4, 8 or 16");
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <int K, bool GLOB>
__global__ void __launch_bounds__(32)
affine_band_kernel(const uint8_t* __restrict__ targets,
                   const uint8_t* __restrict__ queries,
                   const int* __restrict__ t_len, const int* __restrict__ q_len,
                   const int* __restrict__ dlo_in, uint8_t* __restrict__ tb,
                   float* __restrict__ best_out, int* __restrict__ best_i_out,
                   int* __restrict__ best_j_out, uint8_t* __restrict__ dead_out,
                   Params p) {
  constexpr int W = 32 * K;
  constexpr int NW = (K + 3) / 4;
  extern __shared__ __align__(16) uint8_t qsh[];
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int T = p.T, Q = p.Q;
  const int tl = t_len[b], ql = q_len[b], dlo = dlo_in[b];
  const uint8_t* qb = queries + (size_t)b * Q;
  for (int v = lane; v < Q; v += 32) qsh[v] = qb[v];
  __syncwarp();
  const uint8_t* tg = targets + (size_t)b * T;
  const int l0 = K * lane;  // this thread's first band lane

  // row 0: H(0, j) for j = l + dlo
  float H[K], E1[K], E2[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j0 = l0 + k + dlo;
    const float fj = (float)j0;
    const float gap0 = fminf(p.o1 + p.e1 * fj, p.o2 + p.e2 * fj);
    H[k] = (j0 >= 0 && j0 <= ql && j0 > 0) ? -gap0
                                           : (j0 == 0 ? 0.0f : kNeg);
    E1[k] = kNeg;
    E2[k] = kNeg;
  }
  float best = kNeg;
  int best_i = 0, best_j = 0;
  bool dead = false;
  // past t_len the extension mode changes nothing; the plane has T rows
  const int last = GLOB ? T : min(T, max(tl, 0));
  int tc_next = last >= 1 ? tg[0] : 0;

  for (int i = 1; i <= last; ++i) {
    const int tc = tc_next;
    if (i < T) tc_next = tg[i];  // the next row's target byte, a row ahead
    const float fi = (float)i;
    const float gapi = fminf(p.o1 + p.e1 * fi, p.o2 + p.e2 * fi);
    const bool row_in = i <= tl;
    const int jb = l0 + i + dlo;  // column of this thread's first lane
    // H, E1, E2 of lane l+1 in the previous row
    const float Hd = __shfl_down_sync(kAll, H[0], 1);
    const float E1d = __shfl_down_sync(kAll, E1[0], 1);
    const float E2d = __shfl_down_sync(kAll, E2[0], 1);

    float diag[K], E1n[K], E2n[K], H0[K], c1[K], c2[K];
    uint32_t w[NW];
#pragma unroll
    for (int n = 0; n < NW; ++n) w[n] = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = jb + k;
      const bool okc = (row_in && j >= 1 && j <= ql) || j == 0;
      const int qj = min(max(j - 1, 0), Q - 1);
      const float sub = (int)qsh[qj] == tc ? p.mat : p.mis;
      diag[k] = H[k] + sub;
      const bool edge = k == K - 1;
      const int kn = edge ? k : k + 1;  // an index in range either way
      const float Hu = edge ? (lane == 31 ? kNeg : Hd) : H[kn];
      const float E1u = edge ? (lane == 31 ? kNeg : E1d) : E1[kn];
      const float E2u = edge ? (lane == 31 ? kNeg : E2d) : E2[kn];
      const float e1x = E1u - p.e1, e2x = E2u - p.e2;
      E1n[k] = fmaxf(e1x, (Hu - p.o1) - p.e1);
      E2n[k] = fmaxf(e2x, (Hu - p.o2) - p.e2);
      if (GLOB) {
        const uint32_t f = (E1n[k] == e1x ? kE1X : 0u) |
                           (E2n[k] == e2x ? kE2X : 0u);
        w[k >> 2] |= f << (8 * (k & 3));
      }
      float h0 = fmaxf(diag[k], fmaxf(E1n[k], E2n[k]));
      if (j == 0) h0 = -gapi;
      H0[k] = h0;
      const float m = okc ? h0 : kNeg;
      const float lf = (float)(l0 + k);
      const float g1 = m + lf * p.e1, g2 = m + lf * p.e2;
      const int kp = k ? k - 1 : 0;
      c1[k] = k ? fmaxf(c1[kp], g1) : g1;
      c2[k] = k ? fmaxf(c2[kp], g2) : g2;
    }
    // maxima over the lanes of the threads below this one
    float x1 = c1[K - 1], x2 = c2[K - 1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y1 = __shfl_up_sync(kAll, x1, o);
      const float y2 = __shfl_up_sync(kAll, x2, o);
      if (lane >= o) {
        x1 = fmaxf(x1, y1);
        x2 = fmaxf(x2, y2);
      }
    }
    float ex1 = __shfl_up_sync(kAll, x1, 1), ex2 = __shfl_up_sync(kAll, x2, 1);
    if (lane == 0) {
      ex1 = -INFINITY;
      ex2 = -INFINITY;
    }
    float F1[K], F2[K], Hn[K];
    float bv = kNeg;  // the row's best over in-band lanes, first lane kept
    int bl = l0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      // cummax of lane l - 1; NEG at lane 0
      const int kp = k ? k - 1 : 0;
      float r1 = k ? fmaxf(ex1, c1[kp]) : ex1;
      float r2 = k ? fmaxf(ex2, c2[kp]) : ex2;
      if (k == 0 && lane == 0) {
        r1 = kNeg;
        r2 = kNeg;
      }
      const float lf = (float)(l0 + k);
      F1[k] = (r1 - lf * p.e1) - p.o1;
      F2[k] = (r2 - lf * p.e2) - p.o2;
      const int j = jb + k;
      const bool inb = row_in && j >= 1 && j <= ql;
      float h = fmaxf(H0[k], fmaxf(F1[k], F2[k]));
      if (j == 0) h = -gapi;
      if (!(inb || j == 0)) h = kNeg;
      Hn[k] = h;
      const float hm = inb ? h : kNeg;
      if (k == 0 || hm > bv) {
        bv = hm;
        bl = l0 + k;
      }
    }
    if (GLOB) {
      // F of lane l - 1 (NEG at lane 0) for the F extension flags
      float F1l = __shfl_up_sync(kAll, F1[K - 1], 1);
      float F2l = __shfl_up_sync(kAll, F2[K - 1], 1);
      if (lane == 0) {
        F1l = kNeg;
        F2l = kNeg;
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float h = Hn[k];
        uint32_t op = kDiag;
        if (h == F1[k]) op = kIns1;
        if (h == F2[k]) op = kIns2;
        if (h == E1n[k]) op = kDel1;
        if (h == E2n[k]) op = kDel2;
        if (h == diag[k]) op = kDiag;
        const int kp = k ? k - 1 : 0;
        const float f1p = k ? F1[kp] : F1l;
        const float f2p = k ? F2[kp] : F2l;
        op |= (F1[k] == f1p - p.e1 ? kF1X : 0u) |
              (F2[k] == f2p - p.e2 ? kF2X : 0u);
        w[k >> 2] |= op << (8 * (k & 3));
      }
      store_row<K>(tb + ((size_t)b * T + (i - 1)) * W + l0, w);
    }
    // the row's best: largest value, lowest lane among equals
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kAll, bv, o);
      const int ol = __shfl_xor_sync(kAll, bl, o);
      if (ov > bv || (ov == bv && ol < bl)) {
        bv = ov;
        bl = ol;
      }
    }
    if (bv > best && !dead && row_in) {
      best = bv;
      best_i = i;
      best_j = bl + i + dlo;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      H[k] = Hn[k];
      E1[k] = E1n[k];
      E2[k] = E2n[k];
    }
    if (!GLOB && p.zdrop_on) {
      if (row_in && best - bv > p.zdrop) dead = true;
      if (dead) break;  // nothing of the pair changes after this row
    }
  }
  if (lane == 0) {
    best_out[b] = best;
    best_i_out[b] = best_i;
    best_j_out[b] = best_j;
    dead_out[b] = dead ? 1 : 0;
  }
}

template <int K, bool GLOB>
cudaError_t launch(const void* targets, const void* queries, const void* t_len,
                   const void* q_len, const void* dlo, void* tb, void* best,
                   void* best_i, void* best_j, void* dead, int B,
                   const Params& p, cudaStream_t stream) {
  // at most 48 KB: within the default dynamic shared memory of a block
  const size_t smem = (size_t)((p.Q + 15) & ~15);
  affine_band_kernel<K, GLOB><<<B, 32, smem, stream>>>(
      static_cast<const uint8_t*>(targets), static_cast<const uint8_t*>(queries),
      static_cast<const int*>(t_len), static_cast<const int*>(q_len),
      static_cast<const int*>(dlo), static_cast<uint8_t*>(tb),
      static_cast<float*>(best), static_cast<int*>(best_i),
      static_cast<int*>(best_j), static_cast<uint8_t*>(dead), p);
  return cudaGetLastError();
}

template <bool GLOB>
cudaError_t launch_w(int W, const void* targets, const void* queries,
                     const void* t_len, const void* q_len, const void* dlo,
                     void* tb, void* best, void* best_i, void* best_j,
                     void* dead, int B, const Params& p, cudaStream_t s) {
  switch (W) {
    case 32:
      return launch<1, GLOB>(targets, queries, t_len, q_len, dlo, tb, best,
                             best_i, best_j, dead, B, p, s);
    case 128:
      return launch<4, GLOB>(targets, queries, t_len, q_len, dlo, tb, best,
                             best_i, best_j, dead, B, p, s);
    case 256:
      return launch<8, GLOB>(targets, queries, t_len, q_len, dlo, tb, best,
                             best_i, best_j, dead, B, p, s);
    case 512:
      return launch<16, GLOB>(targets, queries, t_len, q_len, dlo, tb, best,
                              best_i, best_j, dead, B, p, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// targets (B, T) uint8, queries (B, Q) uint8, t_len, q_len, dlo (B,) int32
// (dlo from the wrapper, with floor division) -> best (B,) float32,
// best_i, best_j (B,) int32, dead (B,) uint8 and, when glob, tb (B, T, W)
// uint8.  W in {32, 128, 256, 512}, Q <= 48 KB.  One pair (one warp)
// a block.  Returns a cudaError_t (0 = launched).
extern "C" int affine_band_launch(const void* targets, const void* queries,
                                  const void* t_len, const void* q_len,
                                  const void* dlo, void* tb, void* best,
                                  void* best_i, void* best_j, void* dead,
                                  int B, int T, int Q, int W, int glob,
                                  int match, int mismatch, int o1, int e1,
                                  int o2, int e2, int zdrop, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (T <= 0 || Q <= 0 || Q > kMaxQ || (glob && tb == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.mat = (float)match;
  p.mis = (float)mismatch;
  p.o1 = (float)o1;
  p.e1 = (float)e1;
  p.o2 = (float)o2;
  p.e2 = (float)e2;
  p.zdrop = (float)zdrop;
  p.zdrop_on = !glob && zdrop >= 0;
  p.T = T;
  p.Q = Q;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      glob ? launch_w<true>(W, targets, queries, t_len, q_len, dlo, tb, best,
                            best_i, best_j, dead, B, p, s)
           : launch_w<false>(W, targets, queries, t_len, q_len, dlo, tb,
                             best, best_i, best_j, dead, B, p, s);
  return (int)err;
}
