// The tile walk of the chaining DP, shared by chain_dp.cu and
// chain_dp_large.cu.
//
// Rows are finished in tiles of T rows (each kernel picks its T, a
// multiple of 32).  For a tile [i0, i0 + T) of barrier-sorted rows every
// candidate j < i0 already holds its final S, so those pairs are
// independent and the kernels spread them over warps, blocks or the card;
// each row arrives here with its best (test, S[j], j) below the tile.
// What is left is sequential: row r of the tile may chain to rows jr < r
// of the same tile.  This header keeps that part short:
//   * tile_records: all threads of a block compute the S-free terms
//     (chain_pair.cuh::pair_terms) of the tile's T * (T - 1) / 2
//     in-tile pairs into shared memory, one 16-byte record each, with the
//     barrier test in the record's flags (ties in the barrier are common,
//     so jr < r alone does not make a candidate).  The logs leave the
//     serial path.
//   * tile_walk: one warp walks the rows.  Lane l keeps S of rows l,
//     l + 32, ... of the tile in registers; per row it applies one record
//     to its S (four f32 operations), and the warp reduces with one
//     redux.sync and a ballot, against the row's best below the tile (the
//     whole order only where tests tie).  Every lane learns the row's S,
//     so nothing goes through shared memory between two rows.
//   * warp_best: better() is a total order on (test, S[j], j), so any
//     split of the reduction gives the same winner.  Each float maps to an
//     unsigned key of the same order (-0.0 and +0.0, equal under better(),
//     share a key); __reduce_max_sync picks the largest test, then the
//     largest S among the lanes that tie, then the largest j.
// Frozen rows (the warm kernel's frontier) lie below r_lo: they are
// candidates with the S they came with and are never scored.  Rows at or
// past r_hi (n_valid) are not touched.

#pragma once

#include "chain_pair.cuh"

namespace {

constexpr unsigned kFullWarp = 0xffffffffu;

// in-tile pairs (r, jr < r) of a tile of T rows
__host__ __device__ constexpr int tile_pairs(int T) { return T * (T - 1) / 2; }

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

// float -> unsigned with the same order; -0.0 takes +0.0's key
__device__ __forceinline__ unsigned order_key(float f) {
  unsigned u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// the warp's best, valid in every lane.  A lane without a candidate
// holds no_best(); its S key (that of -inf) is above the 0 that marks a
// lane out of the second and third round.
__device__ __forceinline__ Best warp_best(Best b) {
  const unsigned kt = order_key(b.t);
  const unsigned mt = __reduce_max_sync(kFullWarp, kt);
  const unsigned ks = kt == mt ? order_key(b.s) : 0u;
  const unsigned ms = __reduce_max_sync(kFullWarp, ks);
  const unsigned kj = (kt == mt && ks == ms) ? (unsigned)(b.j + 1) : 0u;
  const unsigned mj = __reduce_max_sync(kFullWarp, kj);
  return Best{key_float(mt), key_float(ms), (int)mj - 1};
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <int V>
__device__ __forceinline__ int barrier_of(int4 a) {
  return a.x + ((V == kFine || V == kMismatch) ? a.w : 0);
}

__device__ __forceinline__ int tile_rec_index(int r, int jr) {
  return r * (r - 1) / 2 + jr;
}

// The S-free records of the tile's pairs (r, jr < r), r in [r_lo, r_hi),
// by nthreads threads, of which this is thread tid (a block, or every
// block of a cluster writing into one block's shared memory).  sA, sSkip,
// sMd hold the tile's anchors and per-row penalties.
template <int V>
__device__ __forceinline__ void tile_records(
    Terms* rec, const int4* sA, const float* sSkip, const int* sMd, int r_lo,
    int r_hi, const ChainParams& prm, int tid, int nthreads) {
  const int p_lo = tile_rec_index(r_lo > 1 ? r_lo : 1, 0);
  const int p_hi = r_hi > 0 ? tile_rec_index(r_hi, 0) : 0;
  for (int p = p_lo + tid; p < p_hi; p += nthreads) {
    int r = (int)((1.0f + sqrtf(1.0f + 8.0f * (float)p)) * 0.5f);
    while (tile_rec_index(r, 0) > p) --r;
    while (tile_rec_index(r + 1, 0) <= p) ++r;
    const int jr = p - tile_rec_index(r, 0);
    const int4 ai = sA[r];
    const int4 aj = sA[jr];
    Terms t = pair_terms<V>(ai, aj, sSkip[r], sMd[r], prm);
    if (barrier_of<V>(aj) < barrier_of<V>(ai)) t.flags |= kCandidate;
    rec[p] = t;
  }
}

// One lane's record of pair (r, jr), or one that is no candidate
__device__ __forceinline__ Terms load_record(const Terms* rec, int r, int jr) {
  if (jr < r) return rec[tile_rec_index(r, jr)];
  return Terms{0.0f, 0.0f, 0.0f, 0u};
}

// One warp finishes rows [r_lo, r_hi) of the tile of T rows that starts
// at anchor i0.  below_of[r] is row r's best over the candidates below the
// tile (no_best() where there is none).  sS holds the tile's S (the given
// S of frozen rows matters, the rest is overwritten) and gets the
// finished S; sP gets the finished P of the scored rows.
//
// The chain from one row's S to the next is kept short.  Whatever a row
// reads from shared memory (records, penalties, its best below the tile)
// is fetched while the row before it is finished.  The row itself: apply
// (four f32 operations), the test's key, one redux.sync for the largest
// key, one compare against the key of the best below the tile, and a
// ballot that names the winning lane, whose j follows from its position.
// Only where two candidates tie in the test (a ballot with more than one
// lane, or the in-tile best equal to the best below) does the row take
// the whole (test, S[j], j) order through warp_best, which gives what the
// fast path would have.
//
// kLedger (variant refund, cold DP only): a colinear candidate whose
// ledger allows it gets its predecessor's penalty back.  The ledgers
// exist only for finished rows, like S, so the test is made here: in-tile
// candidates read sFp / sPp (the tile's ledgers, written row by row),
// and the winner's update reads A_all (every anchor of the read) and the
// ledgers in device memory, fixed_pen / pre_pen of this read.
template <int V, int T, bool kLedger>
__device__ __forceinline__ void tile_walk(
    const Terms* rec, const int4* sA, const float* sSkip, const int* sMd,
    const Best* below_of, float* sS, int* sP, int i0, int r_lo, int r_hi,
    int lane, const ChainParams& prm, const int4* A_all, float* sFp,
    float* sPp, float* fixed_pen, float* pre_pen) {
  static_assert(T % 32 == 0 && T <= 128, "lanes keep T / 32 rows each");
  constexpr int Q = T / 32;
  float sreg[Q];
  int preg[Q];
  Terms cur[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    sreg[q] = sS[lane + 32 * q];
    preg[q] = -1;
    cur[q] = load_record(rec, r_lo, lane + 32 * q);
  }
  if (r_lo >= r_hi) return;
  float skip = sSkip[r_lo];
  float l_i = (float)sA[r_lo].w;
  Best below = below_of[r_lo];
  for (int r = r_lo; r < r_hi; ++r) {
    // the next row's inputs do not depend on this row's S
    const int rn = r + 1 < r_hi ? r + 1 : r;
    Terms nxt[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) nxt[q] = load_record(rec, rn, lane + 32 * q);
    const float skip_n = sSkip[rn];
    const float l_n = (float)sA[rn].w;
    const Best below_n = below_of[rn];
    const unsigned k_below = order_key(below.t);  // above 0, also for -inf

    float v[Q];
    unsigned k[Q];
    unsigned k_lane = 0u;  // 0: no candidate, below every float's key
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const bool cand = (cur[q].flags & kCandidate) != 0u;
      v[q] = apply_terms(sreg[q], cur[q], skip);
      if (kLedger && cand) {
        const int jr = lane + 32 * q;
        const float fp = sFp[jr];
        if ((cur[q].flags & kColinear) && fp < 0.0f &&
            fp + cur[q].bonus >= 0.0f)
          v[q] = v[q] + sPp[jr];
      }
      k[q] = cand ? order_key(v[q]) : 0u;
      k_lane = k[q] > k_lane ? k[q] : k_lane;
    }
    const unsigned k_tile = __reduce_max_sync(kFullWarp, k_lane);
    float bt = below.t;
    int bj = below.j;
    bool tied = k_tile == k_below;
    if (k_tile > k_below) {  // uniform over the warp
      int holders = 0;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const unsigned held = __ballot_sync(kFullWarp, k[q] == k_tile);
        holders += __popc(held);
        if (held) bj = i0 + 32 * q + __ffs(held) - 1;
      }
      bt = key_float(k_tile);
      tied = holders > 1;
    }
    if (tied) {  // uniform: the whole order decides
      Best best = lane == 0 ? below : no_best();
#pragma unroll
      for (int q = 0; q < Q; ++q)
        if (k[q] != 0u) take(best, v[q], sreg[q], i0 + lane + 32 * q);
      best = warp_best(best);
      bt = best.t;
      bj = best.j;
    }
    const bool has_pred = bt > l_i;
    const float S_i = has_pred ? bt : l_i;
    const int P_i = has_pred ? bj : -1;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (lane + 32 * q == r) {
        sreg[q] = S_i;
        preg[q] = P_i;
      }
      cur[q] = nxt[q];
    }
    if (kLedger) {
      if (lane == 0) {
        // ledger of the winning predecessor (P = -1 reads index 0, as the
        // reference's clip does; the result is then discarded)
        const int i = i0 + r;
        const int pw = has_pred ? P_i : 0;
        const Terms w = pair_terms<V>(sA[r], A_all[pw], skip, sMd[r], prm);
        const float fpj = pw >= i0 ? sFp[pw - i0] : fixed_pen[pw];
        const float ppj = pw >= i0 ? sPp[pw - i0] : pre_pen[pw];
        const bool col = (w.flags & kColinear) != 0u;
        const bool cont = (fpj < 0.0f) && (fpj + w.bonus < 0.0f);
        const float nfp = col ? (cont ? fpj + w.bonus : 0.0f) : (-skip + w.bonus);
        const float npp = col ? (cont ? ppj : 0.0f) : skip;
        sFp[r] = fixed_pen[i] = has_pred ? nfp : 0.0f;
        sPp[r] = pre_pen[i] = has_pred ? npp : 0.0f;
      }
      __syncwarp();
    }
    skip = skip_n;
    l_i = l_n;
    below = below_n;
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int r = lane + 32 * q;
    if (r >= r_lo && r < r_hi) {
      sS[r] = sreg[q];
      sP[r] = preg[q];
    }
  }
  __syncwarp();
}

}  // namespace
