// Pair scoring of the non-linear chaining DP, shared by chain_dp.cu and
// chain_dp_large.cu (through chain_tile.cuh) so that the f32 operation
// order exists once.
//
// A line-for-line translation of vacmap_tpu/ops/chain_jax.py::_pair_scores
// and its helpers for one (i, j) pair.  f32 rules, so that P agrees with
// the reference: every formula keeps the reference's operation order,
// logf/log2f are the precise versions, and the library is compiled with
// -fmad=false and without fast math.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;  // chain_jax.NEG

enum Variant { kGlobal = 0, kGlobalNocov = 1, kRefund = 2, kFine = 3,
               kMismatch = 4 };

// The S-free part of one (i, j) pair: every branch of the reference's
// test(i, j) has the form
//   t = (((S[j] - p0) + bonus) - p1) - p2
// with p0 = skip_i on the global non-colinear branch only (kUseSkip), p1
// the colinear gap cost or the branch's whole penalty, p2 the fine /
// mismatch read-gap term, and zeros elsewhere (x - 0.0f is exact).  The
// penalties are never folded into one another or into the bonus: the f32
// operation order is the contract.  16 bytes, so a tile's in-tile pairs
// fit shared memory as one record each.
struct Terms {
  float p1;
  float p2;
  float bonus;     // (float)bonus, the only form the scores use
  unsigned flags;
};

constexpr unsigned kCandidate = 1u;  // barrier_j < barrier_i (set by the tile code)
constexpr unsigned kKill = 2u;       // test = kNeg (local variants, no progress)
constexpr unsigned kColinear = 4u;
constexpr unsigned kUseSkip = 8u;    // p0 = skip_i

// The scalars of one launch, and the block's table of logs.
struct ChainParams {
  float kcoef;     // f32(0.01 * kmersize)
  int maxgap;
  float skipcost;
  const float* log2_lut;  // shared memory, fill_log2_lut
};

// The logs of the DP take small integers almost always (a colinear gap
// cost is at most maxdiff, a read gap term stops at 99 or 30).  Each block
// tabulates log2f(k), k < kLog2Lut, with the same precise log2f the
// scoring would call, so a table value is that call's value bit for bit.
constexpr int kLog2Lut = 128;

__device__ __forceinline__ void fill_log2_lut(float* lut, int tid,
                                              int nthreads) {
  for (int k = tid; k < kLog2Lut; k += nthreads)
    lut[k] = log2f((float)(k > 0 ? k : 1));
}

// log2f((float)k) for an integer k >= 1
__device__ __forceinline__ float log2_int(int k, const float* lut) {
  return k < kLog2Lut ? lut[k] : log2f((float)k);
}

// chain_jax._extra_penalty:
//   min(36, min(30 + 0.5 log(g), min(10, g / 100) + min(30, g / 1000))).
// Most pairs of a read are far apart on the reference, so the common
// cases are settled without the log and without the divisions, each with
// the reference's result: g / 100 >= 10 from g = 1000 on and g / 1000 >=
// 30 from g = 30,000 on (a correctly rounded division is monotonic, and
// both are exact at the threshold); the log term is at least 30 (g >= 1),
// so it cannot win against a third term of at most 30; and from
// g = 163,000 on (log g > 12.0015) it is above 36 while the third term is
// 40, so the result is 36.
__device__ __forceinline__ float extra_penalty(int gapcost) {
  if (gapcost >= 163000) return 36.0f;
  const float gf = (float)gapcost;
  const float a = gapcost >= 1000 ? 10.0f : fminf(10.0f, gf / 100.0f);
  const float b = gapcost >= 30000 ? 30.0f : fminf(30.0f, gf / 1000.0f);
  const float third = a + b;
  if (third <= 30.0f) return third;
  const float g = fmaxf(gf, 1.0f);
  return fminf(36.0f, fminf(30.0f + 0.5f * logf(g), third));
}

// chain_jax._gapcost_colinear
__device__ __forceinline__ float gapcost_colinear(int gapcost, bool local,
                                                  const ChainParams& prm) {
  if (!(gapcost > 0)) return 0.0f;
  const float lg = log2_int(gapcost, prm.log2_lut);
  const float coef = (local && gapcost > 10) ? 2.0f : 0.5f;
  return prm.kcoef * (float)gapcost + coef * lg;
}

// chain_jax._pair_scores for one (i, j) pair without S[j].  Only the
// branch that `where(colinear, col, sv)` keeps is evaluated.
template <int V>
__device__ __forceinline__ Terms pair_terms(int4 ai, int4 aj, float skip,
                                            int md, const ChainParams& prm) {
  const int maxgap = prm.maxgap;
  const float skipcost = prm.skipcost;
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

  Terms t;
  t.bonus = (float)bonus;
  t.p2 = 0.0f;
  t.flags = 0u;
  if (colinear) {
    t.flags |= kColinear;
    t.p1 = gapcost_colinear(gapcost, local, prm);
    // log2f(rg + 1.0f) of the reference: rg + 1 is a small integer
    if (V == kFine) {
      const int rg = readgap < 99 ? readgap : 99;
      t.p2 = readgap > 0 ? 0.1f * log2_int(rg + 1, prm.log2_lut) : 0.0f;
    } else if (V == kMismatch) {
      if (readgap >= 30)
        t.p2 = 0.5f * (float)readgap;
      else
        t.p2 = readgap > 0 ? 0.1f * log2_int(readgap + 1, prm.log2_lut) : 0.0f;
    }
  } else {
    if (V == kGlobal || V == kGlobalNocov) {
      t.flags |= kUseSkip;
      t.p1 = extra_penalty(gapcost);
    } else if (V == kRefund) {
      t.p1 = skip;
    } else if (V == kFine) {
      t.p1 =
          (same ? skipcost : fminf(50.0f, skipcost)) + extra_penalty(gapcost);
    } else {  // mismatch
      const int gc = gapcost < 99999 ? gapcost : 99999;
      t.p1 = skipcost + 0.5f * log2_int(gc + 1, prm.log2_lut);
    }
  }
  if (local && neg && bonus <= 0) t.flags |= kKill;
  return t;
}

// test(i, j) from S[j] and the pair's S-free terms
__device__ __forceinline__ float apply_terms(float Sj, const Terms& t,
                                             float skip) {
  const float p0 = (t.flags & kUseSkip) ? skip : 0.0f;
  const float test = (((Sj - p0) + t.bonus) - t.p1) - t.p2;
  return (t.flags & kKill) ? kNeg : test;
}

// (t, s, j) lexicographic "greater than": the reference's argmax with
// ties broken by the larger S[j], then the larger j
__device__ __forceinline__ bool better(float t, float s, int j, float bt,
                                       float bs, int bj) {
  return t > bt || (t == bt && (s > bs || (s == bs && j > bj)));
}

}  // namespace
