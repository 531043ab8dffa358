// Pair scoring of the non-linear chaining DP, shared by chain_dp.cu and
// chain_dp_large.cu so that the f32 operation order exists once.
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

}  // namespace
