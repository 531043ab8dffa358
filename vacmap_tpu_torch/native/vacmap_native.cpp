// vacmap-tpu native host kernels.
//
// TPU-native equivalents of the reference's C extension components
// (SURVEY.md section 2.6): the device (JAX/Pallas) kernels own the batched
// hot path; these C++ routines are the low-latency host implementations
// used for small/irregular jobs and as the always-available fallback.
//
//   * myers_edit_distance — blocked bit-parallel global edit distance
//     (divergence filter; replaces edlib, mammap_clrnano.py:19251)
//   * align2p_native      — banded two-piece affine DP with traceback
//     (replaces mp.k_cigar, mammap_clrnano.py:21554/:2381); identical
//     cost model and tie-breaking to ops/affine_ref.py
//
// Built as a plain shared library; Python binds via ctypes (no pybind11).

#include <chrono>
#include <cstring>
#include <cmath>
#include <cstdint>
#include <immintrin.h>
#include <cstdlib>
#include <vector>
#include <algorithm>
#include <utility>
#include <cstdio>

extern "C" {

// ---------------------------------------------------------------------------
// Blocked Myers bit-parallel edit distance (Myers 1999, blocked as in
// Hyyro 2003): pattern = query b, text = a; O(na * nb/64).
// Returns the global (NW) distance; if cap >= 0 and the result exceeds
// cap, returns cap + 1 (exact decision, possibly early-outs on |na-nb|).
// ---------------------------------------------------------------------------
int64_t myers_edit_distance(const uint8_t* a, int64_t na,
                            const uint8_t* b, int64_t nb, int64_t cap) {
  if (na == 0) return (cap >= 0 && nb > cap) ? cap + 1 : nb;
  if (nb == 0) return (cap >= 0 && na > cap) ? cap + 1 : na;
  if (cap >= 0 && std::llabs(na - nb) > cap) return cap + 1;
  const int64_t W = (nb + 63) / 64;
  std::vector<uint64_t> Peq(5 * W, 0);
  for (int64_t i = 0; i < nb; i++) {
    uint8_t c = b[i] < 4 ? b[i] : 4;
    Peq[(size_t)c * W + i / 64] |= 1ull << (i % 64);
  }
  std::vector<uint64_t> Pv(W, ~0ull), Mv(W, 0);
  const uint64_t HIGH = 1ull << ((nb - 1) % 64);
  // Ukkonen band over blocks (value-safe): cells with true distance <= cap
  // lie within rows [j-cap, j+cap]; untouched blocks keep their virgin
  // all-+1 state, which is an UPPER bound on their true values, and the
  // +1 horizontal boundary delta entering the first in-band block is also
  // an upper bound — since no <=cap path leaves the band, in-band values
  // <= cap are exact (decision- and value-exact for d <= cap).
  // bscore[w] = D(bottom row of block w, current column) for processed
  // blocks; a block entering at the bottom chains bscore from above.
  std::vector<int64_t> bscore(W);
  // block w's tracked row is its bottom row, except the last block which
  // tracks the pattern end (the HIGH bit)
  for (int64_t w = 0; w < W; w++)
    bscore[w] = std::min<int64_t>(64 * (w + 1), nb);
  const bool banded = (cap >= 0) && (cap + 130 < nb);
  // both-endpoint band: a cell (i, j) on an end-to-end <=cap path obeys
  // |i-j| deviation cost on BOTH sides, so rows stay within
  // [j + min(0,D) - half, j + max(0,D) + half] where D = nb-na and
  // half = (cap - |D|)/2 — HALF the width of the origin-only bound.
  // Exactness: <=cap end-to-end paths never leave this band, so the
  // final value is exact whenever it is <=cap, and the early abort
  // below remains sound (each column of such a path has an in-band
  // tracked prefix value <=cap).
  const int64_t Dend = nb - na;
  const int64_t half = banded ? (cap - std::llabs(Dend)) / 2 : 0;
  const int64_t row_off_lo = std::min<int64_t>(0, Dend) - half - 2;
  const int64_t row_off_hi = std::max<int64_t>(0, Dend) + half + 2;
  int64_t b_hi_old = banded ? -1 : W - 1;
  for (int64_t j = 0; j < na; j++) {
    uint8_t c = a[j] < 4 ? a[j] : 4;
    const uint64_t* eqrow = &Peq[(size_t)c * W];
    int64_t b_lo = 0, b_hi = W - 1;
    if (banded) {
      b_lo = std::max<int64_t>(0, (j + row_off_lo - 1) / 64 - 1);
      b_hi = std::min<int64_t>(W - 1, (j + row_off_hi + 1) / 64 + 1);
      for (int64_t b = std::max<int64_t>(b_hi_old + 1, 1); b <= b_hi; b++)
        bscore[b] =
            bscore[b - 1] + (std::min<int64_t>(64 * (b + 1), nb) - 64 * b);
      b_hi_old = std::max(b_hi_old, b_hi);
    }
    int hin = 1;  // NW boundary (and upper-bound delta when b_lo > 0)
    // branchless inner loop; the final (HIGH-masked) block is peeled so
    // every in-loop block uses bit 63
    const int64_t w_last = b_hi;
    for (int64_t w = b_lo; w <= w_last; w++) {
      uint64_t Eq = eqrow[w];
      const uint64_t Pv_w = Pv[w], Mv_w = Mv[w];
      const uint64_t Xv = Eq | Mv_w;
      Eq |= (uint64_t)(hin >> 1) & 1ull;  // hin<0 -> set bit 0
      const uint64_t Xh = (((Eq & Pv_w) + Pv_w) ^ Pv_w) | Eq;
      uint64_t Ph = Mv_w | ~(Xh | Pv_w);
      uint64_t Mh = Pv_w & Xh;
      const uint64_t high = (w == W - 1) ? HIGH : (1ull << 63);
      const int hout = (int)((Ph & high) != 0) - (int)((Mh & high) != 0);
      Ph <<= 1;
      Mh <<= 1;
      Mh |= (uint64_t)(hin >> 1) & 1ull;
      Ph |= (uint64_t)(hin == 1);
      Pv[w] = Mh | ~(Xv | Ph);
      Mv[w] = Ph & Xv;
      hin = hout;
      bscore[w] += hout;
    }
    // early abort (junk pairs): cells with true value <= cap are tracked
    // exactly (no <=cap path leaves the band) and a block's min is
    // >= bscore - 63, so if every in-band block bottom exceeds cap + 63
    // there is no <=cap cell in this column — and since a column's
    // in-band minimum never drops below the previous column's (left/diag
    // moves cost >= 0), the final score must exceed cap.
    if (banded && (j & 15) == 15) {
      int64_t mn = INT64_MAX;
      for (int64_t w = b_lo; w <= b_hi; w++) mn = std::min(mn, bscore[w]);
      if (mn - 63 > cap) return cap + 1;
    }
  }
  const int64_t score = bscore[W - 1];
  if (cap >= 0 && score > cap) return cap + 1;
  return score;
}

// ---------------------------------------------------------------------------
// banded two-piece affine alignment with traceback.
// Band in offset d = j - i over [dlo, dhi]; H tie priority
// DIAG > DEL1 > DEL2 > INS1 > INS2 (matches ops/affine_ref.py).
// ops buffer receives (op, len) int32 pairs (op: 0=M 1=I 2=D).
// ---------------------------------------------------------------------------

static const float NEG = -1e30f;

#if defined(__AVX2__)
// Two interleaved in-place inclusive prefix maxes (independent carry
// chains hide the lane-shift latency).
static inline void prefix_max2_avx2(float* __restrict__ g1,
                                    float* __restrict__ g2, int64_t n,
                                    float c1, float c2) {
  const __m256 vneg = _mm256_set1_ps(NEG);
  const __m256i p1 = _mm256_setr_epi32(0, 0, 1, 2, 3, 4, 5, 6);
  const __m256i p2 = _mm256_setr_epi32(0, 0, 0, 1, 2, 3, 4, 5);
  const __m256i p4 = _mm256_setr_epi32(0, 0, 0, 0, 0, 1, 2, 3);
  __m256 vc1 = _mm256_set1_ps(c1), vc2 = _mm256_set1_ps(c2);
  int64_t p = 0;
  for (; p + 8 <= n; p += 8) {
    __m256 a = _mm256_loadu_ps(g1 + p);
    __m256 b = _mm256_loadu_ps(g2 + p);
    a = _mm256_max_ps(a, _mm256_blend_ps(_mm256_permutevar8x32_ps(a, p1), vneg, 0x01));
    b = _mm256_max_ps(b, _mm256_blend_ps(_mm256_permutevar8x32_ps(b, p1), vneg, 0x01));
    a = _mm256_max_ps(a, _mm256_blend_ps(_mm256_permutevar8x32_ps(a, p2), vneg, 0x03));
    b = _mm256_max_ps(b, _mm256_blend_ps(_mm256_permutevar8x32_ps(b, p2), vneg, 0x03));
    a = _mm256_max_ps(a, _mm256_blend_ps(_mm256_permutevar8x32_ps(a, p4), vneg, 0x0F));
    b = _mm256_max_ps(b, _mm256_blend_ps(_mm256_permutevar8x32_ps(b, p4), vneg, 0x0F));
    a = _mm256_max_ps(a, vc1);
    b = _mm256_max_ps(b, vc2);
    _mm256_storeu_ps(g1 + p, a);
    _mm256_storeu_ps(g2 + p, b);
    vc1 = _mm256_permutevar8x32_ps(a, _mm256_set1_epi32(7));
    vc2 = _mm256_permutevar8x32_ps(b, _mm256_set1_epi32(7));
  }
  float s1 = _mm256_cvtss_f32(vc1), s2 = _mm256_cvtss_f32(vc2);
  for (; p < n; p++) {
    s1 = std::max(s1, g1[p]); g1[p] = s1;
    s2 = std::max(s2, g2[p]); g2[p] = s2;
  }
}

// In-place inclusive prefix max with carry-in; returns final carry.
// Log-step lane shifts via permutevar8x32 + NEG blends.
static inline float prefix_max_avx2(float* __restrict__ g, int64_t n, float carry) {
  const __m256 vneg = _mm256_set1_ps(NEG);
  const __m256i p1 = _mm256_setr_epi32(0, 0, 1, 2, 3, 4, 5, 6);
  const __m256i p2 = _mm256_setr_epi32(0, 0, 0, 1, 2, 3, 4, 5);
  const __m256i p4 = _mm256_setr_epi32(0, 0, 0, 0, 0, 1, 2, 3);
  __m256 vcarry = _mm256_set1_ps(carry);
  int64_t p = 0;
  for (; p + 8 <= n; p += 8) {
    __m256 v = _mm256_loadu_ps(g + p);
    v = _mm256_max_ps(v, _mm256_blend_ps(_mm256_permutevar8x32_ps(v, p1), vneg, 0x01));
    v = _mm256_max_ps(v, _mm256_blend_ps(_mm256_permutevar8x32_ps(v, p2), vneg, 0x03));
    v = _mm256_max_ps(v, _mm256_blend_ps(_mm256_permutevar8x32_ps(v, p4), vneg, 0x0F));
    v = _mm256_max_ps(v, vcarry);
    _mm256_storeu_ps(g + p, v);
    carry = g[p + 7];
    vcarry = _mm256_set1_ps(carry);
  }
  for (; p < n; p++) {
    carry = std::max(carry, g[p]);
    g[p] = carry;
  }
  return carry;
}
#endif

int align2p_native_eqx(
    const uint8_t* target, int64_t T, const uint8_t* query, int64_t Q,
    int match, int mismatch, int o1, int e1, int o2, int e2,
    int bw, int zdrop, int glob, int eqx,
    int32_t* out_ops, int64_t max_ops, int64_t* n_ops,
    int64_t* q_end, int64_t* t_end, int64_t* score_out, int* zdropped);

int align2p_native(
    const uint8_t* target, int64_t T, const uint8_t* query, int64_t Q,
    int match, int mismatch, int o1, int e1, int o2, int e2,
    int bw, int zdrop, int glob,
    int32_t* out_ops, int64_t max_ops, int64_t* n_ops,
    int64_t* q_end, int64_t* t_end, int64_t* score_out, int* zdropped) {
  return align2p_native_eqx(target, T, query, Q, match, mismatch, o1, e1,
                            o2, e2, bw, zdrop, glob, 0, out_ops, max_ops,
                            n_ops, q_end, t_end, score_out, zdropped);
}

// eqx != 0 emits =/X runs (op codes 3/4) instead of M.
static void __attribute__((noinline)) affine_pass3(
    int64_t p_lo, int64_t p_hi, float fe1, float fe2,
    const float* __restrict__ F1b, const float* __restrict__ F2b,
    const float* __restrict__ E1n, const float* __restrict__ E2n,
    const float* __restrict__ diag_buf, float* __restrict__ Hn,
    int32_t* __restrict__ Bb, float f1_prev, float f2_prev,
    float* row_best_out) {
  float row_best = NEG;
  #pragma GCC ivdep
  for (int64_t p = p_lo; p <= p_hi; p++) {
    const float H0 = Hn[p];
    const float F1v = F1b[p];
    const float F2v = F2b[p];
    const float H = std::max(H0, std::max(F1v, F2v));
    int32_t op = (H == F2v) ? 4 : 0;
    op = (H == F1v) ? 3 : op;
    op = (H == E2n[p]) ? 2 : op;
    op = (H == E1n[p]) ? 1 : op;
    op = (H == diag_buf[p]) ? 0 : op;
    const float F1pv = (p > p_lo) ? F1b[p - 1] : f1_prev;
    const float F2pv = (p > p_lo) ? F2b[p - 1] : f2_prev;
    int32_t b = Bb[p] | op;
    b |= (F1v == F1pv - fe1) ? 32 : 0;
    b |= (F2v == F2pv - fe2) ? 64 : 0;
    Bb[p] = b;
    Hn[p] = H;
  }
  for (int64_t p = p_lo; p <= p_hi; p++) row_best = std::max(row_best, Hn[p]);
  *row_best_out = row_best;
}

int align2p_native_eqx(
    const uint8_t* target, int64_t T, const uint8_t* query, int64_t Q,
    int match, int mismatch, int o1, int e1, int o2, int e2,
    int bw, int zdrop, int glob, int eqx,
    int32_t* out_ops, int64_t max_ops, int64_t* n_ops,
    int64_t* q_end, int64_t* t_end, int64_t* score_out, int* zdropped) {
  *n_ops = 0; *zdropped = 0;
  if (T == 0 || Q == 0) {
    int64_t k = 0;
    if (Q) { out_ops[k * 2] = 1; out_ops[k * 2 + 1] = (int32_t)Q; k++; }
    if (T) { out_ops[k * 2] = 2; out_ops[k * 2 + 1] = (int32_t)T; k++; }
    *n_ops = k; *q_end = Q; *t_end = T; *score_out = 0;
    return 0;
  }
  // Adaptive band for global fills: the reference's k_cigar runs bw=-1
  // (full DP), but inter-anchor fill paths hug the main diagonal.  Start
  // narrow and escalate whenever the traceback touches a clipped band
  // edge — the final level reproduces the original full-width behaviour,
  // so escalation converges to the bw=-1 result (fuzz-verified).
  static const int64_t kBandLevels[3] = {64, 250, 1002};
  int band_attempt = 0;
retry_band:
  const int64_t w =
      glob ? (std::llabs(Q - T) + kBandLevels[band_attempt]) : bw;
  int64_t dlo = std::min<int64_t>(0, Q - T) - w;
  int64_t dhi = std::max<int64_t>(0, Q - T) + w;
  dlo = std::max<int64_t>(dlo, -T);
  dhi = std::min<int64_t>(dhi, Q);
  const int64_t Wb = dhi - dlo + 1;

  // rows carry one NEG sentinel at index Wb so the p+1 (vertical) reads
  // never go out of bounds; scratch reused across calls (thread-local)
  static thread_local std::vector<float> Hrow, E1row, E2row, Hnew, E1new,
      E2new, Dbuf, F1buf, F2buf, G1buf, G2buf;
  static thread_local std::vector<int32_t> Bbuf;
  static thread_local std::vector<uint8_t> tb;
  for (auto* v : {&Hrow, &E1row, &E2row, &Hnew, &E1new, &E2new, &Dbuf,
                  &F1buf, &F2buf}) {
    v->assign(Wb + 1, NEG);
  }
  G1buf.assign(Wb + 8, NEG);
  G2buf.assign(Wb + 8, NEG);
  Bbuf.assign(Wb + 1, 0);
  tb.resize((size_t)T * Wb);

  auto gapf = [&](int64_t l) -> float {
    return (float)std::min((int64_t)o1 + (int64_t)e1 * l,
                           (int64_t)o2 + (int64_t)e2 * l);
  };
  for (int64_t p = 0; p < Wb; p++) {
    int64_t j = p + dlo;
    if (j == 0) Hrow[p] = 0.0f;
    else if (j > 0 && j <= Q) Hrow[p] = -gapf(j);
  }
  float best = NEG;
  int64_t best_i = 0, best_j = 0;
  // substitution lookup: sub_lut[tch*5 + qch]
  float sub_lut[25];
  for (int a = 0; a < 5; a++)
    for (int b = 0; b < 5; b++)
      sub_lut[a * 5 + b] = (a == b && a < 4) ? (float)match : (float)mismatch;
  const float fe1 = (float)e1, fe2 = (float)e2;
  const float fo1e = (float)(o1 + e1), fo2e = (float)(o2 + e2);
  const float fo1 = (float)o1, fo2 = (float)o2;
  for (int64_t i = 1; i <= T; i++) {
    uint8_t* __restrict__ bits_row = &tb[(size_t)(i - 1) * Wb];
    const float gapi = -gapf(i);
    float run1 = NEG, run2 = NEG;      // max(H0[p'] + p'*e_k) over p' <= p
    float f1_prev = NEG, f2_prev = NEG;
    const uint8_t tch = target[i - 1] < 4 ? target[i - 1] : 4;
    const float* __restrict__ subrow = &sub_lut[tch * 5];
    const float* __restrict__ Hp = Hrow.data();
    const float* __restrict__ E1p = E1row.data();
    const float* __restrict__ E2p = E2row.data();
    float* __restrict__ Hn = Hnew.data();
    float* __restrict__ E1n = E1new.data();
    float* __restrict__ E2n = E2new.data();
    // in-band lane range: j in [1, Q]  ->  p in [p_lo, p_hi]
    const int64_t off = dlo + i;
    const int64_t p_lo = std::max<int64_t>(0, 1 - off);
    const int64_t p_hi = std::min<int64_t>(Wb - 1, Q - off);
    const int64_t p_zero = -off;  // lane of j == 0, may be out of range
    // row i only ever reads lanes [p_lo, p_hi + 1] of row i-1, which row
    // i-1 wrote as [p_lo-1, p_hi] of ITS range plus this one boundary
    // lane — so a single below-range fill replaces the full out-of-band
    // sweep (this halves row work for global alignments)
    if (p_lo - 1 >= 0) {
      const int64_t pb = p_lo - 1;
      Hn[pb] = (pb == p_zero) ? gapi : NEG;
      E1n[pb] = NEG;
      E2n[pb] = NEG;
    }
    if (p_zero >= 0 && p_zero < Wb) {
      run1 = gapi + (float)p_zero * fe1;
      run2 = gapi + (float)p_zero * fe2;
    }
    float row_best = NEG;
    const uint8_t* __restrict__ qbase = query + off - 1;  // q index = p + off - 1
    // pass 1 (vectorizable): vertical/diagonal candidates — no intra-row
    // dependency.  H0 stored in Hn temporarily; diag kept in scratch.
    float* __restrict__ diag_buf = Dbuf.data();
    int32_t* __restrict__ Bb = Bbuf.data();
    const float fmat = (float)match, fmis = (float)mismatch;
    const int tmatchable = (tch < 4) ? 1 : 0;
    #pragma GCC ivdep
    for (int64_t p = p_lo; p <= p_hi; p++) {
      const float H_up = Hp[p + 1];
      const float E1u = E1p[p + 1];
      const float E2u = E2p[p + 1];
      const float E1v = std::max(E1u - fe1, H_up - fo1e);
      const float E2v = std::max(E2u - fe2, H_up - fo2e);
      const float sub = (tmatchable & (qbase[p] == tch)) ? fmat : fmis;
      const float diag = Hp[p] + sub;
      const float H0 = std::max(diag, std::max(E1v, E2v));
      diag_buf[p] = diag;
      E1n[p] = E1v;
      E2n[p] = E2v;
      Hn[p] = H0;
      Bb[p] = ((E1v == E1u - fe1) ? 8 : 0) | ((E2v == E2u - fe2) ? 16 : 0);
    }
    // pass 2: discounted running maxima as a vector prefix-max scan
    float* __restrict__ F1b = F1buf.data();
    float* __restrict__ F2b = F2buf.data();
#if defined(__AVX2__)
    {
      float* __restrict__ G1 = G1buf.data();
      float* __restrict__ G2 = G2buf.data();
      #pragma GCC ivdep
      for (int64_t p = p_lo; p <= p_hi; p++) {
        const float H0 = Hn[p];
        G1[p] = H0 + (float)p * fe1;
        G2[p] = H0 + (float)p * fe2;
      }
      prefix_max2_avx2(G1 + p_lo, G2 + p_lo, p_hi - p_lo + 1, run1, run2);
      #pragma GCC ivdep
      for (int64_t p = p_lo; p <= p_hi; p++) {
        const float r1 = (p > p_lo) ? G1[p - 1] : run1;
        const float r2 = (p > p_lo) ? G2[p - 1] : run2;
        F1b[p] = r1 - (float)p * fe1 - fo1;
        F2b[p] = r2 - (float)p * fe2 - fo2;
      }
    }
#else
    for (int64_t p = p_lo; p <= p_hi; p++) {
      const float pe1 = (float)p * fe1, pe2 = (float)p * fe2;
      F1b[p] = run1 - pe1 - fo1;
      F2b[p] = run2 - pe2 - fo2;
      const float H0 = Hn[p];
      run1 = std::max(run1, H0 + pe1);
      run2 = std::max(run2, H0 + pe2);
    }
#endif
    // pass 3: combine + traceback bits (separate function so the
    // vectorizer gets a fresh context)
    affine_pass3(p_lo, p_hi, fe1, fe2, F1b, F2b, E1n, E2n, diag_buf, Hn,
                 Bb, f1_prev, f2_prev, &row_best);
    #pragma GCC ivdep
    for (int64_t p = p_lo; p <= p_hi; p++) bits_row[p] = (uint8_t)Bb[p];

    // guard: p_hi can exceed available qbase range only if band math wrong
    std::swap(Hrow, Hnew); std::swap(E1row, E1new); std::swap(E2row, E2new);
    if (!glob) {
      for (int64_t p = p_lo; p <= p_hi; p++) {
        if (Hrow[p] > best) { best = Hrow[p]; best_i = i; best_j = p + off; }
      }
      if (zdrop >= 0 && best - row_best > (float)zdrop) {
        *zdropped = 1;
        break;
      }
    }
  }
  int64_t ei, ej;
  if (glob) {
    ei = T; ej = Q;
    *score_out = (int64_t)llroundf(Hrow[Q - T - dlo]);
  } else {
    ei = best_i; ej = best_j;
    *score_out = (int64_t)llroundf(best);
  }
  *q_end = ej; *t_end = ei;

  // traceback (state machine identical to affine_ref._traceback)
  int64_t i = ei, j = ej;
  int state = 0;
  int64_t p_min = INT64_MAX, p_max = INT64_MIN;
  static thread_local std::vector<std::pair<int, int64_t>> rev;
  rev.clear();
  auto push = [&](int op, int64_t len) {
    if (!rev.empty() && rev.back().first == op) rev.back().second += len;
    else rev.push_back({op, len});
  };
  while (i > 0 || j > 0) {
    if (i == 0) { push(1, j); break; }
    if (j == 0) { push(2, i); break; }
    const int64_t p = j - i - dlo;
    p_min = std::min(p_min, p);
    p_max = std::max(p_max, p);
    const uint8_t b = tb[(size_t)(i - 1) * Wb + p];
    if (state == 0) {
      const int op = b & 7;
      if (op == 0) {
        if (eqx) {
          const bool eq = (target[i - 1] == query[j - 1] && target[i - 1] < 4);
          push(eq ? 3 : 4, 1);
        } else {
          push(0, 1);
        }
        i--; j--;
      }
      else if (op == 1) state = 1;
      else if (op == 2) state = 2;
      else if (op == 3) state = 3;
      else state = 4;
    } else if (state == 1 || state == 2) {
      push(2, 1);
      const bool ext = b & (state == 1 ? 8 : 16);
      i--;
      if (!ext) state = 0;
    } else {
      push(1, 1);
      const bool ext = b & (state == 3 ? 32 : 64);
      j--;
      if (!ext) state = 0;
    }
  }
  // escalate when the optimal path touched a clipped band edge (the full
  // matrix extends beyond the band there): results may be band-limited
  if (glob && band_attempt + 1 < 3) {
    const bool lo_clipped = (dlo > -T);
    const bool hi_clipped = (dhi < Q);
    if ((lo_clipped && p_min <= 0) || (hi_clipped && p_max >= Wb - 1)) {
      band_attempt++;
      goto retry_band;
    }
  }
  int64_t k = 0;
  for (auto it = rev.rbegin(); it != rev.rend(); ++it) {
    if (k >= max_ops) return -2;
    out_ops[k * 2] = it->first;
    out_ops[k * 2 + 1] = (int32_t)it->second;
    k++;
  }
  *n_ops = k;
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Non-linear chaining DP (exact), C++ host kernel.
//
// Same recurrence/tie-breaks as ops/chain_ref.chain_dp: for each anchor i,
// candidates are all anchors with a strictly smaller barrier key, scanned
// in descending (S, index) order with the lossless early break
// S[j] <= running_max - len_i (the reference's S_arg scan,
// mammap_clrnano.py:24828/24944).  variant: 0=global 1=refund 2=fine
// 3=mismatch.  Anchors must be barrier-sorted (readpos, or readpos+len
// for local variants).  extra[] table passed in from Python so the
// surcharge matches bit-for-bit.
// ---------------------------------------------------------------------------

extern "C" int chain_dp_native_warm(
    const int64_t* anchors, int64_t n,
    int kmersize, double skipcost, int maxdiff, int maxgap, int variant,
    const float* extra, int64_t extra_size,
    double* S_out, int64_t* P_out, int64_t max_ops_per_anchor,
    int64_t n_warm, const double* warm_S, const int64_t* warm_P);

extern "C" int chain_dp_native(
    const int64_t* anchors, int64_t n,  // rows of (readpos, refpos, strand, len)
    int kmersize, double skipcost, int maxdiff, int maxgap, int variant,
    const float* extra, int64_t extra_size,  // extra table (len = extra_size+1)
    double* S_out, int64_t* P_out, int64_t max_ops_per_anchor) {
  return chain_dp_native_warm(anchors, n, kmersize, skipcost, maxdiff, maxgap,
                              variant, extra, extra_size, S_out, P_out,
                              max_ops_per_anchor, 0, nullptr, nullptr);
}

// Warm-start variant for the streaming (asm) chain: the first n_warm
// anchors are a carried frontier with fixed scores warm_S and (negative,
// cross-batch) predecessor codes warm_P; they participate as candidates
// but are not re-scored (reference linked_* DPs, mammap_asm.py:21687).
extern "C" int chain_dp_native_warm(
    const int64_t* anchors, int64_t n,
    int kmersize, double skipcost, int maxdiff, int maxgap, int variant,
    const float* extra, int64_t extra_size,
    double* S_out, int64_t* P_out, int64_t max_ops_per_anchor,
    int64_t n_warm, const double* warm_S, const int64_t* warm_P) {
  if (n == 0) return 0;
  // variant 4 = "global_nocov": asm-mode global scoring WITHOUT the
  // adaptive repeat coverage (the asm kernels use flat skipcost,
  // mammap_asm.py:20552/:21687) and with the asm opposite-strand
  // geometry (non_overlap_size forms, no +-1 — mammap_asm.py:20552
  // refgap cases; same-strand forms are algebraically identical)
  const bool use_cov = (variant == 0);
  const bool asm_geo_v = (variant == 4 || variant == 6);
  if (variant == 4) variant = 0;
  // variant 5 = "scar": the R-mode local re-chain
  // (mammap_noprefercloser.py:23419) — local barrier/overlap rules,
  // GLOBAL-style colinear gap table, 0.1*log2(g) readgap term, flat
  // skipcost SV moves with the refund ledger
  const bool scar = (variant == 5);
  // variant 6 = "asm_fine": the asm local re-chain DP (mammap_asm.py live
  // ..._fine_list / linked_..._fine_list_all) — readpos (START) barrier,
  // flat 0.5*log2 colinear gap table, 0.1*log2(readgap) readgap term,
  // SV cost skipcost + extra[gapcost], start-based overlap geometry for
  // opposite strands, no coverage adaptation, no bonus<=0 skip, no abort
  const bool asmf = (variant == 6);
  const bool local = (variant == 2 || variant == 3 || scar);
  const bool refund = (variant == 1 || scar);

  // colinear gap-cost table
  std::vector<double> gapcost_list(maxdiff + 1, 0.0);
  for (int g = 1; g <= maxdiff; g++) {
    double coef = (local && !scar && g > 10) ? 2.0 : 0.5;
    gapcost_list[g] = 0.01 * kmersize * g + coef * std::log2((double)g);
  }
  // fine-variant colinear readgap cost (float32 table in the reference)
  std::vector<double> readgapcost(100, 0.0);
  for (int g = 1; g < 100; g++) readgapcost[g] = (float)(0.1 * std::log2(g + 1.0));
  // scar-variant readgap cost (mammap_noprefercloser.py:16534-16536)
  std::vector<double> scarcost(100, 0.0);
  for (int g = 1; g < 100; g++) scarcost[g] = (float)(0.1 * std::log2((double)g));
  // mismatch-variant large readgap cost
  std::vector<double> lrg(maxgap + 1, 0.0);
  for (int g = 1; g <= maxgap; g++)
    lrg[g] = (float)((g >= 30) ? 0.5 * g : 0.1 * std::log2(g + 1.0));

  auto A = [&](int64_t i, int c) { return anchors[i * 4 + c]; };

  // adaptive repeat penalties (global variant)
  std::vector<double> skip_i(n, skipcost);
  std::vector<int> maxdiff_i(n, maxdiff);
  if (use_cov) {
    int64_t maxr = 0;
    for (int64_t i = 0; i < n; i++) maxr = std::max(maxr, A(i, 0));
    std::vector<int32_t> cov(maxr + 1, 0);
    for (int64_t i = 0; i < n; i++) {
      int64_t r = A(i, 0);
      if (cov[r] < 20) cov[r]++;
    }
    for (int64_t i = 0; i < n; i++) {
      skip_i[i] = skipcost + cov[A(i, 0)];
      maxdiff_i[i] = std::max(maxdiff - cov[A(i, 0)], 10);
    }
  }

  std::vector<double> fixed_pen, pre_pen;
  if (refund) { fixed_pen.assign(n, 0.0); pre_pen.assign(n, 0.0); }

  std::vector<int64_t> barrier(n);
  for (int64_t i = 0; i < n; i++)
    barrier[i] = A(i, 0) + (local ? A(i, 3) : 0);

  // sorted candidate order: ascending (S, index); binary insert per group
  std::vector<int64_t> order;  // candidate indices sorted ascending by (S, idx)
  order.reserve(n);
  std::vector<double> S(n, 0.0);
  std::vector<int64_t> P(n, -1);

  for (int64_t i = 0; i < n_warm; i++) { S[i] = warm_S[i]; P[i] = warm_P[i]; }
  if (n_warm == 0) S[0] = (double)A(0, 3);
  int64_t inserted = 0;  // anchors currently in `order`
  int64_t prebarrier = barrier[0];
  int64_t opcount = 0;

  auto insert_sorted = [&](int64_t k) {
    double s = S[k];
    int64_t lo = 0, hi = (int64_t)order.size();
    while (lo < hi) {
      int64_t mid = (lo + hi) / 2;
      if (S[order[mid]] < s || (S[order[mid]] == s && order[mid] < k)) lo = mid + 1;
      else hi = mid;
    }
    order.insert(order.begin() + lo, k);
  };

  if (n_warm > 0) {
    // all frontier anchors become candidates before any new anchor
    while (inserted < n_warm) insert_sorted(inserted++);
    for (int64_t i = 0; i < n_warm; i++)
      prebarrier = std::max(prebarrier, barrier[i]);
  }
  // abort classes (mirroring the reference's mid-DP bailouts):
  //  * global/refund DPs abort at a readpos advance when opcount/i >
  //    max_factor (mammap_clrnano.py:24914, true division) — caller
  //    switches to the fast bucketed DP;
  //  * local fine/mismatch DPs abort when opcount > 100000 AND
  //    opcount/prereadloc > max_factor (mammap_clrnano.py:27380,:28333),
  //    and their inner loop counts the BREAKING candidate too (opcount
  //    incremented before the `S[j] < max-w` test, a `<` not `<=` break);
  //  * scar (mammap_noprefercloser.py:23419) and asm_fine have NO abort.
  const bool abort_global =
      (variant == 0 || variant == 1) && !scar && !asmf &&
      max_ops_per_anchor > 0;
  const bool abort_local =
      (variant == 2 || variant == 3) && max_ops_per_anchor > 0;
  // local fine/mismatch count candidates before the break test
  const bool count_first = (variant == 2 || variant == 3);
  for (int64_t i = n_warm; i < n; i++) {
    if (i > 0 && prebarrier < barrier[i]) {
      if (abort_global &&
          (double)opcount / (double)i > (double)max_ops_per_anchor)
        return 1;  // caller discards partial S/P and uses the fast DP
      if (abort_local && opcount > 100000 &&
          (double)opcount / (double)std::max<int64_t>(prebarrier, 1) >
              (double)max_ops_per_anchor)
        return 1;
      while (inserted < i) insert_sorted(inserted++);
      prebarrier = barrier[i];
    }
    const int64_t r_i = A(i, 0), y_i = A(i, 1), s_i = A(i, 2), l_i = A(i, 3);
    double max_scores = (double)l_i;
    int64_t pre_index = -1;
    bool win_col = false;
    int64_t win_bonus = 0;
    // descending (S, idx) scan with early break
    for (int64_t oi = (int64_t)order.size() - 1; oi >= 0; oi--) {
      const int64_t j = order[oi];
      if (barrier[j] >= barrier[i]) continue;  // safety (shouldn't happen)
      if (count_first) {
        opcount++;
        if (S[j] < max_scores - (double)l_i) break;
      } else if (scar) {
        // scar breaks on `<` (mammap_noprefercloser.py:23510): candidates
        // at exact equality ARE evaluated, and with the refund ledger an
        // equality candidate can win — output-relevant, not just a prune
        if (S[j] < max_scores - (double)l_i) break;
      } else {
        if (!(S[j] > max_scores - (double)l_i)) break;
        opcount++;
      }
      const int64_t r_j = A(j, 0), y_j = A(j, 1), s_j = A(j, 2), l_j = A(j, 3);
      int64_t readgap = r_i - r_j - l_j;
      int64_t bonus, refgap;
      const bool same = (s_i == s_j);
      if (readgap < 0) {
        bonus = r_i + l_i - r_j - l_j;
        if (local && bonus <= 0) continue;
        const int64_t overlap = r_j + l_j - r_i;
        readgap = 0;
        if (same) {
          refgap = (s_i == 1) ? (y_i + overlap - (y_j + l_j)) : (y_j - (y_i + bonus));
        } else if (asm_geo_v) {
          // asm start-based overlap geometry (non_overlap = r_i - r_j)
          const int64_t nov = r_i - r_j;
          refgap = (s_j == -1) ? (y_i + l_j - nov - y_j)
                               : (y_i + l_i - y_j - nov);
        } else {
          refgap = (s_j == -1) ? (y_i + overlap - y_j + 1)
                               : (y_i + bonus - 1 - (y_j + l_j));
        }
      } else {
        bonus = l_i;
        if (same) {
          refgap = (s_i == 1) ? (y_i - y_j - l_j) : (y_j - y_i - l_i);
        } else if (asm_geo_v) {
          refgap = (s_j == -1) ? (y_i - y_j) : (y_i + l_i - y_j - l_j);
        } else {
          refgap = (s_j == -1) ? (y_i - y_j + 1) : (y_i + l_i - 1 - y_j - l_j);
        }
      }
      int64_t gapcost = std::llabs(readgap - refgap);
      const bool colinear =
          same && refgap >= 0 && readgap <= maxgap && gapcost <= maxdiff_i[i];
      double ts;
      if (colinear) {
        ts = S[j] + bonus - gapcost_list[gapcost];
        if (variant == 2) ts -= readgapcost[std::min<int64_t>(readgap, 99)];
        else if (variant == 3) ts -= lrg[std::min<int64_t>(readgap, maxgap)];
        else if (scar || asmf) ts -= scarcost[std::min<int64_t>(readgap, 99)];
        if (refund && fixed_pen[j] < 0 && fixed_pen[j] + bonus >= 0)
          ts += pre_pen[j];
      } else {
        const int64_t gc = std::min(gapcost, extra_size);
        if (variant == 0 || asmf) ts = S[j] - skip_i[i] + bonus - (double)extra[gc];
        else if (variant == 1 || scar) ts = S[j] + bonus - skip_i[i];
        else if (variant == 2) {
          const double pen = (same ? skipcost : std::min(50.0, skipcost)) +
                             (double)extra[gc];
          ts = S[j] + bonus - pen;
        } else {
          ts = S[j] + bonus -
               (skipcost + 0.5 * std::log2((double)std::min<int64_t>(
                                        gapcost, 99999) + 1.0));
        }
      }
      if (ts > max_scores) {
        max_scores = ts;
        pre_index = j;
        win_col = colinear;
        win_bonus = bonus;
      }
    }
    S[i] = max_scores;
    P[i] = pre_index;
    if (refund && pre_index >= 0) {
      const int64_t j = pre_index;
      if (win_col) {
        if (fixed_pen[j] < 0 && fixed_pen[j] + win_bonus < 0) {
          fixed_pen[i] = fixed_pen[j] + win_bonus;
          pre_pen[i] = pre_pen[j];
        }
      } else {
        fixed_pen[i] = -skip_i[i] + win_bonus;
        pre_pen[i] = skip_i[i];
      }
    }
  }
  for (int64_t i = 0; i < n; i++) { S_out[i] = S[i]; P_out[i] = P[i]; }
  return 0;
}

// ---------------------------------------------------------------------------
// k-mer hit -> anchor merge (local harvest).
//
// Hits are pre-sorted by (diagonal, readpos); runs of overlapping hits on
// one diagonal grow an anchor which is emitted when its length would
// reach 20 (mammap_clrnano.py:23260-23305).  strand +1/-1 selects the
// ref-leftmost update rule.  Returns the number of anchors written.
// ---------------------------------------------------------------------------

extern "C" int64_t merge_diag_runs(
    const int64_t* rpos, const int64_t* refloc, const int64_t* diag,
    int64_t n, int64_t strand, int64_t k,
    int64_t* out /* (n*2, 4) capacity */) {
  int64_t m = 0;
  int64_t i = 0;
  auto emit = [&](int64_t r, int64_t y, int64_t l) {
    out[m * 4 + 0] = r;
    out[m * 4 + 1] = y;
    out[m * 4 + 2] = strand;
    out[m * 4 + 3] = l;
    m++;
  };
  while (i < n) {
    const int64_t d = diag[i];
    int64_t a_r = rpos[i], a_y = refloc[i], a_l = k;
    i++;
    while (i < n && diag[i] == d) {
      const int64_t r = rpos[i], y = refloc[i];
      i++;
      if (a_r + a_l >= r) {
        const int64_t bouns = r - (a_r + a_l) + k;
        if (bouns > 0) {
          if (a_l + bouns < 20) {
            if (strand == 1) a_l += bouns;
            else { a_y = y; a_l += bouns; }
          } else {
            emit(a_r, a_y, a_l);
            if (strand == 1) { a_r = a_r + a_l; a_y = a_y + a_l; a_l = bouns; }
            else { a_r = a_r + a_l; a_y = y; a_l = bouns; }
          }
        }
      } else {
        emit(a_r, a_y, a_l);
        a_r = r; a_y = y; a_l = k;
      }
    }
    emit(a_r, a_y, a_l);
  }
  return m;
}

// ---------------------------------------------------------------------------
// Minimizer sketch (index build / read lookup).
//
// Rolling 2-bit k-mer + invertible hash + sliding-window minimum with a
// monotone deque; keeps ALL tied minimal positions (strand-symmetric),
// identical selection to index/minimizer.py.  Returns count written.
// ---------------------------------------------------------------------------

static inline uint64_t mm_hash64(uint64_t x, uint64_t mask) {
  x = (~x + (x << 21)) & mask;
  x = x ^ (x >> 24);
  x = (x + (x << 3) + (x << 8)) & mask;
  x = x ^ (x >> 14);
  x = (x + (x << 2) + (x << 4)) & mask;
  x = x ^ (x >> 28);
  x = (x + (x << 31)) & mask;
  return x;
}

// Streaming ranged sketch: ONE pass, O(w) state, zero O(n) temporaries.
// Selection identical to the two-pass winmin/cover formulation it
// replaces (and to index/minimizer.py): position p is emitted iff its
// key (min of the two strand hashes; BIG when palindromic or the kmer
// touches a non-ACGT base) is not BIG and equals the minimum of at
// least one covering window.  Only positions in [emit_lo, emit_hi]
// (kmer indices) are written, ascending — the MT segmented build calls
// this directly per segment.
//
// Structure: a monotone deque over the last w keys that KEEPS ties
// (pop strictly-greater), so at each window every tied minimum is
// present in the head run and gets flagged; a position's flag is final
// once its last covering window has been processed, at which point it
// is emitted from a w-deep ring (restores global position order).
extern "C" int64_t minimizer_sketch_range(
    const uint8_t* seq, int64_t n, int k, int w,
    int64_t emit_lo, int64_t emit_hi,
    int64_t* out_hash, int64_t* out_pos, int8_t* out_strand) {
  if (n < k || w < 1) return 0;
  const uint64_t mask = (k < 32) ? ((1ull << (2 * k)) - 1) : ~0ull;
  const int64_t nk = n - k + 1;
  const uint64_t BIG = ~0ull;
  if (emit_lo < 0) emit_lo = 0;
  if (emit_hi >= nk) emit_hi = nk - 1;
  int64_t m = 0;
  const uint64_t shift_rev = 2 * (k - 1);
  if (nk < w) {  // single degenerate window: global min, all ties
    uint64_t fwd = 0, rev = 0, mn = BIG;
    int64_t valid_run = 0;
    std::vector<uint64_t> keys(nk, BIG);
    std::vector<int8_t> strs(nk, 0);
    for (int64_t i = 0; i < n; i++) {
      const uint8_t c = seq[i];
      if (c < 4) {
        fwd = ((fwd << 2) | c) & mask;
        rev = (rev >> 2) | (((uint64_t)(3 - c)) << shift_rev);
        valid_run++;
      } else { fwd = 0; rev = 0; valid_run = 0; }
      const int64_t p = i - k + 1;
      if (p < 0) continue;
      if (valid_run >= k) {
        const uint64_t hf = mm_hash64(fwd, mask);
        const uint64_t hr = mm_hash64(rev, mask);
        if (hf < hr) { keys[p] = hf; strs[p] = 1; }
        else if (hr < hf) { keys[p] = hr; strs[p] = -1; }
      }
      mn = std::min(mn, keys[p]);
    }
    if (mn == BIG) return 0;
    for (int64_t p = 0; p < nk; p++)
      if (keys[p] == mn && p >= emit_lo && p <= emit_hi) {
        out_hash[m] = (int64_t)mn; out_pos[m] = p; out_strand[m] = strs[p];
        m++;
      }
    return m;
  }
  // Branch-free strip selection (replaces the ring + monotone deque):
  // position p is a minimizer iff max over covering full windows of the
  // window minima equals keys[p] (ties kept, minimap2-style) — the
  // numpy oracle's window_min_positions rule, computed per strip with
  // two van Herk sliding passes (min then max) at ~3 ops/position.
  // Invalid/palindromic kmers carry INT64_MAX and are never selected.
  const int64_t KBIG = INT64_MAX;
  const int64_t BUFCAP = std::max<int64_t>(1 << 16, 4 * (int64_t)w + 64);
  static thread_local std::vector<int64_t> key_buf, vh_R1, vh_R2, vh_Z,
      vh_S;
  static thread_local std::vector<int8_t> str_buf;
  key_buf.resize(BUFCAP);
  str_buf.resize(BUFCAP);
  int64_t buf_base = 0;   // global kmer index of key_buf[0]
  int64_t fill = 0;       // entries in the buffer
  int64_t sel_next = 0;   // next global position to select
  uint64_t fwd = 0, rev = 0;
  int64_t valid_run = 0;
  auto vh_slide = [&](const int64_t* X, int64_t L, int64_t* R,
                      bool is_min) {
    // R[i] = min/max X[i..i+w-1] for i in [0, L-w]
    vh_S.resize(L);
    for (int64_t bs = 0; bs < L; bs += w) {
      const int64_t be = std::min<int64_t>(bs + w, L);
      vh_S[be - 1] = X[be - 1];
      if (is_min)
        for (int64_t j = be - 2; j >= bs; j--)
          vh_S[j] = std::min(X[j], vh_S[j + 1]);
      else
        for (int64_t j = be - 2; j >= bs; j--)
          vh_S[j] = std::max(X[j], vh_S[j + 1]);
    }
    int64_t pm = is_min ? INT64_MAX : INT64_MIN;
    for (int64_t i = 0; i + w <= L; i++) {
      const int64_t e = i + w - 1;
      pm = (e % w == 0) ? X[e]
                        : (is_min ? std::min(pm, X[e]) : std::max(pm, X[e]));
      R[i] = is_min ? std::min(vh_S[i], pm) : std::max(vh_S[i], pm);
    }
  };
  auto flush = [&](bool final_flush) {
    const int64_t last_key = buf_base + fill - 1;
    const int64_t P1 = final_flush ? nk - 1 : last_key - (w - 1);
    if (P1 >= sel_next) {
      const int64_t P0 = sel_next;
      const int64_t t0 = std::max<int64_t>(0, P0 - w + 1);
      const int64_t t1 = std::min<int64_t>(nk - w, P1);
      if (t1 >= t0) {
        const int64_t YL = t1 - t0 + 1;
        // winmin[t] over keys[t .. t+w-1], t in [t0, t1]
        vh_R1.resize(YL);
        vh_slide(&key_buf[t0 - buf_base], YL + w - 1, vh_R1.data(), true);
        // cover[p] = max winmin over t in [p-w+1, p] (clipped): pad both
        // ends with MIN so out-of-range windows are ignored by the max
        vh_Z.resize(YL + 2 * (w - 1));
        std::fill(vh_Z.begin(), vh_Z.begin() + (w - 1), INT64_MIN);
        std::copy(vh_R1.begin(), vh_R1.end(), vh_Z.begin() + (w - 1));
        std::fill(vh_Z.begin() + (w - 1) + YL, vh_Z.end(), INT64_MIN);
        vh_R2.resize(YL + w - 1);
        vh_slide(vh_Z.data(), YL + 2 * (w - 1), vh_R2.data(), false);
        const int64_t pe_lo = std::max(P0, emit_lo);
        const int64_t pe_hi = std::min(P1, emit_hi);
        for (int64_t p = pe_lo; p <= pe_hi; p++) {
          const int64_t key = key_buf[p - buf_base];
          if (key == KBIG || vh_R2[p - t0] != key) continue;
          out_hash[m] = key;
          out_pos[m] = p;
          out_strand[m] = str_buf[p - buf_base];
          m++;
        }
      }
      sel_next = P1 + 1;
    }
    if (!final_flush) {
      const int64_t keep_from =
          std::max<int64_t>(buf_base, sel_next - (w - 1));
      const int64_t keep = last_key - keep_from + 1;
      std::memmove(&key_buf[0], &key_buf[keep_from - buf_base],
                   (size_t)keep * sizeof(int64_t));
      std::memmove(&str_buf[0], &str_buf[keep_from - buf_base],
                   (size_t)keep);
      buf_base = keep_from;
      fill = keep;
    }
  };
  auto consume = [&](int64_t p, uint64_t key, int8_t st) {
    key_buf[fill] = (key == BIG) ? KBIG : (int64_t)key;
    str_buf[fill] = st;
    fill++;
    if (fill == BUFCAP) flush(false);
    (void)p;
  };
#if defined(__AVX2__)
  // block the base scan: rolling codes stay serial (cheap), the two
  // mm_hash64 per position run 4-wide on the 64-bit AVX2 lanes — the
  // hash is ~2/3 of the scalar per-base cost
  {
    const __m256i vm = _mm256_set1_epi64x((long long)mask);
    auto hash4 = [&](const uint64_t* in, uint64_t* out) {
      __m256i x = _mm256_loadu_si256((const __m256i*)in);
      // x = (~x + (x << 21)) & m
      x = _mm256_and_si256(
          _mm256_add_epi64(_mm256_xor_si256(x, _mm256_set1_epi64x(-1)),
                           _mm256_slli_epi64(x, 21)), vm);
      x = _mm256_xor_si256(x, _mm256_srli_epi64(x, 24));
      x = _mm256_and_si256(
          _mm256_add_epi64(_mm256_add_epi64(x, _mm256_slli_epi64(x, 3)),
                           _mm256_slli_epi64(x, 8)), vm);
      x = _mm256_xor_si256(x, _mm256_srli_epi64(x, 14));
      x = _mm256_and_si256(
          _mm256_add_epi64(_mm256_add_epi64(x, _mm256_slli_epi64(x, 2)),
                           _mm256_slli_epi64(x, 4)), vm);
      x = _mm256_xor_si256(x, _mm256_srli_epi64(x, 28));
      x = _mm256_and_si256(
          _mm256_add_epi64(x, _mm256_slli_epi64(x, 31)), vm);
      _mm256_storeu_si256((__m256i*)out, x);
    };
    int64_t i = 0;
    uint64_t kf8[8], kr8[8], hf8[8], hr8[8];
    uint8_t vl8[8];
    while (i < n) {
      const int64_t blk = std::min<int64_t>(8, n - i);
      for (int64_t b = 0; b < blk; b++) {
        const uint8_t c = seq[i + b];
        if (c < 4) {
          fwd = ((fwd << 2) | c) & mask;
          rev = (rev >> 2) | (((uint64_t)(3 - c)) << shift_rev);
          valid_run++;
        } else { fwd = 0; rev = 0; valid_run = 0; }
        kf8[b] = fwd;
        kr8[b] = rev;
        vl8[b] = valid_run >= k;
      }
      hash4(kf8, hf8);
      hash4(kr8, hr8);
      if (blk > 4) { hash4(kf8 + 4, hf8 + 4); hash4(kr8 + 4, hr8 + 4); }
      for (int64_t b = 0; b < blk; b++) {
        const int64_t p = i + b - k + 1;
        if (p < 0) continue;
        uint64_t key = BIG;
        int8_t st = 0;
        if (vl8[b]) {
          if (hf8[b] < hr8[b]) { key = hf8[b]; st = 1; }
          else if (hr8[b] < hf8[b]) { key = hr8[b]; st = -1; }
        }
        consume(p, key, st);
      }
      i += blk;
    }
  }
#else
  for (int64_t i = 0; i < n; i++) {
    const uint8_t c = seq[i];
    if (c < 4) {
      fwd = ((fwd << 2) | c) & mask;
      rev = (rev >> 2) | (((uint64_t)(3 - c)) << shift_rev);
      valid_run++;
    } else { fwd = 0; rev = 0; valid_run = 0; }
    const int64_t p = i - k + 1;
    if (p < 0) continue;
    uint64_t key = BIG;
    int8_t st = 0;
    if (valid_run >= k) {
      const uint64_t hf = mm_hash64(fwd, mask);
      const uint64_t hr = mm_hash64(rev, mask);
      if (hf < hr) { key = hf; st = 1; }
      else if (hr < hf) { key = hr; st = -1; }
    }
    consume(p, key, st);
  }
#endif
  flush(true);
  return m;
}

extern "C" int64_t minimizer_sketch(
    const uint8_t* seq, int64_t n, int k, int w,
    int64_t* out_hash, int64_t* out_pos, int8_t* out_strand) {
  if (n < k) return 0;
  return minimizer_sketch_range(seq, n, k, w, 0, n, out_hash, out_pos,
                                out_strand);
}

// ---------------------------------------------------------------------------
// Full k=9 local harvest: exact k-mer table over reference windows
// (direct-addressed 4^k heads + chains), per-position scan of the read
// with guide-diagonal proximity filtering, and per-diagonal run merge.
// Mirrors ops/harvest.py::harvest_anchors exactly (which mirrors
// mammap_clrnano.py:23069-23345).
//
// windows: nw pairs (lo, hi) of global ref ranges.  guide arrays sorted
// by readpos.  out receives (readpos, refpos, strand, len) rows.
// ---------------------------------------------------------------------------

extern "C" int64_t harvest_join(
    const uint8_t* ref_codes, const int64_t* win_lo, const int64_t* win_hi,
    int64_t nw, const uint8_t* read_codes, int64_t read_len,
    int64_t readstart, int64_t readend,
    const int64_t* g_rp, const int64_t* g_ref, int64_t ng,
    int64_t k, int64_t* out, int64_t out_cap) {
  const int64_t K4 = 1ll << (2 * k);
  const uint64_t mask = K4 - 1;
  // --- build table over windows ---------------------------------------
  static thread_local std::vector<int32_t> head;
  static thread_local std::vector<int32_t> nxt;
  static thread_local std::vector<int64_t> pos_of;
  head.assign(K4, -1);
  nxt.clear();
  pos_of.clear();
  for (int64_t w = 0; w < nw; w++) {
    const int64_t lo = win_lo[w], hi = win_hi[w];
    uint64_t km = 0;
    int run = 0;
    for (int64_t i = lo; i < hi; i++) {
      const uint8_t c = ref_codes[i];
      if (c < 4) { km = ((km << 2) | c) & mask; run++; }
      else { km = 0; run = 0; }
      if (run >= k) {
        const int64_t p = i - k + 1;
        const int32_t id = (int32_t)pos_of.size();
        pos_of.push_back(p);
        nxt.push_back(head[km]);
        head[km] = id;
      }
    }
  }
  // chains list positions in REVERSE window order; reverse per-kmer at
  // consumption is unnecessary: downstream sorts by (diag, readpos)

  // per-strand hit buffers (sorted later)
  static thread_local std::vector<int64_t> h_r, h_y, h_d;

  auto flush_strand = [&](int64_t strand, int64_t& m) -> bool {
    // sort hits by (diag, readpos): hits are emitted in increasing
    // readpos order, so a STABLE counting sort on the (bounded) diagonal
    // gives the full (diag, readpos) order in O(n + range)
    const int64_t n = h_r.size();
    std::vector<int64_t> order(n);
    int64_t dmin = INT64_MAX, dmax = INT64_MIN;
    for (int64_t i = 0; i < n; i++) {
      dmin = std::min(dmin, h_d[i]);
      dmax = std::max(dmax, h_d[i]);
    }
    const int64_t range = (n > 0) ? (dmax - dmin + 1) : 0;
    if (n > 0 && range <= 4 * n + 1024) {
      static thread_local std::vector<int64_t> counts;
      counts.assign(range + 1, 0);
      for (int64_t i = 0; i < n; i++) counts[h_d[i] - dmin + 1]++;
      for (int64_t k2 = 1; k2 <= range; k2++) counts[k2] += counts[k2 - 1];
      for (int64_t i = 0; i < n; i++) order[counts[h_d[i] - dmin]++] = i;
    } else {
      for (int64_t i = 0; i < n; i++) order[i] = i;
      std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
        if (h_d[a] != h_d[b]) return h_d[a] < h_d[b];
        return h_r[a] < h_r[b];
      });
    }
    int64_t i = 0;
    auto emit = [&](int64_t r, int64_t y, int64_t l) -> bool {
      if (m >= out_cap) return false;
      out[m * 4 + 0] = r; out[m * 4 + 1] = y;
      out[m * 4 + 2] = strand; out[m * 4 + 3] = l;
      m++;
      return true;
    };
    while (i < n) {
      const int64_t d = h_d[order[i]];
      int64_t a_r = h_r[order[i]], a_y = h_y[order[i]], a_l = k;
      i++;
      while (i < n && h_d[order[i]] == d) {
        const int64_t r = h_r[order[i]], y = h_y[order[i]];
        i++;
        if (a_r + a_l >= r) {
          const int64_t bouns = r - (a_r + a_l) + k;
          if (bouns > 0) {
            if (a_l + bouns < 20) {
              if (strand == 1) a_l += bouns;
              else { a_y = y; a_l += bouns; }
            } else {
              if (!emit(a_r, a_y, a_l)) return false;
              if (strand == 1) { a_r += a_l; a_y += a_l; a_l = bouns; }
              else { a_r += a_l; a_y = y; a_l = bouns; }
            }
          }
        } else {
          if (!emit(a_r, a_y, a_l)) return false;
          a_r = r; a_y = y; a_l = k;
        }
      }
      if (!emit(a_r, a_y, a_l)) return false;
    }
    h_r.clear(); h_y.clear(); h_d.clear();
    return true;
  };

  // precompute the rolling kmer stream ONCE for both strands, so the
  // strand loops are pure probe loops that can prefetch the (1 MB,
  // random-access) head table a fixed distance ahead
  const int64_t span = readend - readstart;
  static thread_local std::vector<uint64_t> kf_arr, kr_arr;
  static thread_local std::vector<uint8_t> val_arr;
  kf_arr.resize(span);
  kr_arr.resize(span);
  val_arr.assign(span, 0);
  {
    uint64_t fwd = 0, rev = 0;
    int run = 0;
    const uint64_t shift_rev = 2 * (k - 1);
    for (int64_t i = readstart; i < readend + k - 1 && i < read_len; i++) {
      const uint8_t c = read_codes[i];
      if (c < 4) {
        fwd = ((fwd << 2) | c) & mask;
        rev = (rev >> 2) | (((uint64_t)(3 - c)) << shift_rev);
        run++;
      } else { fwd = rev = 0; run = 0; }
      const int64_t p = i - k + 1;
      if (p < readstart || p >= readend) continue;
      const int64_t s = p - readstart;
      val_arr[s] = (run >= k) && (fwd != rev);  // palindromes excluded
      kf_arr[s] = fwd;
      kr_arr[s] = rev;
    }
  }

  int64_t m = 0;
  const int64_t PD = 16;  // head-probe prefetch distance
  // one pass over the position stream probing BOTH strands: the stream
  // reads, loop bookkeeping, and the per-hit guide-proximity block are
  // shared (the two-pass version recomputed them per strand)
  static thread_local std::vector<int64_t> h_r2, h_y2, h_d2;
  h_r.clear(); h_y.clear(); h_d.clear();
  h_r2.clear(); h_y2.clear(); h_d2.clear();
  {
    int64_t gptr = 0;  // two-pointer lower bound into g_rp (p ascending)
    for (int64_t s = 0; s < span; s++) {
      if (s + PD < span && val_arr[s + PD]) {
        __builtin_prefetch(&head[kf_arr[s + PD]]);
        __builtin_prefetch(&head[kr_arr[s + PD]]);
      }
      if (!val_arr[s]) continue;
      const int32_t idf = head[kf_arr[s]];
      const int32_t idr = head[kr_arr[s]];
      if (idf < 0 && idr < 0) continue;
      const int64_t p = readstart + s;
      // guide proximity (findClosest_1 semantics); p is ascending, so
      // the lower bound advances monotonically — a two-pointer replaces
      // the per-hit binary search
      while (gptr < ng && g_rp[gptr] < p) gptr++;
      int64_t i1 = gptr;
      int64_t i0 = i1 > 0 ? i1 - 1 : 0;
      if (i1 >= ng) i1 = ng - 1;
      if (p <= g_rp[0]) { i0 = i1 = 0; }
      else if (p >= g_rp[ng - 1]) { i0 = i1 = ng - 1; }
      else if (g_rp[i1] == p) i0 = i1;
      const int64_t bias0 = std::llabs(g_rp[i0] - p);
      const int64_t bias1 = std::llabs(g_rp[i1] - p);
      const int64_t interval = std::min<int64_t>(bias0 + bias1 + 500, 2000);
      const int64_t ref0 = g_ref[i0], ref1 = g_ref[i1];
      const int64_t readgap = std::llabs(p - g_rp[i0]);
      for (int32_t id = idf; id >= 0; id = nxt[id]) {
        const int64_t refloc = pos_of[id];
        const int64_t refgap = std::llabs(refloc - ref0);
        const bool near =
            (std::llabs(readgap - refgap) < 500) ||
            (ref0 + interval >= refloc && ref0 - interval <= refloc) ||
            (ref1 + interval >= refloc && ref1 - interval <= refloc);
        if (!near) continue;
        h_r.push_back(p);
        h_y.push_back(refloc);
        h_d.push_back(refloc - p);
      }
      for (int32_t id = idr; id >= 0; id = nxt[id]) {
        const int64_t refloc = pos_of[id];
        const int64_t refgap = std::llabs(refloc - ref0);
        const bool near =
            (std::llabs(readgap - refgap) < 500) ||
            (ref0 + interval >= refloc && ref0 - interval <= refloc) ||
            (ref1 + interval >= refloc && ref1 - interval <= refloc);
        if (!near) continue;
        h_r2.push_back(p);
        h_y2.push_back(refloc);
        h_d2.push_back(-(refloc + p));
      }
    }
  }
  if (!flush_strand(1, m)) return -1;
  std::swap(h_r, h_r2); std::swap(h_y, h_y2); std::swap(h_d, h_d2);
  if (!flush_strand(-1, m)) return -1;
  return m;
}

// ---------------------------------------------------------------------------
// Bucketed-prune ("fast") chaining DP — the repeat-dense fallback.
//
// Exact transcription of ops/chain_ref.chain_dp_fast (itself mirroring the
// reference _d_fast_all, mammap_clrnano.py:25033): integer-quantized score
// buckets, each sorted by signed diagonal; buckets larger than fast_t test
// only the diagonal-nearest candidate (distance ties prefer the larger
// diagonal).  Supports all four variants incl. the refund ledger.
// ---------------------------------------------------------------------------

extern "C" int chain_dp_fast_native_warm(
    const int64_t* anchors, int64_t n,
    int kmersize, double skipcost, int maxdiff, int maxgap, int variant,
    const float* extra, int64_t extra_size, int64_t fast_t,
    double* S_out, int64_t* P_out,
    int64_t n_warm, const double* warm_S, const int64_t* warm_P) {
  if (n == 0) return 0;
  const bool use_cov = (variant == 0);  // 4 = global w/o repeat coverage
  // asm-mode DPs use the asm opposite-strand geometry (mammap_asm.py
  // fast DP refgap cases; same-strand forms are identical to clrnano)
  const bool asm_geo_v = (variant == 4);
  if (variant == 4) variant = 0;
  const bool local = (variant == 2 || variant == 3);
  const bool refund = (variant == 1);
  auto A = [&](int64_t i, int c) { return anchors[i * 4 + c]; };

  std::vector<double> gapcost_list(maxdiff + 1, 0.0);
  for (int g = 1; g <= maxdiff; g++) {
    double coef = (local && g > 10) ? 2.0 : 0.5;
    gapcost_list[g] = 0.01 * kmersize * g + coef * std::log2((double)g);
  }
  std::vector<double> readgapcost(100, 0.0);
  for (int g = 1; g < 100; g++) readgapcost[g] = (float)(0.1 * std::log2(g + 1.0));
  std::vector<double> lrg(maxgap + 1, 0.0);
  for (int g = 1; g <= maxgap; g++)
    lrg[g] = (float)((g >= 30) ? 0.5 * g : 0.1 * std::log2(g + 1.0));

  int64_t maxr = 0;
  for (int64_t i = 0; i < n; i++) maxr = std::max(maxr, A(i, 0));
  std::vector<int32_t> cov(maxr + 1, 0);
  if (use_cov)
    for (int64_t i = 0; i < n; i++) {
      int64_t r = A(i, 0);
      if (cov[r] < 20) cov[r]++;
    }

  const int64_t readlength = A(n - 1, 0) + 1000;
  std::vector<int64_t> target(n), barrier(n);
  for (int64_t i = 0; i < n; i++) {
    target[i] = (A(i, 2) == 1) ? (A(i, 1) - A(i, 0) + readlength)
                               : -(A(i, 1) + A(i, 0) + readlength);
    barrier[i] = A(i, 0) + (local ? A(i, 3) : 0);
  }

  std::vector<double> S(n, 0.0), fixed_pen, pre_pen;
  std::vector<int64_t> P(n, -1);
  if (refund) { fixed_pen.assign(n, 0.0); pre_pen.assign(n, 0.0); }

  // buckets[int score] -> (diag, idx) sorted ascending
  std::vector<std::vector<std::pair<int64_t, int64_t>>> bucket;
  auto ensure = [&](int64_t sc) {
    if ((int64_t)bucket.size() <= sc) bucket.resize(sc + 1);
  };
  int64_t max_score_i, inserted, prebarrier;
  if (n_warm > 0) {
    // streaming warm start (reference linked_..._d_fast_all,
    // mammap_asm.py:21872): carried frontier anchors enter the candidate
    // buckets with their rebased scores (integer-truncated for bucketing)
    // and pass-through predecessor codes; candidate set is complete
    // before the first new-batch anchor because batches advance in
    // readpos (new readpos > every frontier readpos).
    max_score_i = INT64_MIN;
    prebarrier = INT64_MIN;
    for (int64_t i = 0; i < n_warm; i++) {
      S[i] = warm_S[i];
      P[i] = warm_P[i];
      const int64_t si = (int64_t)warm_S[i];
      if (si >= 0) {  // frontier scores are +1000-rebased, always positive
        ensure(si);
        auto& bl = bucket[si];
        const std::pair<int64_t, int64_t> key{target[i], i};
        bl.insert(std::upper_bound(bl.begin(), bl.end(), key), key);
        if (si > max_score_i) max_score_i = si;
      }
      prebarrier = std::max(prebarrier, barrier[i]);
    }
    inserted = n_warm;
  } else {
    S[0] = (double)A(0, 3);
    int64_t s0 = (int64_t)S[0];
    ensure(s0);
    bucket[s0].push_back({target[0], 0});
    max_score_i = s0;
    inserted = 1;
    prebarrier = barrier[0];
  }
  double skip_c = skipcost + (use_cov ? cov[A(0, 0)] : 0);
  int mdiff_c = std::max(maxdiff - (int)(use_cov ? cov[A(0, 0)] : 0), 10);

  struct PairScore { double ts; bool col; int64_t bonus; };
  auto score_pair = [&](int64_t i, int64_t j) -> PairScore {
    const int64_t r_i = A(i, 0), y_i = A(i, 1), s_i = A(i, 2), l_i = A(i, 3);
    const int64_t r_j = A(j, 0), y_j = A(j, 1), s_j = A(j, 2), l_j = A(j, 3);
    int64_t readgap = r_i - r_j - l_j;
    int64_t bonus, refgap;
    const bool same = (s_i == s_j);
    if (readgap < 0) {
      bonus = r_i + l_i - r_j - l_j;
      if (local && bonus <= 0) return {-1e300, false, bonus};
      const int64_t overlap = r_j + l_j - r_i;
      readgap = 0;
      if (same)
        refgap = (s_i == 1) ? (y_i + overlap - (y_j + l_j)) : (y_j - (y_i + bonus));
      else if (asm_geo_v) {
        const int64_t nov = r_i - r_j;
        refgap = (s_j == -1) ? (y_i + l_j - nov - y_j)
                             : (y_i + l_i - y_j - nov);
      } else
        refgap = (s_j == -1) ? (y_i + overlap - y_j + 1)
                             : (y_i + bonus - 1 - (y_j + l_j));
    } else {
      bonus = l_i;
      if (same)
        refgap = (s_i == 1) ? (y_i - y_j - l_j) : (y_j - y_i - l_i);
      else if (asm_geo_v)
        refgap = (s_j == -1) ? (y_i - y_j) : (y_i + l_i - y_j - l_j);
      else
        refgap = (s_j == -1) ? (y_i - y_j + 1) : (y_i + l_i - 1 - y_j - l_j);
    }
    const int64_t gapcost = std::llabs(readgap - refgap);
    const bool colinear =
        same && refgap >= 0 && readgap <= maxgap && gapcost <= mdiff_c;
    double ts;
    if (colinear) {
      ts = S[j] + bonus - gapcost_list[gapcost];
      if (variant == 2) ts -= readgapcost[std::min<int64_t>(readgap, 99)];
      else if (variant == 3) ts -= lrg[std::min<int64_t>(readgap, maxgap)];
      else if (refund && fixed_pen[j] < 0 && fixed_pen[j] + bonus >= 0)
        ts += pre_pen[j];
    } else {
      const int64_t gc = std::min(gapcost, extra_size);
      if (variant == 0) ts = S[j] - skip_c + bonus - (double)extra[gc];
      else if (variant == 1) ts = S[j] + bonus - skip_c;
      else if (variant == 2)
        ts = S[j] + bonus -
             ((same ? skipcost : std::min(50.0, skipcost)) + (double)extra[gc]);
      else
        ts = S[j] + bonus -
             (skipcost + 0.5 * std::log2(
                              (double)std::min<int64_t>(gapcost, 99999) + 1.0));
    }
    return {ts, colinear, bonus};
  };

  for (int64_t i = (n_warm > 0 ? n_warm : 1); i < n; i++) {
    if (prebarrier < barrier[i]) {
      while (inserted < i) {
        const int64_t kk = inserted;
        const int64_t sk = (int64_t)S[kk];
        ensure(sk);
        auto& bl = bucket[sk];
        const std::pair<int64_t, int64_t> key{target[kk], kk};
        bl.insert(std::upper_bound(bl.begin(), bl.end(), key), key);
        if (sk > max_score_i) max_score_i = sk;
        inserted++;
      }
      if (use_cov) {
        skip_c = skipcost + cov[A(i, 0)];
        mdiff_c = std::max(maxdiff - (int)cov[A(i, 0)], 10);
      }
      prebarrier = barrier[i];
    }
    const int64_t l_i = A(i, 3);
    double max_scores = (double)l_i;
    int64_t pre_index = -1;
    bool win_col = false;
    int64_t win_bonus = 0;
    int64_t c = max_score_i;
    while ((double)c > max_scores - (double)(l_i + 1)) {
      if (c >= 0 && c < (int64_t)bucket.size() && !bucket[c].empty()) {
        auto& bl = bucket[c];
        if ((int64_t)bl.size() > fast_t) {
          // diagonal-nearest; distance ties prefer the larger diagonal
          const int64_t t = target[i];
          auto it = std::lower_bound(
              bl.begin(), bl.end(), std::pair<int64_t, int64_t>{t, -1});
          int64_t best_j = -1;
          int64_t best_d = INT64_MAX;
          int64_t best_diag = INT64_MIN;
          auto consider = [&](const std::pair<int64_t, int64_t>& e) {
            const int64_t d = std::llabs(e.first - t);
            const bool better =
                d < best_d || (d == best_d && e.first > best_diag);
            if (better) { best_d = d; best_diag = e.first; best_j = e.second; }
          };
          if (it != bl.end()) consider(*it);
          if (it != bl.begin()) consider(*std::prev(it));
          if (best_j >= 0) {
            const PairScore ps = score_pair(i, best_j);
            if (ps.ts > max_scores) {
              max_scores = ps.ts; pre_index = best_j;
              win_col = ps.col; win_bonus = ps.bonus;
            }
          }
        } else {
          for (auto it = bl.rbegin(); it != bl.rend(); ++it) {
            const PairScore ps = score_pair(i, it->second);
            if (ps.ts > max_scores) {
              max_scores = ps.ts; pre_index = it->second;
              win_col = ps.col; win_bonus = ps.bonus;
            }
          }
        }
      }
      c--;
    }
    S[i] = max_scores;
    P[i] = pre_index;
    if (refund && pre_index >= 0) {
      const int64_t j = pre_index;
      if (win_col) {
        if (fixed_pen[j] < 0 && fixed_pen[j] + win_bonus < 0) {
          fixed_pen[i] = fixed_pen[j] + win_bonus;
          pre_pen[i] = pre_pen[j];
        }
      } else {
        fixed_pen[i] = -skip_c + win_bonus;
        pre_pen[i] = skip_c;
      }
    }
  }
  for (int64_t i = 0; i < n; i++) { S_out[i] = S[i]; P_out[i] = P[i]; }
  return 0;
}

extern "C" int chain_dp_fast_native(
    const int64_t* anchors, int64_t n,
    int kmersize, double skipcost, int maxdiff, int maxgap, int variant,
    const float* extra, int64_t extra_size, int64_t fast_t,
    double* S_out, int64_t* P_out) {
  return chain_dp_fast_native_warm(anchors, n, kmersize, skipcost, maxdiff,
                                   maxgap, variant, extra, extra_size, fast_t,
                                   S_out, P_out, 0, nullptr, nullptr);
}

// ---------------------------------------------------------------------------
// Batched global alignment: all of a read's inter-anchor gap pairs in one
// call (amortizes binding overhead; scratch shared across pairs).
// Layout: seqs = concatenated target/query codes with per-pair offsets;
// out_ops shared, per-pair [ops_off, n_ops] written to ops_meta.
// ---------------------------------------------------------------------------

// ---------------------------------------------------------------------------
// Multi-path chain backtrack (pipeline/chaining._backtrack_all; reference
// hit2work_1 :23588-23640): walk the best path from g_max, then disjoint
// suffix paths in the given start order, deducting the joined prefix
// score when a walk hits a used anchor.  Returns the path count.
// ---------------------------------------------------------------------------

extern "C" int64_t backtrack_all_native(
    const double* S, const int64_t* P, int64_t n, int64_t g_max,
    const int64_t* order, int64_t n_order, double min_score,
    int64_t* out_idx, int64_t* out_path_off, double* out_scores,
    double* out_sarr, int64_t max_paths) {
  if (n == 0 || g_max < 0) return 0;
  std::vector<uint8_t> used(n, 0);
  int64_t w = 0;        // cursor into out_idx
  int64_t n_paths = 0;
  auto walk = [&](int64_t start, bool record_sarr) -> double {
    double score = S[start];
    int64_t take = start;
    for (;;) {
      out_idx[w] = take;
      if (record_sarr) out_sarr[w - out_path_off[n_paths]] = S[take];
      w++;
      used[take] = 1;
      const int64_t p = P[take];
      if (p < 0) break;
      if (used[p]) { score -= S[p]; break; }
      take = p;
    }
    return score;
  };
  out_path_off[0] = 0;
  const double best = walk(g_max, true);
  if (!(best > min_score)) return 0;
  out_scores[n_paths++] = best;
  out_path_off[n_paths] = w;
  for (int64_t k = 0; k < n_order && n_paths < max_paths; k++) {
    const int64_t start = order[k];
    if (used[start]) continue;
    const int64_t w0 = w;
    const double sc = walk(start, false);
    if (sc > min_score) {
      out_scores[n_paths++] = sc;
      out_path_off[n_paths] = w;
    } else {
      w = w0;  // roll the indices back (anchors stay marked used, like
               // the python version which marks during the walk)
      out_path_off[n_paths] = w;
    }
  }
  return n_paths;
}

// ---------------------------------------------------------------------------
// Chain-break segmentation (pipeline/extend.rebuild_chain_break; reference
// rebuild_chain_break, mammap_clrnano.py:23437-23484): split an ascending
// chain path into colinear segments, dropping one-anchor and sub-50bp
// segments and skipping small duplication-overlap anchors.  seg_id_out
// gets the segment index per anchor (-1 = dropped); returns n_segments.
// ---------------------------------------------------------------------------

extern "C" int64_t rebuild_chain_break_native(
    const int64_t* path /* (n,4) */, int64_t n,
    const int64_t* starts, int64_t n_contigs,
    int64_t large_cost, int64_t small_alignment, int32_t allow_dup_overlap,
    int32_t* seg_id_out) {
  // allow_dup_overlap=1: clrnano rule (refgap >= -20 with the readgap<=20
  // skip); 0: the asm module's plain refgap >= 0 accept (mammap_asm.py
  // live rebuild_chain_break)
  const int64_t refgap_floor = allow_dup_overlap ? -20 : 0;
  if (n == 0) return 0;
  auto A = [&](int64_t i, int c) { return path[i * 4 + c]; };
  auto contig_of = [&](int64_t pos) {
    int64_t lo = 0, hi = n_contigs;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (starts[mid] <= pos) lo = mid + 1; else hi = mid;
    }
    return lo > 0 ? lo - 1 : 0;
  };
  for (int64_t i = 0; i < n; i++) seg_id_out[i] = -1;
  // python semantics exactly, including the pop cascade at breaks (a
  // popped 1-anchor segment exposes the PREVIOUS segment to the span
  // check): keep a real segment stack
  std::vector<std::vector<int64_t>> segs;
  auto span_small = [&](const std::vector<int64_t>& m) {
    const int64_t f = m.front(), l = m.back();
    return (A(l, 0) + A(l, 3) - A(f, 0)) < small_alignment;
  };
  auto break_pops = [&]() {
    if (!segs.empty() && segs.back().size() == 1) segs.pop_back();
    if (!segs.empty() && span_small(segs.back())) segs.pop_back();
  };
  segs.push_back({0});
  int64_t pre = 0;
  int64_t pre_cid = contig_of(A(0, 1));
  for (int64_t i = 1; i < n; i++) {
    const int64_t now_cid = contig_of(A(i, 1));
    if (A(pre, 2) == A(i, 2)) {
      const int64_t readgap = A(i, 0) - A(pre, 0) - A(pre, 3);
      const int64_t refgap = (A(pre, 2) == 1)
          ? A(i, 1) - A(pre, 1) - A(pre, 3)
          : A(pre, 1) - A(i, 1) - A(i, 3);
      if (std::llabs(readgap - refgap) <= large_cost &&
          refgap >= refgap_floor && readgap < 100 && pre_cid == now_cid) {
        if (refgap >= 0 || readgap > 20) {
          segs.back().push_back(i);
          pre = i; pre_cid = now_cid;
          continue;
        }
        // small duplication overlap: skip the anchor entirely
        continue;
      }
    }
    break_pops();
    segs.push_back({i});
    pre = i; pre_cid = now_cid;
  }
  break_pops();
  int32_t seg_id = 0;
  for (const auto& m : segs) {
    for (const int64_t i : m) seg_id_out[i] = seg_id;
    seg_id++;
  }
  return seg_id;
}

// ---------------------------------------------------------------------------
// Predecessor-chain follow for the DP backtracks (chain_local's path
// gather): out gets start, P[start], P[P[start]], ... until -1.  Returns
// the path length, or -1 on a bad index / cycle (caller falls back to the
// Python follow).  Avoids materializing P.tolist() per read.
// ---------------------------------------------------------------------------

extern "C" int64_t backtrack_follow(const int64_t* P, int64_t n,
                                    int64_t start, int64_t* out) {
  if (start < 0 || start >= n) return -1;
  int64_t m = 0, take = start;
  out[m++] = take;
  while (P[take] >= 0) {
    if (m >= n) return -1;  // cycle guard (predecessors strictly decrease)
    take = P[take];
    if (take >= n) return -1;
    out[m++] = take;
  }
  return m;
}

// ---------------------------------------------------------------------------
// kseq-style FASTA/FASTQ reader (plain or gzip via zlib gzFile) — the
// native data loader matching the reference's C `mp.fastx_read`
// (vacmap:445).  Records are packed into a caller buffer per chunk:
// per record 5 int64 offsets (name, comment, seq, qual, end) into the
// char buffer; fields are NUL-free slices (comment/qual may be empty).
// ---------------------------------------------------------------------------

#include <zlib.h>
#include <string>
#include <cstring>

struct FastxHandle {
  gzFile f = nullptr;     // gzip path
  FILE* pf = nullptr;     // plain path (gzFile caps plain reads ~100MB/s)
  std::vector<char> buf;  // raw read buffer
  int64_t pos = 0, len = 0;
  bool eof = false;
  // a record parsed but not yet emitted (chunk buffer was full)
  bool pending = false;
  std::string p_name, p_comment, p_seq, p_qual;
};

static bool fx_fill(FastxHandle* h) {
  if (h->pos < h->len) return true;
  if (h->eof) return false;
  if (h->pf)
    h->len = (int64_t)fread(h->buf.data(), 1, h->buf.size(), h->pf);
  else
    h->len = gzread(h->f, h->buf.data(), (unsigned)h->buf.size());
  h->pos = 0;
  if (h->len <= 0) { h->eof = true; return false; }
  return true;
}

// append the next line (without newline / trailing CR) to out via
// memchr over the buffered data; returns false at EOF with nothing read
static bool fx_read_line(FastxHandle* h, std::string& out) {
  bool any = false;
  for (;;) {
    if (!fx_fill(h)) break;
    const char* base = h->buf.data() + h->pos;
    const int64_t avail = h->len - h->pos;
    const char* nl = (const char*)memchr(base, '\n', (size_t)avail);
    if (nl == nullptr) {
      out.append(base, (size_t)avail);
      h->pos = h->len;
      any = true;
      continue;
    }
    out.append(base, (size_t)(nl - base));
    h->pos += (nl - base) + 1;
    any = true;
    break;
  }
  if (any && !out.empty() && out.back() == '\r') out.pop_back();
  return any || !out.empty();
}

// peek the first character of the next non-empty line (-1 at EOF)
static int fx_peek(FastxHandle* h) {
  for (;;) {
    if (!fx_fill(h)) return -1;
    const char c = h->buf[h->pos];
    if (c == '\n' || c == '\r' || c == ' ') { h->pos++; continue; }
    return (unsigned char)c;
  }
}

extern "C" void* fastx_open(const char* path, int64_t bufsize) {
  FILE* pf = fopen(path, "rb");
  if (!pf) return nullptr;
  unsigned char magic[2] = {0, 0};
  const size_t got = fread(magic, 1, 2, pf);
  auto* h = new FastxHandle();
  h->buf.resize(bufsize > 0 ? bufsize : (1 << 20));
  if (got == 2 && magic[0] == 0x1f && magic[1] == 0x8b) {
    fclose(pf);
    h->f = gzopen(path, "rb");
    if (!h->f) { delete h; return nullptr; }
    gzbuffer(h->f, 1 << 20);
  } else {
    rewind(pf);
    h->pf = pf;
  }
  return h;
}

extern "C" void fastx_close(void* hp) {
  auto* h = (FastxHandle*)hp;
  if (!h) return;
  if (h->pf) fclose(h->pf);
  if (h->f) gzclose(h->f);
  delete h;
}

// Fills out_chars (cap chars) and out_offs (max_recs * 5 int64).
// Returns number of records, 0 at EOF, -1 on malformed input, -2 when
// the next record would overflow the buffers (caller grows and retries).
extern "C" int64_t fastx_read_chunk(void* hp, char* out_chars, int64_t cap,
                                    int64_t* out_offs, int64_t max_recs) {
  auto* h = (FastxHandle*)hp;
  int64_t n = 0, w = 0;
  std::string& name = h->p_name;
  std::string& comment = h->p_comment;
  std::string& seq = h->p_seq;
  std::string& qual = h->p_qual;
  static thread_local std::string line;
  while (n < max_recs) {
    if (!h->pending) {
      const int c = fx_peek(h);
      if (c < 0) break;
      if (c != '>' && c != '@') return -1;
      const bool fastq = (c == '@');
      h->pos++;  // consume the marker
      name.clear(); comment.clear(); seq.clear(); qual.clear();
      line.clear();
      if (!fx_read_line(h, line)) break;
      // split header at the first space/tab
      size_t sp = line.find_first_of(" \t");
      if (sp == std::string::npos) {
        name = line;
      } else {
        name.assign(line, 0, sp);
        comment.assign(line, sp + 1, std::string::npos);
      }
      if (fastq) {
        line.clear();
        if (fx_read_line(h, line)) seq = line;
        line.clear();
        fx_read_line(h, line);  // '+' separator line
        while (qual.size() < seq.size()) {
          line.clear();
          if (!fx_read_line(h, line)) break;
          qual += line;
        }
      } else {
        for (;;) {
          const int c2 = fx_peek(h);
          if (c2 < 0 || c2 == '>') break;
          line.clear();
          if (!fx_read_line(h, line)) break;
          seq += line;
        }
      }
    }
    const int64_t need = (int64_t)(name.size() + comment.size() +
                                   seq.size() + qual.size());
    if (w + need > cap) {
      h->pending = true;      // emit this record on the next call
      if (n == 0) return -2;  // caller grows the buffer and retries
      break;
    }
    h->pending = false;
    int64_t* o = out_offs + n * 5;
    o[0] = w; memcpy(out_chars + w, name.data(), name.size()); w += name.size();
    o[1] = w; memcpy(out_chars + w, comment.data(), comment.size()); w += comment.size();
    o[2] = w; memcpy(out_chars + w, seq.data(), seq.size()); w += seq.size();
    o[3] = w; memcpy(out_chars + w, qual.data(), qual.size()); w += qual.size();
    o[4] = w;
    n++;
  }
  return n;
}

// ---------------------------------------------------------------------------
// Sorted-hash range lookup with a 16-bit prefix bucket table: the seeding
// hot loop's searchsorted over the (tens-of-MB) minimizer table is cache-
// miss bound; bucketing by the top bits keeps the final probes local.
// pstarts has 65537 entries: bucket p covers table[pstarts[p], pstarts[p+1]).
// ---------------------------------------------------------------------------

template <typename T>
static inline void lookup_ranges(const T* table, const int64_t* pstarts,
                                 int shift, const T* q, int64_t m,
                                 int64_t* lo_out, int64_t* hi_out) {
  if (m < 64) {  // small batches: the plain serial search
    for (int64_t i = 0; i < m; i++) {
      const T h = q[i];
      const uint64_t p = (uint64_t)h >> shift;
      int64_t a = pstarts[p], b = pstarts[p + 1];
      while (a < b) {
        const int64_t mid = (a + b) >> 1;
        if (table[mid] < h) a = mid + 1; else b = mid;
      }
      lo_out[i] = a;
      b = pstarts[p + 1];
      while (a < b) {
        const int64_t mid = (a + b) >> 1;
        if (table[mid] <= h) a = mid + 1; else b = mid;
      }
      hi_out[i] = a;
    }
    return;
  }
  // level-synchronous batched binary search: each query's probe chain is
  // serially dependent, but ACROSS queries the probes are independent —
  // running one level for all queries per pass (prefetching a fixed
  // distance ahead) overlaps the cache misses that dominate lookups
  // into a genome-scale table.
  static thread_local std::vector<int64_t> A, Bv;
  A.resize(m);
  Bv.resize(m);
  const int64_t D = 16;  // prefetch distance (queries ahead)
  for (int64_t i = 0; i < m; i++) {
    const uint64_t p = (uint64_t)q[i] >> shift;
    A[i] = pstarts[p];
    Bv[i] = pstarts[p + 1];
  }
  bool any = true;
  while (any) {
    any = false;
    for (int64_t i = 0; i < m; i++) {
      if (i + D < m && A[i + D] < Bv[i + D])
        __builtin_prefetch(&table[(A[i + D] + Bv[i + D]) >> 1]);
      if (A[i] >= Bv[i]) continue;
      const int64_t mid = (A[i] + Bv[i]) >> 1;
      if (table[mid] < q[i]) A[i] = mid + 1; else Bv[i] = mid;
      any = true;
    }
  }
  for (int64_t i = 0; i < m; i++) lo_out[i] = A[i];
  // upper bound: forward equality scan from the (cache-hot) lower bound —
  // occurrence runs are nearly always short; long runs fall back to a
  // binary search over the remainder of the bucket
  static thread_local std::vector<int64_t> longi;
  longi.clear();
  for (int64_t i = 0; i < m; i++) {
    const uint64_t p = (uint64_t)q[i] >> shift;
    const int64_t bend = pstarts[p + 1];
    int64_t j = A[i];
    const int64_t scan_end = std::min(bend, j + 16);
    while (j < scan_end && table[j] == q[i]) j++;
    if (j == scan_end && j < bend && table[j] == q[i]) {
      longi.push_back(i);
      Bv[i] = bend;
    }
    A[i] = j;
  }
  any = !longi.empty();
  while (any) {
    any = false;
    for (int64_t t = 0; t < (int64_t)longi.size(); t++) {
      const int64_t i = longi[t];
      if (t + D < (int64_t)longi.size() &&
          A[longi[t + D]] < Bv[longi[t + D]])
        __builtin_prefetch(&table[(A[longi[t + D]] + Bv[longi[t + D]]) >> 1]);
      if (A[i] >= Bv[i]) continue;
      const int64_t mid = (A[i] + Bv[i]) >> 1;
      if (table[mid] <= q[i]) A[i] = mid + 1; else Bv[i] = mid;
      any = true;
    }
  }
  for (int64_t i = 0; i < m; i++) hi_out[i] = A[i];
}

extern "C" void hash_lookup_ranges_u32(
    const uint32_t* table, const int64_t* pstarts, int shift,
    const uint32_t* q, int64_t m, int64_t* lo_out, int64_t* hi_out) {
  lookup_ranges(table, pstarts, shift, q, m, lo_out, hi_out);
}

extern "C" void hash_lookup_ranges_i64(
    const int64_t* table, const int64_t* pstarts, int shift,
    const int64_t* q, int64_t m, int64_t* lo_out, int64_t* hi_out) {
  lookup_ranges(table, pstarts, shift, q, m, lo_out, hi_out);
}

// ---------------------------------------------------------------------------
// CIGAR string utilities (host SAM layer): ASCII emission from op arrays,
// one-pass merge + NM + =/X->M collapse (pipeline/sam.merge_nm_collapse),
// and query-span accounting.  Counterpart of the reference's mergecigar_n
// and nm_from_cigar (mammap_clrnano.py:5425; output_functions.py:300).
// ---------------------------------------------------------------------------

static const char OPCHARS[5] = {'M', 'I', 'D', '=', 'X'};

static inline char* put_run(char* w, int64_t ln, char op) {
  char tmp[20];
  int t = 0;
  if (ln == 0) tmp[t++] = '0';
  while (ln > 0) { tmp[t++] = (char)('0' + ln % 10); ln /= 10; }
  while (t > 0) *w++ = tmp[--t];
  *w++ = op;
  return w;
}

// ops: (n,2) int32 (opcode, len) with opcodes indexing OPCHARS.
extern "C" int64_t ops_to_cigar_ascii(const int32_t* ops, int64_t n,
                                      char* out, int64_t cap) {
  char* w = out;
  for (int64_t i = 0; i < n; i++) {
    if (w - out + 24 > cap) return -1;
    w = put_run(w, ops[i * 2 + 1], OPCHARS[ops[i * 2]]);
  }
  return w - out;
}

// Batched variant over one ops plane: meta rows are (row_offset, n_ops)
// into `ops` (the align2p_batch_native output layout).  All cigars are
// emitted back-to-back into `out`; ends[i] is the exclusive end offset of
// item i.  Returns total bytes or -1 on overflow.  One ctypes call
// replaces ~1k per-item calls per fill batch.
extern "C" int64_t ops_to_cigar_ascii_batch(
    const int32_t* ops, const int64_t* meta, int64_t n_items,
    char* out, int64_t cap, int64_t* ends) {
  char* w = out;
  for (int64_t i = 0; i < n_items; i++) {
    const int32_t* o = ops + meta[i * 2] * 2;
    const int64_t m = meta[i * 2 + 1];
    if ((w - out) + 24 * m > cap) return -1;
    for (int64_t j = 0; j < m; j++)
      w = put_run(w, o[j * 2 + 1], OPCHARS[o[j * 2]]);
    ends[i] = w - out;
  }
  return w - out;
}

// One pass over an ASCII cigar: merged cigar, merged-op count, NM
// (X+I+D; -1 when M runs are present), =/X->M collapsed cigar and its op
// count.  Returns 0 or -1 on overflow/parse error.
extern "C" int cigar_finish(
    const char* cig, int64_t len, int collapse,
    char* out_merged, int64_t merged_cap, int64_t* merged_len,
    char* out_collapsed, int64_t collapsed_cap, int64_t* collapsed_len,
    int64_t* n_runs_merged, int64_t* n_runs_collapsed, int64_t* nm_out) {
  int64_t nm = 0;
  bool has_m = false;
  char* wm = out_merged;
  char* wc = out_collapsed;
  int64_t runs_m = 0, runs_c = 0;
  char pre_m = 0, pre_c = 0;
  int64_t acc_m = 0, acc_c = 0;
  const char* p = cig;
  const char* end = cig + len;
  while (p < end) {
    int64_t ln = 0;
    if (*p < '0' || *p > '9') return -1;
    while (p < end && *p >= '0' && *p <= '9') ln = ln * 10 + (*p++ - '0');
    if (p >= end) return -1;
    const char op = *p++;
    if (op == 'M') has_m = true;
    else if (op == 'X' || op == 'I' || op == 'D') nm += ln;
    if (op == pre_m) acc_m += ln;
    else {
      if (pre_m) {
        if (wm - out_merged + 24 > merged_cap) return -1;
        wm = put_run(wm, acc_m, pre_m); runs_m++;
      }
      pre_m = op; acc_m = ln;
    }
    if (collapse) {
      const char cop = (op == '=' || op == 'X') ? 'M' : op;
      if (cop == pre_c) acc_c += ln;
      else {
        if (pre_c) {
          if (wc - out_collapsed + 24 > collapsed_cap) return -1;
          wc = put_run(wc, acc_c, pre_c); runs_c++;
        }
        pre_c = cop; acc_c = ln;
      }
    }
  }
  if (pre_m) {
    if (wm - out_merged + 24 > merged_cap) return -1;
    wm = put_run(wm, acc_m, pre_m); runs_m++;
  }
  if (collapse && pre_c) {
    if (wc - out_collapsed + 24 > collapsed_cap) return -1;
    wc = put_run(wc, acc_c, pre_c); runs_c++;
  }
  *merged_len = wm - out_merged;
  *collapsed_len = wc - out_collapsed;
  *n_runs_merged = runs_m;
  *n_runs_collapsed = runs_c;
  *nm_out = has_m ? -1 : nm;
  return 0;
}

// ---------------------------------------------------------------------------
// Decode the device traceback op streams (ops/affine_pallas.py): packed
// (S4, B) bytes hold 2-bit codes per step (0=M 1=I 2=D 3=done), emitted
// path-end-first.  Emits merged (op, len) int32 pairs per job, with =/X
// expansion against the sequences when eqx != 0.
// ---------------------------------------------------------------------------

extern "C" int decode_tb_ops_batch(
    const uint8_t* packed, int64_t S4, int64_t B, int64_t n_jobs,
    const uint8_t* seqs, const int64_t* t_off, const int64_t* t_len,
    const int64_t* q_off, const int64_t* q_len, int eqx,
    int32_t* out_ops, int64_t ops_cap, int64_t* ops_meta /* (n,2) */) {
  int64_t cursor = 0;
  static thread_local std::vector<uint8_t> stream;
  for (int64_t b = 0; b < n_jobs; b++) {
    // collect this job's codes in forward (alignment) order
    stream.clear();
    for (int64_t g = S4 - 1; g >= 0; g--) {
      const uint8_t byte = packed[g * B + b];
      for (int k = 3; k >= 0; k--) {
        const uint8_t c = (byte >> (2 * k)) & 3;
        if (c != 3) stream.push_back(c);
      }
    }
    const uint8_t* t = seqs + t_off[b];
    const uint8_t* q = seqs + q_off[b];
    int64_t i = 0, j = 0;
    int64_t k = 0;
    int32_t pre_op = -1;
    int64_t acc = 0;
    auto flush = [&]() -> bool {
      if (pre_op >= 0 && acc > 0) {
        if (k >= ops_cap - cursor) return false;
        out_ops[(cursor + k) * 2] = pre_op;
        out_ops[(cursor + k) * 2 + 1] = (int32_t)acc;
        k++;
      }
      return true;
    };
    for (const uint8_t c : stream) {
      int32_t op;
      if (c == 0) {
        op = eqx ? ((t[i] == q[j] && t[i] < 4) ? 3 : 4) : 0;
        i++; j++;
      } else if (c == 1) {
        op = 1; j++;
      } else {
        op = 2; i++;
      }
      if (op == pre_op) acc++;
      else {
        if (!flush()) return -2;
        pre_op = op; acc = 1;
      }
    }
    if (!flush()) return -2;
    // sanity: the walk must consume exactly the sequences
    if (i != t_len[b] || j != q_len[b]) return -3;
    ops_meta[b * 2] = cursor;
    ops_meta[b * 2 + 1] = k;
    cursor += k;
  }
  return 0;
}

// Decode the device fill kernel's row-run traceback planes
// (ops/affine_pallas.py _fill_tb_kernel): per job, lane l holds matrix
// row l+1 with lo = n_ins & 255 and ex = is_diag | (n_ins >> 8 << 1).
// Forward-order ops: I x j0, then for r = 1..t_len: exit(r), I x n(r).
extern "C" int decode_rowruns_batch(
    const uint8_t* lo, const uint8_t* ex, int64_t N, int64_t n_jobs,
    const uint8_t* seqs, const int64_t* t_off, const int64_t* t_len,
    const int64_t* q_off, const int64_t* q_len, int eqx,
    int32_t* out_ops, int64_t ops_cap, int64_t* ops_meta /* (n,2) */) {
  int64_t cursor = 0;
  for (int64_t b = 0; b < n_jobs; b++) {
    const uint8_t* lo_r = lo + b * N;
    const uint8_t* ex_r = ex + b * N;
    const int64_t tl = t_len[b];
    if (tl > N) return -4;
    const uint8_t* t = seqs + t_off[b];
    const uint8_t* q = seqs + q_off[b];
    int64_t tot_i = 0, n_m = 0;
    for (int64_t r = 0; r < tl; r++) {
      tot_i += (int64_t)lo_r[r] | (((int64_t)(ex_r[r] >> 1) & 1) << 8);
      n_m += ex_r[r] & 1;
    }
    const int64_t j0 = q_len[b] - tot_i - n_m;
    if (j0 < 0) return -3;
    int64_t i = 0, j = 0, k = 0;
    int32_t pre_op = -1;
    int64_t acc = 0;
    auto flush = [&]() -> bool {
      if (pre_op >= 0 && acc > 0) {
        if (k >= ops_cap - cursor) return false;
        out_ops[(cursor + k) * 2] = pre_op;
        out_ops[(cursor + k) * 2 + 1] = (int32_t)acc;
        k++;
      }
      return true;
    };
    auto emit = [&](int32_t op, int64_t n) -> bool {
      if (n <= 0) return true;
      if (op == pre_op) { acc += n; return true; }
      if (!flush()) return false;
      pre_op = op; acc = n;
      return true;
    };
    if (!emit(1, j0)) return -2;
    j += j0;
    for (int64_t r = 0; r < tl; r++) {
      if (ex_r[r] & 1) {  // diag
        if (eqx) {
          const int32_t op = (t[i] == q[j] && t[i] < 4) ? 3 : 4;
          if (!emit(op, 1)) return -2;
        } else {
          if (!emit(0, 1)) return -2;
        }
        i++; j++;
      } else {  // del
        if (!emit(2, 1)) return -2;
        i++;
      }
      const int64_t n = (int64_t)lo_r[r] | (((int64_t)(ex_r[r] >> 1) & 1) << 8);
      if (!emit(1, n)) return -2;
      j += n;
    }
    if (!flush()) return -2;
    if (i != tl || j != q_len[b]) return -3;
    ops_meta[b * 2] = cursor;
    ops_meta[b * 2 + 1] = k;
    cursor += k;
  }
  return 0;
}

// query span of a cigar: consumed query bases (M/I/=/X, plus S/H when
// with_clips).  Returns -1 on parse error.
extern "C" int64_t cigar_qspan(const char* cig, int64_t len, int with_clips) {
  int64_t span = 0;
  const char* p = cig;
  const char* end = cig + len;
  while (p < end) {
    int64_t ln = 0;
    if (*p < '0' || *p > '9') return -1;
    while (p < end && *p >= '0' && *p <= '9') ln = ln * 10 + (*p++ - '0');
    if (p >= end) return -1;
    const char op = *p++;
    if (op == 'M' || op == 'I' || op == '=' || op == 'X') span += ln;
    else if ((op == 'S' || op == 'H') && with_clips) span += ln;
  }
  return span;
}

#if defined(__AVX2__)
// ---------------------------------------------------------------------------
// 16-lane inter-sequence striped two-piece affine global DP (int16 AVX2).
// Each SIMD lane aligns a DIFFERENT (target, query) pair over the FULL
// matrix — exact bw=-1 (k_cigar global) semantics, tie-breaking identical
// to align2p_native_eqx / ops/affine_ref.py.  Traceback bits are packed
// per cell (16 lanes -> 16 bytes) and walked per lane on completion.
// ---------------------------------------------------------------------------

static const int16_t SNEG16 = -30000;

// state-machine traceback for one stripe lane (same rules as the scalar
// banded path: op 0=DIAG 1=E1 2=E2 3=F1 4=F2; ext flags 8/16/32/64)
static int stripe_traceback(
    const uint8_t* bits, int64_t Qmax, int lane,
    const uint8_t* target, int64_t T, const uint8_t* query, int64_t Q,
    int eqx, int32_t* out_ops, int64_t max_ops, int64_t* n_ops,
    int64_t R = -1, int64_t dlo = 0, int64_t dhi = 0, int64_t Wb = -1) {
  if (Wb < 0) Wb = Qmax;  // full-width row stride
  // R >= 0: the fill ran a shared band of radius R around the stripe
  // diagonal c(i) = i*Qmax/Tmax.  Bits outside the band are stale, and a
  // path touching a clipped band edge may be band-limited — return 2 so
  // the caller redoes the job full-width (same escalate-on-edge-touch
  // convention as the scalar banded path above, fuzz-verified there).
  int64_t i = T, j = Q;
  int state = 0;
  static thread_local std::vector<std::pair<int, int64_t>> rev;
  rev.clear();
  auto push = [&](int op, int64_t len) {
    if (!rev.empty() && rev.back().first == op) rev.back().second += len;
    else rev.push_back({op, len});
  };
  while (i > 0 || j > 0) {
    if (i == 0) { push(1, j); break; }
    if (j == 0) { push(2, i); break; }
    int64_t off = j - 1;  // full-width: plain column index
    if (R >= 0) {
      // offset-space band (same geometry as the scalar banded path):
      // j in [i + dlo, i + dhi], stride-anchored at i + dlo
      const int64_t jlo = (i + dlo < 1) ? 1 : i + dlo;
      const int64_t jhi = (i + dhi > Qmax) ? Qmax : i + dhi;
      if (j < jlo || j > jhi) return 2;
      if ((j == jlo && jlo > 1) || (j == jhi && jhi < Q)) return 2;
      off = j - (i + dlo);
    }
    const uint8_t b = bits[(((size_t)(i - 1) * Wb) + off) * 16 + lane];
    if (state == 0) {
      const int op = b & 7;
      if (op == 0) {
        if (eqx) {
          const bool eq = (target[i - 1] == query[j - 1] && target[i - 1] < 4);
          push(eq ? 3 : 4, 1);
        } else {
          push(0, 1);
        }
        i--; j--;
      }
      else if (op == 1) state = 1;
      else if (op == 2) state = 2;
      else if (op == 3) state = 3;
      else state = 4;
    } else if (state == 1 || state == 2) {
      push(2, 1);
      const bool ext = b & (state == 1 ? 8 : 16);
      i--;
      if (!ext) state = 0;
    } else {
      push(1, 1);
      const bool ext = b & (state == 3 ? 32 : 64);
      j--;
      if (!ext) state = 0;
    }
  }
  int64_t k = 0;
  for (auto it = rev.rbegin(); it != rev.rend(); ++it) {
    if (k >= max_ops) return -2;
    out_ops[k * 2] = it->first;
    out_ops[k * 2 + 1] = (int32_t)it->second;
    k++;
  }
  *n_ops = k;
  return 0;
}

// Run one stripe of up to 16 jobs.  jobs[l] indexes the batch arrays;
// n_jobs <= 16 (missing lanes run a 1x1 dummy).
static double g_t_prep = 0, g_t_sweep = 0, g_t_tb = 0;
static int64_t g_cells = 0;
static int64_t g_groups = 0, g_spread = 0, g_tsum = 0, g_lane_cells = 0;

static inline double now_s() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

static int run_stripe16(
    const uint8_t* seqs, const int64_t* t_off, const int64_t* t_len,
    const int64_t* q_off, const int64_t* q_len,
    const int64_t* jobs, int n_jobs,
    int match, int mismatch, int o1, int e1, int o2, int e2, int eqx,
    int32_t* out_ops, int64_t ops_cap, int64_t* ops_meta, int64_t* cursor,
    bool force_full, std::vector<int64_t>* escalated) {
  const bool prof = getenv("VACMAP_TPU_STRIPE_STATS") != nullptr;
  double t0 = prof ? now_s() : 0;
  int64_t Tmax = 1, Qmax = 1;
  for (int l = 0; l < n_jobs; l++) {
    Tmax = std::max(Tmax, t_len[jobs[l]]);
    Qmax = std::max(Qmax, q_len[jobs[l]]);
  }
  // shared band radius: base 64 plus the 75th-percentile lane deviation
  // from the stripe diagonal (jobs are size-sorted, so most lanes sit
  // close; outlier lanes land outside the band, escalate at traceback
  // and re-run in a full-width striped pass).  The N^2-byte bits traffic
  // is what caps this kernel on the memory-bandwidth-throttled bench
  // host, so banding pays ~2.5x.
  // offset-space band (the scalar banded path's geometry, level-0
  // radius): every lane's endpoint diagonal q_l - t_l lies inside
  // [dlo, dhi], so single-gap paths are covered by construction and
  // only local wander can clip — caught by edge-touch escalation.
  // The N^2-byte bits traffic caps this kernel on the
  // memory-bandwidth-throttled bench host, so banding pays ~2.5x.
  int64_t R = -1, dlo = 0, dhi = 0;
  if (!force_full) {
    int64_t dmin = 0, dmax = 0;
    for (int l = 0; l < n_jobs; l++) {
      const int64_t d = q_len[jobs[l]] - t_len[jobs[l]];
      dmin = std::min<int64_t>(dmin, d);
      dmax = std::max<int64_t>(dmax, d);
    }
    // radius 16 measured SAM-identical to full-width on clean (5% SNP)
    // and noisy (10% mixed indel) corpora with zero escalations and a
    // 2.2x cell reduction vs the old 64 (escalate-on-edge redoes any
    // clipped lane full-width, so tightening only ever costs re-runs;
    // fuzz suite passes down to R=4).  VACMAP_TPU_STRIPE_R overrides.
    static const int64_t R_env = []() {
      const char* e = getenv("VACMAP_TPU_STRIPE_R");
      const int64_t v = e ? atoll(e) : 0;
      return v > 0 ? v : 16;
    }();
    R = R_env;
    dlo = dmin - R;
    dhi = dmax + R;
    if (dhi - dlo + 32 >= Qmax) R = -1;  // band wouldn't shrink the sweep
  }
  // jobs above the legacy 768 cap ride the striped kernel ONLY when the
  // band keeps the traceback buffer small; otherwise the group belongs
  // on the scalar adaptive-band path (rc=3: caller reroutes, nothing
  // written yet)
  if (Qmax > 768) {
    if (R < 0 ||
        (size_t)Tmax * (size_t)(dhi - dlo + 1) * 16 > (48u << 20))
      return 3;
  }
  // transposed char planes (int16), pad char 4 (mismatches everything)
  static thread_local std::vector<int16_t> tT, tQ;
  static thread_local std::vector<int16_t> Hprev, Hcur, E1prev, E1cur,
      E2prev, E2cur;
  static thread_local std::vector<uint8_t> bits;
  tT.assign((size_t)Tmax * 16, 4);
  tQ.assign((size_t)Qmax * 16, 4);
  // 16x16 byte-block transpose (unpck ladder) for the bulk; scalar tails
  auto fill_plane = [&](std::vector<int16_t>& plane, bool is_t) {
    const int64_t* lens = is_t ? t_len : q_len;
    const int64_t* offs = is_t ? t_off : q_off;
    int64_t common = INT64_MAX;
    for (int l = 0; l < n_jobs; l++) common = std::min(common, lens[jobs[l]]);
    if (n_jobs < 16) common = 0;  // dummy lanes keep pad char
    int64_t i = 0;
    for (; i + 16 <= common; i += 16) {
      __m128i rows[16];
      for (int l = 0; l < 16; l++)
        rows[l] = _mm_loadu_si128(
            (const __m128i*)(seqs + offs[jobs[l]] + i));
      // transpose 16x16 bytes: 4 unpack layers
      for (int step = 0; step < 4; step++) {
        __m128i nr[16];
        for (int k = 0; k < 8; k++) {
          nr[2 * k] = _mm_unpacklo_epi8(rows[k], rows[k + 8]);
          nr[2 * k + 1] = _mm_unpackhi_epi8(rows[k], rows[k + 8]);
        }
        for (int k = 0; k < 16; k++) rows[k] = nr[k];
      }
      for (int r = 0; r < 16; r++) {
        // rows[r] = bytes of position i+r across the 16 jobs; clamp >3
        const __m128i v = _mm_min_epu8(rows[r], _mm_set1_epi8(4));
        const __m256i w = _mm256_cvtepu8_epi16(v);
        _mm256_storeu_si256((__m256i*)&plane[(size_t)(i + r) * 16], w);
      }
    }
    for (int l = 0; l < n_jobs; l++) {
      const uint8_t* src = seqs + offs[jobs[l]];
      for (int64_t r = i; r < lens[jobs[l]]; r++)
        plane[(size_t)r * 16 + l] = src[r] < 4 ? src[r] : 4;
    }
  };
  fill_plane(tT, true);
  fill_plane(tQ, false);
  const size_t rowlen = (size_t)(Qmax + 1) * 16;
  Hprev.resize(rowlen); Hcur.resize(rowlen);
  E1prev.assign(rowlen, SNEG16); E1cur.resize(rowlen);
  E2prev.assign(rowlen, SNEG16); E2cur.resize(rowlen);
  // band-local bits rows: banded groups store only [jlo(i), jhi(i)] per
  // row, so the traceback buffer is O(Tmax * band) not O(Tmax * Qmax) —
  // what lets the striped kernel take jobs the old full buffer couldn't
  const int64_t Wb = (R >= 0) ? (dhi - dlo + 1) : Qmax;
  bits.resize((size_t)Tmax * Wb * 16);

  auto gapf = [&](int64_t l) -> int16_t {
    return (int16_t)std::min((int64_t)o1 + (int64_t)e1 * l,
                             (int64_t)o2 + (int64_t)e2 * l);
  };
  // row 0: H(0, j) = -gapf(j)
  for (int64_t j = 0; j <= Qmax; j++) {
    const int16_t v = (j == 0) ? 0 : (int16_t)-gapf(j);
    for (int l = 0; l < 16; l++) Hprev[(size_t)j * 16 + l] = v;
  }
  const __m256i ve1 = _mm256_set1_epi16((int16_t)e1);
  const __m256i ve2 = _mm256_set1_epi16((int16_t)e2);
  const __m256i vo1e1 = _mm256_set1_epi16((int16_t)(o1 + e1));
  const __m256i vo2e2 = _mm256_set1_epi16((int16_t)(o2 + e2));
  const __m256i vmat = _mm256_set1_epi16((int16_t)match);
  const __m256i vmis = _mm256_set1_epi16((int16_t)mismatch);
  const __m256i vneg = _mm256_set1_epi16(SNEG16);
  const __m256i vfour = _mm256_set1_epi16(4);
  const __m256i v1 = _mm256_set1_epi16(1);
  const __m256i v2 = _mm256_set1_epi16(2);
  const __m256i v3 = _mm256_set1_epi16(3);
  const __m256i v4 = _mm256_set1_epi16(4);
  const __m256i v8 = _mm256_set1_epi16(8);
  const __m256i v16 = _mm256_set1_epi16(16);
  const __m256i v32 = _mm256_set1_epi16(32);
  const __m256i v64 = _mm256_set1_epi16(64);

  if (prof) { g_t_prep += now_s() - t0; t0 = now_s(); }
  int16_t score16[16] = {0};
  for (int64_t i = 1; i <= Tmax; i++) {
    int64_t jlo = 1, jhi = Qmax;
    if (R >= 0) {
      jlo = (i + dlo < 1) ? 1 : i + dlo;
      jhi = (i + dhi > Qmax) ? Qmax : i + dhi;
    }
    const __m256i tvec = _mm256_loadu_si256(
        (const __m256i*)&tT[(size_t)(i - 1) * 16]);
    const __m256i tvalid = _mm256_cmpgt_epi16(vfour, tvec);
    const int16_t hg = (int16_t)-gapf(i);
    // F gaps open from the pre-F maximum H0 of the previous column (the
    // prefix-max formulation of affine_ref.py); at j=0, H0 = boundary.
    // Banded rows with jlo > 1 start from a -inf left wall instead (the
    // out-of-band cell), and store it so the next row's diagonal read of
    // this column sees the wall too.
    __m256i H0_jm1 = (jlo == 1) ? _mm256_set1_epi16(hg) : vneg;
    _mm256_storeu_si256((__m256i*)&Hcur[(size_t)(jlo - 1) * 16], H0_jm1);
    __m256i diag_carry =
        _mm256_loadu_si256((const __m256i*)&Hprev[(size_t)(jlo - 1) * 16]);
    __m256i F1 = vneg, F2 = vneg;
    // anchor the row at offset j - (i + dlo) when banded (stride-stable
    // even when jlo clamps to the matrix edge); plain (j-1) otherwise
    uint8_t* bits_row = &bits[(size_t)(i - 1) * Wb * 16];
    if (R >= 0)  // store index (j-1): (j-1) - (i+dlo-1) = j-(i+dlo)
      bits_row -= (ptrdiff_t)(i + dlo - 1) * 16;
    for (int64_t j = jlo; j <= jhi; j++) {
      const __m256i Hp_j =
          _mm256_loadu_si256((const __m256i*)&Hprev[(size_t)j * 16]);
      const __m256i E1p =
          _mm256_loadu_si256((const __m256i*)&E1prev[(size_t)j * 16]);
      const __m256i E2p =
          _mm256_loadu_si256((const __m256i*)&E2prev[(size_t)j * 16]);
      const __m256i E1ext_cand = _mm256_subs_epi16(E1p, ve1);
      const __m256i E2ext_cand = _mm256_subs_epi16(E2p, ve2);
      const __m256i E1 =
          _mm256_max_epi16(E1ext_cand, _mm256_subs_epi16(Hp_j, vo1e1));
      const __m256i E2 =
          _mm256_max_epi16(E2ext_cand, _mm256_subs_epi16(Hp_j, vo2e2));
      const __m256i qvec = _mm256_loadu_si256(
          (const __m256i*)&tQ[(size_t)(j - 1) * 16]);
      const __m256i eqm = _mm256_and_si256(
          _mm256_cmpeq_epi16(qvec, tvec), tvalid);
      const __m256i sub = _mm256_blendv_epi8(vmis, vmat, eqm);
      const __m256i diag = _mm256_adds_epi16(diag_carry, sub);
      const __m256i F1ext_cand = _mm256_subs_epi16(F1, ve1);
      const __m256i F2ext_cand = _mm256_subs_epi16(F2, ve2);
      F1 = _mm256_max_epi16(F1ext_cand, _mm256_subs_epi16(H0_jm1, vo1e1));
      F2 = _mm256_max_epi16(F2ext_cand, _mm256_subs_epi16(H0_jm1, vo2e2));
      const __m256i H0 = _mm256_max_epi16(diag, _mm256_max_epi16(E1, E2));
      const __m256i H = _mm256_max_epi16(H0, _mm256_max_epi16(F1, F2));
      // op priority DIAG > E1 > E2 > F1 > F2 (blend order reversed)
      __m256i op = v4;
      op = _mm256_blendv_epi8(op, v3, _mm256_cmpeq_epi16(H, F1));
      op = _mm256_blendv_epi8(op, v2, _mm256_cmpeq_epi16(H, E2));
      op = _mm256_blendv_epi8(op, v1, _mm256_cmpeq_epi16(H, E1));
      op = _mm256_blendv_epi8(op, _mm256_setzero_si256(),
                              _mm256_cmpeq_epi16(H, diag));
      __m256i b = op;
      b = _mm256_or_si256(b, _mm256_and_si256(
          _mm256_cmpeq_epi16(E1, E1ext_cand), v8));
      b = _mm256_or_si256(b, _mm256_and_si256(
          _mm256_cmpeq_epi16(E2, E2ext_cand), v16));
      b = _mm256_or_si256(b, _mm256_and_si256(
          _mm256_cmpeq_epi16(F1, F1ext_cand), v32));
      b = _mm256_or_si256(b, _mm256_and_si256(
          _mm256_cmpeq_epi16(F2, F2ext_cand), v64));
      // pack 16x int16 -> 16x uint8 and store
      const __m256i packed = _mm256_packus_epi16(b, b);
      const __m256i perm = _mm256_permute4x64_epi64(packed, 0x08);
      _mm_storeu_si128((__m128i*)&bits_row[(size_t)(j - 1) * 16],
                       _mm256_castsi256_si128(perm));
      _mm256_storeu_si256((__m256i*)&Hcur[(size_t)j * 16], H);
      _mm256_storeu_si256((__m256i*)&E1cur[(size_t)j * 16], E1);
      _mm256_storeu_si256((__m256i*)&E2cur[(size_t)j * 16], E2);
      diag_carry = Hp_j;
      H0_jm1 = H0;
    }
    for (int l = 0; l < n_jobs; l++)
      if (t_len[jobs[l]] == i && q_len[jobs[l]] >= jlo - 1
          && q_len[jobs[l]] <= jhi)
        score16[l] = Hcur[(size_t)q_len[jobs[l]] * 16 + l];
    std::swap(Hprev, Hcur);
    std::swap(E1prev, E1cur);
    std::swap(E2prev, E2cur);
    if (R >= 0 && i < Tmax) {
      // columns entering the band next row hold stale row i-1 values
      // after the swap: reset them to the out-of-band wall
      const int64_t hi2 =
          (i + 1 + dhi > Qmax) ? Qmax : i + 1 + dhi;
      for (int64_t j2 = jhi + 1; j2 <= hi2; j2++) {
        _mm256_storeu_si256((__m256i*)&Hprev[(size_t)j2 * 16], vneg);
        _mm256_storeu_si256((__m256i*)&E1prev[(size_t)j2 * 16], vneg);
        _mm256_storeu_si256((__m256i*)&E2prev[(size_t)j2 * 16], vneg);
      }
    }
  }
  if (prof) {
    g_t_sweep += now_s() - t0;
    g_cells += Tmax * Wb * 16;
    g_groups++; g_spread += (R >= 0) ? (dhi - dlo + 1) : Qmax;
    g_tsum += Tmax;
    for (int l = 0; l < n_jobs; l++)
      g_lane_cells += t_len[jobs[l]] * Wb;
    if (getenv("VACMAP_TPU_STRIPE_DUMP")) {
      int64_t tmin = INT64_MAX;
      for (int l = 0; l < n_jobs; l++)
        tmin = std::min(tmin, t_len[jobs[l]]);
      fprintf(stderr, "[grp] n=%d Tmax=%ld Tmin=%ld W=%ld\n",
              n_jobs, (long)Tmax, (long)tmin, (long)Wb);
    }
    t0 = now_s();
  }
  (void)score16;  // per-pair score available if a caller ever needs it
  for (int l = 0; l < n_jobs; l++) {
    const int64_t p = jobs[l];
    int64_t n_ops = 0;
    int rc = stripe_traceback(
        bits.data(), Qmax, l,
        seqs + t_off[p], t_len[p], seqs + q_off[p], q_len[p], eqx,
        out_ops + *cursor * 2, ops_cap - *cursor, &n_ops,
        R, dlo, dhi, Wb);
    if (rc == 2) {
      // band-limited lane: collect for the caller's full-width striped
      // second pass (cheaper than a scalar redo)
      escalated->push_back(p);
      continue;
    }
    if (rc != 0) return rc;
    ops_meta[p * 2] = *cursor;
    ops_meta[p * 2 + 1] = n_ops;
    *cursor += n_ops;
  }
  if (prof) g_t_tb += now_s() - t0;
  return 0;
}

extern "C" void stripe_prof_dump() {
  fprintf(stderr, "[stripeprof] prep=%.3fs sweep=%.3fs tb=%.3fs "
          "cells=%ldM (%.0f Mcells/s sweep) groups=%ld avgW=%.0f "
          "avgT=%.0f lane_fill=%.2f\n",
          g_t_prep, g_t_sweep, g_t_tb, (long)(g_cells / 1000000),
          g_cells / std::max(g_t_sweep, 1e-9) / 1e6,
          (long)g_groups, (double)g_spread / std::max<int64_t>(g_groups, 1),
          (double)g_tsum / std::max<int64_t>(g_groups, 1),
          (double)g_lane_cells * 16.0 / std::max<int64_t>(g_cells, 1) / 16.0);
  g_t_prep = g_t_sweep = g_t_tb = 0; g_cells = 0;
  g_groups = g_spread = g_tsum = g_lane_cells = 0;
}
#endif  // __AVX2__

extern "C" int align2p_batch_native(
    const uint8_t* seqs, const int64_t* t_off, const int64_t* t_len,
    const int64_t* q_off, const int64_t* q_len, int64_t n_pairs,
    int match, int mismatch, int o1, int e1, int o2, int e2, int eqx,
    int32_t* out_ops, int64_t ops_cap, int64_t* ops_meta /* (n,2) */) {
  int64_t cursor = 0;
#if defined(__AVX2__)
  // jobs small enough for the striped kernel (full-matrix int16): group
  // size-sorted so stripe dims hug each lane's true dims
  static const int64_t STRIPE_MAX = 4096;
  static thread_local std::vector<int64_t> striped, striped_big,
      scalar_jobs;
  striped.clear(); striped_big.clear(); scalar_jobs.clear();
  for (int64_t p = 0; p < n_pairs; p++) {
    const int64_t mx = std::max(t_len[p], q_len[p]);
    if (t_len[p] <= 0 || q_len[p] <= 0 || n_pairs < 4)
      scalar_jobs.push_back(p);
    else if (mx <= 768)
      striped.push_back(p);
    else if (mx <= STRIPE_MAX)
      striped_big.push_back(p);  // banded-only class: never mixed with
                                 // small jobs (padding would explode)
    else
      scalar_jobs.push_back(p);
  }
  auto by_size = [&](int64_t a, int64_t b) {
    // primary: 64-wide size buckets (padding stays bounded); secondary:
    // endpoint diagonal q-t, so each 16-group's offset band [dmin, dmax]
    // stays tight and the banded sweep actually shrinks
    const int64_t ma = std::max(t_len[a], q_len[a]) >> 6;
    const int64_t mb = std::max(t_len[b], q_len[b]) >> 6;
    if (ma != mb) return ma > mb;
    return (q_len[a] - t_len[a]) < (q_len[b] - t_len[b]);
  };
  std::sort(striped.begin(), striped.end(), by_size);
  std::sort(striped_big.begin(), striped_big.end(), by_size);
  static thread_local std::vector<int64_t> escalated;
  escalated.clear();
  for (auto* cls : {&striped, &striped_big}) {
    auto& lst = *cls;
    for (size_t s = 0; s < lst.size(); s += 16) {
      const int n_jobs = (int)std::min<size_t>(16, lst.size() - s);
      // a nearly-empty tail chunk sweeps Tmax*W cells on all 16 lanes
      // for a handful of real jobs (measured: single SV-deletion windows
      // at T~3k were 81% of ALL swept cells as 1-real-lane groups); the
      // scalar adaptive-band path is strictly cheaper below ~1/4
      // occupancy
      if (n_jobs < 4) {
        for (int l = 0; l < n_jobs; l++) scalar_jobs.push_back(lst[s + l]);
        continue;
      }
      const int rc = run_stripe16(
          seqs, t_off, t_len, q_off, q_len, &lst[s], n_jobs,
          match, mismatch, o1, e1, o2, e2, eqx,
          out_ops, ops_cap, ops_meta, &cursor, false, &escalated);
      if (rc == 3) {  // band too wide for a big group: scalar path
        for (int l = 0; l < n_jobs; l++) scalar_jobs.push_back(lst[s + l]);
        continue;
      }
      if (rc != 0) return rc;
    }
  }
  // band-limited jobs: full-width striped second pass when small enough,
  // scalar otherwise
  static thread_local std::vector<int64_t> esc_small;
  esc_small.clear();
  if (getenv("VACMAP_TPU_STRIPE_STATS") && !escalated.empty())
    fprintf(stderr, "[stripe] escalated %zu/%zu\n", escalated.size(),
            striped.size());
  for (const int64_t p : escalated) {
    if (std::max(t_len[p], q_len[p]) <= 768) esc_small.push_back(p);
    else scalar_jobs.push_back(p);
  }
  for (size_t s = 0; s < esc_small.size(); s += 16) {
    const int n_jobs = (int)std::min<size_t>(16, esc_small.size() - s);
    const int rc = run_stripe16(
        seqs, t_off, t_len, q_off, q_len, &esc_small[s], n_jobs,
        match, mismatch, o1, e1, o2, e2, eqx,
        out_ops, ops_cap, ops_meta, &cursor, true, nullptr);
    if (rc != 0) return rc;
  }
#else
  static thread_local std::vector<int64_t> scalar_jobs;
  scalar_jobs.clear();
  for (int64_t p = 0; p < n_pairs; p++) scalar_jobs.push_back(p);
#endif
  for (const int64_t p : scalar_jobs) {
    int64_t n_ops = 0, q_end = 0, t_end = 0, score = 0;
    int zdropped = 0;
    const int64_t room = ops_cap - cursor;
    const int rc = align2p_native_eqx(
        seqs + t_off[p], t_len[p], seqs + q_off[p], q_len[p],
        match, mismatch, o1, e1, o2, e2, -1, -1, 1, eqx,
        out_ops + cursor * 2, room, &n_ops, &q_end, &t_end, &score,
        &zdropped);
    if (rc != 0) return rc;
    ops_meta[p * 2] = cursor;
    ops_meta[p * 2 + 1] = n_ops;
    cursor += n_ops;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Multithreaded minimizer sketch + fully-native sorted index table.
//
// TPU-native replacement for the reference's minimap2-backed index build
// (vacmap:331 `mp.Aligner(..., fn_idx_out=...)`).  The sequence is split
// into overlapping kmer segments; a position p is emitted by the ONE
// segment that contains ALL windows covering p (window starts p-w+1..p),
// i.e. segment kmer range [a, b) emits p in [a+w-1, b-w] (first segment
// from 0, last to the end).  Consecutive segments overlap by 2w-2 kmers
// so emit ranges tile the sequence exactly: the union equals the
// single-thread selection, disjoint, position-ascending -- no dedup.
// ---------------------------------------------------------------------------

#include <thread>
#include <atomic>
#include <memory>

extern "C" int64_t minimizer_sketch_range(const uint8_t*, int64_t, int, int,
                                          int64_t, int64_t,
                                          int64_t*, int64_t*, int8_t*);

namespace {

struct SketchPart {
  // uninitialized heap buffers (NOT zero-filled vectors: at genome
  // scale the value-initialization alone was >15 GB of page-touching)
  std::unique_ptr<int64_t[]> hash, pos;
  std::unique_ptr<int8_t[]> strand;
  int64_t n = 0;
};

// segment bounds in kmer space: kmers [a, b), emit positions
// [emit_lo, emit_hi]
static void sketch_segment(const uint8_t* seq, int64_t n, int k, int w,
                           int64_t a, int64_t b, int64_t emit_lo,
                           int64_t emit_hi, SketchPart* out) {
  // bases for kmer range [a, b): a .. b + k - 1
  const int64_t base_lo = a, base_hi = std::min<int64_t>(n, b + k - 1);
  const int64_t nseq = base_hi - base_lo;
  // the streaming kernel filters to the emit range itself, so the
  // output buffers are sized to the emit range (every position is
  // emitted at most once); only the emitted prefix is ever touched
  const int64_t cap = std::max<int64_t>(emit_hi - emit_lo + 1, 1);
  out->hash.reset(new int64_t[cap]);
  out->pos.reset(new int64_t[cap]);
  out->strand.reset(new int8_t[cap]);
  out->n = minimizer_sketch_range(
      seq + base_lo, nseq, k, w, emit_lo - base_lo, emit_hi - base_lo,
      out->hash.get(), out->pos.get(), out->strand.get());
  for (int64_t i = 0; i < out->n; i++) out->pos[i] += base_lo;
}

// bounded-size segments drained by a fixed thread pool: allocation per
// in-flight segment stays small and threads load-balance
static std::vector<SketchPart> sketch_parallel(const uint8_t* seq, int64_t n,
                                               int k, int w, int nthreads) {
  const int64_t nk = n - k + 1;
  std::vector<SketchPart> parts;
  if (nk <= 0) return parts;
  const int64_t MAX_SEG = 16ll << 20;  // kmers per segment
  const int64_t MIN_SEG = 4 * (int64_t)w + 64;  // below this, ST is fine
  int64_t nseg = std::max<int64_t>(nthreads, (nk + MAX_SEG - 1) / MAX_SEG);
  while (nseg > 1 && nk / nseg < MIN_SEG) nseg--;
  parts.resize(nseg);
  const int64_t per = (nk + nseg - 1) / nseg;
  std::atomic<int64_t> next{0};
  auto work = [&]() {
    for (;;) {
      const int64_t s = next.fetch_add(1);
      if (s >= nseg) break;
      // emit range [e_lo, e_hi]; segment kmers [a, b)
      const int64_t e_lo = (s == 0) ? 0 : s * per;
      const int64_t e_hi =
          (s == nseg - 1) ? nk - 1 : std::min(nk - 1, (s + 1) * per - 1);
      if (e_lo > e_hi) continue;
      const int64_t a = std::max<int64_t>(0, e_lo - (w - 1));
      const int64_t b = std::min<int64_t>(nk, e_hi + w);  // last = e_hi+w-1
      sketch_segment(seq, n, k, w, a, b, e_lo, e_hi, &parts[s]);
    }
  };
  const int np = (int)std::min<int64_t>(std::max(nthreads, 1), nseg);
  std::vector<std::thread> ts;
  for (int t = 0; t < np; t++) ts.emplace_back(work);
  for (auto& t : ts) t.join();
  return parts;
}

}  // namespace

extern "C" int64_t minimizer_sketch_mt(
    const uint8_t* seq, int64_t n, int k, int w, int nthreads,
    int64_t* out_hash, int64_t* out_pos, int8_t* out_strand) {
  if (n < k) return 0;
  if (nthreads <= 1)
    return minimizer_sketch(seq, n, k, w, out_hash, out_pos, out_strand);
  auto parts = sketch_parallel(seq, n, k, w, nthreads);
  int64_t m = 0;
  for (auto& p : parts) {
    std::copy(p.hash.get(), p.hash.get() + p.n, out_hash + m);
    std::copy(p.pos.get(), p.pos.get() + p.n, out_pos + m);
    std::copy(p.strand.get(), p.strand.get() + p.n, out_strand + m);
    m += p.n;
  }
  return m;
}

// Full sorted index table: MT sketch -> scatter into 256 buckets on the
// top 8 bits of the 2k-bit hash -> per-bucket stable sort by hash (pos
// order preserved within equal hashes because the scatter is in position
// order).  Output = (hash asc, pos asc), bit-identical to the numpy
// argsort path in index/index.py::build.  Returns count, or -needed if
// cap is too small.
extern "C" int64_t index_build_sorted(
    const uint8_t* seq, int64_t n, int k, int w, int nthreads, int64_t cap,
    int64_t nctg, const int64_t* ctg_starts, const int64_t* ctg_lens,
    int64_t* out_hash, int64_t* out_pos, int8_t* out_strand) {
  if (n < k) return 0;
  const bool timing = getenv("VACMAP_TPU_IDX_TIME") != nullptr;
  auto tick = [&]() {
    return std::chrono::duration<double>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
  };
  double t0 = timing ? tick() : 0.0;
  // sketch per contig (kmers never span a boundary), segments in
  // position order so per-bucket scatter order stays position-ascending
  std::vector<SketchPart> parts;
  for (int64_t c = 0; c < nctg; c++) {
    auto ps = sketch_parallel(seq + ctg_starts[c], ctg_lens[c], k, w,
                              std::max(nthreads, 1));
    for (auto& p : ps) {
      for (int64_t i = 0; i < p.n; i++) p.pos[i] += ctg_starts[c];
      parts.push_back(std::move(p));
    }
  }
  if (timing) {
    fprintf(stderr, "[idx] sketch %.2fs\n", tick() - t0);
    t0 = tick();
  }
  int64_t total = 0;
  for (auto& p : parts) total += p.n;
  if (total > cap) return -total;
  const int shift = std::max(0, 2 * k - 8);
  const int NB = 256;
  // counts per (part, bucket) -> per-bucket offsets with parts in order
  std::vector<int64_t> cnt(parts.size() * NB, 0);
  for (size_t s = 0; s < parts.size(); s++)
    for (int64_t i = 0; i < parts[s].n; i++)
      cnt[s * NB + ((uint64_t)parts[s].hash[i] >> shift)]++;
  std::vector<int64_t> bucket_off(NB + 1, 0);
  for (int b = 0; b < NB; b++) {
    int64_t c = 0;
    for (size_t s = 0; s < parts.size(); s++) c += cnt[s * NB + b];
    bucket_off[b + 1] = bucket_off[b] + c;
  }
  // scatter (parallel over parts would race per bucket; do parts serially
  // per bucket by precomputing (part, bucket) write offsets)
  std::vector<int64_t> woff(parts.size() * NB);
  for (int b = 0; b < NB; b++) {
    int64_t o = bucket_off[b];
    for (size_t s = 0; s < parts.size(); s++) {
      woff[s * NB + b] = o;
      o += cnt[s * NB + b];
    }
  }
  {
    std::vector<std::thread> ts;
    for (size_t s = 0; s < parts.size(); s++) {
      ts.emplace_back([&, s]() {
        std::vector<int64_t> o(woff.begin() + s * NB,
                               woff.begin() + (s + 1) * NB);
        const auto& p = parts[s];
        for (int64_t i = 0; i < p.n; i++) {
          const int b = (int)((uint64_t)p.hash[i] >> shift);
          const int64_t at = o[b]++;
          out_hash[at] = p.hash[i];
          out_pos[at] = p.pos[i];
          out_strand[at] = p.strand[i];
        }
      });
    }
    for (auto& t : ts) t.join();
  }
  if (timing) {
    fprintf(stderr, "[idx] scatter %.2fs\n", tick() - t0);
    t0 = tick();
  }
  // per-bucket stable LSD radix by the low `shift` hash bits (the top 8
  // already define the bucket); stability preserves the
  // position-ascending order within equal hashes
  {
    const int rem_bits = shift;
    const int PASS_BITS = 11;
    const int npass = std::max(1, (rem_bits + PASS_BITS - 1) / PASS_BITS);
    std::atomic<int> next{0};
    auto work = [&]() {
      std::vector<int64_t> th, tp;
      std::vector<int8_t> ts_;
      std::vector<int64_t> hist;
      for (;;) {
        const int b = next.fetch_add(1);
        if (b >= NB) break;
        const int64_t lo = bucket_off[b], hi = bucket_off[b + 1];
        const int64_t m = hi - lo;
        if (m <= 1) continue;
        th.resize(m); tp.resize(m); ts_.resize(m);
        int64_t* sh = out_hash + lo;
        int64_t* sp = out_pos + lo;
        int8_t* ss = out_strand + lo;
        int64_t* dh = th.data();
        int64_t* dp = tp.data();
        int8_t* ds = ts_.data();
        for (int pass = 0; pass < npass; pass++) {
          const int bit_lo = pass * PASS_BITS;
          const int bits = std::min(PASS_BITS, rem_bits - bit_lo);
          if (bits <= 0) break;
          const int64_t R = 1ll << bits;
          hist.assign(R + 1, 0);
          for (int64_t i = 0; i < m; i++)
            hist[(((uint64_t)sh[i]) >> bit_lo & (R - 1)) + 1]++;
          for (int64_t r = 0; r < R; r++) hist[r + 1] += hist[r];
          for (int64_t i = 0; i < m; i++) {
            const int64_t at = hist[((uint64_t)sh[i]) >> bit_lo & (R - 1)]++;
            dh[at] = sh[i]; dp[at] = sp[i]; ds[at] = ss[i];
          }
          std::swap(sh, dh); std::swap(sp, dp); std::swap(ss, ds);
        }
        if (sh != out_hash + lo) {  // odd pass count: copy back
          std::copy(sh, sh + m, out_hash + lo);
          std::copy(sp, sp + m, out_pos + lo);
          std::copy(ss, ss + m, out_strand + lo);
        }
      }
    };
    std::vector<std::thread> pool;
    for (int t = 0; t < std::max(nthreads, 1); t++) pool.emplace_back(work);
    for (auto& t : pool) t.join();
  }
  if (timing) fprintf(stderr, "[idx] sort %.2fs\n", tick() - t0);
  return total;
}

// ---------------------------------------------------------------------------
// Whole seeding tail in one call (index/index.py::seeds): batched range
// lookup over the sorted minimizer table, hit expansion, reference
// cluster cap, strand-aware colinear merge and the final
// (readpos, refpos) sort.  The numpy formulation spends most of its
// time in per-call overhead on ~1-20k-element arrays; one native pass
// removes ~25 numpy dispatches per read.  Semantics bit-identical to
// the python path (differential-tested).
// ---------------------------------------------------------------------------

static double g_sd_lookup = 0, g_sd_expand = 0, g_sd_cap = 0,
              g_sd_merge = 0, g_sd_sort = 0;

extern "C" void seeds_prof_dump() {
  fprintf(stderr,
          "[seedsprof] lookup=%.3fs expand=%.3fs cap=%.3fs merge=%.3fs "
          "finsort=%.3fs\n",
          g_sd_lookup, g_sd_expand, g_sd_cap, g_sd_merge, g_sd_sort);
  g_sd_lookup = g_sd_expand = g_sd_cap = g_sd_merge = g_sd_sort = 0;
}

extern "C" int64_t seeds_core_u32(
    const uint32_t* table, const uint32_t* mm_pos, const int8_t* mm_strand,
    const int64_t* pstarts, int shift,
    const int64_t* qh, const int64_t* qp, const int8_t* qs, int64_t m,
    int64_t cutoff, int64_t check_num, int64_t k, int64_t merge_max_len,
    int64_t* out, int64_t out_cap) {
  if (m == 0) return 0;
  const bool prof = getenv("VACMAP_TPU_SEEDS_STATS") != nullptr;
  double t0 = prof ? now_s() : 0;
  // ---- batched range lookup ------------------------------------------
  static thread_local std::vector<uint32_t> q32;
  static thread_local std::vector<int64_t> lo_v, hi_v;
  q32.resize(m);
  lo_v.resize(m);
  hi_v.resize(m);
  for (int64_t i = 0; i < m; i++) q32[i] = (uint32_t)qh[i];
  lookup_ranges(table, pstarts, shift, q32.data(), m, lo_v.data(),
                hi_v.data());
  if (prof) { g_sd_lookup += now_s() - t0; t0 = now_s(); }
  // ---- expansion ------------------------------------------------------
  // each kept query gathers [lo, hi) from the genome-scale pos/strand
  // tables — random misses that dominate at 3 Gb; prefetch a fixed
  // query distance ahead (ranges are <= cutoff entries, 1-2 lines)
  struct Hit { int64_t r, y, s; };
  static thread_local std::vector<Hit> hits;
  hits.clear();
  const int64_t PD = 24;  // prefetch distance (queries ahead): the
  // per-query work is ~30 ns, so a deep distance is needed to cover
  // DRAM latency; ranges are <= cutoff entries (1-2 lines each)
  for (int64_t i = 0; i < m; i++) {
    if (i + PD < m) {
      const int64_t plo = lo_v[i + PD], phi = hi_v[i + PD];
      if (phi > plo && phi - plo <= cutoff) {
        __builtin_prefetch(&mm_pos[plo]);
        __builtin_prefetch(&mm_strand[plo]);
        __builtin_prefetch(&mm_pos[phi - 1]);
      }
    }
    const int64_t occ = hi_v[i] - lo_v[i];
    if (occ <= 0 || occ > cutoff) continue;
    for (int64_t t = lo_v[i]; t < hi_v[i]; t++)
      hits.push_back({qp[i], (int64_t)mm_pos[t],
                      (int64_t)qs[i] * (int64_t)mm_strand[t]});
  }
  const int64_t n = (int64_t)hits.size();
  if (prof) { g_sd_expand += now_s() - t0; t0 = now_s(); }
  if (n == 0) return 0;
  // ---- cluster cap (top check_num ref clusters by anchor count; ties
  // resolved exactly like np.argsort(counts)[::-1][:check_num]:
  // stable-ascending order reversed -> equal counts keep the HIGHER
  // cluster id) -----------------------------------------------------------
  static thread_local std::vector<int32_t> order;
  order.resize(n);
  for (int64_t i = 0; i < n; i++) order[i] = (int32_t)i;
  static thread_local std::vector<Hit> kept;
  kept.clear();
  if (check_num > 0) {
    if (n < (int64_t)1 << 24) {
      // flat packed keys ((y << 24) | i) through an LSD radix sort:
      // the 3 Gb bench expands ~25k scattered hits/read and the cap's
      // indirect stable_sort was 1.5 ms/read; 11-bit-digit radix over
      // packed words is ~10x.  Stability by construction (unique low
      // bits); y < 2^40 (refs < 1 Tb).
      static thread_local std::vector<uint64_t> keys, tmp;
      keys.resize(n);
      tmp.resize(n);
      uint64_t mx = 0;
      for (int64_t i = 0; i < n; i++) {
        keys[i] = ((uint64_t)hits[i].y << 24) | (uint64_t)i;
        mx |= keys[i];
      }
      uint64_t* src = keys.data();
      uint64_t* dst = tmp.data();
      // bound the digit loop by the key's bit count: `mx >> sh` with
      // sh >= 64 is UB (found by UBSan at 3 Gb where keys use 56 bits)
      const int key_bits = 64 - __builtin_clzll(mx | 1);
      for (int sh = 0; sh < key_bits; sh += 11) {
        int64_t cnt[2048] = {0};
        for (int64_t i = 0; i < n; i++) cnt[(src[i] >> sh) & 2047]++;
        int64_t acc = 0;
        for (int b = 0; b < 2048; b++) { int64_t c = cnt[b]; cnt[b] = acc; acc += c; }
        for (int64_t i = 0; i < n; i++) dst[cnt[(src[i] >> sh) & 2047]++] = src[i];
        std::swap(src, dst);
      }
      for (int64_t i = 0; i < n; i++)
        order[i] = (int32_t)(src[i] & 0xFFFFFF);
    } else {
      std::stable_sort(order.begin(), order.end(),
                       [&](int32_t a, int32_t b) {
                         return hits[a].y < hits[b].y;
                       });
    }
    static thread_local std::vector<int32_t> cl_of;
    cl_of.resize(n);
    int64_t n_cl = 0;
    int64_t prev_y = hits[order[0]].y;
    for (int64_t i = 0; i < n; i++) {
      const int64_t y = hits[order[i]].y;
      if (i > 0 && y - prev_y > 100000) n_cl++;
      cl_of[order[i]] = (int32_t)n_cl;
      prev_y = y;
    }
    n_cl++;
    if (n_cl > check_num) {
      static thread_local std::vector<int64_t> counts;
      counts.assign(n_cl, 0);
      for (int64_t i = 0; i < n; i++) counts[cl_of[i]]++;
      // (count asc, id asc) stable order; keep the LAST check_num
      static thread_local std::vector<int32_t> cids;
      cids.resize(n_cl);
      for (int64_t c = 0; c < n_cl; c++) cids[c] = (int32_t)c;
      std::stable_sort(cids.begin(), cids.end(),
                       [&](int32_t a, int32_t b) {
                         return counts[a] < counts[b];
                       });
      static thread_local std::vector<uint8_t> keep_cl;
      keep_cl.assign(n_cl, 0);
      for (int64_t c = n_cl - check_num; c < n_cl; c++) keep_cl[cids[c]] = 1;
      // cap output order: ref-sorted (like the numpy path, which
      // returns ref_sorted[keep_mask])
      for (int64_t i = 0; i < n; i++) {
        const int32_t oi = order[i];
        if (keep_cl[cl_of[oi]]) kept.push_back(hits[oi]);
      }
    } else {
      kept = hits;  // original (readpos) order preserved
    }
  } else {
    kept = hits;
  }
  if (prof) { g_sd_cap += now_s() - t0; t0 = now_s(); }
  // ---- colinear merge (merge_colinear_anchors) ------------------------
  // diag = strand==1 ? y - r : -(y + r + k); sort by (strand, diag, r)
  const int64_t nk2 = (int64_t)kept.size();
  struct MRec { int64_t r, y, s, d; };
  static thread_local std::vector<MRec> recs;
  recs.resize(nk2);
  for (int64_t i = 0; i < nk2; i++) {
    const auto& h = kept[i];
    recs[i] = {h.r, h.y, h.s,
               h.s == 1 ? h.y - h.r : -(h.y + h.r + k)};
  }
  std::stable_sort(recs.begin(), recs.end(), [](const MRec& a, const MRec& b) {
    if (a.s != b.s) return a.s < b.s;
    if (a.d != b.d) return a.d < b.d;
    return a.r < b.r;
  });
  // run breaks mirror the numpy path EXACTLY: a new run starts when the
  // diagonal changes or the read start passes the PREVIOUS anchor's end
  // (strand participates in the sort but not the break; the merged
  // strand/refpos come from the run's first/last anchors)
  static thread_local std::vector<MRec> merged;  // {r0, y, s, LEN in .d}
  merged.clear();
  int64_t run_r0 = 0, prev_end = 0, run_yfirst = 0, run_ylast = 0;
  int64_t run_s = 0, run_d = 0, run_last_r = 0;
  bool open = false;
  auto close_run = [&]() {
    if (!open) return;
    const int64_t ln = (run_last_r + k) - run_r0;
    const int64_t y = (run_s == 1) ? run_yfirst : run_ylast;
    merged.push_back({run_r0, y, run_s, ln});
    open = false;
  };
  for (int64_t i = 0; i < nk2; i++) {
    const auto& a = recs[i];
    if (!open || a.d != run_d || a.r > prev_end) {
      close_run();
      run_r0 = a.r;
      run_yfirst = a.y;
      run_s = a.s;
      run_d = a.d;
      open = true;
    }
    run_ylast = a.y;
    run_last_r = a.r;
    prev_end = a.r + k;
  }
  close_run();
  // split runs longer than merge_max_len (order: short runs first, then
  // per-long-run chunks, exactly like the numpy path's concat)
  static thread_local std::vector<MRec> fin;
  fin.clear();
  static thread_local std::vector<MRec> longs;
  longs.clear();
  for (const auto& r : merged) {
    if (r.d <= merge_max_len) fin.push_back(r);
    else longs.push_back(r);
  }
  for (const auto& g : longs) {
    const int64_t ln = g.d;
    const int64_t n_chunks = (ln + merge_max_len - 1) / merge_max_len;
    for (int64_t c = 0; c < n_chunks; c++) {
      const int64_t off = c * merge_max_len;
      const int64_t cl = std::min(merge_max_len, ln - off);
      if (g.s == 1)
        fin.push_back({g.r + off, g.y + off, g.s, cl});
      else
        fin.push_back({g.r + off, g.y + ln - off - cl, g.s, cl});
    }
  }
  if (prof) { g_sd_merge += now_s() - t0; t0 = now_s(); }
  // ---- final (readpos, refpos) sort -----------------------------------
  std::stable_sort(fin.begin(), fin.end(), [](const MRec& a, const MRec& b) {
    if (a.r != b.r) return a.r < b.r;
    return a.y < b.y;
  });
  const int64_t outn = (int64_t)fin.size();
  if (outn > out_cap) return -outn;
  for (int64_t i = 0; i < outn; i++) {
    out[i * 4 + 0] = fin[i].r;
    out[i * 4 + 1] = fin[i].y;
    out[i * 4 + 2] = fin[i].s;
    out[i * 4 + 3] = fin[i].d;  // len
  }
  if (prof) g_sd_sort += now_s() - t0;
  return outn;
}

// ---------------------------------------------------------------------------
// segment_cigar_jobs decision walk (pipeline/extend.py): which anchors of
// a normalized segment walk are KEPT as CIGAR-window boundaries.  The
// python loop's skip-chaining is sequential and data-dependent; only the
// coordinate decisions live here — gap sequence extraction stays in
// python.  walk rows: (readpos, refpos, strand, len) int64, already in
// walk order (reversed for minus segments by the caller).
// Returns the number of kept indices written to out_keep (including
// index 0), or -1 when no pair is emitted (caller raises like the
// python path).
// ---------------------------------------------------------------------------

extern "C" int64_t segment_walk_keep(
    const int64_t* walk, int64_t n, int minus, int64_t force_gap,
    int64_t min_gap, int64_t* out_keep) {
  if (n <= 0) return -1;
  int64_t nk = 0;
  out_keep[nk++] = 0;
  int64_t pre = 0;
  for (int64_t i = 1; i < n; i++) {
    const int64_t pr = walk[pre * 4 + 0], pf = walk[pre * 4 + 1],
                  pl = walk[pre * 4 + 3];
    const int64_t cr = walk[i * 4 + 0], cf = walk[i * 4 + 1],
                  cl = walk[i * 4 + 3];
    int64_t readgap, refgap;
    if (minus) {
      readgap = pr - cr - cl;
      refgap = cf - pf - pl;
    } else {
      readgap = cr - pr - pl;
      refgap = cf - pf - pl;
    }
    const int64_t mx = readgap > refgap ? readgap : refgap;
    const int64_t mn = readgap < refgap ? readgap : refgap;
    if (!(force_gap > 0 && mx >= force_gap)) {
      if ((cl < 19 || mn < min_gap) && i + 1 != n) continue;
    }
    out_keep[nk++] = i;
    pre = i;
  }
  return nk >= 2 ? nk : -1;
}
