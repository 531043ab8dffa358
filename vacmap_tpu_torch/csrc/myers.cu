// Exact global edit distance of B (text, pattern) pairs: Myers' 1999
// bit-vector recurrence over the whole pattern (no band, no cap), one
// warp per pair.
//
// Replaces examples/myers_pallas_device.py::_myers_device (Pallas kernel
// _myers_kernel; vacmap_tpu/ops/myers_pallas.py in the reference's
// history).  That kernel lays 32-bit pattern words on 128 vector lanes,
// jobs on sublanes, scans the add's carries with a Kogge-Stone ladder and
// returns per-word score sums.  None of that is kept.  Here the column
// vectors Pv / Mv are 64-bit words in registers, WPL consecutive words a
// lane (word w of the pattern at lane w / WPL), so one warp holds up to
// 32 * WPL * 64 pattern bases:
//
//   * X + Pv: each lane ripples its own WPL words with carry-in 0 and
//     reports whether its block generates a carry or would pass one on
//     (every word all ones).  Two __ballot_sync masks and one 32-bit add,
//     ((g | p) + g) ^ (g | p) ^ g, give every lane its carry-in; a lane
//     that gets one ripples an increment through its words.
//   * Ph << 1, Mh << 1: inside a lane the top bit moves to the next
//     word; across lanes one __shfl_up_sync carries both top bits.  Bit 0
//     of the pattern takes 1 for Ph (row 0 of the global DP grows by one
//     a column) and 0 for Mh.
//   * the score D(m, i) starts at m and moves by Ph / Mh at bit m - 1, in
//     the one lane that owns that bit; bits above it never reach it
//     (carries and shifts only move up).
//
// The loop runs over the pair's own n text columns, not the bucket's T.
// A text code >= 4 matches nothing and a pattern code 4 sets no Peq bit
// (the host packs Peq), so an ambiguous base mismatches every base, an
// ambiguous base included, as in the TPU kernel.
//
// What bounds it on an H100: integer operations in a dependent chain,
// n columns of about 29 64-bit operations a word (kOpsPerWordStep), with
// one warp a pair and so at most B warps on the card.  The bytes are
// small beside that: the text and the Peq table are read once.  Peq lives
// in shared memory, [code][word-in-lane][lane], so a column's loads are
// conflict-free.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxWpl = 14;  // 32 lanes * 14 words * 64 = 28,672 bases

// 64-bit integer operations per pattern word and text column, counted
// from column() below: pass A 8 (and, add, add, 2 compares, or, compare,
// and), pass B 11 (add, compare, and, xor, or, or, not, or, and, or,
// score), pass C 10 (2 x shift-or-shift, or, not, or, and).
constexpr int kOpsPerWordStep = 29;

template <int WPL>
__device__ __forceinline__ void column(const u64* __restrict__ pe, bool known,
                                       int lane, int own_k, u64 own_bit,
                                       u64 (&Pv)[WPL], u64 (&Mv)[WPL],
                                       int& score) {
  u64 S[WPL];
  // pass A: block sum with carry-in 0
  unsigned carry = 0;
  bool all_ones = true;
#pragma unroll
  for (int k = 0; k < WPL; ++k) {
    const u64 Eq = known ? pe[k * 32] : 0ull;
    const u64 X = Eq & Pv[k];
    const u64 s1 = X + Pv[k];
    const u64 s = s1 + carry;
    carry = (unsigned)(s1 < X) | (unsigned)(s < s1);
    all_ones = all_ones && (s == ~0ull);
    S[k] = s;
  }
  const unsigned g = __ballot_sync(kFullMask, carry != 0);
  const unsigned p = __ballot_sync(kFullMask, all_ones);
  const unsigned a = g | p;
  unsigned inc = (((a + g) ^ a ^ g) >> lane) & 1u;
  // pass B: add the carry-in, horizontal deltas, score
#pragma unroll
  for (int k = 0; k < WPL; ++k) {
    const u64 s = S[k] + inc;
    inc &= (unsigned)(s == 0ull);
    const u64 Eq = known ? pe[k * 32] : 0ull;
    const u64 Xh = (s ^ Pv[k]) | Eq;
    const u64 Ph = Mv[k] | ~(Xh | Pv[k]);
    const u64 Mh = Pv[k] & Xh;
    if (k == own_k)
      score += (int)((Ph & own_bit) != 0ull) - (int)((Mh & own_bit) != 0ull);
    S[k] = Eq | Mv[k];  // Xv
    Pv[k] = Ph;
    Mv[k] = Mh;
  }
  // pass C: shift by one pattern row, vertical deltas
  const unsigned top = (unsigned)(Pv[WPL - 1] >> 63) |
                       ((unsigned)(Mv[WPL - 1] >> 63) << 1);
  unsigned below = __shfl_up_sync(kFullMask, top, 1);
  if (lane == 0) below = 1u;
  u64 in_p = below & 1u, in_m = below >> 1;
#pragma unroll
  for (int k = 0; k < WPL; ++k) {
    const u64 Ph = Pv[k], Mh = Mv[k];
    const u64 Phs = (Ph << 1) | in_p;
    const u64 Mhs = (Mh << 1) | in_m;
    in_p = Ph >> 63;
    in_m = Mh >> 63;
    const u64 Xv = S[k];
    Pv[k] = Mhs | ~(Xv | Phs);
    Mv[k] = Phs & Xv;
  }
}

template <int WPL>
__global__ void __launch_bounds__(32)
myers_kernel(const uint8_t* __restrict__ text, const u64* __restrict__ peq,
             const int* __restrict__ n_len, const int* __restrict__ m_len,
             int* __restrict__ dist, int T, int W) {
  extern __shared__ u64 peq_sh[];  // [4][WPL][32]
  const int job = blockIdx.x;
  const int lane = threadIdx.x;
  const u64* pg = peq + (size_t)job * 4 * W;
  for (int idx = lane; idx < 4 * WPL * 32; idx += 32) {
    const int ck = idx >> 5;  // idx = (c * WPL + k) * 32 + lane
    const int w = lane * WPL + ck % WPL;
    peq_sh[idx] = w < W ? pg[(size_t)(ck / WPL) * W + w] : 0ull;
  }
  __syncwarp();

  int n = n_len[job];
  n = n < 0 ? 0 : (n > T ? T : n);
  int m = m_len[job];
  m = m < 1 ? 1 : (m > W * 64 ? W * 64 : m);
  const int own_w = (m - 1) >> 6;
  const int own_k = lane == own_w / WPL ? own_w % WPL : -1;
  const u64 own_bit = 1ull << ((m - 1) & 63);

  u64 Pv[WPL], Mv[WPL];
#pragma unroll
  for (int k = 0; k < WPL; ++k) {
    Pv[k] = ~0ull;
    Mv[k] = 0ull;
  }
  int score = 0;
  const uint8_t* tj = text + (size_t)job * T;
  for (int i0 = 0; i0 < n; i0 += 32) {
    // 32 columns' codes, one a lane, handed round by shuffle
    const int mine = i0 + lane < n ? (int)tj[i0 + lane] : 4;
    const int cnt = n - i0 < 32 ? n - i0 : 32;
    for (int j = 0; j < cnt; ++j) {
      const int c = __shfl_sync(kFullMask, mine, j);
      column<WPL>(peq_sh + (c & 3) * (WPL * 32) + lane, c < 4, lane, own_k,
                  own_bit, Pv, Mv, score);
    }
  }
  if (own_k >= 0) dist[job] = m + score;
}

template <int WPL>
int launch(const void* text, const void* peq, const void* n_len,
           const void* m_len, void* dist, int B, int T, int W,
           cudaStream_t stream) {
  myers_kernel<WPL><<<B, 32, 4 * WPL * 32 * sizeof(u64), stream>>>(
      static_cast<const uint8_t*>(text), static_cast<const u64*>(peq),
      static_cast<const int*>(n_len), static_cast<const int*>(m_len),
      static_cast<int*>(dist), T, W);
  return (int)cudaGetLastError();
}

}  // namespace

// text (B, T) uint8 codes 0-4; peq (B, 4, W) 64-bit words, bit j of word
// w of plane c set where pattern[64 w + j] == c; n_len, m_len (B,) int32
// with n <= T and 1 <= m <= 64 W  ->  dist (B,) int32.  W <= 448.
// Returns a cudaError_t (0 = launched).
extern "C" int myers_launch(const void* text, const void* peq,
                            const void* n_len, const void* m_len, void* dist,
                            int B, int T, int W, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (T <= 0 || W <= 0 || W > 32 * kMaxWpl) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W <= 32 * 2)
    return launch<2>(text, peq, n_len, m_len, dist, B, T, W, s);
  if (W <= 32 * 6)
    return launch<6>(text, peq, n_len, m_len, dist, B, T, W, s);
  return launch<kMaxWpl>(text, peq, n_len, m_len, dist, B, T, W, s);
}

// 64-bit integer operations of one pattern word in one text column (for
// the caller's operation count).
extern "C" int myers_ops_per_word_step() { return kOpsPerWordStep; }
