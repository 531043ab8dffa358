// Exact global edit distance of B (text, pattern) pairs: Myers' 1999
// bit-vector recurrence over the whole pattern (no band, no cap), one
// thread block a pair, one 64-bit pattern word a thread.
//
// Replaces examples/myers_pallas_device.py::_myers_kernel (:48), launched
// by _myers_device (:151 -> pl.pallas_call :154; vacmap_tpu/ops/
// myers_pallas.py in the reference's history).  That kernel lays 32-bit
// pattern words on 128 vector lanes and pairs on sublanes, scans the
// add's carries with a Kogge-Stone ladder each column and returns
// per-word score sums.  None of that is kept.
//
// What bounds it on an H100: the dependent chain of one pair, times (n +
// pipeline depth) steps, not operations.  A text column needs the column
// before it, and inside a column word w needs three bits of word w - 1
// (the carry out of its add, the top bits of its Ph and Mh).  The work,
// about 29 64-bit operations a word and column, is far below the card's
// rate (PERF.md: the bound is 1/100 of the time or less), and the
// divergence filter's launches carry about three pairs, so a launch lasts
// as long as its longest pair, on one SM.  A step is about 50 integer
// instructions issued in order by one warp (PERF.md: 58 ns alone on a
// scheduler); a pair of more than four warps shares the SM's four
// schedulers, so its step costs up to twice that.
//
// What the design does about that: word w at column i depends only on
// word w at column i - 1 and on those three bits of word w - 1 at column
// i, so the words run as a wavefront and a column costs one word's step,
// however long the pattern:
//  - the block has one thread per 64-bit word of the bucket (2, 6 or 14
//    warps); warps whose first word lies above the pair's top word,
//    (m - 1) / 64, exit before the loop (bits only move up, so words
//    above it never reach bit m - 1); lanes above it inside its warp run
//    along for the shuffles and are ignored;
//  - each thread keeps its word's Pv and Mv in registers and its Peq
//    values in shared memory, [code][word] with a zero plane for code 4,
//    so an Eq is one load, made a step ahead, off the chain; the text is
//    staged once;
//  - lane l computes column s - l at step s of its warp: X = Eq & Pv, the
//    add with word w - 1's carry, Ph and Mh, the shift with word w - 1's
//    top bits, the new Pv and Mv, in 32-bit halves (the add one carry
//    chain, the shifts funnel shifts).  It hands its carry out and its two
//    top bits on with one __shfl_up_sync, in the top byte of one word with
//    the text code of its next column, so only lane 0 reads an input from
//    shared memory;
//  - lane 0 of warp 0 reads carry 0, Ph 1 and Mh 0 (row 0 of the global
//    DP grows by one a column) with the codes, as the text is staged;
//    lane 0 of warp k > 0 reads the byte that warp k - 1's lane 31 handed
//    on, from a ring of kRing columns in shared memory.  Every kBlock steps
//    warp k - 1 publishes its column count with a release store and warp
//    k the count of columns it has read; each polls the other's with
//    acquire loads at the block's head (traps after a bounded spin: a lost
//    hand-over fails, it does not hang) and never inside a step.  Warp k
//    trails warp k - 1 by about 64 columns, so a pair takes about
//    n + 64 (warps - 1) + 31 steps;
//  - lane l > 0 spends its first l steps on columns before 0 with Eq 0
//    and no bits in, where (Pv, Mv) = (~0, 0) is a fixed point of the
//    recurrence with no bits out, so no select guards the state; after
//    column n - 1 nothing reads it.  The thread that owns bit m - 1 adds
//    Ph and subtracts Mh at that bit for columns below n and writes
//    m + score at the end.  A step has no branch, and there is no block
//    barrier after staging.
//
// A text code >= 4 matches nothing and a pattern code 4 sets no Peq bit
// (the host packs Peq), so an ambiguous base mismatches every base, an
// ambiguous base included, as in the TPU kernel.  The plain PyTorch twin
// of this order, ops/myers.py::myers_distances_wavefront_ref, is held bit
// for bit to the plain version on the CPU.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kMaxWords = 448;  // 448 * 64 = 28,672 pattern bases
constexpr int kMaxWarps = kMaxWords / 32;
constexpr int kBlock = 32;   // steps between two hand-overs of a warp
constexpr int kRing = 512;   // columns a hand-over ring holds
// bytes of a ring: a block's 32 columns lie in consecutive slots (one
// block of the 16 runs past slot 511, into the last 32)
constexpr int kRingBytes = kRing + kBlock;
constexpr int kPad = 64;     // code-4 columns staged after the text
constexpr int kCounts = 16;  // column counts a kind (at least kMaxWarps)
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];"
               : "=r"(v)
               : "r"(smem_addr(p))
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;" ::"r"(smem_addr(p)),
               "r"(v)
               : "memory");
}

// One byte to shared memory where pred holds: a predicated store, so the
// step has no branch around it.
__device__ __forceinline__ void st_byte(uint8_t* p, unsigned v, bool pred) {
  asm volatile("{.reg .pred q; setp.ne.b32 q, %2, 0;\n\t"
               "@q st.shared.u8 [%0], %1;}" ::"r"(smem_addr(p)),
               "r"(v), "r"((int)pred));
}

// Wait until *p >= need (acquire loads; trap after a bounded spin: a lost
// hand-over fails, it does not hang).
__device__ __forceinline__ void wait_for(const int* p, int need, int& seen) {
  for (int spins = 0; seen < need; ++spins) {
    if (spins == (1 << 26)) __trap();
    seen = ld_acquire(p);
  }
}

// Shared memory: Peq of the thread's word, [5][threads] (plane 4 zero:
// code 4 matches nothing); the hand-over rings, kRingBytes a warp; two
// kinds of column counts; the text as warp 0's lane-0 inputs.
__host__ __device__ __forceinline__ size_t smem_bytes(int threads, int T) {
  return (size_t)5 * threads * sizeof(u64) +
         (size_t)(threads / 32) * kRingBytes + 2 * kCounts * sizeof(int) +
         T + kPad;
}

// sum = X + Pv + (bit 31 of p), as 32-bit halves, and its carry out.
__device__ __forceinline__ void add_carry(unsigned p, unsigned x0, unsigned x1,
                                          unsigned v0, unsigned v1,
                                          unsigned& s0, unsigned& s1,
                                          unsigned& carry) {
  asm("{.reg .u32 t;\n\t"
      "add.cc.u32 t, %3, 0x80000000;\n\t"
      "addc.cc.u32 %0, %4, %6;\n\t"
      "addc.cc.u32 %1, %5, %7;\n\t"
      "addc.u32 %2, 0, 0;}"
      : "=r"(s0), "=r"(s1), "=r"(carry)
      : "r"(p), "r"(x0), "r"(x1), "r"(v0), "r"(v1));
}

// A lane's input and its packet: bit 31 the carry into the word, bits 30
// and 29 the Ph and Mh bits shifted in, bits 24-26 the text code of the
// lane's next column; its top byte goes through the rings.
__global__ void __launch_bounds__(kMaxWarps * 32)
myers_kernel(const uint8_t* __restrict__ text, const u64* __restrict__ peq,
             const int* __restrict__ n_len, const int* __restrict__ m_len,
             int* __restrict__ dist, int T, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int threads = blockDim.x, warps = threads >> 5;
  u64* peq_sh = reinterpret_cast<u64*>(smem);
  uint8_t* rings = smem + (size_t)5 * threads * sizeof(u64);
  int* ready = reinterpret_cast<int*>(rings + (size_t)warps * kRingBytes);
  int* consumed = ready + kCounts;
  uint8_t* tsh = reinterpret_cast<uint8_t*>(consumed + kCounts);
  const int job = blockIdx.x;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;

  int n = n_len[job];
  n = n < 0 ? 0 : (n > T ? T : n);
  int m = m_len[job];
  m = m < 1 ? 1 : (m > W * 64 ? W * 64 : m);
  const int top = (m - 1) >> 6;  // the pair's top word

  // warp 0's lane-0 input for column v - 1: carry 0, Ph 1, Mh 0 and the
  // code of column v
  const uint8_t* tj = text + (size_t)job * T;
  for (int v = t; v < T + kPad; v += threads)
    tsh[v] = (uint8_t)(0x40u | (v < n ? tj[v] : 4u));
  // ring slots not yet written hold code 4 (lane 0 reads a slot for its
  // next column every step, also past the pair's last column)
  for (int v = t; v < warps * kRingBytes; v += threads) rings[v] = 4u;
  if (t < warps) {
    ready[t] = 0;
    consumed[t] = 0;
  }
  // the word's Peq values, coalesced: Peq is [c][w]
  const u64* pg = peq + (size_t)job * 4 * W;
#pragma unroll
  for (int c = 0; c < 5; ++c)
    peq_sh[c * threads + t] = c < 4 && t < W ? pg[(size_t)c * W + t] : 0ull;
  __syncthreads();
  if (warp * 32 > top) return;

  const int bit = (m - 1) & 63;  // bit m - 1 in the top word
  const bool feeds = warp < top / 32;  // hands over to a warp that computes
  // column c of a block of columns 32k + 1 .. 32k + 32 lies at slot
  // ((32k + 1) & src_mask) + c - 32k - 1 of the lane-0 inputs: the rings,
  // or for warp 0 the staged text (at c)
  uint8_t* ring_out = rings + (size_t)warp * kRingBytes;
  const uint8_t* src =
      warp == 0 ? tsh + 1 : rings + (size_t)(warp - 1) * kRingBytes;
  const int src_mask = warp == 0 ? -1 : kRing - 1;
  const int* ready_in = ready + (warp > 0 ? warp - 1 : 0);
  const u64* pe = peq_sh + t;
  int avail = warp == 0 ? INT_MAX : 0, room = 0;

  // Before the block of steps s0 .. s0 + 31: lane 0 reads columns up to
  // s0 + 32; the warp writes columns up to s0 into its ring, over columns
  // up to s0 - kRing, which the next warp must have read.
  auto head = [&](int s0) {
    wait_for(ready_in, s0 + kBlock + 1 < n ? s0 + kBlock + 1 : n, avail);
    if (feeds) wait_for(consumed + warp + 1, s0 + 1 - kRing, room);
  };

  head(0);
  const unsigned first = tsh[0] & 7u;  // the code of column 0
  u64 Pv = ~0ull, Mv = 0ull;
  u64 eq = lane == 0 ? pe[first * threads] : 0ull;
  // Lane l > 0 computes column s - l < 0 in its first l steps on Eq 0 and
  // no bits in, where (Pv, Mv) = (~0, 0) is a fixed point with no bits
  // out, so no select guards the state; lane 1 gets the code of column 0.
  // (written as three shifted cases: folding the shift into one select
  // moved ptxas's schedule of the loop and cost 14-16% at T = 2048 and
  // 8192, PERF.md)
  unsigned P = lane == 0   ? (unsigned)src[((1 - kBlock) & src_mask) + kBlock - 1]
                               << 24
               : lane == 1 ? first << 24
                           : 4u << 24;
  int score = 0;
  for (int s0 = 0; s0 < n + 31; s0 += kBlock) {
    const uint8_t* in_block = src + ((s0 + 1) & src_mask);
    uint8_t* out_block = ring_out + ((s0 + 1 - kBlock) & (kRing - 1));
    const int live = n - s0 + lane;  // step u's column is below n if u < live
#pragma unroll
    for (int u = 0; u < kBlock; ++u) {
      const unsigned v = in_block[u];  // lane 0's next input
      const unsigned pv0 = (unsigned)Pv, pv1 = (unsigned)(Pv >> 32);
      const unsigned mv0 = (unsigned)Mv, mv1 = (unsigned)(Mv >> 32);
      const unsigned eq0 = (unsigned)eq, eq1 = (unsigned)(eq >> 32);
      unsigned sum0, sum1, carry;
      add_carry(P, eq0 & pv0, eq1 & pv1, pv0, pv1, sum0, sum1, carry);
      const unsigned xh0 = (sum0 ^ pv0) | eq0, xh1 = (sum1 ^ pv1) | eq1;
      const unsigned ph0 = mv0 | ~(xh0 | pv0), ph1 = mv1 | ~(xh1 | pv1);
      const unsigned mh0 = pv0 & xh0, mh1 = pv1 & xh1;
      const u64 Ph = (u64)ph1 << 32 | ph0, Mh = (u64)mh1 << 32 | mh0;
      const int d = (int)((Ph >> bit) & 1ull) - (int)((Mh >> bit) & 1ull);
      score += u < live ? d : 0;
      // shift by one pattern row, the word below's top bits coming in
      const unsigned phs0 = __funnelshift_l(P << 1, ph0, 1);
      const unsigned phs1 = __funnelshift_l(ph0, ph1, 1);
      const unsigned mhs0 = __funnelshift_l(P << 2, mh0, 1);
      const unsigned mhs1 = __funnelshift_l(mh0, mh1, 1);
      const unsigned xv0 = eq0 | mv0, xv1 = eq1 | mv1;
      Pv = (u64)(mhs1 | ~(xv1 | phs1)) << 32 | (mhs0 | ~(xv0 | phs0));
      Mv = (u64)(phs1 & xv1) << 32 | (phs0 & xv0);
      eq = pe[((P >> 24) & 7u) * threads];  // the next column's
      const unsigned pkt = carry << 31 | ((ph1 >> 1) & 0x40000000u) |
                           ((mh1 >> 2) & 0x20000000u) | (P & 0x07000000u);
      st_byte(out_block + u, pkt >> 24, lane == 31 && feeds);
      const unsigned up = __shfl_up_sync(kAll, pkt, 1);
      P = lane == 0 ? v << 24 : up;
    }
    // hand over: lane 31 has written columns up to s0, lane 0 read
    // columns up to s0 + 32
    if (lane == 31 && feeds) st_release(ready + warp, s0 + 1);
    if (lane == 0) st_release(consumed + warp, s0 + kBlock + 1);
    head(s0 + kBlock);
  }
  if (t == top) dist[job] = m + score;
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
  if (T <= 0 || W <= 0 || W > kMaxWords) return (int)cudaErrorInvalidValue;
  const int threads = 32 * ((W + 31) / 32);
  const size_t bytes = smem_bytes(threads, T);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        myers_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  myers_kernel<<<B, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(text), static_cast<const u64*>(peq),
      static_cast<const int*>(n_len), static_cast<const int*>(m_len),
      static_cast<int*>(dist), T, W);
  return (int)cudaGetLastError();
}
