// Banded two-piece affine DP over a batch of pairs: one warp a pair, an
// anti-diagonal wavefront over the band.
//
// Replaces the lax.scan over target rows (vacmap_tpu/ops/affine_jax.py:162)
// of _affine_batch (:51): row i of pair b holds band lanes l = 0 .. W-1 at
// column j = l + i + dlo[b].  Global mode (GLOB) writes every row's
// traceback bytes, a (B, T, W) plane, rows past t_len included; the
// extension mode writes none and returns the best cell, its row and
// column and the z-drop flag.  Same values, masks, op priority (DIAG > E2
// > E1 > F2 > F1) and flag bits as the reference's step (:85-156) and the
// plain version, ops/affine_batch.py::affine_batch_ref; the CPU twin of
// this order is ops/affine_batch.py::affine_batch_wavefront_ref.
//
// What bounds it on an H100: one pair's dependent chain, on one warp.
// A pair is T dependent rows (up to 32,768 in the extension mode), a
// launch takes as long as its longest pair, and a warp alone on its SM
// partition issues every instruction itself: from K = 4 up the cells'
// maxima, compares and selects (the half-rate ALU pipe) set the pace,
// at K = 1 the two shuffle rounds a row (PERF.md, the kernel table).
//
// The step rule.  Cell (i, l) reads its left neighbour (i, l-1), the cell
// above, (i-1, l+1), and its diagonal (i-1, l).  At step s = 2i + l
// every input was made at step s-1 or s-2, so the cells of one step are
// independent.  Thread t holds the K = W / 32 lanes K t .. K t + K-1 in
// registers; a step computes the K / 2 lanes of its parity, each on a
// row of its own (lanes 2m and 2m+1 on row ib - m, ib = p - K t / 2 at
// step pair p), and a pair of steps is one row for every lane.  No step
// waits on a scan or a butterfly: it has one round of independent
// shuffles and K / 2 independent cells.
// What each lane carries:
//  - to the right, along its row: the cummaxes run1, run2 (the
//    reference's cummax as run[l] = max(run[l-1], base[l]), exact in any
//    order), F1 and F2 (for the F extension flags) and the row's best so
//    far (value, lane; a strict > keeps the lowest lane among equal
//    maxima, argmax's first index).  Lane K t - 1 of thread t - 1 comes
//    by one __shfl_up_sync at the even step;
//  - to the left, for the next row: H, E1 and E2 (lane l-1's cell above
//    and its own diagonal).  Lane K (t+1) comes by one __shfl_down_sync
//    at the odd step.
// A row's best is complete at lane W-1 (thread 31) at step 2i + W - 1:
// thread 31 alone updates best, best_i, best_j and dead there; in the
// extension mode the warp stops a pair after dead is set (a vote issued
// at the top of the pair, off the cells' chain).  The lanes further left
// have then run up to W/2 - 1 rows past the drop, which changes nothing.
// At K = 1 (W = 32, the mapping step's band) every other thread idles on
// a step and each step shuffles both ways: a row's chain is two shuffle
// rounds and two dependent cells however the 32 lanes are laid out, and
// two lanes a thread on 16 threads would only issue fewer shuffles.
// Masks: at pair p lane l is on row p - l / 2 and column p + dlo +
// (l + 1) / 2, so which cells are in band, on column 0 or past the last
// row follows from p alone; the pairs run in ranges (Band::run_all) and
// the cells of a range where every cell is in band (kFull), or none is
// (kVoid), skip the masks' compares and selects.  Before its first row a
// lane computes a cell all the same and keeps row 0's H, E1 and E2 (a
// select, no branch); past the last row its cells are never read.
// Bytes: the query is staged in shared memory (Q <= 48 KB, MAX_Q: the
// only input staged, so no limit moves); a thread's K / 2 cells of a step
// read consecutive query bytes and K / 2 consecutive target rows, so both
// come from per-thread byte windows in registers that shift one byte a
// pair (the target byte read from global memory a pair ahead), one XOR
// for K / 2 lanes.  Per-lane constants stay in registers or are read once
// a step (column 0's H): a table read per cell, at a stride of K lanes
// between threads, conflicts in the shared memory banks.  In the global
// mode a cell's byte is made at step 2i + l, so a row is finished W - 1
// steps after it starts: lanes write their bytes into a shared ring of
// at least W / 2 + 2 R rows (the rows in flight and two blocks), lanes
// 2m and 2m+1 as one 16-bit store, and each finished block of R rows
// leaves as one contiguous R W-byte span of tb[b] through the bulk copy
// engine (cp.async.bulk after fence.proxy.async; wait_group.read before
// a block's slots are reused; probe_affine.py times it beside 16-byte
// stores by the whole warp).  The ring and the query
// pass 48 KB at W = 256 and 512, so the launch raises the kernel's
// dynamic shared memory limit there.
// Floating point stays float32 and keeps the reference's operands and
// order ((H - o1) - e1, F as (run[l-1] - l e) - o; build flag
// -fmad=false, no fast-math intrinsics): NEG = -1e9 enters every
// out-of-band and masked lane and -1e9 + k e rounds, so another type or
// order would change masked cells' bytes; only maxima are taken in
// another order, which is exact.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

// the plane's ring: blocks of R rows (4 KB from W = 128 on) and at
// least W / 2 + 2 R rows, a multiple of R, so a block is contiguous in
// the ring; a power of two up to W = 256 (slots by a mask), 272 rows
// (136 KB) at W = 512
template <int W>
struct Ring {
  static constexpr int R = W <= 128 ? 32 : 4096 / W;
  static constexpr int MIN = W / 2 + 2 * R;
  static constexpr int ROWS =
      W <= 256 ? (MIN <= 64 ? 64 : MIN <= 128 ? 128 : 256)
               : (MIN + R - 1) / R * R;
  static constexpr bool POW2 = (ROWS & (ROWS - 1)) == 0;
  static_assert(ROWS >= MIN && ROWS % R == 0, "ring too small");
};

// shared memory: each lane's column-0 H, the query, and in the global
// mode the ring
template <int W, bool GLOB>
size_t smem_bytes(int Q) {
  return 4 * (size_t)W + (size_t)((Q + 15) & ~15) +
         (GLOB ? (size_t)Ring<W>::ROWS * W : 0);
}

struct Cell {  // one cell's results
  float h, e1, e2, r1, r2, f1, f2, bv;
  int bl;
  uint32_t op;
};

// what a pair of steps knows of its cells' masks (warp-uniform): lanes
// before their first row (kStart), any cell in or out of band or on
// column 0 (kMixed), every cell in band (kFull), every cell out of band
// and off column 0 (kVoid: rows past t_len, columns past q_len), or
// lanes past the last row (kTail: as kMixed, and those rows write no
// plane bytes)
enum Mode { kStart, kMixed, kFull, kVoid, kTail };

// cell (i, l): hd its diagonal, hu/e1u/e2u the cell above, r1p .. blp
// the left neighbour's carries (NEG, NEG, NEG, NEG, -inf at lane 0), eq
// the query and target bytes' match, inb the cell in band (1 <= j <=
// q_len, i <= t_len), col0 column 0 (then ng is its H), le1 = l e1, le2
// = l e2.  Column 0 and the band exclude each other, so the reference's
// three masks of H are two selects here, and none in kFull and kVoid
template <bool GLOB, int MODE>
__device__ __forceinline__ Cell cell(const Params& p, float hd, float hu,
                                     float e1u, float e2u, float r1p,
                                     float r2p, float f1p, float f2p,
                                     float bvp, int blp, bool lane0, bool eq,
                                     bool inb, bool col0, float ng, int l,
                                     float le1, float le2) {
  if (MODE == kFull) inb = true, col0 = false;
  if (MODE == kVoid) inb = false, col0 = false;
  Cell c;
  const float diag = hd + (eq ? p.mat : p.mis);
  const float e1x = e1u - p.e1, e2x = e2u - p.e2;
  const float t1 = (hu - p.o1) - p.e1, t2 = (hu - p.o2) - p.e2;
  c.e1 = fmaxf(e1x, t1);
  c.e2 = fmaxf(e2x, t2);
  const float ee = fmaxf(c.e1, c.e2);
  const float h0 = fmaxf(diag, ee);
  const float m = col0 ? ng : (inb ? h0 : kNeg);
  const float b1 = m + le1, b2 = m + le2;
  c.r1 = lane0 ? b1 : fmaxf(r1p, b1);
  c.r2 = lane0 ? b2 : fmaxf(r2p, b2);
  c.f1 = (r1p - le1) - p.o1;
  c.f2 = (r2p - le2) - p.o2;
  const float ff = fmaxf(c.f1, c.f2);
  const float hm = inb ? fmaxf(h0, ff) : kNeg;
  const float h = col0 ? ng : hm;
  c.h = h;
  const bool take = hm > bvp;
  c.bv = take ? hm : bvp;
  c.bl = take ? l : blp;
  if (GLOB) {
    uint32_t op;
    if (MODE == kFull) {
      // h is the maximum of all five: the first of DIAG, E2, E1, F2, F1
      // equal to it is diag if h == diag, else the larger of the E and F
      // pairs (E on a tie), and within a pair E2 / F2 on a tie
      const uint32_t de = c.e2 >= c.e1 ? kDel2 : kDel1;
      const uint32_t di = c.f2 >= c.f1 ? kIns2 : kIns1;
      op = h == diag ? kDiag : (ee >= ff ? de : di);
    } else {
      op = kDiag;
      if (h == c.f1) op = kIns1;
      if (h == c.f2) op = kIns2;
      if (h == c.e1) op = kDel1;
      if (h == c.e2) op = kDel2;
      if (h == diag) op = kDiag;
    }
    // E extended: max(e x, t) kept e x, that is e x >= t
    op |= (e1x >= t1 ? kE1X : 0u) | (e2x >= t2 ? kE2X : 0u) |
          (c.f1 == f1p - p.e1 ? kF1X : 0u) | (c.f2 == f2p - p.e2 ? kF2X : 0u);
    c.op = op;
  } else {
    c.op = 0;
  }
  return c;
}

// a byte window of N bytes
template <int N>
using Win = typename std::conditional<(N > 4), uint64_t, uint32_t>::type;

template <int K, bool GLOB>
struct Band {
  static constexpr int W = 32 * K;
  static constexpr int H2 = K / 2;  // lanes a step (K >= 4)
  static constexpr int R = Ring<W>::R, ROWS = Ring<W>::ROWS;

  // ring slot r + 1 and r - m (0 <= m < ROWS)
  static __device__ __forceinline__ int slot_next(int r) {
    if constexpr (Ring<W>::POW2) return (r + 1) & (ROWS - 1);
    return r + 1 == ROWS ? 0 : r + 1;
  }
  static __device__ __forceinline__ int slot_back(int r, int m) {
    if constexpr (Ring<W>::POW2) return (r - m) & (ROWS - 1);
    return r - m < 0 ? r - m + ROWS : r - m;
  }

  const Params& p;
  const int t, b, T, Q, tl, ql, dlo, last;
  const uint8_t* tg;
  const uint8_t* qsh;
  const float* ngt;  // lane l's H at column 0 (row -dlo - l)
  const float lf0;   // this thread's first lane, as a float
  const float ng1;   // K = 1: this thread's lane's column-0 H
  uint8_t* ring;
  uint8_t* tb;
  // per lane: H, E1, E2 of its last row; its carries to the right
  float H[K], E1[K], E2[K], R1[K], R2[K], F1[GLOB ? K : 1], F2[GLOB ? K : 1],
      BV[K];
  int BL[K];
  // thread 31: the pair's best
  float best = kNeg;
  int best_i = 0, best_j = 0;
  bool dead = false;
  // byte windows (K >= 4): query bytes of this step's columns, target
  // bytes of this pair's rows; the target byte of the next pair
  Win<H2> qw = 0, tw = 0;
  uint32_t tnext = 0;
  int srow;  // ring slot of row ib (K >= 4) or of this thread's row

  __device__ __forceinline__ Band(const Params& p_, int t_, int b_, int tl_,
                                  int ql_, int dlo_, int last_,
                                  const uint8_t* tg_, const uint8_t* qsh_,
                                  const float* ngt_, uint8_t* ring_,
                                  uint8_t* tb_)
      : p(p_), t(t_), b(b_), T(p_.T), Q(p_.Q), tl(tl_), ql(ql_), dlo(dlo_),
        last(last_), tg(tg_), qsh(qsh_), ngt(ngt_), lf0((float)(K * t_)),
        ng1(ngt_[t_]), ring(ring_), tb(tb_) {
    const int l0 = K * t;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      // row 0: H(0, j) for j = l + dlo
      const int j0 = l0 + k + dlo;
      const float fj = (float)j0;
      const float gap0 = fminf(p.o1 + p.e1 * fj, p.o2 + p.e2 * fj);
      H[k] = (j0 > 0 && j0 <= ql) ? -gap0 : (j0 == 0 ? 0.0f : kNeg);
      E1[k] = E2[k] = R1[k] = R2[k] = BV[k] = kNeg;
      BL[k] = 0;
      if (GLOB) F1[k] = F2[k] = kNeg;
    }
    if constexpr (K == 1) {
      // thread t's row at pair 1 is 1 - t / 2
      tnext = tg[clampi(-(t >> 1), T)];
      srow = ROWS - (t >> 1) - 1;
    } else {
      // pair 1: ib = 1 - H2 t, columns from jb = 1 + H2 t + dlo
      const int jb = 1 + H2 * t + dlo;
#pragma unroll
      for (int m = 0; m < H2; ++m)
        qw |= (Win<H2>)qsh[clampi(jb - 1 + m, Q)] << (8 * m);
      tnext = tg[clampi(-H2 * t, T)];
      srow = ROWS - H2 * t - 1;
    }
  }

  static __device__ __forceinline__ int clampi(int v, int n) {
    return min(max(v, 0), n - 1);
  }

  __device__ __forceinline__ static uint32_t byte_of(uint64_t w, int m) {
    return (uint32_t)(w >> (8 * m)) & 0xffu;
  }

  // row ic's best at lane W-1 (thread 31)
  __device__ __forceinline__ void row_best(int ic, float rb, int rl) {
    const bool in_t = ic <= tl;
    if (rb > best && !dead && in_t) {
      best = rb;
      best_i = ic;
      best_j = rl + ic + dlo;
    }
    if (!GLOB && p.zdrop_on && in_t && best - rb > p.zdrop) dead = true;
  }

  // rows up to c are finished: c ends a block of R rows, or is T
  __device__ __forceinline__ void flush(int c) {
    const int r0 = (c - 1) & ~(R - 1);  // the block's first row, 0-based
    const int n = (c - r0) * W;
    const uint8_t* src = ring + (r0 % ROWS) * W;
    uint8_t* dst = tb + ((size_t)b * T + r0) * W;
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (t == 0) {
      const uint32_t s = (uint32_t)__cvta_generic_to_shared(src);
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
              dst),
          "r"(s), "r"(n)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      // the block before this one has been read: its slots are free
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
    }
    __syncwarp();
  }

  __device__ __forceinline__ void finish() {
    if (GLOB && t == 0)
      asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }

  // lane k's cell made: its carries always; H, E1 and E2 only from its
  // first row on (before it, the cell above of lane k - 1's first row and
  // its own diagonal are row 0's).  Cells of rows past last change
  // nothing that a row up to last reads (kTail keeps them out of the
  // ring), and a ring slot written for a row below 1 is a later row's,
  // never flushed before and written again before its flush
  __device__ __forceinline__ void keep(int k, const Cell& c, bool started) {
    H[k] = started ? c.h : H[k];
    E1[k] = started ? c.e1 : E1[k];
    E2[k] = started ? c.e2 : E2[k];
    R1[k] = c.r1, R2[k] = c.r2, BV[k] = c.bv, BL[k] = c.bl;
    if (GLOB) F1[k] = c.f1, F2[k] = c.f2;
  }

  // one pair of steps (2p, 2p + 1), K >= 4
  template <int MODE>
  __device__ __forceinline__ void pair(int pp) {
    constexpr bool START = MODE == kStart;
    const int l0 = K * t;
    const int ib = pp - H2 * t;       // the row of lanes 0 and 1
    const int jb = pp + H2 * t + dlo;  // the column of lane 0
    tw = (tw << 8) | tnext;            // byte m: target row ib - m
    tnext = tg[clampi(ib, T)];         // row ib + 1, for the next pair
    const uint32_t qnew = qsh[clampi(jb - 1 + H2, Q)];
    if (GLOB) srow = slot_next(srow);

    // even step: lanes 2m, row ib - m, column jb + m; in band for m in
    // lo .. hi, column 0 at m = -jb
    float r1l = __shfl_up_sync(kAll, R1[K - 1], 1);
    float r2l = __shfl_up_sync(kAll, R2[K - 1], 1);
    float f1l = GLOB ? __shfl_up_sync(kAll, F1[K - 1], 1) : kNeg;
    float f2l = GLOB ? __shfl_up_sync(kAll, F2[K - 1], 1) : kNeg;
    float bvl = __shfl_up_sync(kAll, BV[K - 1], 1);
    int bll = __shfl_up_sync(kAll, BL[K - 1], 1);
    if (t == 0) {
      r1l = r2l = f1l = f2l = kNeg;
      bvl = -INFINITY;
    }
    const int rlo = ib - tl;  // rows past t_len are out of band
    int lo = max(1 - jb, rlo), hi = ql - jb;
    float ng = ngt[clampi(l0 - 2 * jb, W)];
    const Win<H2> x0 = qw ^ tw;
    uint32_t ev[H2] = {};
#pragma unroll
    for (int m = 0; m < H2; ++m) {
      const int k = 2 * m, i = ib - m;
      const bool lo0 = k == 0;
      const float lf = lf0 + (float)k;
      const Cell c = cell<GLOB, MODE>(
          p, H[k], H[k + 1], E1[k + 1], E2[k + 1], lo0 ? r1l : R1[k - 1 + lo0],
          lo0 ? r2l : R2[k - 1 + lo0], lo0 ? f1l : F1[GLOB ? k - 1 + lo0 : 0],
          lo0 ? f2l : F2[GLOB ? k - 1 + lo0 : 0], lo0 ? bvl : BV[k - 1 + lo0],
          lo0 ? bll : BL[k - 1 + lo0], lo0 && t == 0, byte_of(x0, m) == 0,
          lo <= m && m <= hi, m == -jb, ng, l0 + k, lf * p.e1, lf * p.e2);
      keep(k, c, !START || i >= 1);
      if (GLOB) ev[m] = c.op;
    }
    // the query window moves one column: byte m is column jb + m's
    qw = (qw >> 8) | ((Win<H2>)qnew << (8 * (H2 - 1)));

    // odd step: lanes 2m + 1, row ib - m, column jb + m + 1
    float hr = __shfl_down_sync(kAll, H[0], 1);
    float e1r = __shfl_down_sync(kAll, E1[0], 1);
    float e2r = __shfl_down_sync(kAll, E2[0], 1);
    if (t == 31) hr = e1r = e2r = kNeg;
    lo = max(-jb, rlo), hi = ql - jb - 1;
    ng = ngt[clampi(l0 - 2 * jb - 1, W)];
    const Win<H2> x1 = qw ^ tw;
#pragma unroll
    for (int m = 0; m < H2; ++m) {
      const int k = 2 * m + 1, i = ib - m;
      const bool hi0 = k == K - 1;
      const int ku = hi0 ? k : k + 1;  // in range either way
      const float lf = lf0 + (float)k;
      const Cell c = cell<GLOB, MODE>(
          p, H[k], hi0 ? hr : H[ku], hi0 ? e1r : E1[ku], hi0 ? e2r : E2[ku],
          R1[k - 1], R2[k - 1], F1[GLOB ? k - 1 : 0], F2[GLOB ? k - 1 : 0],
          BV[k - 1], BL[k - 1], false, byte_of(x1, m) == 0,
          lo <= m && m <= hi, m == -jb - 1, ng, l0 + k, lf * p.e1,
          lf * p.e2);
      keep(k, c, !START || i >= 1);
      if (GLOB && (MODE != kTail || i <= last)) {
        uint8_t* at = ring + slot_back(srow, m) * W + l0 + k - 1;
        *reinterpret_cast<uint16_t*>(at) = (uint16_t)(ev[m] | (c.op << 8));
      }
    }
    const int ic = pp - W / 2 + 1;  // the row lane W - 1 finished
    if (t == 31 && ic >= 1 && ic <= last) row_best(ic, BV[K - 1], BL[K - 1]);
    if (GLOB && ic >= 1 && ((ic & (R - 1)) == 0 || ic == T)) flush(ic);
  }

  // one pair of steps at K = 1: thread t's lane t, row pp - t / 2, at the
  // step of its parity
  template <int MODE>
  __device__ __forceinline__ void pair1(int pp) {
    constexpr bool START = MODE == kStart;
    const int i = pp - (t >> 1);
    const int j = t + i + dlo;
    const uint32_t tc = tnext;
    tnext = tg[clampi(i, T)];  // row i + 1, for the next pair
    const bool eq = qsh[clampi(j - 1, Q)] == tc;
    if (GLOB) srow = slot_next(srow);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float r1l = __shfl_up_sync(kAll, R1[0], 1);
      float r2l = __shfl_up_sync(kAll, R2[0], 1);
      float f1l = GLOB ? __shfl_up_sync(kAll, F1[0], 1) : kNeg;
      float f2l = GLOB ? __shfl_up_sync(kAll, F2[0], 1) : kNeg;
      float bvl = __shfl_up_sync(kAll, BV[0], 1);
      const int bll = __shfl_up_sync(kAll, BL[0], 1);
      float hr = __shfl_down_sync(kAll, H[0], 1);
      float e1r = __shfl_down_sync(kAll, E1[0], 1);
      float e2r = __shfl_down_sync(kAll, E2[0], 1);
      if (t == 0) {
        r1l = r2l = f1l = f2l = kNeg;
        bvl = -INFINITY;
      }
      if (t == 31) hr = e1r = e2r = kNeg;
      if ((t & 1) == half) {
        const Cell c = cell<GLOB, MODE>(
            p, H[0], hr, e1r, e2r, r1l, r2l, f1l, f2l, bvl, bll, t == 0, eq,
            i <= tl && (unsigned)(j - 1) < (unsigned)ql, j == 0, ng1, t,
            lf0 * p.e1, lf0 * p.e2);
        keep(0, c, !START || i >= 1);
        if (GLOB && (MODE != kTail || i <= last))
          ring[srow * W + t] = (uint8_t)c.op;
      }
    }
    const int ic = pp - W / 2 + 1;
    if (t == 31 && ic >= 1 && ic <= last) row_best(ic, BV[0], BL[0]);
    if (GLOB && ic >= 1 && ((ic & (R - 1)) == 0 || ic == T)) flush(ic);
  }

  template <int MODE>
  __device__ __forceinline__ void step_pair(int pp) {
    if constexpr (K == 1) {
      pair1<MODE>(pp);
    } else {
      pair<MODE>(pp);
    }
  }

  // pairs pp .. hi - 1 in one mode; the extension mode stops a pair
  // after thread 31 has set dead
  template <int MODE>
  __device__ __forceinline__ void run(int& pp, int hi, bool& stop) {
    const bool stops = !GLOB && p.zdrop_on;
    for (; pp < hi && !stop; ++pp) {
      if (stops) stop = __any_sync(kAll, dead);
      step_pair<MODE>(pp);
    }
  }

  // every pair: at pair pp lane l is on row pp - l / 2 and column pp +
  // dlo + (l + 1) / 2, so the masks split the pairs into ranges: the
  // lanes start (kStart, pairs 1 .. W/2 - 1), then with every lane on a
  // row in 1 .. last come columns all below 0 (kVoid), some cells out of
  // band or on column 0 (kMixed), every cell in band (kFull), kMixed
  // again, rows all past t_len or columns all past q_len (kVoid); then
  // the band drains (kTail, up to last + W/2 - 1)
  __device__ __forceinline__ void run_all() {
    if (last < 1) return;  // no row
    const int P = last + W / 2 - 1;
    const int a = W / 2, z = last + 1;  // the steady pairs: a .. z - 1
    const auto in = [&](int v) { return min(max(v, a), max(z, a)); };
    const int v0 = in(-dlo - W / 2);            // columns all below 0 before
    const int v1 = in(min(tl + W / 2, ql - dlo + 1));  // void from here
    const int f0 = min(max(in(1 - dlo), v0), v1);
    const int f1 = min(max(in(min(tl, ql - dlo - W / 2) + 1), f0), v1);
    int pp = 1;
    bool stop = false;
    run<kStart>(pp, a, stop);
    run<kVoid>(pp, v0, stop);
    run<kMixed>(pp, f0, stop);
    run<kFull>(pp, f1, stop);
    run<kMixed>(pp, v1, stop);
    run<kVoid>(pp, max(z, a), stop);
    run<kTail>(pp, P + 1, stop);
  }
};

template <int K, bool GLOB>
__global__ void __launch_bounds__(32)
affine_band_kernel(const uint8_t* __restrict__ targets,
                   const uint8_t* __restrict__ queries,
                   const int* __restrict__ t_len, const int* __restrict__ q_len,
                   uint8_t* __restrict__ tb, float* __restrict__ best_out,
                   int* __restrict__ best_i_out, int* __restrict__ best_j_out,
                   int* __restrict__ dlo_out, uint8_t* __restrict__ dead_out,
                   Params p) {
  constexpr int W = 32 * K;
  extern __shared__ __align__(16) uint8_t smem[];
  float* ngt = reinterpret_cast<float*>(smem);
  uint8_t* qsh = smem + 4 * W;
  uint8_t* ring = qsh + ((p.Q + 15) & ~15);
  const int t = threadIdx.x;
  const int b = blockIdx.x;
  const int T = p.T, Q = p.Q;
  const int tl = t_len[b], ql = q_len[b];
  // the band's first offset, so that it holds the end cell: the
  // reference's floor division (affine_jax.py:71-72); >> 1 floors
  const int dq = ql - tl;
  const int dlo = max(min(0, dq) - ((W - (abs(dq) + 1)) >> 1), -tl);

  const uint8_t* qb = queries + (size_t)b * Q;
  if ((Q & 15) == 0 && (reinterpret_cast<uintptr_t>(qb) & 15) == 0) {
    for (int v = 16 * t; v < Q; v += 16 * 32)
      *reinterpret_cast<uint4*>(qsh + v) =
          *reinterpret_cast<const uint4*>(qb + v);
  } else {
    for (int v = t; v < Q; v += 32) qsh[v] = qb[v];
  }
  for (int l = t; l < W; l += 32) {
    // column 0 lies on row -dlo - l of lane l
    const float fi = (float)(-dlo - l);
    ngt[l] = -fminf(p.o1 + p.e1 * fi, p.o2 + p.e2 * fi);
  }
  if (!GLOB && b == 0 && tb != nullptr)  // the extension mode's (T,) zeros
    for (int v = t; v < T; v += 32) tb[v] = 0;
  __syncwarp();

  // past t_len the extension mode changes nothing; the plane has T rows
  const int last = GLOB ? T : min(T, max(tl, 0));
  Band<K, GLOB> s(p, t, b, tl, ql, dlo, last, targets + (size_t)b * T, qsh,
                  ngt, ring, tb);
  s.run_all();
  s.finish();
  if (t == 31) {
    best_out[b] = s.best;
    best_i_out[b] = s.best_i;
    best_j_out[b] = s.best_j;
    dead_out[b] = s.dead ? 1 : 0;
    dlo_out[b] = dlo;
  }
}

template <int K, bool GLOB>
cudaError_t launch(const void* targets, const void* queries, const void* t_len,
                   const void* q_len, void* tb, void* best, void* best_i,
                   void* best_j, void* dlo, void* dead, int B,
                   const Params& p, cudaStream_t stream) {
  constexpr int W = 32 * K;
  const size_t smem = smem_bytes<W, GLOB>(p.Q);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        affine_band_kernel<K, GLOB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  affine_band_kernel<K, GLOB><<<B, 32, smem, stream>>>(
      static_cast<const uint8_t*>(targets), static_cast<const uint8_t*>(queries),
      static_cast<const int*>(t_len), static_cast<const int*>(q_len),
      static_cast<uint8_t*>(tb), static_cast<float*>(best),
      static_cast<int*>(best_i), static_cast<int*>(best_j),
      static_cast<int*>(dlo), static_cast<uint8_t*>(dead), p);
  return cudaGetLastError();
}

template <bool GLOB>
cudaError_t launch_w(int W, const void* targets, const void* queries,
                     const void* t_len, const void* q_len, void* tb,
                     void* best, void* best_i, void* best_j, void* dlo,
                     void* dead, int B, const Params& p, cudaStream_t s) {
  switch (W) {
    case 32:
      return launch<1, GLOB>(targets, queries, t_len, q_len, tb, best, best_i,
                             best_j, dlo, dead, B, p, s);
    case 128:
      return launch<4, GLOB>(targets, queries, t_len, q_len, tb, best, best_i,
                             best_j, dlo, dead, B, p, s);
    case 256:
      return launch<8, GLOB>(targets, queries, t_len, q_len, tb, best, best_i,
                             best_j, dlo, dead, B, p, s);
    case 512:
      return launch<16, GLOB>(targets, queries, t_len, q_len, tb, best,
                              best_i, best_j, dlo, dead, B, p, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// targets (B, T) uint8, queries (B, Q) uint8, t_len, q_len (B,) int32 ->
// best (B,) float32, best_i, best_j, dlo (B,) int32 (dlo with the
// reference's floor division), dead (B,) uint8 and tb: when glob the (B,
// T, W) plane, else T bytes the kernel clears (the reference's zeros;
// may be null).  tb 16-byte aligned.  W in {32, 128, 256, 512}, Q <= 48
// KB.  One pair (one warp) a block.  Returns a cudaError_t (0 =
// launched).
extern "C" int affine_band_launch(const void* targets, const void* queries,
                                  const void* t_len, const void* q_len,
                                  void* tb, void* best, void* best_i,
                                  void* best_j, void* dlo, void* dead, int B,
                                  int T, int Q, int W, int glob, int match,
                                  int mismatch, int o1, int e1, int o2, int e2,
                                  int zdrop, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (T <= 0 || Q <= 0 || Q > kMaxQ || (glob && tb == nullptr) ||
      (reinterpret_cast<uintptr_t>(tb) & 15))
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
      glob ? launch_w<true>(W, targets, queries, t_len, q_len, tb, best,
                            best_i, best_j, dlo, dead, B, p, s)
           : launch_w<false>(W, targets, queries, t_len, q_len, tb, best,
                             best_i, best_j, dlo, dead, B, p, s);
  return (int)err;
}
