// The full-width global two-piece affine fill of one job on an
// anti-diagonal wavefront, shared by fill_full.cu (row-run walk) and
// fill_scan.cu (lockstep op walk), and the shared-memory ring of table
// rows that fill_full.cu's walk reads.
//
// Computes what vacmap_tpu/ops/affine_pallas.py::_fill_body (:73)
// computes for _fill_tb_kernel (:172) and _fill_kernel (:166): the same
// traceback byte per cell (op in bits 0-2: 0=DIAG 1=E1 2=E2 3=F1 4=F2,
// DIAG winning ties; ext flags 8/16/32/64).  The bytes of rows 1..tl go
// to device memory as an (N, N) row-major table per job; rows past tl
// are not filled, since no walk reads them.
//
// What bounds it on an H100: the latency of one job.  A job is tl
// dependent rows (each cell needs its left, upper and upper-left
// neighbours) and then a walk of up to tl + ql dependent steps; the cells
// are a few dozen operations each and the table N*N bytes, far below the
// card's rates (the bound is 1/50 of the time or less).  A launch lasts as
// long as its longest job, and the executor's full-width launches hold
// four jobs.  So a job gets a warp per 128 columns and nothing to wait
// for but its own chain:
//  - lane l of the job holds the C consecutive columns C*l+1 .. C*l+C
//    (C = 4 from N = 128 up, fewer below: a warp per 128 columns, 2 at
//    N = 256 and 4 at N = 512; more columns a lane, or fewer, measured
//    slower, PERF.md), with their H, E1, E2 and query characters in
//    registers; the target plane is staged in shared memory once;
//  - at step s, lane l computes row i = s - l of its columns, so a warp
//    runs rows on an anti-diagonal: tl + 31 steps, each C cells issued in
//    order around four shuffles.  The horizontal gap runs through a
//    lane's columns by its recurrence,
//        F(j) = max(F(j-1) - e, H0(j-1) - (o + e)),
//    started from the left lane's last column, which comes with one
//    shuffle a value a step (H, H0, F1, F2 of its row i + 1 arrive for the
//    next step; the H received a step earlier is the diagonal input).
//    There is no scan, no block barrier and no shared-memory exchange
//    inside a warp;
//  - lane 0 of warp w + 1 takes warp w's last column from a row buffer in
//    shared memory, published every kPublish rows with a release store of
//    the row count that it polls with acquire loads; warp 0's lane 0
//    takes column 0 (H(i, 0) = -gapf(i), no F) from the same kind of
//    buffer, staged with the target.  The warps never meet at a barrier
//    until the fill is done, and a step has no branch but the poll: the
//    row's bytes and the hand-over are predicated stores;
//  - a cell is int32 maxima written as Hopper's DPX __vibmax_s32, which
//    gives each maximum and, as a predicate, which side won (a compare
//    and a select each), so the op and the four ext flags come from the
//    maxima themselves; each lane writes its C bytes of a row as one
//    store.
// Why these are the reference's bytes: the reference works in f32 with
// NEG = -1e9 and takes F as a prefix maximum, F(j) = max(H(i,0),
// max_{j'<j} H0(j') + j'e) - j e - o; unrolled, the recurrence is the
// same maximum.  With match 2, mismatch -4, gaps min(4 + 2l, 24 + l) and
// N <= 1024 every value a cell can hold is an integer far below 2^24, so
// the f32 arithmetic is exact and equals this int32 arithmetic; NEG only
// enters as E of row 0 and the left F of column 1, where NEG - e (f32:
// rounded back to NEG; int32: NEG - e) loses every maximum and every
// equality test in both.  The plain PyTorch twin of this decomposition,
// ops/affine_fill.py::_fill_bits_wavefront_ref, is held to the reference
// bit for bit on the CPU.
//
// fill_full.cu's walk reads the table, which the fill leaves in L2,
// through a ring of rows in shared memory (RowRing): the warp copies
// kChunk rows at a time with cp.async (16 bytes a lane), kSlots - 1
// chunks ahead, so a step is a shared-memory read instead of an L2 round
// trip.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNeg = -1000000000;  // the reference's NEG
constexpr int kMaxN = 1024;
constexpr int kMaxCols = 4;   // columns a lane from N = 128 up
constexpr int kPad = 32;      // target bytes staged before row 1 (and after)
constexpr int kPublish = 8;   // rows a warp hands on to the next at once
constexpr int kChunk = 8;     // table rows a ring slot holds
constexpr int kSlots = 4;     // ring slots (at least 3)
constexpr unsigned kAll = 0xffffffffu;

struct Scoring {
  int mat, mis, e1, e2, o1, o2, o1e1, o2e2;
};

inline Scoring make_scoring(int match, int mismatch, int o1, int e1, int o2,
                            int e2) {
  return Scoring{match, mismatch, e1, e2, o1, o2, o1 + e1, o2 + e2};
}

// Columns a lane holds for width N, and warps a job.
inline int cols_a_lane(int N) {
  int c = 1;
  while (32 * c < N && c < kMaxCols) c *= 2;
  return c;
}

inline int warps_a_job(int N) {
  const int per_warp = 32 * cols_a_lane(N);
  return (N + per_warp - 1) / per_warp;
}

__host__ __device__ constexpr int pad16(int n) { return (n + 15) & ~15; }

// The block's dynamic shared memory: the rows each warp's lane 0 takes
// its left column from (int4 H, H0, F1, F2 of rows 0..N: column 0 for
// warp 0, warp w - 1's last column for warp w; W + 1 of them, the last
// written by the last warp and not read), the rows published of each,
// the staged target plane, the walk's ring of rows (ring_bytes) and the
// walk's output bytes (out_bytes).
struct Layout {
  int xch, ready, tsh, ring, out, total;
};

__host__ __device__ inline Layout layout(int N, int W, int ring_bytes,
                                         int out_bytes) {
  Layout L;
  L.xch = 0;
  L.ready = L.xch + (W + 1) * (N + 1) * 16;
  L.tsh = L.ready + pad16(4 * (W + 1));
  L.ring = L.tsh + pad16(N + 2 * kPad);
  L.out = L.ring + ring_bytes;
  L.total = L.out + pad16(out_bytes);
  return L;
}

__device__ __forceinline__ int gapf(const Scoring& sc, int l) {
  return min(sc.o1 + sc.e1 * l, sc.o2 + sc.e2 * l);
}

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

// The block stages the job's target plane at tsh[kPad ..] (code 4 around
// it: the wavefront's lanes before their first row and past tl read
// there) and column 0 (H(i, 0) = -gapf(i), no F) as warp 0's left
// column, all rows published; the other warps' counts start at 0.  Ends
// with a barrier.
__device__ __forceinline__ void stage(const uint8_t* __restrict__ tTb, int N,
                                      const Scoring& sc, uint8_t* tsh,
                                      int4* xch, int* ready) {
  for (int v = threadIdx.x; v < N + 2 * kPad; v += blockDim.x)
    tsh[v] = (v >= kPad && v < N + kPad) ? tTb[v - kPad] : 4;
  for (int i = threadIdx.x; i <= N; i += blockDim.x) {
    const int h = i == 0 ? 0 : -gapf(sc, i);
    xch[i] = make_int4(h, h, kNeg, kNeg);
  }
  if (threadIdx.x <= (blockDim.x >> 5))
    ready[threadIdx.x] = threadIdx.x == 0 ? N : 0;
  __syncthreads();
}

template <int C>
__device__ __forceinline__ void load_query(const uint8_t* __restrict__ p,
                                           bool live, int (&qc)[C]) {
  static_assert(C == 1 || C == 2 || C == 4, "columns a lane");
  uint32_t w = 0x04040404u;
  if (live) {
    if constexpr (C == 1) {
      w = p[0];
    } else if constexpr (C == 2) {
      w = *reinterpret_cast<const uint16_t*>(p);
    } else {
      w = *reinterpret_cast<const uint32_t*>(p);
    }
  }
#pragma unroll
  for (int k = 0; k < C; ++k) qc[k] = (w >> (8 * k)) & 255;
}

// The C bytes of a lane's row (byte k of w), where pred holds: one
// predicated store, so the row loop has no branch around it.
template <int C>
__device__ __forceinline__ void store_bytes(uint8_t* p, uint32_t w,
                                            bool pred) {
  if constexpr (C == 1) {
    asm volatile("{.reg .pred p; setp.ne.b32 p, %2, 0;\n\t"
                 "@p st.global.b8 [%0], %1;}" ::"l"(p), "r"(w),
                 "r"((int)pred));
  } else if constexpr (C == 2) {
    asm volatile("{.reg .pred p; setp.ne.b32 p, %2, 0;\n\t"
                 "@p st.global.b16 [%0], %1;}" ::"l"(p),
                 "h"((unsigned short)w), "r"((int)pred));
  } else {
    asm volatile("{.reg .pred p; setp.ne.b32 p, %2, 0;\n\t"
                 "@p st.global.b32 [%0], %1;}" ::"l"(p), "r"(w),
                 "r"((int)pred));
  }
}

// Lane 31's last column of row i for the next warp, where pred holds, and
// the row count published (a release store) where pub holds.
__device__ __forceinline__ void hand_over(int4* x, int h, int h0, int f1,
                                          int f2, bool pred, int* cnt, int i,
                                          bool pub) {
  asm volatile("{.reg .pred p; setp.ne.b32 p, %5, 0;\n\t"
               "@p st.shared.v4.b32 [%0], {%1, %2, %3, %4};}" ::"r"(smem_addr(x)),
               "r"(h), "r"(h0), "r"(f1), "r"(f2), "r"((int)pred));
  asm volatile("{.reg .pred p; setp.ne.b32 p, %2, 0;\n\t"
               "@p st.release.cta.shared.b32 [%0], %1;}" ::"r"(smem_addr(cnt)),
               "r"(i), "r"((int)pub)
               : "memory");
}

// One lane's columns j0 + 1 .. j0 + C and what it has received.
template <int C>
struct Lane {
  int H[C], E1[C], E2[C];  // the lane's row so far
  int qc[C];               // query characters
  // the left column's H of the row before (the diagonal input), its H of
  // this row as received, and its H0, F1, F2 of this row
  int dH, rH, lH0, lF1, lF2;
  int tc;     // the target character of this step's row
  int avail;  // rows of the left column published
};

// H, E1, E2 of row 0 at columns j0 + 1 .. j0 + C.
template <int C>
__device__ __forceinline__ void row0(Lane<C>& a, int j0, const Scoring& sc) {
#pragma unroll
  for (int k = 0; k < C; ++k) {
    a.H[k] = -gapf(sc, j0 + k + 1);
    a.E1[k] = kNeg;
    a.E2[k] = kNeg;
  }
}

// Step s of the wavefront in one lane: row i = s - lane of its columns,
// its bytes, and the left column of row i + 1.  In the first 32 steps
// (kHead) the lane whose row is 0 reloads row 0, so that its first row
// starts from there; before that its rows are never stored.
template <int C, bool kHead>
__device__ __forceinline__ void step(Lane<C>& a, int s, int lane, int j0,
                                     bool live, int tl, int N,
                                     const Scoring& sc, const uint8_t* tsh,
                                     const int4* xin, int* rin, int4* xout,
                                     int* rout, uint8_t* __restrict__ tab) {
  const int i = s - lane;
  const int tc_next = tsh[kPad + i];
  const int tm = a.tc < 4 ? a.tc : 256;  // code 4 matches nothing
  int hd = a.dH, h0l = a.lH0, f1 = a.lF1, f2 = a.lF2;
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int hold = a.H[k];
    const int diag = hd + (a.qc[k] == tm ? sc.mat : sc.mis);
    bool pe1, pe2, pf1, pf2, p12, pd, pf, ph;
    const int E1n = __vibmax_s32(a.E1[k] - sc.e1, hold - sc.o1e1, &pe1);
    const int E2n = __vibmax_s32(a.E2[k] - sc.e2, hold - sc.o2e2, &pe2);
    const int H0 = __vibmax_s32(diag, __vibmax_s32(E1n, E2n, &p12), &pd);
    const int F1 = __vibmax_s32(f1 - sc.e1, h0l - sc.o1e1, &pf1);
    const int F2 = __vibmax_s32(f2 - sc.e2, h0l - sc.o2e2, &pf2);
    const int Hn = __vibmax_s32(H0, __vibmax_s32(F1, F2, &pf), &ph);
    // DIAG > E1 > E2 > F1 > F2: the first maximum that each winner won
    const uint32_t op = ph ? (pd ? 0u : (p12 ? 1u : 2u)) : (pf ? 3u : 4u);
    const uint32_t bb = op | (pe1 ? 8u : 0u) | (pe2 ? 16u : 0u) |
                        (pf1 ? 32u : 0u) | (pf2 ? 64u : 0u);
    w |= bb << (8 * k);
    hd = hold;
    h0l = H0;
    f1 = F1;
    f2 = F2;
    a.H[k] = Hn;
    a.E1[k] = E1n;
    a.E2[k] = E2n;
  }
  store_bytes<C>(tab + (i - 1) * N + j0, w, live && i >= 1 && i <= tl);
  if constexpr (kHead) {
    if (i == 0) row0<C>(a, j0, sc);
  }
  const bool mine = lane == 31 && i >= 1 && i <= tl;
  hand_over(xout + i, a.H[C - 1], h0l, f1, f2, mine, rout, i,
            mine && (i % kPublish == 0 || i == tl));
  // the left column of row s + 1 - lane, for the next step: lane 0's
  // from xin (column 0, or the warp before), the others' from the lane
  // before
  const int nxt = s + 1;
  const int need = min(nxt, tl);
  if (a.avail < need) {
    for (int spins = 0; a.avail < need; ++spins) {
      if (spins == (1 << 26)) __trap();  // a lost hand-over: fail, not hang
      a.avail = ld_acquire(rin);
    }
  }
  const int4 v = xin[min(nxt, N)];
  const int sH = __shfl_up_sync(kAll, a.H[C - 1], 1);
  const int sH0 = __shfl_up_sync(kAll, h0l, 1);
  const int sF1 = __shfl_up_sync(kAll, f1, 1);
  const int sF2 = __shfl_up_sync(kAll, f2, 1);
  a.dH = a.rH;
  a.rH = lane == 0 ? v.x : sH;
  a.lH0 = lane == 0 ? v.y : sH0;
  a.lF1 = lane == 0 ? v.z : sF1;
  a.lF2 = lane == 0 ? v.w : sF2;
  a.tc = tc_next;
}

// Fill rows 1..tl of one job: thread t holds columns C t + 1 .. C t + C;
// tQb is the job's query plane in device memory, tsh the staged target,
// xch / ready the left columns and their counts (stage()), and tab the
// job's (N, N) byte table.  Lanes before their first row and past tl
// compute rows that are never stored.
template <int C>
__device__ __forceinline__ void fill_rows(const uint8_t* __restrict__ tQb,
                                          const uint8_t* tsh, int tl, int N,
                                          const Scoring& sc, int4* xch,
                                          int* ready,
                                          uint8_t* __restrict__ tab) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j0 = C * threadIdx.x;
  const bool live = j0 < N;
  const int4* xin = xch + warp * (N + 1);
  int4* xout = xch + (warp + 1) * (N + 1);  // the last warp's goes unread

  Lane<C> a;
  load_query<C>(tQb + (live ? j0 : 0), live, a.qc);
  row0<C>(a, j0, sc);
  a.dH = j0 == 0 ? 0 : -gapf(sc, j0);  // H(0, j0)
  a.rH = a.dH;
  a.lH0 = 0;
  a.lF1 = a.lF2 = kNeg;
  a.tc = tsh[kPad - 1 - lane];
  a.avail = 0;
  int s = 0;
  for (const int head = min(32, tl + 32); s < head; ++s)
    step<C, true>(a, s, lane, j0, live, tl, N, sc, tsh, xin, ready + warp,
                  xout, ready + warp + 1, tab);
  for (; s <= tl + 31; ++s)
    step<C, false>(a, s, lane, j0, live, tl, N, sc, tsh, xin, ready + warp,
                   xout, ready + warp + 1, tab);
}

__device__ __forceinline__ int clamp_len(int v, int N) {
  return v < 0 ? 0 : (v > N ? N : v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__host__ __device__ constexpr int ring_bytes(int N) {
  return kSlots * kChunk * N;
}

// The table rows of a walk that visits rows in descending order, staged
// in chunks of kChunk rows (chunk c: rows kChunk c + 1 .. kChunk c +
// kChunk, in slot c % kSlots), kSlots - 1 chunks ahead, by the whole warp
// (every lane runs the walk, so its steps are uniform and the copies need
// no hand-over).  start(top) before the first row; enter(r) for r = top,
// top - 1, ... in turn before row r is read, after which rows r and r - 1
// can be read (enter() waits for the chunk below too).
struct RowRing {
  uint8_t* buf;  // kSlots * kChunk * N bytes
  const uint8_t* table;
  int N;

  // chunk c into its slot: one commit group, empty for c < 0
  __device__ __forceinline__ void fetch(int c) const {
    if (c >= 0) {
      const uint8_t* src = table + (size_t)c * kChunk * N;
      uint8_t* dst = buf + (c & (kSlots - 1)) * kChunk * N;
      for (int o = 16 * (threadIdx.x & 31); o < kChunk * N; o += 16 * 32)
        cp_async16(dst + o, src + o);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  }

  __device__ __forceinline__ void start(int top) const {
    const int c = (top - 1) / kChunk;
    for (int k = 0; k < kSlots - 1; ++k) fetch(c - k);
  }

  __device__ __forceinline__ void enter(int r, int top) const {
    if (r != top && r % kChunk != 0) return;  // inside the current chunk
    __syncwarp();  // every read of the slot fetch() refills is done
    fetch((r - 1) / kChunk - (kSlots - 1));
    asm volatile("cp.async.wait_group %0;" ::"n"(kSlots - 2) : "memory");
    __syncwarp();  // every lane's copies of this chunk and the next are in
  }

  __device__ __forceinline__ const uint8_t* row(int r) const {
    return buf + (((r - 1) / kChunk) & (kSlots - 1)) * kChunk * N +
           ((r - 1) % kChunk) * N;
  }

  // no copy may land after the walk: the block's shared memory goes to
  // the next block when it exits
  __device__ __forceinline__ void finish() const {
    asm volatile("cp.async.wait_all;" ::: "memory");
  }
};

}  // namespace
