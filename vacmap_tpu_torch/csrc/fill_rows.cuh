// The full-width global two-piece affine fill of one job by one thread
// block, one thread per column, shared by fill_full.cu (row-run walk) and
// fill_scan.cu (lockstep op walk).
//
// Computes what vacmap_tpu/ops/affine_pallas.py::_fill_body computes: the
// same cell recurrences, the same f32 arithmetic and NEG = -1e9, and the
// same per-cell traceback byte (op in bits 0-2: 0=DIAG 1=E1 2=E2 3=F1
// 4=F2, DIAG winning ties; ext flags 8/16/32/64).  The bytes of rows
// 1..tl go to device memory as an (N, N) row-major table per job; rows
// past tl are not filled, since no traceback reads them.
//
// Per row: the column's vertical state (E1, E2) stays in registers, the
// previous row's H is exchanged through shared memory for the diagonal
// move, and the horizontal gap F = prefix max of H0 + j*e is two
// warp-shuffle scans joined through shared memory (max is exact, so any
// order agrees with the reference's log-step rolls).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e9f;
constexpr int kMaxN = 1024;
constexpr int kMaxWarps = kMaxN / 32;

struct Scoring {
  float mat, mis, e1, e2, o1, o2, o1e1, o2e2;
};

inline Scoring make_scoring(int match, int mismatch, int o1, int e1, int o2,
                            int e2) {
  Scoring sc;
  sc.mat = (float)match;
  sc.mis = (float)mismatch;
  sc.e1 = (float)e1;
  sc.e2 = (float)e2;
  sc.o1 = (float)o1;
  sc.o2 = (float)o2;
  sc.o1e1 = (float)(o1 + e1);
  sc.o2e2 = (float)(o2 + e2);
  return sc;
}

__device__ __forceinline__ float gapf(const Scoring& sc, float l) {
  return fminf(sc.o1 + sc.e1 * l, sc.o2 + sc.e2 * l);
}

struct FillShared {
  float H[kMaxN];
  float scan1[kMaxN], scan2[kMaxN];
  float F1[kMaxN], F2[kMaxN];
  float wmax1[kMaxWarps], wmax2[kMaxWarps];
};

// Fill rows 1..tl of one job: thread t holds column j = t + 1 and reads
// its query character qc; tTb is the job's target plane and bitsb its
// (N, N) byte table.  blockDim.x == N.  Ends with a barrier, so the bytes
// of every row are visible to the whole block on return.
__device__ __forceinline__ void fill_rows(const uint8_t* __restrict__ tTb,
                                          int qc, int tl, int N,
                                          const Scoring& sc, FillShared& sm,
                                          uint8_t* __restrict__ bitsb) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const float jf = (float)(t + 1);
  const float je1 = jf * sc.e1, je2 = jf * sc.e2;

  float H = -gapf(sc, jf);  // H(0, j)
  float E1 = kNeg, E2 = kNeg;
  sm.H[t] = H;
  __syncthreads();

  for (int i = 1; i <= tl; ++i) {
    const float h0_prev = (i == 1) ? -0.0f : -gapf(sc, (float)(i - 1));
    const float h0_cur = -gapf(sc, (float)i);
    const int tchar = tTb[i - 1];
    const float sub = (qc == tchar && tchar < 4) ? sc.mat : sc.mis;
    const float diag = (t == 0 ? h0_prev : sm.H[t - 1]) + sub;
    const float E1n = fmaxf(E1 - sc.e1, H - sc.o1e1);
    const float E2n = fmaxf(E2 - sc.e2, H - sc.o2e2);
    const float H0 = fmaxf(diag, fmaxf(E1n, E2n));
    // inclusive prefix max of G = H0 + j*e along the row
    float g1 = H0 + je1, g2 = H0 + je2;
    for (int o = 1; o < 32; o <<= 1) {
      const float n1 = __shfl_up_sync(0xffffffffu, g1, o);
      const float n2 = __shfl_up_sync(0xffffffffu, g2, o);
      if (lane >= o) {
        g1 = fmaxf(g1, n1);
        g2 = fmaxf(g2, n2);
      }
    }
    if (lane == 31) {
      sm.wmax1[warp] = g1;
      sm.wmax2[warp] = g2;
    }
    __syncthreads();  // (A) H reads done, warp maxima visible
    for (int w = 0; w < warp; ++w) {
      g1 = fmaxf(g1, sm.wmax1[w]);
      g2 = fmaxf(g2, sm.wmax2[w]);
    }
    sm.scan1[t] = g1;
    sm.scan2[t] = g2;
    __syncthreads();  // (B)
    const float P1 = fmaxf(t == 0 ? kNeg : sm.scan1[t - 1], h0_cur);
    const float P2 = fmaxf(t == 0 ? kNeg : sm.scan2[t - 1], h0_cur);
    const float F1 = (P1 - je1) - sc.o1;
    const float F2 = (P2 - je2) - sc.o2;
    const float Hn = fmaxf(H0, fmaxf(F1, F2));
    sm.F1[t] = F1;
    sm.F2[t] = F2;
    sm.H[t] = Hn;
    __syncthreads();  // (C)
    const float F1l = t == 0 ? kNeg : sm.F1[t - 1];
    const float F2l = t == 0 ? kNeg : sm.F2[t - 1];
    int op = 4;
    if (Hn == F1) op = 3;
    if (Hn == E2n) op = 2;
    if (Hn == E1n) op = 1;
    if (Hn == diag) op = 0;
    int bb = op;
    if (E1n == E1 - sc.e1) bb |= 8;
    if (E2n == E2 - sc.e2) bb |= 16;
    if (F1 == F1l - sc.e1) bb |= 32;
    if (F2 == F2l - sc.e2) bb |= 64;
    bitsb[(size_t)(i - 1) * N + t] = (uint8_t)bb;
    H = Hn;
    E1 = E1n;
    E2 = E2n;
  }
  __syncthreads();  // the bytes of every row are visible to the block
}

__device__ __forceinline__ int clamp_len(int v, int N) {
  return v < 0 ? 0 : (v > N ? N : v);
}

}  // namespace
