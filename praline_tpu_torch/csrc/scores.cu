// Skewed pair-score producer for Hopper (sm_90a).
//
// Replaces the TPU kernels praline_tpu/kernels/fused_scores.py
// ::fused_skewed_scores (classic layout) and ::fused_skewed_scores_strip
// (strip-packed layout).  Both compute, per problem b,
//
//     T     = Cx[b] @ S                      (Lx x A)
//     H_int = T @ Cy[b]^T                    (Lx x Ly)
//     H     = (H_int * inv_x) * inv_y        two separately rounded multiplies
//
// and emit it skewed by anti-diagonal: hs[d, b, i] = H[i-1, d-i-1] for
// 1 <= i <= Lx, 0 <= d-i-1 < Ly, and 0 elsewhere; hs is f32[D, B, Lx+1]
// with D = Lx + Ly + 1 (the layout of kernels/scores.py::skewed_pair_scores).
//
// Exactness: counts and S are integer valued (or dyadic) and every partial
// sum stays below 2**24 (praline_tpu/oracle/score.py), so each product and
// sum is exact and any summation order gives the same bits.  The scale is
// __fmul_rn twice, never fused; the build passes --fmad=false as well.
//
// What bounds it on the H100: the output write.  hs holds D * (Lx+1) f32
// per problem (8.4 MB at bucket 1023), and each cell costs A multiply-adds
// from registers and shared memory, far below the card's f32 rate.  So the
// design makes the store the only device-memory stream: a block owns 128
// lanes x 128 diagonals of one problem, keeps its S, its T rows (in
// registers, one row per thread) and the Cy rows its parallelogram touches
// (in shared memory, padded to an odd row stride so the per-lane row reads
// are free of bank conflicts), and every warp stores one diagonal's 32
// consecutive lanes per instruction, fully coalesced.  Zero cells are
// written by the same pass, so hs needs no separate memset.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXA = 32;     // largest alphabet the kernel takes
constexpr int TI = 128;      // lanes (threads) per block
constexpr int TD = 128;      // diagonals per block
constexpr int ROWS = TD + TI;  // Cy rows one block can touch
constexpr int RS = MAXA + 1;   // odd row stride: conflict-free row reads

__global__ void __launch_bounds__(TI) skewed_scores_kernel(
    const float* __restrict__ cx, const float* __restrict__ inv_x,
    const float* __restrict__ cy, const float* __restrict__ inv_y,
    const float* __restrict__ s, float* __restrict__ hs,
    int B, int Lx, int Ly, int A) {
  __shared__ float s_sh[MAXA * MAXA];
  __shared__ float cy_sh[ROWS * RS];
  __shared__ float ivy_sh[ROWS];

  const int Lp = Lx + 1;
  const int D = Lx + Ly + 1;
  const int t = threadIdx.x;
  const int i0 = blockIdx.x * TI;
  const int d0 = blockIdx.y * TD;
  const int b = blockIdx.z;
  const int i = i0 + t;
  // Row r of cy_sh holds column j = jbase + r; lane i0+t at diagonal d0+dd
  // reads j = d0 + dd - i0 - t - 1, i.e. row dd + TI - 1 - t.
  const int jbase = d0 - i0 - TI;

  for (int idx = t; idx < A * A; idx += TI) s_sh[idx] = s[idx];
  const float* cyb = cy + (size_t)b * Ly * A;
  for (int idx = t; idx < ROWS * A; idx += TI) {
    const int r = idx / A, a = idx - r * A;
    const int j = jbase + r;
    cy_sh[r * RS + a] = (j >= 0 && j < Ly) ? cyb[(size_t)j * A + a] : 0.0f;
  }
  for (int r = t; r < ROWS; r += TI) {
    const int j = jbase + r;
    ivy_sh[r] = (j >= 0 && j < Ly) ? inv_y[(size_t)b * Ly + j] : 1.0f;
  }
  __syncthreads();

  // This lane's row of T = Cx @ S, in registers.
  const bool row_ok = i >= 1 && i <= Lx;
  float trow[MAXA];
  float ivx = 1.0f;
  {
    float xr[MAXA];
    const float* cxr = cx + ((size_t)b * Lx + (row_ok ? i - 1 : 0)) * A;
#pragma unroll
    for (int a = 0; a < MAXA; ++a) xr[a] = (row_ok && a < A) ? cxr[a] : 0.0f;
#pragma unroll
    for (int c = 0; c < MAXA; ++c) {
      float acc = 0.0f;
      if (c < A) {
#pragma unroll
        for (int a = 0; a < MAXA; ++a)
          if (a < A) acc = __fadd_rn(acc, __fmul_rn(xr[a], s_sh[a * A + c]));
      }
      trow[c] = acc;
    }
    if (row_ok) ivx = inv_x[(size_t)b * Lx + i - 1];
  }

  if (i >= Lp) return;  // no output lane (no barrier follows)
  const int dmax = min(TD, D - d0);
  for (int dd = 0; dd < dmax; ++dd) {
    const int d = d0 + dd;
    const int j = d - i - 1;
    float val = 0.0f;
    if (row_ok && j >= 0 && j < Ly) {
      const int r = dd + TI - 1 - t;
      const float* cr = cy_sh + r * RS;
      float h = 0.0f;
#pragma unroll
      for (int c = 0; c < MAXA; ++c)
        if (c < A) h = __fadd_rn(h, __fmul_rn(trow[c], cr[c]));
      val = __fmul_rn(__fmul_rn(h, ivx), ivy_sh[r]);
    }
    hs[((size_t)d * B + b) * Lp + i] = val;
  }
}

}  // namespace

// hs must hold D * B * (Lx+1) floats.  Returns cudaGetLastError() after the
// launch (0 = launched), or cudaErrorInvalidValue for shapes the kernel
// does not take.
extern "C" int praline_skewed_scores(const float* cx, const float* inv_x,
                                     const float* cy, const float* inv_y,
                                     const float* s, float* hs, int B, int Lx,
                                     int Ly, int A, void* stream) {
  if (B < 1 || Lx < 1 || Ly < 1 || A < 1 || A > MAXA || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int Lp = Lx + 1;
  const int D = Lx + Ly + 1;
  dim3 grid((Lp + TI - 1) / TI, (D + TD - 1) / TD, B);
  skewed_scores_kernel<<<grid, TI, 0, (cudaStream_t)stream>>>(
      cx, inv_x, cy, inv_y, s, hs, B, Lx, Ly, A);
  return (int)cudaGetLastError();
}
