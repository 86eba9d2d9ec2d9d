// The in-place score source of the Hopper DPs that need no hs tensor
// (csrc/fused_dp.cu, csrc/tiled_dp.cu): a prep kernel writes T = Cx @ S
// and a copy of Cy into scratch the wrapper allocates, and the functor
// FusedRows computes cell (i, j)'s score from them where the DP consumes it:
//
//     h = sum_c T[i-1, c] * Cy[j-1, c],   then (h * inv_x) * inv_y
//
// exactly as csrc/scores.cu does: every partial sum is an integer below
// 2^24 (praline_tpu/oracle/score.py), so the order of the sum is free and
// the zero padding adds +0.0 to a sum that is never -0.0; the scale is two
// __fmul_rn, never fused (--fmad=false).  Each row is padded with zeros to
// AP = A rounded up to 4 floats, so a row is AP / 4 aligned float4 loads,
// read through the read-only path (a problem's rows are a few hundred KB,
// resident in L2 and mostly in L1).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int MAXA = 32;  // largest alphabet the kernels take
constexpr int PREP_T = 128;

// T and Cy rows of one problem, padded to n4 float4 each.
struct FusedRows {
  const float4* t;    // [Lx][n4]
  const float4* cy;   // [Ly][n4]
  const float* ivx;   // [Lx]
  const float* ivy;   // [Ly]
  int Ly, n4;
  // Cell (i, d - i) = hs[d, b, i]: H[i-1, j] with j = d - i - 1, zero
  // outside 1 <= i, 0 <= j < Ly.  Lanes never exceed Lx.
  __device__ __forceinline__ float operator()(int d, int i) const {
    const int j = d - i - 1;
    if (i < 1 || j < 0 || j >= Ly) return 0.0f;
    const float4* tr = t + (size_t)(i - 1) * n4;
    const float4* cr = cy + (size_t)j * n4;
    float h = 0.0f;
#pragma unroll
    for (int g = 0; g < MAXA / 4; ++g) {
      if (g < n4) {
        const float4 a = __ldg(tr + g), c = __ldg(cr + g);
        h = __fadd_rn(h, __fmul_rn(a.x, c.x));
        h = __fadd_rn(h, __fmul_rn(a.y, c.y));
        h = __fadd_rn(h, __fmul_rn(a.z, c.z));
        h = __fadd_rn(h, __fmul_rn(a.w, c.w));
      }
    }
    return __fmul_rn(__fmul_rn(h, __ldg(ivx + i - 1)), __ldg(ivy + j));
  }
};

// The rows of problem b in the scratch of a batch of Lx x Ly problems.
__device__ __forceinline__ FusedRows fused_rows(const float* t, const float* cyp,
                                                const float* ivx, const float* ivy,
                                                int b, int Lx, int Ly, int AP) {
  return FusedRows{reinterpret_cast<const float4*>(t + (size_t)b * Lx * AP),
                   reinterpret_cast<const float4*>(cyp + (size_t)b * Ly * AP),
                   ivx + (size_t)b * Lx, ivy + (size_t)b * Ly, Ly, AP / 4};
}

// Block (b, r0 / PREP_T): row r of T[b] = Cx[b, r] @ S and row r of Cy[b],
// both zero-padded to AP floats.
__global__ void __launch_bounds__(PREP_T) prep_kernel(
    const float* __restrict__ cx, const float* __restrict__ cy,
    const float* __restrict__ s, float* __restrict__ t,
    float* __restrict__ cyp, int Lx, int Ly, int A, int AP) {
  __shared__ float s_sh[MAXA * MAXA];
  const int b = blockIdx.x;
  const int r = blockIdx.y * PREP_T + threadIdx.x;
  for (int idx = threadIdx.x; idx < A * A; idx += PREP_T) s_sh[idx] = s[idx];
  __syncthreads();
  if (r < Lx) {
    const float* xr = cx + ((size_t)b * Lx + r) * A;
    float* tr = t + ((size_t)b * Lx + r) * AP;
    for (int c = 0; c < AP; ++c) {
      float acc = 0.0f;
      if (c < A)
        for (int a = 0; a < A; ++a)
          acc = __fadd_rn(acc, __fmul_rn(xr[a], s_sh[a * A + c]));
      tr[c] = acc;
    }
  }
  if (r < Ly) {
    const float* yr = cy + ((size_t)b * Ly + r) * A;
    float* pr = cyp + ((size_t)b * Ly + r) * AP;
    for (int c = 0; c < AP; ++c) pr[c] = c < A ? yr[c] : 0.0f;
  }
}

// Padded row width of the scratch for an alphabet of A symbols.
inline int padded_alphabet(int A) { return (A + 3) / 4 * 4; }

// Launches prep_kernel for B problems; returns cudaGetLastError(), or
// cudaErrorInvalidValue for shapes it does not take.
inline int launch_prep(const float* cx, const float* cy, const float* s, float* t,
                       float* cyp, int B, int Lx, int Ly, int A, cudaStream_t st) {
  const int row_blocks = ((Lx > Ly ? Lx : Ly) + PREP_T - 1) / PREP_T;
  if (A < 1 || A > MAXA || row_blocks > 65535) return (int)cudaErrorInvalidValue;
  prep_kernel<<<dim3(B, row_blocks), PREP_T, 0, st>>>(cx, cy, s, t, cyp, Lx, Ly, A,
                                                      padded_alphabet(A));
  return (int)cudaGetLastError();
}

}  // namespace
