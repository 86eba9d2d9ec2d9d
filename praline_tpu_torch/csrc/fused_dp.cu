// Fused score producer + wavefront DP for Hopper (sm_90a): the DP computes
// each cell's score where it consumes it, so the skewed score tensor hs
// never exists in device memory.
//
// Replaces three JAX functions that compute the same thing,
// kernels/scan.py::wavefront_dp over kernels/scores.py::skewed_pair_scores,
// without holding the score matrix in device memory:
//   praline_tpu/kernels/fused_dp.py:70   wavefront_dp_fused (a 128-diagonal
//                                        score band in VMEM, Pallas),
//   praline_tpu/kernels/chunked.py:26    wavefront_dp_chunked (one band
//                                        chunk of hs at a time, DP carries
//                                        across chunks),
//   praline_tpu/kernels/scan.py:106      wavefront_dp_streamed (each
//                                        diagonal's scores inside the scan).
// Their contract is the plain composition, bit for bit: score, length, ti,
// tj, tcode and, with traceback, the bytes tb uint8[D - 2, B, Lp] that
// csrc/replay.cu walks.
//
// Two launches on the caller's stream:
//   1. prep_kernel writes T = Cx @ S (B x Lx rows) and a copy of Cy
//      (B x Ly rows) into scratch the wrapper allocates, each row padded
//      with zeros to AP = A rounded up to 4 floats, so a row is AP / 4
//      aligned float4 loads;
//   2. fused_kernel is the DP of csrc/wavefront.cuh (the recurrence exists
//      only there) with a score source that computes cell (i, j)'s
//        h = sum_c T[i-1, c] * Cy[j-1, c],   then (h * inv_x) * inv_y
//      exactly as csrc/scores.cu does: every partial sum is an integer
//      below 2^24 (praline_tpu/oracle/score.py), so the order of the sum is
//      free and the zero padding adds +0.0 to a sum that is never -0.0;
//      the scale is two __fmul_rn, never fused (--fmad=false).
//
// What bounds it on the H100: the same chain of dependent diagonals as the
// two-kernel DP, plus, per cell, 2 * AP / 4 float4 loads and A multiplies
// and adds that are off that chain.  T and Cy are read through the
// read-only path: a problem's rows are a few hundred KB, resident in L2
// (50 MB) and mostly in L1, so device memory carries the operands once
// and, with traceback, one byte per cell.  The register budget is the
// limit on lanes: __launch_bounds__(1024) leaves 64 registers a thread,
// already used by one lane's carries at k <= 2, so the T row is not kept in
// registers, and four lanes per thread (Lp <= 4096) spill their carries to
// local memory (L1).  Memory grows as O(B * (Lx + Ly) * A), so Ly is
// unbounded.

#include "wavefront.cuh"

namespace {

using namespace praline_dp;

constexpr int kMaxQ = 4;
constexpr int MAXA = 32;  // largest alphabet the kernel takes
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

struct FusedArgs {
  const float* t;
  const float* cyp;
  const float* ivx;
  const float* ivy;
  const int* lx;
  const int* ly;
  Gaps gaps;
  int mode, traceback, B, Lx, Ly, AP, nt;
  Outs out;
  cudaStream_t stream;
};

template <int K, int Q>
__global__ void __launch_bounds__(MAXT) fused_kernel(FusedArgs a) {
  const int b = blockIdx.x;
  const int n4 = a.AP / 4;
  const FusedRows rows{
      reinterpret_cast<const float4*>(a.t + (size_t)b * a.Lx * a.AP),
      reinterpret_cast<const float4*>(a.cyp + (size_t)b * a.Ly * a.AP),
      a.ivx + (size_t)b * a.Lx, a.ivy + (size_t)b * a.Ly, a.Ly, n4};
  wavefront_block<K, Q>(rows, b, a.lx[b], a.ly[b], a.gaps, a.mode,
                        a.traceback, a.Lx + a.Ly + 1, a.B, a.Lx + 1, a.out);
}

struct Kernel {
  using Args = FusedArgs;
  static constexpr int MAXQ = kMaxQ;
  template <int K, int Q>
  static int launch(const Args& a) {
    fused_kernel<K, Q><<<a.B, a.nt, 0, a.stream>>>(a);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// cx f32[B, Lx, A], inv_x f32[B, Lx], cy f32[B, Ly, A], inv_y f32[B, Ly],
// s f32[A, A], lx/ly int32[B] with 1 <= lx <= Lx, 1 <= ly <= Ly; gaps: k
// host floats.  Scratch t f32[B, Lx, AP] and cyp f32[B, Ly, AP] with
// AP = A rounded up to a multiple of 4.  Outputs as praline_wavefront_dp
// (tb uint8[Lx + Ly - 1, B, Lx + 1], ignored unless traceback).  Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for
// shapes and series the kernel does not take (Lx + 1 > 4096).
extern "C" int praline_fused_dp(const float* cx, const float* inv_x,
                                const float* cy, const float* inv_y,
                                const float* s, const int* lx, const int* ly,
                                const float* gaps_host, int k, int mode,
                                int traceback, int B, int Lx, int Ly, int A,
                                float* t, float* cyp, float* score,
                                float* length, int* ti, int* tj, int* tcode,
                                uint8_t* tb, void* stream) {
  const int Lp = Lx + 1;
  if (k < 1 || k > MAXK || mode < 0 || mode > 2 || B < 1 || Lx < 1 ||
      Ly < 1 || A < 1 || A > MAXA || Lp > kMaxQ * MAXT)
    return (int)cudaErrorInvalidValue;
  const int AP = (A + 3) / 4 * 4;
  const int row_blocks = ((Lx > Ly ? Lx : Ly) + PREP_T - 1) / PREP_T;
  if (row_blocks > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  prep_kernel<<<dim3(B, row_blocks), PREP_T, 0, st>>>(cx, cy, s, t, cyp, Lx,
                                                      Ly, A, AP);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  FusedArgs a = {};
  for (int l = 0; l < k; ++l) a.gaps.g[l] = gaps_host[l];
  int q;
  lane_split(Lp, &a.nt, &q);
  a.t = t;
  a.cyp = cyp;
  a.ivx = inv_x;
  a.ivy = inv_y;
  a.lx = lx;
  a.ly = ly;
  a.mode = mode;
  a.traceback = traceback;
  a.B = B;
  a.Lx = Lx;
  a.Ly = Ly;
  a.AP = AP;
  a.out = {score, length, ti, tj, tcode, tb};
  a.stream = st;
  return launch_levels<Kernel>(k, q, a);
}
