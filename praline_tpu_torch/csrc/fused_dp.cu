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
// Two launches on the caller's stream: the prep kernel of
// csrc/fused_rows.cuh writes T = Cx @ S and a padded copy of Cy into scratch
// the wrapper allocates; fused_kernel is the DP of csrc/wavefront.cuh (the
// recurrence exists only there) with the score source FusedRows of
// csrc/fused_rows.cuh, which computes each cell's score in place, bit-equal
// to csrc/scores.cu.
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

#include "fused_rows.cuh"
#include "wavefront.cuh"

namespace {

using namespace praline_dp;

constexpr int kMaxQ = 4;

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
  const FusedRows rows = fused_rows(a.t, a.cyp, a.ivx, a.ivy, b, a.Lx, a.Ly, a.AP);
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
  const cudaStream_t st = (cudaStream_t)stream;
  const int rc = launch_prep(cx, cy, s, t, cyp, B, Lx, Ly, A, st);
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
  a.AP = padded_alphabet(A);
  a.out = {score, length, ti, tj, tcode, tb};
  a.stream = st;
  return launch_levels<Kernel>(k, q, a);
}
