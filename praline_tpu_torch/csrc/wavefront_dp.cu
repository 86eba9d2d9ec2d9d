// Anti-diagonal M/Ix/Iy wavefront DP over a skewed score tensor, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels praline_tpu/kernels/strip.py::wavefront_dp_strip
// and praline_tpu/kernels/pallas_dp.py::wavefront_dp_pallas.  The contract
// is that of kernels/scan.py::wavefront_dp (the plain version beside this
// kernel), bit for bit; the recurrence itself, its lane layout and its
// terminal rules are csrc/wavefront.cuh, shared with csrc/fused_dp.cu and
// csrc/tiled_dp.cu.  This kernel reads each cell's score from hs
// f32[D, B, Lp], the output of csrc/scores.cu (the functor HsRows).
//
// What bounds it on the H100: the dependency chain along the diagonals.
// A diagonal costs roughly a hundred dependent instructions per lane plus
// one block barrier, and a problem needs Lx + Ly of them in sequence, so a
// problem is latency bound and throughput comes from many problems in
// flight (one block each, every SM busy).  Device memory traffic is one
// f32 read per cell (hs, coalesced along the lanes, through the read-only
// path) and, with traceback, one byte written per cell.
//
// Gap series of 1 to 15 levels (the JAX package's limit) are compiled in,
// k = 2 collapsed; the levels are a template parameter so the carries stay
// in registers.  Up to two lanes per thread: Lp <= 2048 (bucket 2047);
// longer rows take csrc/fused_dp.cu (up to 4096 lanes) or csrc/tiled_dp.cu.

#include "wavefront.cuh"

namespace {

using namespace praline_dp;

constexpr int kMaxQ = 2;

struct DpArgs {
  const float* hs;
  const int* lx;
  const int* ly;
  Gaps gaps;
  int mode, traceback, D, B, Lp, nt;
  Outs out;
  cudaStream_t stream;
};

template <int K, int Q>
__global__ void __launch_bounds__(MAXT) wavefront_kernel(DpArgs a) {
  const int b = blockIdx.x;
  wavefront_block<K, Q>(HsRows{a.hs, a.B, a.Lp, b}, b, a.lx[b], a.ly[b],
                        a.gaps, a.mode, a.traceback, a.D, a.B, a.Lp, a.out);
}

struct Kernel {
  using Args = DpArgs;
  static constexpr int MAXQ = kMaxQ;
  template <int K, int Q>
  static int launch(const Args& a) {
    wavefront_kernel<K, Q><<<a.B, a.nt, 0, a.stream>>>(a);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// hs f32[D, B, Lp]; lx, ly int32[B] with 1 <= lx < Lp, 1 <= ly <= D - Lp;
// gaps: k host floats.  Outputs f32/int32
// [B]; tb uint8[D - 2, B, Lp] (ignored unless traceback).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// shapes and series the kernel does not take.
extern "C" int praline_wavefront_dp(const float* hs, const int* lx,
                                    const int* ly,
                                    const float* gaps_host, int k, int mode,
                                    int traceback, int D, int B, int Lp,
                                    float* score, float* length, int* ti,
                                    int* tj, int* tcode, uint8_t* tb,
                                    void* stream) {
  if (k < 1 || k > MAXK || mode < 0 || mode > 2 || B < 1 || Lp < 2 ||
      Lp > kMaxQ * MAXT || D < Lp + 1)
    return (int)cudaErrorInvalidValue;
  DpArgs a = {};
  for (int l = 0; l < k; ++l) a.gaps.g[l] = gaps_host[l];
  int q;
  lane_split(Lp, &a.nt, &q);
  a.hs = hs;
  a.lx = lx;
  a.ly = ly;
  a.mode = mode;
  a.traceback = traceback;
  a.D = D;
  a.B = B;
  a.Lp = Lp;
  a.out = {score, length, ti, tj, tcode, tb};
  a.stream = (cudaStream_t)stream;
  return launch_levels<Kernel>(k, q, a);
}
