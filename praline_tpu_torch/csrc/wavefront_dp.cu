// Anti-diagonal M/Ix/Iy wavefront DP over a skewed score tensor, for
// Hopper (sm_90a): a walk over hs in narrow lane tiles.
//
// Replaces the TPU kernels praline_tpu/kernels/strip.py::wavefront_dp_strip
// and praline_tpu/kernels/pallas_dp.py::wavefront_dp_pallas (K2/K4).  The
// contract is that of kernels/scan.py::wavefront_dp (the plain version),
// bit for bit: score, length, ti, tj, tcode and, with traceback, every
// byte of tb uint8[D - 2, B, Lp] that csrc/replay.cu walks.  The
// recurrence is csrc/wavefront.cuh's, step for step; the order of the steps
// is csrc/cluster_walk.cuh's, shared with the fused (csrc/fused_dp.cu) and
// the tiled kernel (csrc/tiled_dp.cu); the scores come from hs f32[D, B,
// Lp] (csrc/scores*.cu) through csrc/hs_visits.cuh, each thread copying its
// lane of the next box into shared memory by cp.async while the DP steps
// through the current one.
//
// Design.  The Lp <= 2048 lanes of a problem are cut into tiles of W <= 128
// lanes, one lane a thread, and the diagonals into boxes of T; a problem
// runs on a cluster of R CTAs of m tiles (R = 1: a plain CTA), the carries
// of m > 1 tiles in an L2 scratch, so that four or five CTAs share an SM.
// The kernel is csrc/cluster_walk.cuh's walk_kernel on the hs source, built
// for 128 threads a CTA and at least 4 (at most 128 registers a thread) or
// 5 (102) CTAs an SM.  The caller picks the geometry a chunk
// (kernels/wavefront.py::dp_geometry):
//   throughput  R = 1 for chunks that fill the card: several problems share
//               an SM, and a step's barrier spans only W / 32 warps;
//   latency     R > 1 for chunks that would leave SMs idle (merge levels,
//               the tracks chunks): a problem spreads over R SMs, up to
//               one tile a CTA, which shortens its chain of diagonals.
// In scores mode the walk runs only the visits that hold a cell of the
// problem's band 0 <= i <= lx, 0 <= j <= ly (cluster_walk's BAND): about
// (W + ly) / ly lane slots a cell instead of the whole row's (Lp (lx + ly)
// / (lx ly)).  Traceback mode walks every lane of every box: the bytes of
// padded cells are part of the contract.
//
// What bounds it on the H100: the chain of dependent diagonals of each
// problem and the instructions of its lane slots.  A step is a few dozen
// dependent instructions of one W-lane tile and a CTA barrier; with many
// problems in flight the SM's issue rate over the lane slots is the limit,
// so the band's fewer slots are the throughput, and fewer warps a barrier
// the latency.  Device memory carries hs once over the visited boxes and,
// with traceback, tb once; the carries of m > 1 tiles once a visit in the
// L2 scratch.
//
// Exactness: --fmad=false, the __fadd_rn order and the tie order of
// csrc/wavefront.cuh, unchanged.

#include "cluster_walk.cuh"
#include "hs_visits.cuh"

namespace {

using namespace praline_dp;

constexpr int MAX_W = 128;       // lanes (= threads) of a CTA
constexpr int MAX_LANES = 2048;  // Lp: bucket 2047

// The launch (or the occupancy query) of the kernel built for at least
// min_blocks (4 or 5) CTAs an SM.
int dispatch(int k, int min_blocks, const WalkArgs& a, const HsSource& src, int* clusters) {
  return with_levels(k, [&](auto K) {
    constexpr int k_ = decltype(K)::value;
    if (min_blocks == 4) return launch_walk<HsSource, k_, true, MAX_W, 4>(a, src, clusters);
    if (min_blocks == 5) return launch_walk<HsSource, k_, true, MAX_W, 5>(a, src, clusters);
    return (int)cudaErrorInvalidValue;
  });
}

}  // namespace

// Dynamic shared memory bytes of a CTA of W lanes and m tiles, T diagonals
// a box, k gap levels (the carries of m > 1 tiles are in the scratch); -1
// for arguments the kernel does not take.
extern "C" int praline_wavefront_dp_smem(int W, int T, int m, int k) {
  if (k < 1 || k > MAXK || m < 1 || W < 32 || T < 1) return -1;
  return walk_layout(k, hs_smem(W, T), W, m, T, 0).total;
}

// How many clusters of R CTAs of W threads and m tiles (k levels, T,
// min_blocks) the card holds at once, into *clusters; returns the CUDA
// error of the query.
extern "C" int praline_wavefront_dp_clusters(int k, int W, int R, int m, int T, int min_blocks,
                                             int* clusters) {
  if (!walk_geometry_ok(k, 2, W, MAX_W, R, m, T, hs_smem(W, T)))
    return (int)cudaErrorInvalidValue;
  WalkArgs a = {};
  a.B = 1;
  a.W = W;
  a.R = R;
  a.m = m;
  a.T = T;
  return dispatch(k, min_blocks, a, HsSource{nullptr}, clusters);
}

// hs f32[D, B, Lp] with Lp <= 2048; lx, ly int32[B] with 1 <= lx < Lp,
// 1 <= ly <= D - Lp; gaps: k host floats; geometry (kernels/wavefront.py::
// dp_geometry): W lanes a tile (= threads a CTA), a multiple of 32 up to
// 128; R CTAs a cluster, 1 to 16; m tiles a CTA with R m W >= Lp; T
// diagonals a box, 1 to 32; min_blocks: the kernel built for at least 4
// or 5 CTAs an SM.  Scratch carry f32[B, 10 + 4 k', Lp] (k' = 1 at k = 2,
// else k) where m > 1, else unused.  Outputs f32/int32 [B]; tb uint8[D - 2,
// B, Lp] (ignored unless traceback); slots: null, or a counter the walk
// adds its lane slots to.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int praline_wavefront_dp(const float* hs, const int* lx, const int* ly,
                                    const float* gaps_host, int k, int mode, int traceback,
                                    int D, int B, int Lp, int W, int R, int m, int T,
                                    int min_blocks, float* carry, float* score, float* length,
                                    int* ti, int* tj, int* tcode, uint8_t* tb,
                                    unsigned long long* slots, void* stream) {
  WalkArgs a = {};
  if (Lp > MAX_LANES ||
      !walk_args(&a, hs_smem(W, T), MAX_W, 0, lx, ly, gaps_host, k, mode, traceback, D, B, Lp,
                 W, R, m, T, carry, Outs{score, length, ti, tj, tcode, tb, slots}, stream))
    return (int)cudaErrorInvalidValue;
  return dispatch(k, min_blocks, a, HsSource{hs}, nullptr);
}
