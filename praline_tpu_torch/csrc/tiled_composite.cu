// The lane-tiled DP (csrc/tiled_dp.cu, K6) over a multi-track composite
// computed in place, for Hopper (sm_90a): the batch aligner's composites
// whose summed hs would pass its byte budget (kernels/batch.py::
// composite_route), which the JAX package runs on its streamed scan.
//
// The score of cell (i, j) is the weighted sum of the tracks' scores, in
// track order, each product and sum rounded on its own (--fmad=false):
//
//     v = s_0 w_0;  v = v + s_1 w_1;  ...     s_t = (h_t inv_x_t) inv_y_t
//
// bit for bit the composite hs of kernels/scores.py::
// composite_skewed_scores (the producer once a track, scaled and added in
// place), whose f32 weights are the JAX package's.  Each track's s_t is
// csrc/fused_rows.cuh's in-place score from its own prep kernel's T = Cx @
// S and Cy rows (praline_tiled_prep, once a chunk a track), +0 outside the
// interior as the skewed tensor is: the "scalar" tier, whose "mma" twin,
// each visit's box track by track on the tensor cores, is
// csrc/tiled_composite_mma.cu.  The
// track table lives in the kernel's parameters (walk_kernel_params,
// __grid_constant__), read through the constant cache: no register holds a
// track's pointers.
//
// Same walk and geometry as the other two sources (csrc/tiled_walk.cuh),
// built with the checkpointed launches in (CKPT): one kernel a gap level
// count serves the full traceback, the forward and the resume launches.
// Its own translation unit, so that its fifteen kernels build beside
// csrc/tiled_dp.cu's and csrc/tiled_ckpt.cu's.
//
// What bounds it on the H100: the same chain of dependent diagonals; each
// step computes one dot product of A floats a track where the rows source
// computes one.

#include "hs_visits.cuh"
#include "tiled_walk.cuh"

namespace {

constexpr int MAX_TRACKS = 8;  // tracks of a composite

struct CompositeSource;

// The composite score of problem b's cells.
struct CompositeRows {
  const CompositeSource* src;
  int b;
  __device__ __forceinline__ float operator()(int d, int i) const;
};

struct CompositeVisits {
  CompositeRows rows;
  __device__ __forceinline__ CompositeRows prepare(int, int, int, int) const { return rows; }
};

// walk_kernel's composite source: each track's prep scratch t f32[B, Lx,
// AP_t] and cyp f32[B, Ly, AP_t], its inverses and its weight.
struct CompositeSource {
  __host__ __device__ static constexpr int smem(int, int) { return 0; }
  __device__ __forceinline__ bool takes(int) const { return true; }
  const float* t[MAX_TRACKS];
  const float* cyp[MAX_TRACKS];
  const float* ivx[MAX_TRACKS];
  const float* ivy[MAX_TRACKS];
  float w[MAX_TRACKS];
  int ap[MAX_TRACKS];
  int n, Lx, Ly;
  __device__ __forceinline__ CompositeVisits visits(const WalkArgs&, int b, int, float*) const {
    return CompositeVisits{CompositeRows{this, b}};
  }
};

__device__ __forceinline__ float CompositeRows::operator()(int d, int i) const {
  float v = 0.0f;
#pragma unroll
  for (int q = 0; q < MAX_TRACKS; ++q) {
    if (q < src->n) {
      const float s = fused_rows(src->t[q], src->cyp[q], src->ivx[q], src->ivy[q], b, src->Lx,
                                 src->Ly, src->ap[q])(d, i);
      const float ws = __fmul_rn(s, src->w[q]);
      v = q == 0 ? ws : __fadd_rn(v, ws);
    }
  }
  return v;
}

}  // namespace

// How many clusters of R CTAs of W threads and m tiles (k levels, T) of
// the composite source the card holds at once, into *clusters; returns the
// CUDA error of the query.
extern "C" int praline_tiled_composite_clusters(int k, int W, int R, int m, int T,
                                                int* clusters) {
  if (!walk_geometry_ok(k, 2, W, MAX_W, R, m, T, 0)) return (int)cudaErrorInvalidValue;
  WalkArgs a = {};
  a.B = 1;
  a.W = W;
  a.R = R;
  a.m = m;
  a.T = T;
  a.budget = WALK_MAX_SMEM;
  return dispatch<true, true>(k, a, CompositeSource{}, clusters);
}

// n tracks (1 to 8), each host arrays of n entries: ops[q] the scratch of
// praline_tiled_prep on tier 1 for the track (T rows f32[B, Lx, AP[q]] then
// Cy rows f32[B, Ly, AP[q]], AP[q] = its alphabet rounded up to 4),
// inv_x[q] f32[B, Lx], inv_y[q] f32[B, Ly] and the weight w[q]; pwide
// unused (the "mma" tier's entry, praline_tiled_composite_mma, takes the
// same arguments).  lx, ly int32[B], gaps, geometry, carry, outputs and
// checkpoints as csrc/tiled_ckpt.cu's praline_tiled_ckpt_rows (snap null:
// an ordinary launch).
extern "C" int praline_tiled_dp_composite(
    int n, const void* const* ops, const float* const* inv_x, const float* const* inv_y,
    const int* AP, const float* w, const unsigned char* /*pwide*/, const int* lx, const int* ly,
    const float* gaps_host, int k, int mode, int traceback, int B, int Lx, int Ly, int W, int R,
    int m, int T, float* carry, float* score, float* length, int* ti, int* tj, int* tcode,
    uint8_t* tb, float* snap, int interval, int block, float cum0, void* stream) {
  WalkArgs a = {};
  if (n < 1 || n > MAX_TRACKS || Lx < 1 || Ly < 1 ||
      !walk_args(&a, 0, MAX_W, WALK_MAX_SMEM, lx, ly, gaps_host, k, mode, traceback,
                 Lx + Ly + 1, B, Lx + 1, W, R, m, T, carry,
                 Outs{score, length, ti, tj, tcode, tb}, stream) ||
      !walk_snapshots(&a, snap, interval, block, cum0))
    return (int)cudaErrorInvalidValue;
  CompositeSource src = {};
  src.n = n;
  src.Lx = Lx;
  src.Ly = Ly;
  for (int q = 0; q < n; ++q) {
    if (!ops[q] || AP[q] < 4 || AP[q] % 4 != 0) return (int)cudaErrorInvalidValue;
    src.t[q] = static_cast<const float*>(ops[q]);
    src.cyp[q] = src.t[q] + (size_t)B * Lx * AP[q];
    src.ivx[q] = inv_x[q];
    src.ivy[q] = inv_y[q];
    src.w[q] = w[q];
    src.ap[q] = AP[q];
  }
  return dispatch<true, true>(k, a, src, nullptr);
}
