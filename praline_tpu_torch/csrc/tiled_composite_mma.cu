// The in-place multi-track composite (csrc/tiled_composite.cu) on the
// "mma" tier for Hopper (sm_90a): each visit's box filled track by track in
// track order on the int8 tensor cores (csrc/rows_box.cuh), s_0 w_0 first,
// then s_q w_q added, each product and sum rounded on its own: bit for bit
// kernels/scores.py::composite_skewed_scores, for composites whose every
// track's operands kernels/fused_scores.py::tensor_core_exact admits (a
// chunk takes one tier for all its tracks).  The counterpart of the JAX
// package's streamed scan over praline_tpu/kernels/scores.py:98-122's
// composite, as csrc/tiled_composite.cu.  One kernel a level count serves
// the full, the forward and the resume launches (CKPT built in); the track
// table lives in the kernel's parameters (walk_kernel_params).  What bounds
// it: the chain of dependent diagonals, plus a box fill a track a visit.
// Its own translation unit, so that its kernels build beside the others.

#include "hs_visits.cuh"
#include "tiled_walk.cuh"
#include "rows_box.cuh"

// How many clusters of R CTAs of W threads and m tiles (k levels, T) of
// the composite's "mma" launches the card holds at once, into *clusters.
extern "C" int praline_tiled_composite_mma_clusters(int k, int W, int R, int m, int T,
                                                    int* clusters) {
  return box_clusters<true, BOX_MAX_TRACKS>(k, W, R, m, T, clusters);
}

// praline_tiled_dp_composite (csrc/tiled_composite.cu) on the "mma" tier:
// ops[q] the scratch of praline_tiled_prep on tier 0 for track q, and pwide
// the flags its calls or-ed over the tracks (AP unused).
extern "C" int praline_tiled_composite_mma(
    int n, const void* const* ops, const float* const* inv_x, const float* const* inv_y,
    const int* /*AP*/, const float* w, const unsigned char* pwide, const int* lx, const int* ly,
    const float* gaps_host, int k, int mode, int traceback, int B, int Lx, int Ly, int W, int R,
    int m, int T, float* carry, float* score, float* length, int* ti, int* tj, int* tcode,
    uint8_t* tb, float* snap, int interval, int block, float cum0, void* stream) {
  WalkArgs a = {};
  if (n < 1 || n > BOX_MAX_TRACKS || Lx < 1 || Ly < 1 ||
      !box_args(&a, ops[0], pwide, lx, ly, gaps_host, k, mode, traceback, Lx + Ly + 1, B,
                Lx + 1, W, R, m, T, carry, Outs{score, length, ti, tj, tcode, tb}, stream) ||
      !walk_snapshots(&a, snap, interval, block, cum0))
    return (int)cudaErrorInvalidValue;
  BoxTable<BOX_MAX_TRACKS> tab = {};
  for (int q = 0; q < n; ++q) {
    if (!ops[q] || reinterpret_cast<uintptr_t>(ops[q]) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    tab.track[q] = BoxTrack{mma_operands(const_cast<void*>(ops[q]), B, Lx, Ly), inv_x[q],
                            inv_y[q], w[q]};
  }
  tab.pwide = pwide;
  tab.n = n;
  tab.Lx = Lx;
  tab.Ly = Ly;
  return box_dispatch<true, BOX_MAX_TRACKS>(k, a, tab, nullptr);
}
