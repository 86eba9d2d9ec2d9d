// The lane-tiled DP's launches (K6: csrc/tiled_dp.cu, csrc/tiled_ckpt.cu,
// csrc/tiled_composite.cu, csrc/tiled_ring.cu and, on the tensor cores,
// csrc/tiled_mma.cu, csrc/tiled_ckpt_mma.cu and csrc/tiled_composite_mma.cu):
// csrc/cluster_walk.cuh's walk_kernel at up to 512 threads a CTA, with or
// without the checkpointed launches built in (CKPT; the ordinary launches
// over hs also at 2 and 3 lanes a thread), on the hs source or
// the scalar rows source below (the "scalar" tier; csrc/rows_box.cuh is the
// "mma" tier's).  Each translation unit that includes it builds its own
// kernels, so they build in parallel.  The including file includes
// csrc/hs_visits.cuh (the hs source, which tiled_ablation.py replaces in
// csrc/tiled_dp.cu's text) before it.

#pragma once

#include "cluster_walk.cuh"
#include "fused_rows.cuh"

namespace {

using namespace praline_dp;

constexpr int MAX_W = 512;  // threads of a CTA
// The ordinary scores launches over hs also run Q = 2 or 3 lanes a thread
// (kernels/tiled_dp.py::tiled_geometry), built at k <= MAX_LANES_K.
constexpr int MAX_Q = 3;
constexpr int MAX_LANES_K = 3;

struct RowsVisits {
  FusedRows rows;
  __device__ __forceinline__ FusedRows prepare(int, int, int, int) const { return rows; }
};

// walk_kernel's in-place score source on the "scalar" tier: the scratch of
// csrc/fused_rows.cuh's prep (praline_tiled_prep, tier 1), t f32[B, Lx, AP]
// then cyp f32[B, Ly, AP].
struct RowsSource {
  const float* t;
  const float* cyp;
  const float* ivx;
  const float* ivy;
  int Lx, Ly, AP;
  __host__ __device__ static constexpr int smem(int, int) { return 0; }
  __device__ __forceinline__ bool takes(int) const { return true; }
  __device__ __forceinline__ RowsVisits visits(const WalkArgs&, int b, int, float*) const {
    return RowsVisits{fused_rows(t, cyp, ivx, ivy, b, Lx, Ly, AP)};
  }
};

// PARAMS: the source's functor reads it from the kernel's parameters
// (walk_kernel_params); RING: the ring's launch; Q lanes a thread (k <=
// MAX_LANES_K where Q > 1).
template <bool CKPT, bool PARAMS = false, bool RING = false, int Q = 1, class Src>
int dispatch(int k, const WalkArgs& a, const Src& src, int* clusters) {
  return with_levels<1, Q == 1 ? MAXK : MAX_LANES_K>(k, [&](auto K) {
    return launch_walk<Src, decltype(K)::value, false, MAX_W, 1, CKPT, PARAMS, RING, Q>(
        a, src, clusters);
  });
}

// dispatch on the hs source at Q lanes a thread: Q = 1, or 2 to MAX_Q on
// the ordinary launches (not CKPT) at k <= MAX_LANES_K.
template <bool CKPT>
int dispatch_hs(int k, int Q, const WalkArgs& a, const HsSource& src, int* clusters) {
  if (Q == 1) return dispatch<CKPT>(k, a, src, clusters);
  if constexpr (!CKPT) {
    if (k <= MAX_LANES_K) {
      if (Q == 2) return dispatch<false, false, false, 2>(k, a, src, clusters);
      if (Q == 3) return dispatch<false, false, false, 3>(k, a, src, clusters);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// How many clusters of R CTAs of m tiles of W lanes, Q a thread (k levels,
// source: hs = 1 or rows = 0, T) the card holds at once, into *clusters.
template <bool CKPT>
int tiled_clusters(int k, int hs, int W, int R, int m, int T, int Q, int* clusters) {
  if (!walk_geometry_ok(k, 2, W, MAX_W, R, m, T, hs ? hs_smem(W, T) : 0, Q) || (Q > 1 && !hs))
    return (int)cudaErrorInvalidValue;
  WalkArgs a = {};
  a.B = 1;
  a.W = W;
  a.R = R;
  a.m = m;
  a.T = T;
  a.budget = WALK_MAX_SMEM;
  return hs ? dispatch_hs<CKPT>(k, Q, a, HsSource{nullptr}, clusters)
            : dispatch<CKPT>(k, a, RowsSource{}, clusters);
}

// A launch on the hs source (csrc/tiled_dp.cu, praline_tiled_dp_hs, says
// what each argument is).
template <bool CKPT>
int tiled_hs(const float* hs, const int* lx, const int* ly, const float* gaps_host, int k,
             int mode, int traceback, int D, int B, int Lp, int W, int R, int m, int T, int Q,
             float* carry, const Outs& out, float* snap, int interval, int block, float cum0,
             void* stream) {
  WalkArgs a = {};
  if (!walk_args(&a, hs_smem(W, T), MAX_W, WALK_MAX_SMEM, lx, ly, gaps_host, k, mode, traceback,
                 D, B, Lp, W, R, m, T, carry, out, stream, Q) ||
      !walk_snapshots(&a, snap, interval, block, cum0))
    return (int)cudaErrorInvalidValue;
  return dispatch_hs<CKPT>(k, Q, a, HsSource{hs}, nullptr);
}

// A launch on the rows source's "scalar" tier (csrc/tiled_dp.cu,
// praline_tiled_dp_rows, says what each argument is).
template <bool CKPT>
int tiled_rows(const void* ops, const float* inv_x, const float* inv_y, const int* lx,
               const int* ly, const float* gaps_host, int k, int mode, int traceback, int B,
               int Lx, int Ly, int AP, int W, int R, int m, int T, float* carry, const Outs& out,
               float* snap, int interval, int block, float cum0, void* stream) {
  WalkArgs a = {};
  if (Lx < 1 || Ly < 1 || !ops || AP < 4 || AP % 4 != 0 ||
      !walk_args(&a, 0, MAX_W, WALK_MAX_SMEM, lx, ly, gaps_host, k, mode, traceback,
                 Lx + Ly + 1, B, Lx + 1, W, R, m, T, carry, out, stream) ||
      !walk_snapshots(&a, snap, interval, block, cum0))
    return (int)cudaErrorInvalidValue;
  const float* t = static_cast<const float*>(ops);
  return dispatch<CKPT>(k, a, RowsSource{t, t + (size_t)B * Lx * AP, inv_x, inv_y, Lx, Ly, AP},
                        nullptr);
}

}  // namespace
