// The lane-tiled DP's launches (K6: csrc/tiled_dp.cu, csrc/tiled_ckpt.cu,
// csrc/tiled_composite.cu): csrc/cluster_walk.cuh's walk_kernel at up to
// 512 threads a CTA, with or without the checkpointed launches built in
// (CKPT), on the hs source or the rows source below.  Each translation
// unit that includes it builds its own kernels, so the three build in
// parallel.  The including file includes csrc/hs_visits.cuh (the hs
// source, which tiled_ablation.py replaces in csrc/tiled_dp.cu's text)
// before it.

#pragma once

#include "cluster_walk.cuh"
#include "fused_rows.cuh"

namespace {

using namespace praline_dp;

constexpr int MAX_W = 512;  // lanes (= threads) of a CTA

struct RowsVisits {
  FusedRows rows;
  __device__ __forceinline__ FusedRows prepare(int, int, int, int) const { return rows; }
};

// walk_kernel's in-place score source: the scratch of csrc/fused_rows.cuh.
struct RowsSource {
  static constexpr bool HS = false;
  const float* t;
  const float* cyp;
  const float* ivx;
  const float* ivy;
  int Lx, Ly, AP;
  __device__ __forceinline__ RowsVisits visits(const WalkArgs&, int b, int, float*) const {
    return RowsVisits{fused_rows(t, cyp, ivx, ivy, b, Lx, Ly, AP)};
  }
};

// PARAMS: the source's functor reads it from the kernel's parameters
// (walk_kernel_params).
template <bool CKPT, bool PARAMS = false, class Src>
int dispatch(int k, const WalkArgs& a, const Src& src, int* clusters) {
  return with_levels(k, [&](auto K) {
    return launch_walk<Src, decltype(K)::value, false, MAX_W, 1, CKPT, PARAMS>(a, src,
                                                                             clusters);
  });
}

// How many clusters of R CTAs of W threads and m tiles (k levels, source:
// hs = 1 or rows = 0, T) the card holds at once, into *clusters.
template <bool CKPT>
int tiled_clusters(int k, int hs, int W, int R, int m, int T, int* clusters) {
  if (!walk_geometry_ok(k, 2, W, MAX_W, R, m, T, hs != 0)) return (int)cudaErrorInvalidValue;
  WalkArgs a = {};
  a.B = 1;
  a.W = W;
  a.R = R;
  a.m = m;
  a.T = T;
  a.budget = WALK_MAX_SMEM;
  return hs ? dispatch<CKPT>(k, a, HsSource{nullptr}, clusters)
            : dispatch<CKPT>(k, a, RowsSource{}, clusters);
}

// A launch on the hs source (csrc/tiled_dp.cu, praline_tiled_dp_hs, says
// what each argument is).
template <bool CKPT>
int tiled_hs(const float* hs, const int* lx, const int* ly, const float* gaps_host, int k,
             int mode, int traceback, int D, int B, int Lp, int W, int R, int m, int T,
             float* carry, const Outs& out, float* snap, int interval, int block, float cum0,
             void* stream) {
  WalkArgs a = {};
  if (!walk_args(&a, true, MAX_W, WALK_MAX_SMEM, lx, ly, gaps_host, k, mode, traceback, D, B,
                 Lp, W, R, m, T, carry, out, stream) ||
      !walk_snapshots(&a, snap, interval, block, cum0))
    return (int)cudaErrorInvalidValue;
  return dispatch<CKPT>(k, a, HsSource{hs}, nullptr);
}

// A launch on the rows source (csrc/tiled_dp.cu, praline_tiled_dp_rows).
template <bool CKPT>
int tiled_rows(const float* cx, const float* inv_x, const float* cy, const float* inv_y,
               const float* s, const int* lx, const int* ly, const float* gaps_host, int k,
               int mode, int traceback, int B, int Lx, int Ly, int A, int W, int R, int m,
               int T, float* t, float* cyp, float* carry, const Outs& out, float* snap,
               int interval, int block, float cum0, void* stream) {
  WalkArgs a = {};
  if (Lx < 1 || Ly < 1 ||
      !walk_args(&a, false, MAX_W, WALK_MAX_SMEM, lx, ly, gaps_host, k, mode, traceback,
                 Lx + Ly + 1, B, Lx + 1, W, R, m, T, carry, out, stream) ||
      !walk_snapshots(&a, snap, interval, block, cum0))
    return (int)cudaErrorInvalidValue;
  const int rc = launch_prep(cx, cy, s, t, cyp, B, Lx, Ly, A, a.stream);
  if (rc != 0) return rc;
  return dispatch<CKPT>(k, a, RowsSource{t, cyp, inv_x, inv_y, Lx, Ly, padded_alphabet(A)},
                        nullptr);
}

}  // namespace
