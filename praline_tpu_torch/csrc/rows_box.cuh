// The lane-tiled DP's in-place score sources on Hopper's int8 tensor cores
// (K6's "mma" tier): the rows source (csrc/tiled_mma.cu: the ordinary
// launches; csrc/tiled_ckpt_mma.cu: the checkpointed forward and resume)
// and the multi-track composite (csrc/tiled_composite_mma.cu), all on
// csrc/cluster_walk.cuh's walk_kernel_params.  Each computes the same bits
// as its scalar tier (csrc/tiled_walk.cuh's RowsSource,
// csrc/tiled_composite.cu) for the operands kernels/fused_scores.py::
// tensor_core_exact admits: the producer's limbs, tiles and proof
// (csrc/score_box.cuh, csrc/scores_mma.cu), which K5 (csrc/fused_dp.cu)
// runs a box at a time on one tile a CTA.
//
// Before each visit's steps the CTA fills the visit's box hk[TB][W + 4] of
// TB = T rounded up to 8 diagonals x W lanes on the tensor cores (fill_box)
// and the steps read their scores from it (BoxScores).  Unlike K5 a CTA
// walks m tiles, so each visit has rows of its own: the visit's rows' limbs
// and inverses and its band of Cy columns come in by cp.async into one of
// two buffers while the steps of the visit before run in the other.  A
// composite is a stage a track: the first track's pass puts s_0 * w_0 in
// the box, each later one adds s_q * w_q to it, each product and sum
// rounded on its own (kernels/scores.py::composite_skewed_scores' order);
// a track's stage is copied while the stage before it fills, the next
// visit's first while the steps run.  (The ring's launch,
// csrc/tiled_ring.cu, keeps the scalar tier: a box filled every visit
// measured slower at every T a superstep takes.)
//
// The tier is two launches of each kernel, as K5's: built without Cy_hi and
// with it (WIDE), each problem run by the launch of its kind (pwide, a flag
// a problem that the prep writes once a chunk) and its CTAs leaving at once
// in the other, so a problem with no count past 255 runs the one-limb code.
// Whether a visit's rows need the second pass over T's limbs is each
// thread's row flag, read with the copies and or-ed over the CTA.

#pragma once

#include "cluster_walk.cuh"
#include "score_box.cuh"

namespace {

using namespace praline_dp;

constexpr int BOX_MAX_TRACKS = 8;  // tracks of a composite (csrc/tiled_composite.cu's)

// The box's depth: T diagonals rounded up to whole n-tiles of 8 (the extra
// diagonals are filled and never read).
__host__ __device__ constexpr int box_depth(int T) { return (T + 7) / 8 * 8; }

// Byte offsets of the source's shared memory (at csrc/cluster_walk.cuh's
// WalkLayout::src): the box hk[TB][W + 4]; two buffers of the rows' limbs
// rows[2][lo, hi][W][32 B]; the bands' Cy_lo columns [2][W + TB][32 B]
// (then, WIDE, their Cy_hi columns [2][W + TB][32 B]); their inverses
// ivy[2][W + TB]; the rows' inverses ivx[2][W].  kernels/tiled_dp.py::
// smem_layout mirrors it (the wide layout).
struct BoxLayout {
  int hk, rows, band, ivy, ivx, total;
  __host__ __device__ BoxLayout(int W, int T, bool wide) {
    const int cols = W + box_depth(T);
    hk = 0;
    rows = round16(box_depth(T) * (W + 4) * 4);
    band = rows + 2 * 2 * W * 32;
    ivy = band + (wide ? 4 : 2) * cols * 32;
    ivx = ivy + round16(2 * cols * 4);
    total = ivx + round16(2 * W * 4);
  }
};

// One track's operands for B problems of Lx x Ly: the prep's limbs and
// flags (csrc/score_box.cuh MmaOperands, in the scratch of
// praline_tiled_prep), the inverses and the track's weight.
struct BoxTrack {
  MmaOperands op;
  const float* ivx;  // [B, Lx]
  const float* ivy;  // [B, Ly]
  float w;
};

// The source's table, in the kernel's parameters: NT tracks (n of them in
// use; the rows source is one track), pwide u8[B] (1 where a count of
// problem b's y passes 255 on some track), the rows of x (Lx) and of y.
template <int NT>
struct BoxTable {
  BoxTrack track[NT];
  const unsigned char* pwide;
  int n, Lx, Ly;
};

// The composite's store: the first track's pass puts s w, each later one
// adds s w to the cell (kernels/scores.py::composite_skewed_scores).
struct WeightedStore {
  float w;
  bool first;
  __device__ __forceinline__ void operator()(float* p, float v) const {
    const float ws = __fmul_rn(v, w);
    *p = first ? ws : __fadd_rn(*p, ws);
  }
};

template <bool WIDE, int NT>
struct BoxSource;

// The visits of problem b (csrc/cluster_walk.cuh calls prepare for each
// visit it runs, every thread of the CTA).
template <bool WIDE, int NT>
struct BoxVisits {
  const BoxSource<WIDE, NT>* src;
  unsigned char* sm;
  int b, W, T, slot;
  bool started, two;  // two: this thread's row flag of the stage in flight

  __device__ __forceinline__ uint32_t* rows_of(const BoxLayout& L, int s) const {
    return reinterpret_cast<uint32_t*>(sm + L.rows) + s * 2 * W * KW;
  }
  __device__ __forceinline__ uint32_t* band_of(const BoxLayout& L, int s) const {
    return reinterpret_cast<uint32_t*>(sm + L.band) + s * (W + box_depth(T)) * KW;
  }
  __device__ __forceinline__ float* ivy_of(const BoxLayout& L, int s) const {
    return reinterpret_cast<float*>(sm + L.ivy) + s * (W + box_depth(T));
  }
  __device__ __forceinline__ float* ivx_of(const BoxLayout& L, int s) const {
    return reinterpret_cast<float*>(sm + L.ivx) + s * W;
  }

  // Start the copies of track q's stage of the visit at lanes i0 ..,
  // diagonals d0 .. into buffer s (one cp.async group): the rows' limbs and
  // inverses, the band's columns j = d0 - i0 - W .. and their inverses.
  // Returns this thread's row flag (its row of x needs two passes).
  __device__ __forceinline__ bool fetch(int s, int d0, int i0, int q) const {
    const BoxLayout L(W, T, WIDE);
    const BoxTrack& tr = src->track[q];
    const int t = threadIdx.x, Lx = src->Lx, Ly = src->Ly, cols = W + box_depth(T);
    uint32_t* lo = rows_of(L, s);
    uint32_t* hi = lo + W * KW;
    const size_t xb = (size_t)b * Lx;
    for (int p = t; p < 2 * W; p += W) {
      const int i = i0 + p / 2;
      const bool ok = i >= 1 && i <= Lx;
      const size_t row = xb + (ok ? i - 1 : 0);
      copy_async<16>(lo + 4 * p, tr.op.xlo + 2 * row + p % 2, ok);
      copy_async<16>(hi + 4 * p, tr.op.xhi + 2 * row + p % 2, ok);
    }
    const int i = i0 + t;
    const bool ok = i >= 1 && i <= Lx;
    copy_async<4>(ivx_of(L, s) + t, ok ? tr.ivx + xb + i - 1 : tr.ivx, ok);
    start_band(band_of(L, s), WIDE ? band_of(L, s + 2) : nullptr, ivy_of(L, s),
               y_rows(tr.op, tr.ivy, b, Ly), d0 - i0 - W, cols, Ly, t, W);
    return ok && tr.op.xwide[xb + i - 1] != 0;
  }

  // The visit's box (lanes i0 .., diagonals d0 ..), filled on the tensor
  // cores; the next visit (nd0, ni0; nd0 < 0: none) on its way.
  __device__ __forceinline__ BoxScores prepare(int d0, int i0, int nd0, int ni0) {
    const BoxLayout L(W, T, WIDE);
    const int t = threadIdx.x, cols = W + box_depth(T);
    const int n = NT == 1 ? 1 : src->n;
    float* hk = reinterpret_cast<float*>(sm + L.hk);
    if (!started) {
      two = fetch(slot, d0, i0, 0);
      started = true;
    }
    for (int q = 0; q < n; ++q) {
      copy_wait_all();
      // this stage has landed; every thread is done with the stage before
      // (the other buffer) and with the steps of the visit before (the box)
      const bool two_pass = __syncthreads_or(two) != 0;
      bool band_wide = false;
      if constexpr (WIDE)
        band_wide = __syncthreads_or(rows_nonzero(band_of(L, slot + 2), cols, t, W)) != 0;
      if (q + 1 < n) two = fetch(slot ^ 1, d0, i0, q + 1);
      else if (nd0 >= 0) two = fetch(slot ^ 1, nd0, ni0, 0);
      const uint32_t* lo = rows_of(L, slot);
      const float* ivx = ivx_of(L, slot);
      const uint32_t* band = band_of(L, slot);
      const uint32_t* band_hi = band_of(L, slot + 2);
      const float* ivy = ivy_of(L, slot);
      if constexpr (NT == 1) {
        fill_box(hk, W + 4, W, box_depth(T), lo, lo + W * KW, two_pass, ivx, band, band_hi,
                 band_wide, ivy, i0, d0, src->Lx, src->Ly);
      } else {  // each thread reads back only the cells it put (fill_box)
        fill_box(hk, W + 4, W, box_depth(T), lo, lo + W * KW, two_pass, ivx, band, band_hi,
                 band_wide, ivy, i0, d0, src->Lx, src->Ly,
                 WeightedStore{src->track[q].w, q == 0});
      }
      slot ^= 1;
    }
    __syncthreads();  // the box is whole
    return BoxScores{hk, W + 4, d0, i0};
  }
};

// walk_kernel_params' source on the "mma" tier (WIDE: the launch with the
// Cy_hi bands).
template <bool WIDE, int NT>
struct BoxSource : BoxTable<NT> {
  __host__ __device__ static int smem(int W, int T) { return BoxLayout(W, T, WIDE).total; }
  __device__ __forceinline__ bool takes(int b) const { return (this->pwide[b] != 0) == WIDE; }
  __device__ __forceinline__ BoxVisits<WIDE, NT> visits(const WalkArgs& a, int b, int,
                                                        float* at) const {
    return BoxVisits<WIDE, NT>{this, reinterpret_cast<unsigned char*>(at), b, a.W, a.T, 0,
                               false, false};
  }
};

// The "mma" tier's launches on a box table: the kernel built without Cy_hi,
// then the wide one; with clusters, the wide one's occupancy (its shared
// memory the larger).
template <bool CKPT, int NT>
int box_dispatch(int k, const WalkArgs& a, const BoxTable<NT>& tab, int* clusters) {
  return with_levels(k, [&](auto K) {
    constexpr int k_ = decltype(K)::value;
    const BoxSource<true, NT> wide{tab};
    if (clusters)
      return launch_walk<BoxSource<true, NT>, k_, false, MAX_W, 1, CKPT, true>(a, wide,
                                                                              clusters);
    const BoxSource<false, NT> narrow{tab};
    const int rc = launch_walk<BoxSource<false, NT>, k_, false, MAX_W, 1, CKPT, true>(
        a, narrow, nullptr);
    return rc ? rc
              : launch_walk<BoxSource<true, NT>, k_, false, MAX_W, 1, CKPT, true>(a, wide,
                                                                                  nullptr);
  });
}

// How many clusters of R CTAs of W threads and m tiles (k levels, T) of a
// box source the card holds at once, into *clusters.
template <bool CKPT, int NT>
int box_clusters(int k, int W, int R, int m, int T, int* clusters) {
  if (!walk_geometry_ok(k, 2, W, MAX_W, R, m, T, BoxSource<true, NT>::smem(W, T)))
    return (int)cudaErrorInvalidValue;
  WalkArgs a = {};
  a.B = 1;
  a.W = W;
  a.R = R;
  a.m = m;
  a.T = T;
  a.budget = WALK_MAX_SMEM;
  return box_dispatch<CKPT, NT>(k, a, BoxTable<NT>{}, clusters);
}

// The checks common to the box sources' launches: the prep's scratch, its
// problem flags, and the walk's arguments at the wide layout (the larger).
inline bool box_args(WalkArgs* a, const void* ops, const unsigned char* pwide, const int* lx,
                     const int* ly, const float* gaps_host, int k, int mode, int traceback,
                     int D, int B, int Lp, int W, int R, int m, int T, float* carry,
                     const Outs& out, void* stream) {
  return ops && pwide && reinterpret_cast<uintptr_t>(ops) % 16 == 0 &&
         walk_args(a, BoxSource<true, 1>::smem(W, T), MAX_W, WALK_MAX_SMEM, lx, ly, gaps_host, k,
                   mode, traceback, D, B, Lp, W, R, m, T, carry, out, stream);
}

// The rows source's table: one track of the prep's scratch `ops` for B
// problems of Lx x Ly.
inline BoxTable<1> rows_table(const void* ops, const unsigned char* pwide, const float* inv_x,
                              const float* inv_y, int B, int Lx, int Ly) {
  BoxTable<1> tab = {};
  tab.track[0] = BoxTrack{mma_operands(const_cast<void*>(ops), B, Lx, Ly), inv_x, inv_y, 1.0f};
  tab.pwide = pwide;
  tab.n = 1;
  tab.Lx = Lx;
  tab.Ly = Ly;
  return tab;
}

// A launch of the rows source on the "mma" tier (csrc/tiled_mma.cu and
// csrc/tiled_ckpt_mma.cu say what each argument is).
template <bool CKPT>
int rows_launch(const void* ops, const unsigned char* pwide, const float* inv_x,
                const float* inv_y, const int* lx, const int* ly, const float* gaps_host, int k,
                int mode, int traceback, int B, int Lx, int Ly, int W, int R, int m, int T,
                float* carry, const Outs& out, float* snap, int interval, int block, float cum0,
                void* stream) {
  WalkArgs a = {};
  if (Lx < 1 || Ly < 1 ||
      !box_args(&a, ops, pwide, lx, ly, gaps_host, k, mode, traceback, Lx + Ly + 1, B, Lx + 1,
                W, R, m, T, carry, out, stream) ||
      !walk_snapshots(&a, snap, interval, block, cum0))
    return (int)cudaErrorInvalidValue;
  return box_dispatch<CKPT, 1>(k, a, rows_table(ops, pwide, inv_x, inv_y, B, Lx, Ly),
                                      nullptr);
}

}  // namespace
