// The cluster walk of the Hopper DPs that run one problem on a thread-block
// cluster: csrc/fused_dp.cu (K5, one tile a CTA, scores computed on chip)
// and csrc/tiled_dp.cu (K6, m tiles a CTA, rows of any length).  The
// recurrence is csrc/wavefront.cuh's; this file orders its steps.
//
// The Lp lanes are cut into tiles of W lanes (one lane a thread, W =
// blockDim.x); CTA rank r of the R in a cluster owns the m tiles r m ..
// r m + m - 1.  The diagonals 2 .. dend are walked in boxes of T: in phase
// p, rank r runs box p - r over its tiles with a lane to compute, left to
// right, and one cluster barrier closes each phase, so rank r runs box k
// right after rank r - 1 ran it.  A problem thus takes (boxes + R - 1) m T
// steps in sequence.  The left neighbour of a tile's first lane at step s
// of a box is the previous tile's last lane before its own step s:
//   - inside a CTA, the previous tile wrote it into the edge buffer
//     edge[s] earlier in the same box (thread W - 1 after the step's
//     barrier; thread 0 of the next tile reads it before its own, and a
//     barrier closes every visit);
//   - across CTAs, rank r - 1's last tile wrote it into rank r's ring, in
//     distributed shared memory, while it ran the box in the previous
//     phase; the ring is double-buffered by box parity, so one cluster
//     barrier a phase orders every write before its read and every read
//     before the next write to the same half.
// Inside a tile lanes cross warps by shuffles and a double-buffered slot a
// warp (xbuf), as in wavefront_block.  One tile's carries live in
// registers; with m > 1 (TILES) a visit loads the tile's carries from a
// CarryStore and stores them back.  Borders use the global lane index.
// Scores mode stops at diagonal dend = lx + ly and skips tiles past lx,
// so high ranks may have nothing to do but the barriers.  Semiglobal and
// local terminals: each thread keeps its best candidate over its lanes,
// each CTA picks its best (block_best), and after a cluster barrier rank 0
// picks among the R over distributed shared memory (candidates are unique
// cells, so the order is free); a last barrier keeps every CTA alive while
// rank 0 reads it.
//
// Distributed shared memory may be written only once the remote CTA runs,
// and read only while it lives: a cluster barrier opens the walk and one
// closes the terminal pick.
//
// The score source is the caller's: visits.prepare(d0, i0, nd0, ni0), which
// every thread of the CTA calls, makes ready the scores of the visit of box
// d0 .. d0 + T - 1 on the tile at lane i0 (nd0 < 0 where this CTA makes no
// further visit, else the next visit's first diagonal and lane) and returns
// a functor score(d, i) = hs[d, b, i] for the visit's cells.

#pragma once

#include <cooperative_groups.h>

#include "wavefront.cuh"

namespace praline_dp {

namespace cg = cooperative_groups;

// Byte offsets of the kernels' shared-memory layouts are rounded to 16.
__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// The cluster's shape: R CTAs of m tiles of W lanes, boxes of T diagonals.
struct WalkShape {
  int R, m, W, T;
};

// Shared memory of the walk: xbuf[2][W / 32][NX], ring[2][T][NX] (written
// by rank r - 1), edge[T][NX] (TILES only), red[W / 32 + 1] (the last
// slot is the CTA's best candidate, read by rank 0).
struct WalkSmem {
  float* xbuf;
  float* ring;
  float* edge;
  Cand* red;
};

// Where a tile's carries wait between visits (TILES only): value v of the
// tile's lane t at base[v * stride + jj * W + t] in shared memory, or, in
// device memory, at base[v * stride + i] for the global lane i < Lp.
struct CarryStore {
  float* base;
  int stride;
  bool global;
};

template <int K, bool TILES, class Visits>
__device__ __forceinline__ void cluster_walk(cg::cluster_group& cluster, const WalkSmem& sm,
                                             const WalkShape& w, const Problem& p,
                                             const Gaps& gaps, const Outs& out, int dend,
                                             int lane_end, const CarryStore& store,
                                             Visits& visits) {
  using C = Carries<K, 1>;
  constexpr int NX = C::NX;
  const int W = w.W, T = w.T, R = w.R, m = TILES ? w.m : 1;
  const int t = threadIdx.x, nw = W >> 5, warp = t >> 5, wl = t & 31;
  const int r = (int)cluster.block_rank();
  const int tile0 = r * m;
  // tiles of this CTA with a lane to compute (uniform over the CTA)
  const int tiles = max(0, min(m, lane_end / W + 1 - tile0));
  const int nbox = (dend - 2) / T + 1;
  float* next_ring = r + 1 < R ? cluster.map_shared_rank(sm.ring, r + 1) : nullptr;

  C c;
  if (!TILES || m == 1) c.init(0, tile0 * W + t, p.mode, gaps.g[0]);
  Cand best = first_candidate<K>(p.mode, tile0 == 0 && t == 0, p.lx, p.ly);
  Border<K> box_border(gaps);  // the border run at diagonal d0 - 1
  cluster.sync();  // every CTA of the cluster runs before any writes another's ring

  for (int ph = 0; ph < nbox + R - 1; ++ph) {
    const int k = ph - r;
    if (tiles > 0 && k >= 0 && k < nbox) {  // uniform over the CTA
      const int d0 = 2 + k * T, d1 = min(d0 + T - 1, dend);
      Border<K> border = box_border;
      for (int jj = 0; jj < tiles; ++jj) {
        const int i0 = (tile0 + jj) * W, i = i0 + t;
        border = box_border;
        const int ci = store.global ? i : jj * W + t;
        if (TILES && m > 1) {
          if (k == 0 || (store.global && i >= p.Lp)) c.init(0, i, p.mode, gaps.g[0]);
          else c.load(0, store.base, store.stride, ci);
        }
        const float* left = jj > 0 ? sm.edge : (r > 0 ? sm.ring + (k & 1) * T * NX : nullptr);
        float* right = jj + 1 < tiles ? sm.edge
                       : (jj == m - 1 && next_ring ? next_ring + (k & 1) * T * NX : nullptr);
        const bool more = jj + 1 < tiles || k + 1 < nbox;
        const int nd0 = !more ? -1 : (jj + 1 < tiles ? d0 : d0 + T);
        const int ni0 = jj + 1 < tiles ? i0 + W : tile0 * W;
        const auto score = visits.prepare(d0, i0, nd0, ni0);
        for (int d = d0; d <= d1; ++d) {
          const int s = d - d0, buf = d & 1;
          float sh[NX];
          c.shfl_in(0, sh);
          if (wl == 31) c.export_x(0, sm.xbuf + (buf * nw + warp) * NX);
          if (t == 0 && left) {
#pragma unroll
            for (int v = 0; v < NX; ++v) sh[v] = left[s * NX + v];
          }
          __syncthreads();
          // this lane's values before step s, for the next tile's first lane
          if (t == W - 1 && right) c.export_x(0, right + s * NX);
          if (wl == 0 && warp > 0) {
            const float* x = sm.xbuf + (buf * nw + warp - 1) * NX;
#pragma unroll
            for (int v = 0; v < NX; ++v) sh[v] = x[v];
          }
          if (i == 0) C::border_x(sh);
          border.next(gaps, d);
          if (i <= lane_end) c.step(0, i, d, sh, border.cum, score, gaps, p, out, best);
        }
        if (TILES && m > 1 && (!store.global || i < p.Lp))
          c.store(0, store.base, store.stride, ci);
        if (jj + 1 < tiles) __syncthreads();  // the next visit reuses edge and xbuf
      }
      box_border = border;
    }
    cluster.sync();  // the ring writes of this phase are visible to the next
  }

  if (p.mode != GLOBAL) {
    const bool local = p.mode == LOCAL;
    const Cand cta = block_best(best, local, sm.red);
    if (t == 0) sm.red[nw] = cta;
    cluster.sync();
    if (r == 0 && t == 0) {
      Cand pick = cta;
      for (int q = 1; q < R; ++q) {
        const Cand o = *cluster.map_shared_rank(sm.red + nw, q);
        if (beats(o, pick, local)) pick = o;
      }
      write_terminal(pick, p.b, out);
    }
    cluster.sync();  // no CTA leaves while rank 0 reads its candidate
  }
}

}  // namespace praline_dp
