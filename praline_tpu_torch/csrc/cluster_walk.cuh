// The cluster walk of the Hopper DPs, each of which runs one problem on a
// thread-block cluster (of one CTA or more): csrc/wavefront_dp.cu (K2/K4,
// hs, up to 2048 lanes, the band flag on), csrc/fused_dp.cu (K5, one tile
// a CTA, scores computed on chip) and csrc/tiled_dp.cu (K6, m tiles a CTA,
// rows of any length).  The recurrence is csrc/wavefront.cuh's; this file
// orders its steps.
//
// The Lp lanes are cut into tiles of W lanes, Q consecutive lanes a thread
// (W = Q blockDim.x; thread t owns lanes t Q .. t Q + Q - 1 of its tile);
// CTA rank r of the R in a cluster owns the m tiles r m .. r m + m - 1.
// The diagonals 2 .. dend are walked in boxes of T: in phase p, rank r runs
// box p - r over its tiles with a lane to compute, left to right, and one
// cluster barrier closes each phase, so rank r runs box k right after rank
// r - 1 ran it.  A problem thus takes (boxes + R - 1) m T steps in
// sequence.  The left neighbour of a tile's first lane at step s of a box
// is the previous tile's last lane before its own step s:
//   - inside a CTA, the previous tile wrote it into the edge buffer
//     edge[s] earlier in the same box (the last thread after the step's
//     barrier; thread 0 of the next tile reads it before its own, and a
//     barrier closes every visit);
//   - across CTAs, rank r - 1's last tile wrote it into rank r's ring, in
//     distributed shared memory, while it ran the box in the previous
//     phase; the ring is double-buffered by box parity, so one cluster
//     barrier a phase orders every write before its read and every read
//     before the next write to the same half.
// Inside a tile lanes cross warps by shuffles and a double-buffered slot a
// warp (xbuf), each thread's last lane exporting and its first lane taking
// its left neighbour; a step runs a thread's lanes from Q - 1 down to 0, so
// each reads its left neighbour's diagonal d - 1 values before they are
// overwritten (csrc/wavefront.cuh's step, untouched: every cell runs the
// same operations on the same inputs at any Q).  One tile's carries live in
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
//
// The kernel of the walks with m tiles a CTA (walk_kernel, its launch and
// its occupancy query launch_walk) is here too, one template over the score
// source, shared by K2/K4 (csrc/hs_visits.cuh's HsSource, the band on) and
// K6 (HsSource, csrc/tiled_walk.cuh's RowsSource, csrc/tiled_composite.cu's
// CompositeSource, or csrc/rows_box.cuh's BoxSource, the two in-place
// sources on the tensor cores); K5 has its own.  A source says how much
// shared memory it takes (Src::smem(W, T)) and whether it takes problem b
// (Src::takes(b): the "mma" tier is two launches, each problem run by one
// and its CTAs leaving at once in the other).
//
// Checkpointed traceback (K6 only, walk_kernel built with CKPT, Snapshots):
// the forward launch writes no
// traceback bytes; where a tile enters a box whose first diagonal is 2 +
// q I (a block of I = every T diagonals), each thread stores its lane's
// carries into the snapshot q.  Each tile writes only its own lanes, so the
// snapshot is whole when the launch ends, with no extra barrier.  A resume
// launch starts every tile at block q's first box from snapshot q (its
// left neighbour's edge values then come from the neighbour's own snapshot
// carries, exported before each step as in any box), walks the block's
// diagonals only, writes their bytes into a block buffer and picks no
// terminal.
//
// The ring's launch (K6 only, walk_kernel built with RING, RingLaunch;
// csrc/tiled_ring.cu, dist/ring.py): one rank's block of Lp lanes, global
// lanes base .., walks one chunk of diagonals d0 .. d1.  Every lane loads
// its carries at the first box and stores them after the last; lane
// indices for the borders, the scores and the terminals are global (i =
// base + the storage lane); CTA rank 0's first lane takes its left
// neighbour before each step from the left rank's values (heads), and the
// rank's last lane hands its own before each step to the right rank
// (tails); the terminal candidate is read from and written back to the
// rank's buffer (out's fields), so a rank holds it across launches.

#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "wavefront.cuh"

namespace praline_dp {

namespace cg = cooperative_groups;

// Byte offsets of the kernels' shared-memory layouts are rounded to 16.
__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// The cluster's shape: R CTAs of m tiles of W lanes, boxes of T diagonals.
struct WalkShape {
  int R, m, W, T;
};

// Shared memory of the walk: xbuf[2][warps][NX], ring[2][T][NX] (written
// by rank r - 1), edge[T][NX] (TILES only), red[warps + 1] (the last slot
// is the CTA's best candidate, read by rank 0); warps = W / Q / 32.
struct WalkSmem {
  float* xbuf;
  float* ring;
  float* edge;
  Cand* red;
};

// Byte offsets of a walking CTA's dynamic shared memory (W lanes, Q a
// thread, so W / Q / 32 warps): the walk's cross-warp exchange
// xbuf[2][warps][NX], ring[2][T][NX] and tile edge edge[T][NX], the
// candidates red[warps + 1]; the score source's src_bytes
// (Src::smem: on the hs source the double-buffered scores hbuf[2][T][W],
// csrc/hs_visits.cuh; on the tensor cores the box and its operands,
// csrc/rows_box.cuh); with m > 1 the carries carry[NS][m W] where the whole
// fits in `budget` bytes (carry = -1 where it does not: they go to a
// device-memory scratch).  kernels/tiled_dp.py::smem_layout mirrors it.
struct WalkLayout {
  int xbuf, ring, edge, red, src, carry, total;
  __host__ __device__ WalkLayout(int W, int T, int m, int nx, int ns, int src_bytes, int budget,
                                 int Q = 1) {
    const int nw = W / Q / 32;
    xbuf = 0;
    ring = xbuf + round16(2 * nw * nx * 4);
    edge = ring + round16(2 * T * nx * 4);
    red = edge + round16(T * nx * 4);
    src = red + round16((nw + 1) * (int)sizeof(Cand));
    total = src + src_bytes;
    carry = -1;
    if (m > 1 && total + (long long)ns * m * W * 4 <= budget) {
      carry = total;
      total += ns * m * W * 4;
    }
  }
};

// Where a tile's carries wait between visits (TILES only): value v of the
// tile's lane t at base[v * stride + jj * W + t] in shared memory, or, in
// device memory, at base[v * stride + i] for the global lane i < Lp.
struct CarryStore {
  float* base;
  int stride;
  bool global;
};

// The checkpoints of a walk: snap f32[nblk, B, NS, Lp] holds lane i's
// carries at the entry of block q (diagonal 2 + q every T) at
// snap[((q B + b) NS + v) Lp + i].  snap == nullptr: an ordinary walk;
// resume < 0: the forward launch, which stores them; resume = q: the
// launch that restarts at block q, with cum0 the border run cost of the
// diagonal before it.
struct Snapshots {
  float* snap = nullptr;
  int every = 1;
  int resume = -1;
  float cum0 = 0.0f;
};

// One ring launch (RING): the rank's first global lane; the chunk d0 .. d1
// with cum0 the border run cost of diagonal d0 - 1; carries f32[B, NS, Lp]
// in (carry_in) and out (carry_out, which may be carry_in); heads and tails
// f32[d1 - d0 + 1, NX, B], value v of step s of problem b at (s NX + v) B
// + b (heads nullptr on the rank of lane 0); the candidate f32[5, B] in
// and out (cand_in, cand_out, which may be one buffer; out's fields are
// cand_out's rows); with traceback, out.tb's row r is diagonal 2 + tb_row0
// + r.
struct RingLaunch {
  int base = 0, d0 = 2, d1 = 2, tb_row0 = 0;
  float cum0 = 0.0f;
  const float* carry_in = nullptr;
  float* carry_out = nullptr;
  const float* heads = nullptr;
  float* tails = nullptr;
  const float* cand_in = nullptr;
  float* cand_out = nullptr;
};

// The candidate of problem b in a ring's f32[5, B] buffer.
__device__ __forceinline__ Cand read_candidate(const float* c, int b, int B) {
  return {c[b], c[B + b], __float_as_int(c[2 * B + b]), __float_as_int(c[3 * B + b]),
          __float_as_int(c[4 * B + b])};
}

// Where the band flag is on (BAND, csrc/wavefront_dp.cu), scores mode runs
// only the visits that hold a cell of the problem's band 0 <= j <= ly
// (rows past lane_end are never walked).  A visit of box d0 .. d1 on the
// tile of lanes i0 .. ie (ie = min(i0 + W - 1, lane_end)) runs the steps
// max(d0, i0) .. min(d1, ie + ly + 1): no lane of it is in the band before
// diagonal i0, and the one step past ie + ly hands the next tile's first
// lane its left neighbour at (i0 + W, ly).  A visit with no cell of the band
// is skipped, but thread W - 1 still writes slot 0 of the edge (or of the
// next CTA's ring) from its carries: the next tile's first lane may enter
// the band's last column at the box's first diagonal.  This is exact
// because nothing outside the band reaches a cell inside it: a cell (i, j)
// reads (i - 1, j), (i, j - 1) and best(i - 1, j - 1), and the j = 0 border
// step overwrites every value that came from j < 0 (M, the gap levels,
// their lengths and the stay bits); so a tile's carries may stay at their
// d = 1 values until its first visit in the band, and values past j = ly
// flow only to larger j.  Traceback mode walks every lane of every box.
// Q > 1 (csrc/tiled_dp.cu's scores launches over hs) takes neither the
// checkpoints nor the ring, and one tile a CTA (walk_geometry_ok).
template <int K, bool TILES, bool BAND = false, bool CKPT = false, bool RING = false, int Q = 1,
          class Visits>
__device__ __forceinline__ void cluster_walk(cg::cluster_group& cluster, const WalkSmem& sm,
                                             const WalkShape& w, const Problem& p,
                                             const Gaps& gaps, const Outs& out, int dend,
                                             int lane_end, const CarryStore& store,
                                             Visits& visits, const Snapshots ck = Snapshots(),
                                             const RingLaunch rl = RingLaunch()) {
  static_assert(Q == 1 || !(CKPT || RING), "Q lanes a thread: neither checkpoints nor the ring");
  using C = Carries<K, Q>;
  constexpr int NX = C::NX;
  const int W = w.W, T = w.T, R = w.R, m = TILES ? w.m : 1;
  const int NT = W / Q;  // threads
  const int t = threadIdx.x, nw = NT >> 5, warp = t >> 5, wl = t & 31;
  const int r = (int)cluster.block_rank();
  const int tile0 = r * m;
  // tiles of this CTA with a lane to compute (uniform over the CTA)
  const int tiles = max(0, min(m, lane_end / W + 1 - tile0));
  // the global index of storage lane 0 and the first diagonal of box 0
  const int gbase = RING ? rl.base : 0, dbase = RING ? rl.d0 : 2;
  const int nbox = (dend - dbase) / T + 1;
  const bool resume = CKPT && ck.snap && ck.resume >= 0;
  const int kfirst = resume ? ck.resume * ck.every : 0;  // the first box walked
  // lane carries of snapshot q (this problem's rows)
  auto snap_at = [&](int q) { return ck.snap + ((size_t)q * p.B + p.b) * C::NS * p.Lp; };
  // a ring lane's carries at the chunk's entry (past the rank's lanes: d = 1's)
  auto ring_load = [&](C& c, int q, int li, int i) {
    if (li < p.Lp) c.load(q, rl.carry_in + (size_t)p.b * C::NS * p.Lp, p.Lp, li);
    else c.init(q, i, p.mode, gaps.g[0]);
  };
  const bool band = BAND && !p.traceback;
  float* next_ring = r + 1 < R ? cluster.map_shared_rank(sm.ring, r + 1) : nullptr;
  // The steps first .. last of visit (box kb, tile jj), and whether it runs:
  // with the band, whether a step of it holds a cell of the band (the step
  // past the band alone is no visit).
  auto steps_of = [&](int kb, int jj, int& first, int& last) {
    const int d0 = dbase + kb * T, d1 = min(d0 + T - 1, dend);
    const int i0 = (tile0 + jj) * W, ie = min(i0 + W - 1, lane_end);
    first = d0;
    last = d1;
    if (band) {
      first = max(d0, i0);
      last = min(d1, ie + p.ly + 1);
      return first <= min(d1, ie + p.ly);
    }
    return true;
  };
  // The visit this CTA runs after (kb, jj): its box and tile, kb = -1 for
  // none.  Past the band is for good: once the CTA's last tile is past, so
  // are all.
  auto next_visit = [&](int kb, int jj, int& nk, int& nj) {
    int f, l;
    for (++jj; kb < nbox; ++kb, jj = 0) {
      for (; jj < tiles; ++jj)
        if (steps_of(kb, jj, f, l)) {
          nk = kb;
          nj = jj;
          return;
        }
      if (band && 2 + kb * T > min((tile0 + tiles) * W - 1, lane_end) + p.ly) break;
    }
    nk = -1;
    nj = 0;
  };

  C c;
  if (!TILES || m == 1) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int li = tile0 * W + t * Q + q, i = li + gbase;
      if (RING) ring_load(c, q, li, i);
      else if (resume && i < p.Lp) c.load(q, snap_at(ck.resume), p.Lp, i);
      else c.init(q, i, p.mode, gaps.g[0]);
    }
  }
  // the ring's diagonal-1 candidates are in the rank's buffer already
  Cand best = first_candidate<K>(p.mode, !RING && tile0 == 0 && t == 0, p.lx, p.ly);
  Border<K> box_border(gaps);  // the border run at diagonal d0 - 1
  if (resume) box_border.cum = ck.cum0;
  if (RING) box_border.cum = rl.cum0;
  cluster.sync();  // every CTA of the cluster runs before any writes another's ring

  for (int ph = 0; ph < nbox - kfirst + R - 1; ++ph) {
    const int k = kfirst + ph - r;
    if (tiles > 0 && k >= kfirst && k < nbox) {  // uniform over the CTA
      const int d0 = dbase + k * T, d1 = min(d0 + T - 1, dend);
      Border<K> border = box_border;
      for (int jj = 0; jj < tiles; ++jj) {
        // this thread's first storage lane li, global lane i (lane q: li + q, i + q)
        const int i0 = (tile0 + jj) * W, li = i0 + t * Q, i = li + gbase;
        border = box_border;
        const int ci = store.global ? li : jj * W + t * Q;
        int first, last;
        const bool runs = steps_of(k, jj, first, last);
        float* right = jj + 1 < tiles ? sm.edge
                       : (jj == m - 1 && next_ring ? next_ring + (k & 1) * T * NX : nullptr);
        if (TILES && m > 1 && (runs || t == NT - 1)) {
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            // a tile's first visit in the band starts from its d = 1 carries
            if (RING && k == kfirst) ring_load(c, q, li + q, i + q);
            else if (resume && k == kfirst && i + q < p.Lp)
              c.load(q, snap_at(ck.resume), p.Lp, i + q);
            else if (k == kfirst || (band && d0 <= i0) || (store.global && li + q >= p.Lp))
              c.init(q, i + q, p.mode, gaps.g[0]);
            else c.load(q, store.base, store.stride, ci + q);
          }
        }
        // the forward launch: this lane's carries at the entry of a block
        if (CKPT && ck.snap && !resume && k % ck.every == 0 && i < p.Lp)
          c.store(0, snap_at(k / ck.every), p.Lp, i);
        if (!runs) {  // BAND only: the next tile's left neighbour at d0
          if (t == NT - 1 && right) c.export_x(Q - 1, right);
          if (jj + 1 < tiles) __syncthreads();  // the next visit reads edge[0]
          continue;
        }
        const float* left = jj > 0 ? sm.edge : (r > 0 ? sm.ring + (k & 1) * T * NX : nullptr);
        // the ring's first lane: the left rank's values before each step
        const float* head = RING && jj == 0 && r == 0 && rl.heads
                                ? rl.heads + (size_t)(d0 - dbase) * NX * p.B + p.b
                                : nullptr;
        int nk = k, nj = jj + 1;
        if (band) {
          next_visit(k, jj, nk, nj);
        } else if (nj == tiles) {
          nk = k + 1 < nbox ? k + 1 : -1;
          nj = 0;
        }
        const int nd0 = nk < 0 ? -1 : dbase + nk * T;
        const int ni0 = (tile0 + nj) * W;
        const auto score = visits.prepare(d0, i0, nd0, ni0);
        for (int d = d0; d <= last; ++d) {
          border.next(gaps, d);
          if (d < first) continue;  // uniform over the CTA
          const int s = d - d0, buf = d & 1;
          float sh[NX];  // the left neighbour of the thread's lane 0
          c.shfl_in(Q - 1, sh);
          if (wl == 31) c.export_x(Q - 1, sm.xbuf + (buf * nw + warp) * NX);
          if (t == 0 && left) {
#pragma unroll
            for (int v = 0; v < NX; ++v) sh[v] = left[s * NX + v];
          }
          if (RING && t == 0 && head) {
#pragma unroll
            for (int v = 0; v < NX; ++v) sh[v] = head[((size_t)s * NX + v) * p.B];
          }
          __syncthreads();
          // the tile's last lane before step s, for the next tile's first lane
          if (t == NT - 1 && right) c.export_x(Q - 1, right + s * NX);
          if (wl == 0 && warp > 0) {
            const float* x = sm.xbuf + (buf * nw + warp - 1) * NX;
#pragma unroll
            for (int v = 0; v < NX; ++v) sh[v] = x[v];
          }
          if (i == 0) C::border_x(sh);
          if (RING && rl.tails && li == p.Lp - 1) {  // the rank's last lane, for the right rank
            float x[NX];
            c.export_x(0, x);
            float* tail = rl.tails + (size_t)(d - dbase) * NX * p.B + p.b;
#pragma unroll
            for (int v = 0; v < NX; ++v) tail[(size_t)v * p.B] = x[v];
          }
#pragma unroll
          for (int q = Q - 1; q > 0; --q) {  // lane q's left neighbour: lane q - 1 at d - 1
            float x[NX];
            c.export_x(q - 1, x);
            if (li + q <= lane_end) c.step(q, i + q, d, x, border.cum, score, gaps, p, out, best);
          }
          if (li <= lane_end) c.step(0, i, d, sh, border.cum, score, gaps, p, out, best);
        }
        // the loop above stepped diagonals first .. last
        if (out.slots && t == 0) atomicAdd(out.slots, (unsigned long long)(last - first + 1) * W);
#pragma unroll
        for (int q = 0; q < Q; ++q)
          if (TILES && m > 1 && (!store.global || li + q < p.Lp))
            c.store(q, store.base, store.stride, ci + q);
        if (RING && k == nbox - 1 && li < p.Lp)  // the carries at the chunk's last diagonal
          c.store(0, rl.carry_out + (size_t)p.b * C::NS * p.Lp, p.Lp, li);
        if (jj + 1 < tiles) __syncthreads();  // the next visit reuses edge and xbuf
      }
      if constexpr (BAND) {
        for (int d = d0; d <= d1; ++d) box_border.next(gaps, d);
      } else {
        box_border = border;
      }
    }
    cluster.sync();  // the ring writes of this phase are visible to the next
  }

  if (p.mode != GLOBAL && !resume) {
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
      if (RING) {  // the rank's candidate from the chunks before
        const Cand prev = read_candidate(rl.cand_in, p.b, p.B);
        if (beats(prev, pick, local)) pick = prev;
      }
      write_terminal(pick, p.b, out);
    }
    cluster.sync();  // no CTA leaves while rank 0 reads its candidate
  } else if (RING && r == 0 && t == 0) {
    // global: the step at (lx, ly) wrote the terminal where this launch
    // holds it; else the candidate passes on
    const int dt = p.lx + p.ly;
    if (!(dt >= dbase && dt <= dend && p.lx >= gbase && p.lx < gbase + p.Lp))
      write_terminal(read_candidate(rl.cand_in, p.b, p.B), p.b, out);
  }
}

constexpr int WALK_MAX_R = 16;         // CTAs of a cluster: the H100's non-portable size
constexpr int WALK_MAX_T = 32;         // T: diagonals a box
constexpr int WALK_MAX_SMEM = 232448;  // shared memory a CTA may use on the H100

// The launch of walk_kernel: one problem a cluster of R CTAs of m tiles of
// W lanes, boxes of T diagonals; budget: the shared-memory bytes a CTA may
// fill with the carries of m > 1 tiles (past it, or at 0, they go to the
// device-memory scratch carry f32[B, NS, Lp]).
// Checkpointed traceback (snap != nullptr, read by walk_kernel built with
// CKPT): snap, interval I (diagonals a block, a multiple of T), block (-1:
// the forward launch; q: resume block q into out.tb, uint8[I, B, Lp]) and
// cum0 (Snapshots).
struct WalkArgs {
  const int* lx;
  const int* ly;
  float* carry;
  Gaps gaps;
  int mode, traceback, D, B, Lp, W, R, m, T, budget;
  Outs out;
  cudaStream_t stream;
  float* snap;
  int interval, block;
  float cum0;
};

// The shared-memory bytes of the hs source's boxes hbuf[2][T][W]
// (csrc/hs_visits.cuh).
__host__ __device__ constexpr int hs_smem(int W, int T) { return 2 * T * W * 4; }

// The shared-memory layout of a walk at k levels whose score source takes
// src_bytes (Src::smem), Q lanes a thread.
__host__ __device__ inline WalkLayout walk_layout(int k, int src_bytes, int W, int m, int T,
                                                  int budget, int Q = 1) {
  const int kc = k == 2 ? 1 : k;
  return WalkLayout(W, T, m, 6 + 2 * kc, 10 + 4 * kc, src_bytes, budget, Q);
}

// Whether walk_kernel takes this geometry for rows of Lp lanes in tiles of
// W lanes, Q a thread (then one tile a CTA), at most max_w threads, on a
// source of Src::smem(W, T) = src_bytes.
inline bool walk_geometry_ok(int k, int Lp, int W, int max_w, int R, int m, int T,
                             int src_bytes, int Q = 1) {
  return k >= 1 && k <= MAXK && Q >= 1 && W >= 32 * Q && W <= max_w * Q && W % (32 * Q) == 0 &&
         R >= 1 && R <= WALK_MAX_R && m >= 1 && (Q == 1 || m == 1) &&
         (long long)R * m * W >= Lp && T >= 1 &&
         T <= WALK_MAX_T && walk_layout(k, src_bytes, W, m, T, 0, Q).total <= WALK_MAX_SMEM;
}

// The checks and fields of a launch common to every walk; false for
// arguments the kernel does not take.  src_bytes: the source's Src::smem;
// Q lanes a thread.
inline bool walk_args(WalkArgs* a, int src_bytes, int max_w, int budget, const int* lx,
                      const int* ly, const float* gaps_host, int k, int mode, int traceback,
                      int D, int B, int Lp, int W, int R, int m, int T, float* carry,
                      const Outs& out, void* stream, int Q = 1) {
  if (mode < 0 || mode > 2 || B < 1 || Lp < 2 || D < Lp + 1 ||
      (long long)B * R > 0x7fffffffLL ||
      !walk_geometry_ok(k, Lp, W, max_w, R, m, T, src_bytes, Q))
    return false;
  if (m > 1 && walk_layout(k, src_bytes, W, m, T, budget, Q).carry < 0 && carry == nullptr)
    return false;  // the carries need the device-memory scratch
  for (int l = 0; l < k; ++l) a->gaps.g[l] = gaps_host[l];
  a->lx = lx;
  a->ly = ly;
  a->carry = carry;
  a->mode = mode;
  a->traceback = traceback;
  a->D = D;
  a->B = B;
  a->Lp = Lp;
  a->W = W;
  a->R = R;
  a->m = m;
  a->T = T;
  a->budget = budget;
  a->out = out;
  a->stream = (cudaStream_t)stream;
  a->snap = nullptr;
  a->block = -1;
  return true;
}

// The checkpoint fields of a launch (snap == nullptr: none); false for
// arguments the kernel does not take.  The forward launch writes no
// traceback bytes; a resume launch writes block `block`'s into out.tb.
inline bool walk_snapshots(WalkArgs* a, float* snap, int interval, int block, float cum0) {
  if (snap == nullptr) return true;
  if (interval < a->T || interval % a->T != 0 || block < -1 ||
      (long long)block * interval + 2 > a->D - 1)
    return false;
  a->snap = snap;
  a->interval = interval;
  a->block = block;
  a->cum0 = cum0;
  a->traceback = block >= 0;
  return true;
}

// The visits of problem b on Src: src.visits, or with Q > 1 lanes a thread
// src.visits<Q> (the hs source's alone).
template <int Q, class Src>
__device__ __forceinline__ auto source_visits(const Src& src, const WalkArgs& a, int b, int dend,
                                              float* buf) {
  if constexpr (Q == 1) return src.visits(a, b, dend, buf);
  else return src.template visits<Q>(a, b, dend, buf);
}

// One problem a cluster, its scores from Src: Src::smem(W, T) bytes of
// shared memory at L.src for the source, src.takes(b) whether this launch
// runs problem b (else every CTA of its cluster leaves at once),
// src.visits(a, b, dend, at) the visit functor of problem b.  CKPT (never
// with BAND) builds the checkpointed launches in, RING (with neither) the
// ring's launch (src.ring, a RingLaunch; a.Lp the rank's lanes, a.out.tb
// its uint8[rows, B, Lp] bytes); without them none of their code is there,
// so the ordinary launches run the walk as it was.  Q: lanes a thread (a.W /
// Q threads a CTA); Q > 1 takes a source with src.visits<Q>.
template <class Src, int K, bool BAND, bool CKPT, bool RING = false, int Q = 1>
__device__ __forceinline__ void walk_problem(const WalkArgs& a, const Src& src) {
  static_assert(!(BAND && CKPT), "the band and the checkpoints exclude each other");
  static_assert(!(RING && (BAND || CKPT)), "the ring's launch takes neither");
  using C = Carries<K, Q>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / a.R;
  if (!src.takes(b)) return;  // uniform over the cluster
  cg::cluster_group cluster = cg::this_cluster();
  const WalkLayout L(a.W, a.T, a.m, C::NX, C::NS, Src::smem(a.W, a.T), a.budget, Q);
  const int lx = a.lx[b], ly = a.ly[b], Lp = a.Lp;
  Problem p = {b, lx, ly, a.mode, a.traceback, a.B, Lp};
  Outs out = a.out;
  // Scores mode stops at the last diagonal that can hold a terminal and
  // skips lanes past lx; traceback mode fills every byte of tb.
  int dend = a.traceback ? a.D - 1 : min(a.D - 1, lx + ly);
  int lane_end = a.traceback ? Lp - 1 : min(Lp - 1, lx);
  Snapshots ck;
  if constexpr (CKPT) {
    if (a.snap) {  // the checkpointed launches walk what the traceback launch walks
      ck = Snapshots{a.snap, a.interval / a.T, a.block, a.cum0};
      dend = a.D - 1;
      lane_end = Lp - 1;
      if (a.block >= 0) {  // a resume launch: its block; no terminal is at lx = ly = -1
        p.lx = p.ly = -1;
        // the step writes diagonal d at row d - 2 of out.tb; the block
        // buffer's row r is diagonal 2 + block I + r, so its base moves
        // back by block I rows (every row written lies in the buffer)
        out.tb -= (size_t)a.block * a.interval * a.B * Lp;
        dend = min(dend, 1 + (a.block + 1) * a.interval);
      }
    }
  }
  RingLaunch rl;
  if constexpr (RING) {  // the chunk, every lane of the rank, global lanes
    rl = src.ring;
    dend = rl.d1;
    lane_end = Lp - 1;
    float* cand = rl.cand_out;
    out.score = cand;
    out.length = cand + a.B;
    out.ti = reinterpret_cast<int*>(cand + 2 * a.B);
    out.tj = reinterpret_cast<int*>(cand + 3 * a.B);
    out.tcode = reinterpret_cast<int*>(cand + 4 * a.B);
    // the step writes global lane i of diagonal d at row d - 2 (stride Lp):
    // the buffer's row d - 2 - tb_row0, storage lane i - base
    if (a.traceback) out.tb -= (size_t)rl.tb_row0 * a.B * Lp + rl.base;
  }
  const CarryStore store =
      L.carry >= 0
          ? CarryStore{reinterpret_cast<float*>(smem + L.carry), a.m * a.W, false}
          : CarryStore{a.carry + (size_t)b * C::NS * Lp, Lp, true};
  const WalkSmem sm = {reinterpret_cast<float*>(smem + L.xbuf),
                       reinterpret_cast<float*>(smem + L.ring),
                       reinterpret_cast<float*>(smem + L.edge),
                       reinterpret_cast<Cand*>(smem + L.red)};
  auto visits = source_visits<Q>(src, a, b, dend, reinterpret_cast<float*>(smem + L.src));
  cluster_walk<K, true, BAND, CKPT, RING, Q>(cluster, sm, WalkShape{a.R, a.m, a.W, a.T}, p,
                                             a.gaps, out, dend, lane_end, store, visits, ck, rl);
}

// walk_problem as a kernel, built for CTAs of at most MAXW threads, at
// least MINB of them an SM (the launch bound), Q lanes a thread.
template <class Src, int K, bool BAND, int MAXW, int MINB, bool CKPT = false, bool RING = false,
          int Q = 1>
__global__ void __launch_bounds__(MAXW, MINB) walk_kernel(WalkArgs a, Src src) {
  walk_problem<Src, K, BAND, CKPT, RING, Q>(a, src);
}

// The same for a source that its functor reads in place from the kernel's
// parameters (__grid_constant__: src's address is in parameter space, no
// copy; the track tables of csrc/tiled_composite.cu and csrc/rows_box.cuh).
template <class Src, int K, bool BAND, int MAXW, int MINB, bool CKPT = false>
__global__ void __launch_bounds__(MAXW, MINB)
    walk_kernel_params(WalkArgs a, const __grid_constant__ Src src) {
  walk_problem<Src, K, BAND, CKPT>(a, src);
}

// Launches walk_kernel, or walk_kernel_params with PARAMS (or, with
// clusters != nullptr, asks how many clusters of this shape fit on the
// card at once: cudaOccupancyMaxActiveClusters); Q lanes a thread.
template <class Src, int K, bool BAND, int MAXW, int MINB, bool CKPT = false,
          bool PARAMS = false, bool RING = false, int Q = 1>
int launch_walk(const WalkArgs& a, const Src& src, int* clusters) {
  static_assert(Q == 1 || !PARAMS, "walk_kernel_params walks one lane a thread");
  const int smem = walk_layout(K, Src::smem(a.W, a.T), a.W, a.m, a.T, a.budget, Q).total;
  auto kern = [] {
    if constexpr (PARAMS) return walk_kernel_params<Src, K, BAND, MAXW, MINB, CKPT>;
    else return walk_kernel<Src, K, BAND, MAXW, MINB, CKPT, RING, Q>;
  }();
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * a.R);
  cfg.blockDim = dim3(a.W / Q);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.R;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters) return (int)cudaOccupancyMaxActiveClusters(clusters, (void*)kern, &cfg);
  e = cudaLaunchKernelEx(&cfg, kern, a, src);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// f(std::integral_constant<int, k>()) for the level count 1 <= k <= TOP
// (a larger k takes TOP: the caller has checked it).
template <int K = 1, int TOP = MAXK, class F>
int with_levels(int k, const F& f) {
  if constexpr (K < TOP) {
    if (k != K) return with_levels<K + 1, TOP>(k, f);
  }
  return f(std::integral_constant<int, K>());
}

}  // namespace praline_dp
