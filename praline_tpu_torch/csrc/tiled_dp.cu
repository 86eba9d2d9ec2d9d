// Lane-tiled wavefront DP for Hopper (sm_90a): rows of any length.
//
// Replaces the TPU kernel praline_tpu/kernels/pallas_dp_tiled.py:448
// wavefront_dp_tiled (K6, register-tiled, k <= 2), and serves on the card
// what the JAX package's streamed scan praline_tpu/kernels/scan.py:106 takes
// for rows past the fused kernel's 4096 lanes: every mode, gap series of 1
// to 15 levels, any Lx and Ly.  The contract is kernels/scan.py::
// wavefront_dp (the plain version), bit for bit: score, length, ti, tj,
// tcode and, with traceback, the bytes tb uint8[D - 2, B, Lp] that
// csrc/replay.cu walks.  The recurrence is csrc/wavefront.cuh's, step for
// step; this file only orders the steps.
//
// Design.  One block per problem; a tile is blockDim.x = W lanes at one
// lane a thread, so the registers hold one tile's carries whatever the row
// length.  For each block of T diagonals the block visits the tiles left to
// right; a visit loads the tile's carries from a per-problem scratch in
// device memory (lane-major rows, coalesced, L2-resident; the wrapper
// allocates it), runs T steps and stores them back.  The left neighbour of
// a tile's first lane at step t is the previous tile's last lane before its
// own step t: that tile saved those NX values into the shared-memory edge
// buffer E[t] earlier in the same diagonal block.  Thread 0 reads E[t]
// before the step's barrier and thread W - 1 writes its own after it; a
// barrier closes every visit.  Each thread's running terminal candidate
// stays in registers across tiles (candidates are unique cells, so the
// order does not matter); borders use the global lane index.  Scores mode
// skips the tiles past lx and stops at diagonal lx + ly.
//
// Two score sources through the functor template: HsRows reads hs
// f32[D, B, Lp] from csrc/scores.cu, K6's own contract; FusedRows
// (csrc/fused_rows.cuh, with its prep kernel) computes each score in place
// for rows whose hs would pass the batch aligner's budget (kernels/batch.py).
//
// What bounds it on the H100: the chain of diagonals, now n_tiles times as
// long: a problem runs D x n_tiles steps in sequence, each about a hundred
// dependent instructions of one W-lane tile plus one block barrier, and a
// round trip of its carries through L2 (10 + 4 k' values a lane, k' = 1 at
// k = 2, else k) once per T diagonals.  T amortises that round trip (at
// T = 32 it is one load and one store per lane per 32 steps); a wider tile
// buys more lanes a step for the same chain, up to 1024 threads (32 warps
// dispatch a step in about the time the chain takes), and fewer tiles.
// Throughput, as for the whole-row kernels, comes from many problems in
// flight.  Device memory traffic: hs once (or the T and Cy rows), tb once,
// the carry scratch once per T.

#include "fused_rows.cuh"
#include "wavefront.cuh"

namespace {

using namespace praline_dp;

constexpr int MAX_STEPS = 32;  // T: the edge buffer's depth

struct TiledArgs {
  const float* hs;   // hs source: f32[D, B, Lp]
  const float* t;    // rows source: scratch of csrc/fused_rows.cuh
  const float* cyp;
  const float* ivx;
  const float* ivy;
  const int* lx;
  const int* ly;
  float* carry;      // f32[B, NS, Lp]
  Gaps gaps;
  int mode, traceback, D, B, Lp, Lx, Ly, AP, W, T;
  Outs out;
  cudaStream_t stream;
};

template <int K, class Scores>
__device__ __forceinline__ void tiled_block(const Scores& score, const TiledArgs& a, int b) {
  using C = Carries<K, 1>;
  constexpr int NX = C::NX;
  __shared__ float xbuf[2][MAXW][NX];
  __shared__ float edge[MAX_STEPS][NX];
  __shared__ Cand red[MAXW];

  const int t = threadIdx.x, W = blockDim.x;
  const int warp = t >> 5, wl = t & 31;
  const int lx = a.lx[b], ly = a.ly[b], Lp = a.Lp;
  const Problem p = {b, lx, ly, a.mode, a.traceback, a.B, Lp};
  float* carry = a.carry + (size_t)b * C::NS * Lp;

  const int dend = a.traceback ? a.D - 1 : min(a.D - 1, lx + ly);
  const int lane_end = a.traceback ? Lp - 1 : min(Lp - 1, lx);
  const int tiles = lane_end / W + 1;
  Cand best = first_candidate<K>(a.mode, t == 0, lx, ly);

  Border<K> block_border(a.gaps);  // the border run at diagonal d0 - 1
  for (int d0 = 2; d0 <= dend; d0 += a.T) {
    const int d1 = min(d0 + a.T - 1, dend);
    Border<K> border = block_border;
    for (int j = 0; j < tiles; ++j) {
      const int i = j * W + t;
      border = block_border;
      C c;
      if (d0 == 2 || i >= Lp) c.init(0, i, a.mode, a.gaps.g[0]);
      else c.load(0, carry, Lp, i);
      for (int d = d0; d <= d1; ++d) {
        const int s = d - d0, buf = d & 1;
        float sh[NX];
        c.shfl_in(0, sh);
        if (wl == 31) c.export_x(0, xbuf[buf][warp]);
        if (t == 0 && j > 0) {
#pragma unroll
          for (int v = 0; v < NX; ++v) sh[v] = edge[s][v];
        }
        __syncthreads();
        if (t == W - 1) c.export_x(0, edge[s]);
        if (wl == 0 && warp > 0) {
#pragma unroll
          for (int v = 0; v < NX; ++v) sh[v] = xbuf[buf][warp - 1][v];
        }
        if (i == 0) C::border_x(sh);
        border.next(a.gaps, d);
        if (i <= lane_end) c.step(0, i, d, sh, border.cum, score, a.gaps, p, a.out, best);
      }
      if (i < Lp) c.store(0, carry, Lp, i);
      __syncthreads();
    }
    block_border = border;
  }

  if (a.mode == GLOBAL) return;
  reduce_terminal(best, a.mode, b, a.out, red);
}

template <int K, int Q>
__global__ void __launch_bounds__(MAXT) tiled_hs_kernel(TiledArgs a) {
  const int b = blockIdx.x;
  tiled_block<K>(HsRows{a.hs, a.B, a.Lp, b}, a, b);
}

template <int K, int Q>
__global__ void __launch_bounds__(MAXT) tiled_rows_kernel(TiledArgs a) {
  const int b = blockIdx.x;
  tiled_block<K>(fused_rows(a.t, a.cyp, a.ivx, a.ivy, b, a.Lx, a.Ly, a.AP), a, b);
}

struct HsKernel {
  using Args = TiledArgs;
  static constexpr int MAXQ = 1;
  template <int K, int Q>
  static int launch(const Args& a) {
    tiled_hs_kernel<K, Q><<<a.B, a.W, 0, a.stream>>>(a);
    return (int)cudaGetLastError();
  }
};

struct RowsKernel {
  using Args = TiledArgs;
  static constexpr int MAXQ = 1;
  template <int K, int Q>
  static int launch(const Args& a) {
    tiled_rows_kernel<K, Q><<<a.B, a.W, 0, a.stream>>>(a);
    return (int)cudaGetLastError();
  }
};

// Common checks and fields of both entry points.
bool fill_args(TiledArgs* a, const int* lx, const int* ly, const float* gaps_host, int k,
               int mode, int traceback, int B, int Lp, int tile, int steps, float* carry,
               float* score, float* length, int* ti, int* tj, int* tcode, uint8_t* tb,
               void* stream) {
  if (k < 1 || k > MAXK || mode < 0 || mode > 2 || B < 1 || Lp < 2 || tile < 32 ||
      tile > MAXT || tile % 32 != 0 || steps < 1 || steps > MAX_STEPS)
    return false;
  for (int l = 0; l < k; ++l) a->gaps.g[l] = gaps_host[l];
  a->lx = lx;
  a->ly = ly;
  a->carry = carry;
  a->mode = mode;
  a->traceback = traceback;
  a->B = B;
  a->Lp = Lp;
  a->W = tile;
  a->T = steps;
  a->out = {score, length, ti, tj, tcode, tb};
  a->stream = (cudaStream_t)stream;
  return true;
}

}  // namespace

// The hs source.  hs f32[D, B, Lp]; lx, ly int32[B] with 1 <= lx < Lp,
// 1 <= ly <= D - Lp; gaps: k host floats; tile: lanes a tile (= threads a
// block), a multiple of 32 up to 1024; steps: diagonals a visit, 1 to 32.
// Scratch carry f32[B, 10 + 4 k', Lp] (k' = 1 at k = 2, else k).  Outputs
// f32/int32 [B]; tb uint8[D - 2, B, Lp] (ignored unless traceback).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int praline_tiled_dp_hs(const float* hs, const int* lx, const int* ly,
                                   const float* gaps_host, int k, int mode, int traceback,
                                   int D, int B, int Lp, int tile, int steps, float* carry,
                                   float* score, float* length, int* ti, int* tj,
                                   int* tcode, uint8_t* tb, void* stream) {
  TiledArgs a = {};
  if (D < Lp + 1 ||
      !fill_args(&a, lx, ly, gaps_host, k, mode, traceback, B, Lp, tile, steps, carry,
                 score, length, ti, tj, tcode, tb, stream))
    return (int)cudaErrorInvalidValue;
  a.hs = hs;
  a.D = D;
  return launch_levels<HsKernel>(k, 1, a);
}

// The in-place source.  cx f32[B, Lx, A], inv_x f32[B, Lx], cy f32[B, Ly,
// A], inv_y f32[B, Ly], s f32[A, A], lx/ly int32[B] with 1 <= lx <= Lx,
// 1 <= ly <= Ly.  Scratch t f32[B, Lx, AP] and cyp f32[B, Ly, AP] (AP = A
// rounded up to a multiple of 4) for the prep kernel, and carry as above
// with Lp = Lx + 1.  Outputs as praline_tiled_dp_hs with D = Lx + Ly + 1.
extern "C" int praline_tiled_dp_rows(const float* cx, const float* inv_x, const float* cy,
                                     const float* inv_y, const float* s, const int* lx,
                                     const int* ly, const float* gaps_host, int k, int mode,
                                     int traceback, int B, int Lx, int Ly, int A, int tile,
                                     int steps, float* t, float* cyp, float* carry,
                                     float* score, float* length, int* ti, int* tj,
                                     int* tcode, uint8_t* tb, void* stream) {
  TiledArgs a = {};
  if (Lx < 1 || Ly < 1 ||
      !fill_args(&a, lx, ly, gaps_host, k, mode, traceback, B, Lx + 1, tile, steps, carry,
                 score, length, ti, tj, tcode, tb, stream))
    return (int)cudaErrorInvalidValue;
  const int rc = launch_prep(cx, cy, s, t, cyp, B, Lx, Ly, A, a.stream);
  if (rc != 0) return rc;
  a.t = t;
  a.cyp = cyp;
  a.ivx = inv_x;
  a.ivy = inv_y;
  a.D = Lx + Ly + 1;
  a.Lx = Lx;
  a.Ly = Ly;
  a.AP = padded_alphabet(A);
  return launch_levels<RowsKernel>(k, 1, a);
}
