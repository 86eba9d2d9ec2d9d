// The ring's superstep on the lane-tiled DP (K6, csrc/tiled_dp.cu) for
// Hopper (sm_90a): one rank's block of lanes of one alignment too big for
// one device, walked one chunk of diagonals a launch (dist/ring.py, the
// counterpart of praline_tpu/dist/ring.py and of the superstepped ring of
// praline_tpu/kernels/scan.py:668-902, whose tiled Pallas form is
// praline_tpu/kernels/pallas_dp_tiled.py:448 wavefront_dp_tiled).
//
// The same walk_kernel, built with the ring flag (RING; csrc/cluster_walk.cuh,
// RingLaunch) on the rows source; the ordinary launches of csrc/tiled_dp.cu
// and the checkpointed ones of csrc/tiled_ckpt.cu are built without it, so
// they run as before.  A launch walks diagonals d0 .. d1 on the rank's Lpn
// lanes (global lanes base ..): every lane starts from the rank's stored
// carries and stores them after the chunk's last diagonal; the first lane's
// left neighbour before step s comes from the left rank (heads, nullptr on
// the rank of lane 0), the last lane hands its own to the right rank
// (tails); the terminal candidate lives in the rank's f32[5, B] buffer
// across launches; with traceback the chunk's bytes go to tb[d - 2 -
// tb_row0, b, lane] (the rank's uint8[D - 2, B, Lpn], or one block of the
// checkpointed traceback).  Contract: kernels/scan.py::ring_superstep_plain,
// bit for bit.
//
// The scores are the rows source's "scalar" tier (csrc/fused_rows.cuh):
// the prep kernel writes T = Cx @ S for the rank's lanes (lane-indexed,
// zero rows at lane 0 and past Lx, so those lanes score +0 as the JAX
// package's padded layout does) and a copy of Cy, once a rank
// (praline_tiled_prep on Lpn rows); each score is computed in place at
// global lane i by the rows functor at i - base + 1.  The ring keeps this
// tier: a box of the tensor-core tier (csrc/rows_box.cuh) filled every
// visit measured slower at every T a superstep takes (PERF.md, Findings).
//
// What bounds it on the H100: a launch is one chunk of K diagonals, so the
// cluster's fill is paid every superstep: (K / T + R - 1) m T steps in
// sequence for K m W lanes of work, of which R - 1 phases of m T steps fill
// the cluster; a smaller box (T) cuts the fill for more cluster barriers.
// The exchange between launches is the host's (dist/ring.py).

#include "cluster_walk.cuh"
#include "hs_visits.cuh"
#include "tiled_walk.cuh"

namespace {

// The rows functor at the rank's lanes: global lane i is lane i - base of
// the lane-indexed T rows, which FusedRows reads as lane i - base + 1.
struct RingScores {
  FusedRows rows;
  int shift;  // 1 - base
  __device__ __forceinline__ float operator()(int d, int i) const {
    return rows(d + shift, i + shift);
  }
};

struct RingVisits {
  RingScores scores;
  __device__ __forceinline__ RingScores prepare(int, int, int, int) const { return scores; }
};

// walk_kernel's ring source: the rank's prep rows and the launch's ring
// fields (walk_problem reads ring where RING is on).
struct RingSource {
  const float* t;    // [B, Lpn, AP], lane-indexed
  const float* cyp;  // [B, Ly, AP]
  const float* ivx;  // [B, Lpn], lane-indexed
  const float* ivy;  // [B, Ly]
  int Lpn, Ly, AP;
  RingLaunch ring;
  __host__ __device__ static constexpr int smem(int, int) { return 0; }
  __device__ __forceinline__ bool takes(int) const { return true; }
  __device__ __forceinline__ RingVisits visits(const WalkArgs&, int b, int, float*) const {
    return RingVisits{RingScores{fused_rows(t, cyp, ivx, ivy, b, Lpn, Ly, AP), 1 - ring.base}};
  }
};

}  // namespace

// How many clusters of R CTAs of W threads and m tiles (k levels, boxes of
// T) the card holds at once for the ring's launch, into *clusters.
extern "C" int praline_tiled_ring_clusters(int k, int W, int R, int m, int T, int* clusters) {
  if (!walk_geometry_ok(k, 2, W, MAX_W, R, m, T, 0)) return (int)cudaErrorInvalidValue;
  WalkArgs a = {};
  a.B = 1;
  a.W = W;
  a.R = R;
  a.m = m;
  a.T = T;
  a.budget = WALK_MAX_SMEM;
  return dispatch<false, false, true>(k, a, RingSource{}, clusters);
}

// One launch: ops the scratch of praline_tiled_prep on tier 1 for the
// rank's Lpn lane-indexed rows (cx lane-indexed, zero rows at lane 0 and
// past Lx: T rows f32[B, Lpn, AP] then Cy rows f32[B, Ly, AP]); ivx
// f32[B, Lpn] (lane-indexed, 1 at lane 0 and past Lx), ivy f32[B, Ly]; lx,
// ly int32[B] with 1 <= lx <= Lx, 1 <= ly <= Ly; gaps: k host floats; the
// rank's lanes base .. base + Lpn - 1 of the problem's Lx + 1 (or its
// padding); the chunk d0 .. d1 (2 <= d0 <= d1 <= Lx + Ly) with cum0 the
// border run cost of diagonal d0 - 1; geometry W, R, m, T as
// praline_tiled_dp_rows's for Lpn lanes; carry_in, carry_out f32[B, 10 + 4
// k', Lpn] (may be one tensor) and scratch (as praline_tiled_dp_rows's
// carry, for Lpn lanes); heads (nullptr iff base = 0) and tails f32[d1 - d0
// + 1, NX, B]; cand_in, cand_out f32[5, B] (may be one tensor); with
// traceback tb uint8[tb_rows, B, Lpn] whose row r is diagonal 2 + tb_row0 +
// r.  Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for arguments the kernel does not take.
extern "C" int praline_tiled_ring(const void* ops, const float* ivx, const float* ivy,
                                  const int* lx, const int* ly, const float* gaps_host, int k,
                                  int mode, int traceback, int B, int Lx, int Ly, int AP,
                                  int Lpn, int base, int d0, int d1, float cum0, int W, int R,
                                  int m, int T, const float* carry_in, float* carry_out,
                                  float* scratch, const float* heads, float* tails,
                                  const float* cand_in, float* cand_out, uint8_t* tb,
                                  int tb_rows, int tb_row0, void* stream) {
  const int D = Lx + Ly + 1;
  WalkArgs a = {};
  if (!ops || AP < 4 || AP % 4 != 0 || Lx < 1 || Ly < 1 || base < 0 || d0 < 2 || d1 < d0 ||
      d1 > D - 1 || (heads == nullptr) != (base == 0) || !carry_in || !carry_out || !tails ||
      !cand_in || !cand_out ||
      (traceback && (!tb || d0 - 2 - tb_row0 < 0 || d1 - 2 - tb_row0 >= tb_rows)) ||
      !walk_args(&a, 0, MAX_W, WALK_MAX_SMEM, lx, ly, gaps_host, k, mode, traceback, D, B, Lpn,
                 W, R, m, T, scratch, Outs{nullptr, nullptr, nullptr, nullptr, nullptr, tb},
                 stream))
    return (int)cudaErrorInvalidValue;
  RingLaunch rl;
  rl.base = base;
  rl.d0 = d0;
  rl.d1 = d1;
  rl.cum0 = cum0;
  rl.carry_in = carry_in;
  rl.carry_out = carry_out;
  rl.heads = heads;
  rl.tails = tails;
  rl.cand_in = cand_in;
  rl.cand_out = cand_out;
  rl.tb_row0 = tb_row0;
  const float* t = static_cast<const float*>(ops);
  return dispatch<false, false, true>(
      k, a, RingSource{t, t + (size_t)B * Lpn * AP, ivx, ivy, Lpn, Ly, AP, rl}, nullptr);
}
