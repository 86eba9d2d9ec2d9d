// Lane-tiled wavefront DP for Hopper (sm_90a): rows of any length on one
// thread-block cluster a problem.
//
// Replaces the TPU kernel praline_tpu/kernels/pallas_dp_tiled.py:448
// wavefront_dp_tiled (K6, register-tiled, k <= 2), and serves on the card
// what the JAX package's streamed scan praline_tpu/kernels/scan.py:106 takes
// for rows past the fused kernel's 4096 lanes: every mode, gap series of 1
// to 15 levels, any Lx and Ly.  The contract is kernels/scan.py::
// wavefront_dp (the plain version), bit for bit: score, length, ti, tj,
// tcode and, with traceback, the bytes tb uint8[D - 2, B, Lp] that
// csrc/replay.cu walks.  The recurrence is csrc/wavefront.cuh's, step for
// step; the order of the steps is csrc/cluster_walk.cuh's, shared with the
// fused kernel (csrc/fused_dp.cu).
//
// Design.  A problem runs on a cluster of R CTAs (up to 16: past the
// portable 8 with cudaFuncAttributeNonPortableClusterSizeAllowed), each
// owning m consecutive tiles of W lanes, Q lanes a thread of at most 512,
// so R m W >= Lp covers a row of any length
// (kernels/tiled_dp.py::tiled_geometry).  In phase p rank r runs box p - r
// (T diagonals) over its m tiles, left to right; the tile edge goes from
// tile to tile through shared memory inside a CTA and from CTA to CTA
// through a double-buffered ring in distributed shared memory, one cluster
// barrier a phase: (boxes + R - 1) m T steps in sequence.  With m = 1 a
// tile's carries stay in registers; with m > 1 each visit loads and stores
// them (14 values a lane at k <= 2, 22 at k = 3) in shared memory where
// they fit beside the rest, else in a device-memory scratch f32[B, NS, Lp]
// that stays in L2.  On the hs source each thread copies its own lanes'
// next T scores into shared memory by cp.async while the DP steps through
// the current visit (W contiguous floats a diagonal, a double buffer), so a
// step reads its score from shared memory and no step waits on device
// memory.
//
// Two geometries, chosen by the chunk's shape.  One problem (a merge
// join's traceback, a chunk the card holds in one wave) wants latency: Q =
// 1 and up to 16 CTAs of one tile, the fewest steps at the cheapest step.
// A scores chunk over hs of more problems than the card holds clusters of
// that shape at once (dhc1's all-pairs chunks: 21-32 problems of 4224-4736
// lanes, 7 clusters of 15-16 CTAs at once) wants throughput: Q = 2 or 3
// lanes a thread, so a row fits on a few CTAs of one wider tile each and
// the card holds many more clusters; a thread's Q cells of a diagonal are
// independent, so they share the step's latency, its shuffles and its
// barrier.  Those launches are built at k <= 3 (csrc/tiled_walk.cuh).
//
// The kernel is csrc/cluster_walk.cuh's walk_kernel, built for 512
// threads a CTA, on either of two score sources: HsSource reads hs
// f32[D, B, Lp] from csrc/scores*.cu, K6's own contract; RowsSource
// (csrc/fused_rows.cuh, its prep kernel run once a chunk by
// praline_tiled_prep in csrc/tiled_mma.cu) computes each score in place
// for rows whose hs would pass the batch aligner's budget (kernels/batch.py)
// on the "scalar" tier; its "mma" tier, each visit's box of scores on the
// tensor cores, is csrc/tiled_mma.cu.  A third source, the multi-track
// composite in place, is csrc/tiled_composite.cu.
//
// The checkpointed launches of the same kernel are csrc/tiled_ckpt.cu; the
// kernels here are built without their code (csrc/tiled_walk.cuh).
//
// What bounds it on the H100: the chain of dependent diagonals.  A problem
// runs (boxes + R - 1) m T steps, each a few dozen dependent instructions
// of one W-lane tile and a CTA barrier, with one cluster barrier a box; the
// scores of a box are in shared memory before its first step.  More CTAs
// a cluster means fewer tiles a CTA (m), so fewer steps in sequence; but a
// chunk of more problems than the card holds clusters runs in waves, and
// there the Q-lane geometry trades a dearer step (Q cells a thread) for
// fewer waves.
// Device memory carries hs once (or the T and Cy rows), tb once and, where
// the carries do not fit in shared memory, the carry scratch once a box.

#include "cluster_walk.cuh"
#include "hs_visits.cuh"
#include "tiled_walk.cuh"
#include "rows_box.cuh"

// Dynamic shared memory bytes of a CTA of W lanes (Q a thread) and m
// tiles, T diagonals a box, k gap levels, on the source `src`: 1 hs, 0 an
// in-place source's "scalar" tier, 2 its "mma" tier (the wide launch's,
// csrc/rows_box.cuh); -1 for arguments the kernel does not take.
extern "C" int praline_tiled_dp_smem(int W, int T, int m, int k, int src, int Q) {
  if (k < 1 || k > MAXK || m < 1 || Q < 1 || W < 32 * Q || W % Q || T < 1 || src < 0 || src > 2)
    return -1;
  const int bytes = src == 1 ? hs_smem(W, T) : src == 2 ? BoxSource<true, 1>::smem(W, T) : 0;
  return walk_layout(k, bytes, W, m, T, WALK_MAX_SMEM, Q).total;
}

// How many clusters of R CTAs of m tiles of W lanes, Q a thread (k levels,
// source: hs = 1 or rows = 0, T; Q > 1 only on hs at k <= 3) the card holds
// at once, into *clusters; returns the CUDA error of the query.
extern "C" int praline_tiled_dp_clusters(int k, int hs, int W, int R, int m, int T, int Q,
                                         int* clusters) {
  return tiled_clusters<false>(k, hs, W, R, m, T, Q, clusters);
}

// The hs source.  hs f32[D, B, Lp]; lx, ly int32[B] with 1 <= lx < Lp,
// 1 <= ly <= D - Lp; gaps: k host floats; geometry (kernels/tiled_dp.py::
// tiled_geometry): W lanes a tile, Q lanes a thread (1; or 2 or 3 at k <=
// 3 with m = 1), W a multiple of 32 Q up to 512 Q; R CTAs a cluster, 1 to
// 16; m tiles a CTA with R m W >= Lp; T diagonals a box, 1 to 32.  Scratch carry f32[B,
// 10 + 4 k', Lp] (k' = 1 at k = 2, else k) where m > 1 and the carries do
// not fit in shared memory (praline_tiled_dp_smem without them), else
// unused.  Outputs f32/int32 [B]; tb uint8[D - 2, B, Lp] (ignored unless
// traceback).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int praline_tiled_dp_hs(const float* hs, const int* lx, const int* ly,
                                   const float* gaps_host, int k, int mode, int traceback,
                                   int D, int B, int Lp, int W, int R, int m, int T, int Q,
                                   float* carry, float* score, float* length, int* ti, int* tj,
                                   int* tcode, uint8_t* tb, void* stream) {
  return tiled_hs<false>(hs, lx, ly, gaps_host, k, mode, traceback, D, B, Lp, W, R, m, T, Q,
                         carry, Outs{score, length, ti, tj, tcode, tb}, nullptr, 0, -1, 0.0f,
                         stream);
}

// The in-place source on the "scalar" tier.  ops: the scratch of
// praline_tiled_prep on tier 1 (T rows f32[B, Lx, AP] then Cy rows f32[B,
// Ly, AP], AP = A rounded up to a multiple of 4); pwide unused (the "mma"
// tier's entry, praline_tiled_mma_rows, takes the same arguments); inv_x
// f32[B, Lx], inv_y f32[B, Ly]; lx/ly int32[B] with 1 <= lx <= Lx, 1 <= ly
// <= Ly; carry as above with Lp = Lx + 1.  Outputs as praline_tiled_dp_hs
// with D = Lx + Ly + 1.
extern "C" int praline_tiled_dp_rows(const void* ops, const unsigned char* /*pwide*/,
                                     const float* inv_x, const float* inv_y, const int* lx,
                                     const int* ly, const float* gaps_host, int k, int mode,
                                     int traceback, int B, int Lx, int Ly, int AP, int W, int R,
                                     int m, int T, float* carry, float* score, float* length,
                                     int* ti, int* tj, int* tcode, uint8_t* tb, void* stream) {
  return tiled_rows<false>(ops, inv_x, inv_y, lx, ly, gaps_host, k, mode, traceback, B, Lx, Ly,
                           AP, W, R, m, T, carry, Outs{score, length, ti, tj, tcode, tb},
                           nullptr, 0, -1, 0.0f, stream);
}
