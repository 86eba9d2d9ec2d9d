// The checkpointed traceback's launches (csrc/tiled_ckpt.cu) on the rows
// source's "mma" tier (csrc/rows_box.cuh) for Hopper (sm_90a): the forward
// launch and the resume launches of walk_kernel_params built with CKPT, each
// visit's box of scores on the int8 tensor cores, for the operands
// kernels/fused_scores.py::tensor_core_exact admits.  The counterpart of
// praline_tpu/kernels/scan.py:173 wavefront_dp_checkpointed, as
// csrc/tiled_ckpt.cu; the same bits as its "scalar" tier.  The operands
// (praline_tiled_prep, csrc/tiled_mma.cu) are made once a chunk and read by
// the forward launch and every resume launch.  What bounds it: as
// csrc/tiled_ckpt.cu.  Its own translation unit, so that its kernels build
// beside the others.

#include "hs_visits.cuh"
#include "tiled_walk.cuh"
#include "rows_box.cuh"

// praline_tiled_ckpt_rows (csrc/tiled_ckpt.cu) on the "mma" tier: ops the
// scratch of praline_tiled_prep on tier 0 and pwide its problem flags.
extern "C" int praline_tiled_ckpt_mma_rows(const void* ops, const unsigned char* pwide,
                                           const float* inv_x, const float* inv_y,
                                           const int* lx, const int* ly, const float* gaps_host,
                                           int k, int mode, int traceback, int B, int Lx, int Ly,
                                           int /*AP*/, int W, int R, int m, int T, float* carry,
                                           float* score, float* length, int* ti, int* tj,
                                           int* tcode, uint8_t* tb, float* snap, int interval,
                                           int block, float cum0, void* stream) {
  if (snap == nullptr) return (int)cudaErrorInvalidValue;
  return rows_launch<true>(ops, pwide, inv_x, inv_y, lx, ly, gaps_host, k, mode, traceback, B,
                           Lx, Ly, W, R, m, T, carry, Outs{score, length, ti, tj, tcode, tb}, snap,
                           interval, block, cum0, stream);
}

// praline_tiled_mma_clusters for the kernels built here.
extern "C" int praline_tiled_ckpt_mma_clusters(int k, int W, int R, int m, int T,
                                               int* clusters) {
  return box_clusters<true, 1>(k, W, R, m, T, clusters);
}
