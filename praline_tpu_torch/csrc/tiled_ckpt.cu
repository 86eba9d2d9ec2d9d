// The checkpointed traceback on the lane-tiled DP (K6, csrc/tiled_dp.cu)
// for Hopper (sm_90a): the counterpart of praline_tpu/kernels/scan.py:173
// wavefront_dp_checkpointed, for tracebacks past the batch aligner's byte
// budget (kernels/batch.py::choose_route's "checkpointed").
//
// The same walk_kernel, built with the checkpoint code in (CKPT;
// csrc/cluster_walk.cuh, Snapshots), on the hs source and the rows source's
// "scalar" tier (its "mma" tier: csrc/tiled_ckpt_mma.cu); the ordinary
// launches of csrc/tiled_dp.cu are built without it, so they run as
// before.  Two launches:
//   - forward (block -1): the traceback launch's terminals and no bytes;
//     where a tile enters a box whose first diagonal is 2 + q interval,
//     each thread stores its lane's carries (10 + 4 k' floats) into
//     snap f32[nblk, B, NS, Lp];
//   - resume (block q): every tile restarts at block q's first box from
//     snapshot q, walks the block's diagonals and writes their bytes into
//     tb uint8[interval, B, Lp], byte for byte the traceback launch's rows
//     2 + q interval ..; no terminal.
// csrc/replay.cu walks each block (praline_replay_block).  Memory: O(D /
// interval + interval) rows of Lp instead of D - 2.  What bounds it: the
// same chain of dependent diagonals, twice, plus R - 1 phases to fill the
// cluster at every resumed block.

#include "hs_visits.cuh"
#include "tiled_walk.cuh"

// praline_tiled_dp_clusters for the kernels built here.
extern "C" int praline_tiled_ckpt_clusters(int k, int hs, int W, int R, int m, int T,
                                           int* clusters) {
  return tiled_clusters<true>(k, hs, W, R, m, T, 1, clusters);
}

// praline_tiled_dp_hs's arguments, then snap, interval (a multiple of T),
// block (-1: the forward launch, traceback ignored; q: resume block q into
// tb uint8[interval, B, Lp], no terminals) and cum0, the border run cost
// of diagonal 1 + block interval (kernels/scan.py::_gap_prefix).
extern "C" int praline_tiled_ckpt_hs(const float* hs, const int* lx, const int* ly,
                                     const float* gaps_host, int k, int mode, int traceback,
                                     int D, int B, int Lp, int W, int R, int m, int T,
                                     float* carry, float* score, float* length, int* ti,
                                     int* tj, int* tcode, uint8_t* tb, float* snap,
                                     int interval, int block, float cum0, void* stream) {
  if (snap == nullptr) return (int)cudaErrorInvalidValue;
  return tiled_hs<true>(hs, lx, ly, gaps_host, k, mode, traceback, D, B, Lp, W, R, m, T, 1,
                        carry, Outs{score, length, ti, tj, tcode, tb}, snap, interval, block,
                        cum0, stream);
}

// praline_tiled_dp_rows's arguments, then the checkpoints as above (the
// operands prepared once a chunk serve the forward and every resume
// launch).
extern "C" int praline_tiled_ckpt_rows(const void* ops, const unsigned char* /*pwide*/,
                                       const float* inv_x, const float* inv_y, const int* lx,
                                       const int* ly, const float* gaps_host, int k, int mode,
                                       int traceback, int B, int Lx, int Ly, int AP, int W, int R,
                                       int m, int T, float* carry, float* score, float* length,
                                       int* ti, int* tj, int* tcode, uint8_t* tb, float* snap,
                                       int interval, int block, float cum0, void* stream) {
  if (snap == nullptr) return (int)cudaErrorInvalidValue;
  return tiled_rows<true>(ops, inv_x, inv_y, lx, ly, gaps_host, k, mode, traceback, B, Lx, Ly,
                          AP, W, R, m, T, carry, Outs{score, length, ti, tj, tcode, tb}, snap,
                          interval, block, cum0, stream);
}
