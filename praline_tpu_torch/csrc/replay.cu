// Traceback walk over the DP's direction bytes, for Hopper (sm_90a).
//
// Counterpart of praline_tpu/kernels/replay.py::replay_moves, which on the
// TPU is an XLA scan (no Pallas kernel); its plain version is the batched
// torch walk in kernels/replay.py, bit for bit: the same (i, j, state,
// level) machine as praline_tpu/oracle/align.py::_traceback, the same move
// codes (1 diagonal, 2 up, 3 left, 0 after the walk ends) and counts.
//
// Design: one thread per problem walks its path from the terminal cell to
// the origin, reading one byte of tb per move.  What bounds it on the H100
// is the latency of those dependent reads (each address depends on the
// previous byte), about L + gaps of them per problem; many problems walk
// in parallel.  The plain version needs some thirty tensor operations per
// move for the whole batch, each a separate launch, so a merge level's walk
// of a few thousand moves costs a launch-bound second there and one launch
// here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PTR_NONE = 31;

__global__ void replay_kernel(const uint8_t* __restrict__ tb,
                              const int* __restrict__ ti,
                              const int* __restrict__ tj,
                              const int* __restrict__ tcode, int T, int B,
                              int Lp, int k, int local, int steps,
                              uint8_t* __restrict__ moves,
                              int* __restrict__ nmoves) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int i = ti[b], j = tj[b];
  const int tc = tcode[b];
  int st = tc == 0 ? 0 : (tc <= k ? 1 : 2);
  int lvl = tc <= k ? tc : tc - k;
  bool done = false;
  int n = 0;
  uint8_t* mv = moves + (size_t)b * steps;
  for (int s = 0; s < steps; ++s) {
    int move = 0;
    if (!done) {
      const int row = min(max(i + j - 2, 0), T - 1);
      const int col = min(max(i, 0), Lp - 1);
      const int bits = tb[((size_t)row * B + b) * Lp + col];
      const int mptr = bits & 31;
      const bool stay_x = (bits >> 5) & 1, stay_y = (bits >> 6) & 1;
      if (st == 0) {
        const bool stop = (i == 0 && j == 0) || (local && ((bits >> 7) & 1));
        if (stop) {
          done = true;  // ends without emitting this cell
        } else {
          move = 1;
          --i;
          --j;
          done = mptr == PTR_NONE;  // a local path's first cell
          st = mptr == 0 ? 0 : (mptr <= k ? 1 : 2);
          lvl = mptr <= k ? mptr : mptr - k;
        }
      } else if (st == 1) {
        move = 2;
        --i;
        if (j == 0) {  // border run: walk to the origin
          lvl = min(i, k);
          done = i == 0;
        } else {
          if (k == 1) {
            st = stay_x ? 1 : 0;
            lvl = stay_x ? 1 : 0;
          } else {
            st = lvl == 1 ? 0 : 1;
            lvl = lvl == 1 ? 0 : (lvl < k ? lvl - 1 : (stay_x ? k : k - 1));
          }
          done = st == 0 && i == 0 && j == 0;
        }
      } else {
        move = 3;
        --j;
        if (i == 0) {
          lvl = min(j, k);
          done = j == 0;
        } else {
          if (k == 1) {
            st = stay_y ? 2 : 0;
            lvl = stay_y ? 1 : 0;
          } else {
            st = lvl == 1 ? 0 : 2;
            lvl = lvl == 1 ? 0 : (lvl < k ? lvl - 1 : (stay_y ? k : k - 1));
          }
          done = st == 0 && i == 0 && j == 0;
        }
      }
    }
    mv[s] = (uint8_t)move;
    n += move != 0;
  }
  nmoves[b] = n;
}

}  // namespace

// tb uint8[T, B, Lp] (row t = diagonal t + 2); ti, tj, tcode int32[B];
// moves uint8[B, steps] (every byte written); nmoves int32[B].  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue.
extern "C" int praline_replay_moves(const uint8_t* tb, const int* ti,
                                    const int* tj, const int* tcode, int T,
                                    int B, int Lp, int k, int local, int steps,
                                    uint8_t* moves, int* nmoves, void* stream) {
  if (T < 1 || B < 1 || Lp < 1 || k < 1 || k > 15 || steps < 0)
    return (int)cudaErrorInvalidValue;
  constexpr int THREADS = 128;
  replay_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                  (cudaStream_t)stream>>>(tb, ti, tj, tcode, T, B, Lp, k,
                                          local, steps, moves, nmoves);
  return (int)cudaGetLastError();
}
