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
//
// The block walk (praline_replay_block) is the backward pass of the
// checkpointed traceback, the counterpart of the walk inside
// praline_tpu/kernels/scan.py:979-1004 (an XLA scan): the same machine over
// one block of re-derived bytes (csrc/tiled_ckpt.cu's resume launch), its
// state carried between blocks in device memory and each move appended at
// the tape's count, so the blocks from the last to the first build the
// tape replay_kernel builds over the whole traceback, with no compaction.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PTR_NONE = 31;
constexpr int THREADS = 128;

// One move of the walk from cell (i, j) in (st, lvl), whose direction byte
// is `bits`: updates the state and returns the move code (0 where the walk
// ends here without emitting the cell).
__device__ __forceinline__ int walk_move(int bits, int k, int local, int& i, int& j, int& st,
                                         int& lvl, bool& done) {
  const int mptr = bits & 31;
  const bool stay_x = (bits >> 5) & 1, stay_y = (bits >> 6) & 1;
  if (st == 0) {
    const bool stop = (i == 0 && j == 0) || (local && ((bits >> 7) & 1));
    if (stop) {
      done = true;  // ends without emitting this cell
      return 0;
    }
    --i;
    --j;
    done = mptr == PTR_NONE;  // a local path's first cell
    st = mptr == 0 ? 0 : (mptr <= k ? 1 : 2);
    lvl = mptr <= k ? mptr : mptr - k;
    return 1;
  }
  if (st == 1) {
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
    return 2;
  }
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
  return 3;
}

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
      move = walk_move(tb[((size_t)row * B + b) * Lp + col], k, local, i, j, st, lvl, done);
    }
    mv[s] = (uint8_t)move;
    n += move != 0;
  }
  nmoves[b] = n;
}

// The walk inside block q of a checkpointed traceback: the diagonals 2 + q
// R .. 2 + (q + 1) R - 1, whose bytes are bits uint8[R, B, Lp] (row d - 2 -
// q R), and below diagonal 2 for q = 0.  The state (i, j, st, lvl, done, n)
// comes from state int32[6, B] and goes back there; each move is appended
// at n of the problem's tape.  The walk stops where its diagonal leaves
// the block: at most R + 2 steps (R diagonals; d = 1 and the stop at the
// origin in block 0).
__global__ void replay_block_kernel(const uint8_t* __restrict__ bits,
                                    int* __restrict__ state, int R, int B, int Lp,
                                    int block, int k, int local, int steps,
                                    uint8_t* __restrict__ moves) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int i = state[b], j = state[B + b], st = state[2 * B + b], lvl = state[3 * B + b];
  bool done = state[4 * B + b] != 0;
  int n = state[5 * B + b];
  const int base = block * R;
  uint8_t* mv = moves + (size_t)b * steps;
  for (int s = 0; s < R + 2 && !done; ++s) {
    const int d = i + j;
    if (d - 2 < base && block > 0) break;  // the blocks below walk on
    const int row = min(max(d - 2 - base, 0), R - 1);
    const int col = min(max(i, 0), Lp - 1);
    const int move =
        walk_move(bits[((size_t)row * B + b) * Lp + col], k, local, i, j, st, lvl, done);
    if (move) {
      if (n < steps) mv[n] = (uint8_t)move;
      ++n;
    }
  }
  state[b] = i;
  state[B + b] = j;
  state[2 * B + b] = st;
  state[3 * B + b] = lvl;
  state[4 * B + b] = done;
  state[5 * B + b] = n;
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
  replay_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                  (cudaStream_t)stream>>>(tb, ti, tj, tcode, T, B, Lp, k,
                                          local, steps, moves, nmoves);
  return (int)cudaGetLastError();
}

// One block of a checkpointed traceback walk (replay_block_kernel): bits
// uint8[R, B, Lp], state int32[6, B] in and out, moves uint8[B, steps]
// (only the bytes at the moves' positions written).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue.
extern "C" int praline_replay_block(const uint8_t* bits, int* state, int R, int B, int Lp,
                                    int block, int k, int local, int steps, uint8_t* moves,
                                    void* stream) {
  if (R < 1 || B < 1 || Lp < 1 || block < 0 || k < 1 || k > 15 || steps < 0)
    return (int)cudaErrorInvalidValue;
  replay_block_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      bits, state, R, B, Lp, block, k, local, steps, moves);
  return (int)cudaGetLastError();
}
