// Traceback walk over the DP's direction bytes, for Hopper (sm_90a).
//
// Counterpart of praline_tpu/kernels/replay.py::replay_moves, which on the
// TPU is an XLA scan (no Pallas kernel); its plain version is the batched
// torch walk in kernels/replay.py, bit for bit: the same (i, j, state,
// level) machine as praline_tpu/oracle/align.py::_traceback, the same move
// codes (1 diagonal, 2 up, 3 left, 0 after the walk ends) and counts.
//
// The block walk (praline_replay_block) is the backward pass of the
// checkpointed traceback, the counterpart of the walk inside
// praline_tpu/kernels/scan.py:979-1004 (an XLA scan): the same machine over
// one block of re-derived bytes (csrc/tiled_ckpt.cu's resume launch), its
// state carried between blocks in device memory and each move appended at
// the tape's count, so the blocks from the last to the first build the
// tape replay_kernel builds over the whole traceback, with no compaction.
//
// What bounds it on the H100: the chain of moves.  Each move reads the byte
// of its cell, and the cell depends on the byte before, so a walk is a
// chain of dependent reads; problems walk in parallel.  Read straight from
// device memory (rows lie B * Lp bytes apart, so every move is its own
// cache line) a move cost a device-memory round trip: 0.436 ms for the
// 1023 moves of B64 x 1023, 1.37 ms for the 4940 of one problem at long8's
// rung 6271 (the thread-a-problem kernel this one replaced).  One
// dependent shared-memory read costs 29 cycles (praline_replay_read_cycles),
// so the longest tape's chain bound is 0.0150 and 0.0724 ms there; this
// kernel takes 0.150 and 0.430 ms, the block walk 0.033 ms a block of 640
// diagonals (chain bound 0.0047; python3 chip_smoke.py walk-times, NVIDIA
// H100 80GB HBM3 at 700 W, PERF.md section 6).  What is left above the
// bound is the move's own instructions, one stream of them a walk (about
// 87 ns a move at B1), and the window's switch (about 0.3 us each).
//
// Design: one warp a problem (a CTA each, so even one problem has a whole
// SM), the bytes of its path staged in shared memory a window at a time.
// Every move lowers the diagonal d = i + j by 1 or 2 and i by 0 or 1, so
// from a cell (i, d) the path's cells at diagonal d - w have their i in
// [i - w, i].  Window k holds the WINDOW diagonals (D - W, D], D = d0 - k W
// (d0 the walk's first cell), as rows of 2 W columns: [i - 2 W + 1, i] for
// the cell where the walk entered window k - 1 (windows 0 and 1: the first
// cell), which covers every cell the walk can reach in window k.  The
// warp's lanes copy window k + 1 into the other of two buffers (cp.async,
// 16-byte chunks aligned in device memory, whatever Lp) while lane 0 walks
// window k from shared memory.  A read outside the window (only an input
// no DP writes, with rows or columns past the clamps) goes to device
// memory, so every byte read is the plain walk's.  Lane 0 stages the moves
// in a ring of shared memory indexed by their address in the tape; after
// each window the warp stores every whole 16-byte chunk of them, and at the
// end the rest and, for the whole walk, the zeros to the tape's end (16
// bytes a lane, the ragged bytes at either end one a lane).  The block walk
// takes the same windows, clipped to its block's rows.
//
// One walker's moves are a single instruction stream, so a move costs what
// its instructions cost, not only its read: walk_move's selects make some
// 120 instructions a move, about 160 ns (walk-times on a version without
// the table, PERF.md section 6).  So where a window holds no cell on the
// matrix's edges (i > 0, j > 0, nothing clamped; every window of a walk but
// the last few), a move is one lookup in a table of walk_move's
// transitions (built by the warp from walk_move while the first windows
// load) and a step of the byte's offset by the state, and the next cell's
// byte is read before the lookup's result is known (the cell a move leads
// to depends on the state alone).  The edges (the origin, border runs, a
// block's lower edge) take walk_move.  WINDOW = 64 by measurement (at 32
// the walk at long8's rung takes 0.473 ms against 0.430; walk-times on a
// copy with WINDOW = 32): 20,608 bytes of shared memory a warp.

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int PTR_NONE = 31;
constexpr int WINDOW = 64;  // diagonals a window
// 16-byte chunks that cover 2 WINDOW columns at any alignment
constexpr int ROW_CHUNKS = (2 * WINDOW + 30) / 16;
constexpr int ROW_BYTES = 16 * ROW_CHUNKS;
constexpr int RING = 2 * WINDOW;  // a window's moves and a partial chunk
static_assert((RING & (RING - 1)) == 0 && RING >= WINDOW + 15, "ring");

// One move of the walk from cell (i, j) in (st, lvl), whose direction byte
// is `bits`: the machine of kernels/replay.py::_walk_step (and of
// praline_tpu/oracle/align.py::_traceback).  The cell the move leads to,
// (ni, nj) = (i - (st != 2), j - (st != 1)), depends on the state alone,
// so the caller computes it (and loads its byte) before this byte is
// known; a stop (the origin, or a local path's bit 7 in M) ends the walk
// there without emitting the cell.  Returns the move code (0 at a stop)
// and sets the next state, level and done; written with selects, no
// branches, so that one move is a short chain of dependent instructions.
__device__ __forceinline__ int walk_move(int bits, int k, int local, int i, int j, int ni,
                                         int nj, int& st, int& lvl, bool& done) {
  const int mptr = bits & 31;
  const bool g = st == 1 ? (bits >> 5) & 1 : (bits >> 6) & 1;  // the gap's stay bit
  const bool stop = st == 0 && ((i == 0 && j == 0) || (local && ((bits >> 7) & 1)));
  // M: the pointer sets state and level; PTR_NONE is a local path's first cell
  const int m_st = mptr == 0 ? 0 : (mptr <= k ? 1 : 2);
  const int m_lvl = mptr <= k ? mptr : mptr - k;
  // a gap (st 1: up, st 2: left): on the border (the other index 0) the run
  // walks to the origin; else it closes or stays by the level or stay bit
  const bool border = (st == 1 ? j : i) == 0;
  const int run = st == 1 ? ni : nj;
  const int k1_st = g ? st : 0, kn_st = lvl == 1 ? 0 : st;
  const int kn_lvl = lvl == 1 ? 0 : (lvl < k ? lvl - 1 : (g ? k : k - 1));
  const int g_st = border ? st : (k == 1 ? k1_st : kn_st);
  const int g_lvl = border ? min(run, k) : (k == 1 ? (int)g : kn_lvl);
  const bool g_done = border && run == 0;
  const int move = stop ? 0 : st + 1;
  done = stop || (st == 0 ? mptr == PTR_NONE : g_done);
  lvl = stop ? lvl : (st == 0 ? m_lvl : g_lvl);
  st = stop ? st : (st == 0 ? m_st : g_st);
  return move;
}

// The walk's transitions away from the matrix's edges (i > 0 and j > 0, so
// neither the origin nor a border run) as a table in shared memory, built
// by walk_move itself.  A state's entries start at its base: M (level 0) at
// 0, one entry a byte; a gap (st 1 or 2, level below 16) at GAPS + ((st -
// 1) * 16 + lvl) * 8, one entry a value of byte >> 5 (the stay bits; bit 7
// is M's alone).  An entry holds the next state's base (0 for a level of 16
// or more, which only a finished walk keeps: PTR_NONE leaves 31 - k), the
// move code, done, the next state and level, the shift of the byte that
// indexes the next state's entries (0 or 5), and the next state's step of
// a byte's offset in a window (M two rows and a column, up a row and a
// column, left a row).
constexpr int GAPS = 256, TABLE = GAPS + 32 * 8;
constexpr int MOVE_AT = 10, DONE_AT = 12, ST_AT = 13, LVL_AT = 15, SHIFT_AT = 20, STEP_AT = 23;

__device__ __forceinline__ int step_of(int st) {
  return st == 0 ? 2 * ROW_BYTES + 1 : st == 1 ? ROW_BYTES + 1 : ROW_BYTES;
}

__device__ __forceinline__ int table_base(int st, int lvl) {
  return st == 0 || lvl >= 16 ? 0 : GAPS + ((st - 1) * 16 + lvl) * 8;
}

__device__ void build_table(uint32_t* table, int k, int local, int lane) {
  for (int e = lane; e < TABLE; e += 32) {
    const bool gap = e >= GAPS;
    int st = gap ? 1 + ((e - GAPS) >> 7) : 0, lvl = gap ? ((e - GAPS) >> 3) & 15 : 0;
    const int bits = gap ? ((e - GAPS) & 7) << 5 : e;
    bool done = false;
    const int move = walk_move(bits, k, local, 1, 1, 1 - (st != 2), 1 - (st != 1), st, lvl, done);
    table[e] = (uint32_t)(table_base(st, lvl) | (move << MOVE_AT) | (done << DONE_AT) |
                          (st << ST_AT) | (lvl << LVL_AT) | ((st ? 5 : 0) << SHIFT_AT)) |
               ((uint32_t)step_of(st) << STEP_AT);
  }
}

// The bytes of one problem: rows [0, T) of bits uint8[T, B, Lp] at problem
// b; a cell (i, j) reads row clamp(i + j - 2 - base, 0, T - 1), column
// clamp(i, 0, Lp - 1).
struct Bytes {
  const uint8_t* bits;
  int T, B, Lp, b, base;

  __device__ const uint8_t* at(int row, int col) const {
    return bits + ((size_t)row * B + b) * Lp + col;
  }
};

// A window: rows [rlo, rhi] and columns [clo, chi] (never empty), row r at
// r - rlo of its buffer, from the 16-byte boundary at or below column clo.
struct Window {
  int rlo, rhi, clo, chi;
  uint32_t at0;  // the low bits of the address of (row 0, column clo)
  bool exact;    // no column clamped, and no row above the last; no column 0
};

// The window of diagonals (D - WINDOW, D] for a walk that entered the one
// above at row i.
__device__ __forceinline__ Window window(const Bytes& m, int D, int i) {
  Window w;
  w.rlo = min(max(D - WINDOW - 1 - m.base, 0), m.T - 1);
  w.rhi = min(max(D - 2 - m.base, 0), m.T - 1);
  w.clo = min(max(i - 2 * WINDOW + 1, 0), m.Lp - 1);
  w.chi = min(max(i, 0), m.Lp - 1);
  w.at0 = (uint32_t)(uintptr_t)m.at(0, w.clo);
  w.exact = D - 2 - m.base <= m.T - 1 && i - 2 * WINDOW + 1 >= 1 && i <= m.Lp - 1;
  return w;
}

// The warp copies window w into buf: each row's 16-byte chunks from the
// one holding column clo to the one holding chi.
__device__ __forceinline__ void stage(uint8_t* buf, const Bytes& m, const Window& w, int lane) {
  int r = lane / ROW_CHUNKS, ch = lane - r * ROW_CHUNKS;  // chunk idx = r ROW_CHUNKS + ch
  for (int idx = lane; idx < (w.rhi - w.rlo + 1) * ROW_CHUNKS; idx += 32) {
    const uintptr_t lo = (uintptr_t)m.at(w.rlo + r, w.clo);
    const uintptr_t src = (lo & ~(uintptr_t)15) + 16 * ch;
    if (src <= lo + (w.chi - w.clo)) copy_async<16>(buf + r * ROW_BYTES + 16 * ch, (const void*)src, true);
    r += 32 / ROW_CHUNKS;
    ch += 32 % ROW_CHUNKS;
    if (ch >= ROW_CHUNKS) {
      ch -= ROW_CHUNKS;
      ++r;
    }
  }
  copy_commit();
}

// The warp stores tape positions [lo, hi) of `row` from the ring (the
// positions at nz and past it as zeros): whole 16-byte chunks by 16-byte
// stores, the ragged bytes at either end one a lane.
__device__ void flush(uint8_t* row, const uint8_t* ring, int lo, int hi, int nz, int lane) {
  if (hi <= lo) return;
  const uintptr_t r0 = (uintptr_t)row, a = r0 + lo, e = r0 + hi;
  uintptr_t h = (a + 15) & ~(uintptr_t)15, t = e & ~(uintptr_t)15;  // whole chunks [h, t)
  if (h > t) h = t = e;  // inside one chunk: bytes only
  const uintptr_t x = lane < 16 ? a + lane : t + (lane - 16);
  if (x < (lane < 16 ? h : e)) {
    const int p = (int)(x - r0);
    *(uint8_t*)x = p < nz ? ring[(uint32_t)x & (RING - 1)] : 0;
  }
  for (uintptr_t c = h + 16 * lane; c < t; c += 32 * 16) {
    const int p = (int)(c - r0);
    union {
      uint4 v;
      uint8_t b[16];
    } u;
    if (p + 16 <= nz) {
      u.v = *(const uint4*)(ring + ((uint32_t)c & (RING - 1)));
    } else {
#pragma unroll
      for (int q = 0; q < 16; ++q) u.b[q] = p + q < nz ? ring[((uint32_t)c + q) & (RING - 1)] : 0;
    }
    *(uint4*)c = u.v;
  }
}

// The fast walk of lane 0 (see walk): from the cell at byte offset `off` of
// the window (its row's place in a chunk `mis`, diagonal d), a move a table
// lookup, until the walk ends, reaches `cap` steps or d reaches `lim`.  A
// row's place in its chunk moves by s1 = B Lp mod 16 a row (s2 two rows).
__device__ __forceinline__ void fast_walk(const uint8_t* bufs, const uint32_t* table,
                                          uint8_t* ring, uint32_t ra, int s1, int s2, int floor,
                                          int cap, int lim, int steps, int& off, int& mis,
                                          int& d, int& st, int& lvl, int& n, int& step,
                                          bool& done) {
  uint32_t e = (uint32_t)table_base(st, lvl) | ((uint32_t)(st ? 5 : 0) << SHIFT_AT) |
               ((uint32_t)step_of(st) << STEP_AT);
  int bits = bufs[off];
  while (true) {
    // the cell a move leads to and its byte, read before the move is known
    const int next_mis = (mis - (st == 0 ? s2 : s1)) & 15;
    const int next_off = off - (int)(e >> STEP_AT) + next_mis - mis;
    const int next = bufs[max(next_off, floor)];  // below the window: not read after
    e = table[(e & 1023) + (bits >> ((e >> SHIFT_AT) & 7))];
    const int move = (e >> MOVE_AT) & 3;
    if (n < steps) ring[(ra + n) & (RING - 1)] = (uint8_t)move;
    n += move != 0;
    ++step;
    if (move) {
      off = next_off;
      mis = next_mis;
      d -= st == 0 ? 2 : 1;
    }
    done = (e >> DONE_AT) & 1;
    st = (e >> ST_AT) & 3;
    lvl = (e >> LVL_AT) & 31;
    bits = next;
    if (done || step >= cap || d <= lim) break;
  }
}

// The walk's state: cell, state, level, done, moves emitted.
struct State {
  int i, j, st, lvl, n;
  bool done;
};

// One problem's walk by the warp, from s.  It stops where it ends, after
// `cap` steps, or (edge) where its diagonal leaves the block below row 0.
// Each move is appended at s.n of `tape` (stored where n < steps); with
// zero_fill the positions from the last move to `steps` are zeroed too.
__device__ void walk(const Bytes& m, int k, int local, int cap, bool edge, State& s,
                     uint8_t* tape, int steps, bool zero_fill) {
  // the two windows, the ring of moves and the table (a CTA is one warp)
  __shared__ __align__(16) uint8_t bufs[2 * WINDOW * ROW_BYTES];
  __shared__ __align__(16) uint8_t ring[RING];
  __shared__ uint32_t table[TABLE];
  const int lane = threadIdx.x & 31;
  const uint32_t stride = (uint32_t)((size_t)m.B * m.Lp), ra = (uint32_t)(uintptr_t)tape;
  int D = s.i + s.j;
  Window cur = window(m, D, s.i), nxt = window(m, D - WINDOW, s.i);
  int cbo = 0;  // window cur's buffer: bufs + cbo, window nxt's the other
  stage(bufs, m, cur, lane);
  stage(bufs + WINDOW * ROW_BYTES, m, nxt, lane);
  build_table(table, k, local, lane);  // while the first windows are in flight
  int flushed = min(s.n, steps), step = 0;
  while (true) {
    copy_wait_group<1>();  // window cur has landed; nxt may be in flight
    __syncwarp();
    bool stop = false;
    if (lane == 0) {
      // the smem offset of (row, col) in window cur, where it holds them
      const int rspan = cur.rhi - cur.rlo, cspan = cur.chi - cur.clo;
      const int off0 = cbo - cur.rlo * ROW_BYTES - cur.clo;
      const auto offset = [&](int row, int col) {
        return row * ROW_BYTES + (int)((cur.at0 + (uint32_t)row * stride) & 15) + col + off0;
      };
      const auto staged = [&](int row, int col) {
        return (unsigned)(row - cur.rlo) <= (unsigned)rspan &&
               (unsigned)(col - cur.clo) <= (unsigned)cspan;
      };
      int i = s.i, j = s.j, st = s.st, lvl = s.lvl, n = s.n, d = i + j, bits = 0;
      bool done = s.done, have = false;  // have: bits holds cell (i, j)'s byte
      // The fast walk: where no cell the walk can reach in this window lies on
      // the matrix's edges (i > 0 and j > 0 there, nothing clamped), a move
      // is a table lookup and a step of the byte's offset by the state (rows
      // of ROW_BYTES, each from its 16-byte boundary: the step carries the
      // change of a row's place in its chunk, stride mod 16 a row), down to
      // the window's last diagonal or the block's edge.
      const bool fast = cur.exact && D - WINDOW >= cur.chi;
      const int lim = edge ? max(D - WINDOW, m.base + 1) : D - WINDOW;
      const int s1 = stride & 15, s2 = (2 * stride) & 15;
      while (true) {
        if (done || step >= cap || (edge && d - 2 < m.base)) {  // ended, or the blocks below
          stop = true;
          break;
        }
        if (d <= D - WINDOW) break;  // into window nxt
        if (fast && (st == 0 ? lvl == 0 : lvl < 16)) {  // a state the table holds
          const int row0 = d - 2 - m.base;
          int off = offset(row0, i), mis = (int)((cur.at0 + (uint32_t)row0 * stride) & 15);
          fast_walk(bufs, table, ring, ra, s1, s2, cbo, cap, lim, steps, off, mis, d, st, lvl, n,
                    step, done);
          // the cell from its offset: its row from the diagonal, then its column
          i = off - off0 - (d - 2 - m.base) * ROW_BYTES - mis;
          j = d - i;
          have = false;
          continue;
        }
        if (!have) {  // the window's first cell, or a byte outside it
          const int row = d - 2 - m.base;
          bits = staged(row, i) ? bufs[offset(row, i)]
                                : *m.at(min(max(row, 0), m.T - 1), min(max(i, 0), m.Lp - 1));
        }
        // the next cell and its byte, loaded while this move is worked out
        const int ni = i - (st != 2), nj = j - (st != 1), nrow = ni + nj - 2 - m.base;
        have = staged(nrow, ni);
        const int next = bufs[have ? offset(nrow, ni) : cbo];
        const int move = walk_move(bits, k, local, i, j, ni, nj, st, lvl, done);
        if (n < steps) ring[(ra + n) & (RING - 1)] = (uint8_t)move;
        n += move != 0;
        ++step;
        if (move) {
          i = ni;
          j = nj;
          d = ni + nj;
        }
        bits = next;
      }
      s.i = i;
      s.j = j;
      s.st = st;
      s.lvl = lvl;
      s.n = n;
      s.done = done;
    }
    __syncwarp();
    stop = __shfl_sync(0xffffffffu, stop, 0);
    s.n = __shfl_sync(0xffffffffu, s.n, 0);
    s.i = __shfl_sync(0xffffffffu, s.i, 0);
    // the moves up to the last whole 16-byte chunk of the tape go out now
    const int upto = (int)((((uintptr_t)tape + min(s.n, steps)) & ~(uintptr_t)15) - (uintptr_t)tape);
    if (upto > flushed) {
      flush(tape, ring, flushed, upto, 0x7fffffff, lane);
      flushed = upto;
    }
    if (stop) break;
    D -= WINDOW;  // the walk is in window nxt; its entry row sets the one after
    const Window after = window(m, D - WINDOW, s.i);
    stage(bufs + cbo, m, after, lane);  // into the buffer cur leaves
    cbo ^= WINDOW * ROW_BYTES;
    cur = nxt;
    nxt = after;
  }
  copy_wait_all();
  if (zero_fill)
    flush(tape, ring, flushed, steps, s.n, lane);
  else
    flush(tape, ring, flushed, min(s.n, steps), 0x7fffffff, lane);
}

__global__ void __launch_bounds__(32)
    replay_kernel(const uint8_t* __restrict__ tb, const int* __restrict__ ti,
                  const int* __restrict__ tj, const int* __restrict__ tcode, int T, int B, int Lp,
                  int k, int local, int steps, uint8_t* __restrict__ moves,
                  int* __restrict__ nmoves) {
  const int b = blockIdx.x;
  const int tc = tcode[b];
  State s{ti[b], tj[b], tc == 0 ? 0 : (tc <= k ? 1 : 2), tc <= k ? tc : tc - k, 0, false};
  walk(Bytes{tb, T, B, Lp, b, 0}, k, local, steps, false, s, moves + (size_t)b * steps, steps,
       true);
  if (threadIdx.x == 0) nmoves[b] = s.n;
}

// The walk inside block q of a checkpointed traceback: the diagonals 2 + q
// R .. 2 + (q + 1) R - 1, whose bytes are bits uint8[R, B, Lp] (row d - 2 -
// q R), and below diagonal 2 for q = 0.  The state (i, j, st, lvl, done, n)
// comes from state int32[6, B] and goes back there; each move is appended
// at n of the problem's tape.  The walk stops where its diagonal leaves
// the block: at most R + 2 steps (R diagonals; d = 1 and the stop at the
// origin in block 0).
__global__ void __launch_bounds__(32)
    replay_block_kernel(const uint8_t* __restrict__ bits, int* __restrict__ state, int R, int B,
                        int Lp, int block, int k, int local, int steps,
                        uint8_t* __restrict__ moves) {
  const int b = blockIdx.x;
  State s{state[b], state[B + b], state[2 * B + b], state[3 * B + b], state[5 * B + b],
          state[4 * B + b] != 0};
  const int base = block * R;
  if (s.done || (block > 0 && s.i + s.j - 2 < base)) return;  // nothing to walk here
  walk(Bytes{bits, R, B, Lp, b, base}, k, local, R + 2, block > 0, s, moves + (size_t)b * steps,
       steps, false);
  if (threadIdx.x == 0) {
    state[b] = s.i;
    state[B + b] = s.j;
    state[2 * B + b] = s.st;
    state[3 * B + b] = s.lvl;
    state[4 * B + b] = s.done;
    state[5 * B + b] = s.n;
  }
}

// One thread's chain of `reads` dependent shared-memory reads: the cycles
// (clock64) the chain took, for the walk's chain bound.
__global__ void read_cycles_kernel(int reads, long long* cycles, int* sink) {
  __shared__ int next[256];
  for (int t = 0; t < 256; ++t) next[t] = (t + 97) & 255;
  volatile int* v = next;
  int p = 0;
  const long long t0 = clock64();
#pragma unroll 16
  for (int r = 0; r < reads; ++r) p = v[p];
  const long long t1 = clock64();
  cycles[0] = t1 - t0;
  sink[0] = p;
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
  replay_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(tb, ti, tj, tcode, T, B, Lp, k, local, steps,
                                                    moves, nmoves);
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
  replay_block_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(bits, state, R, B, Lp, block, k, local,
                                                          steps, moves);
  return (int)cudaGetLastError();
}

// cycles int64[1] gets the clock cycles of one thread's chain of `reads`
// dependent shared-memory reads; sink int32[1] its last index.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue.
extern "C" int praline_replay_read_cycles(int reads, long long* cycles, int* sink, void* stream) {
  if (reads < 1) return (int)cudaErrorInvalidValue;
  read_cycles_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(reads, cycles, sink);
  return (int)cudaGetLastError();
}
