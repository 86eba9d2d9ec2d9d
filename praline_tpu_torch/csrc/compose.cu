// Profile composition of the device-resident merge, for Hopper (sm_90a).
//
// Counterpart of the XLA ops of praline_tpu/msa/device_merge.py:159-266
// (no Pallas kernel there: XLA fuses them on the TPU).  Its plain version
// is kernels/compose.py::compose_plain, bit for bit.  For each of J joins
// of one tree level it
//   1. turns the walk's move tape (terminal -> origin) into the
//      full-coverage tape of the merge mode: semiglobal prepends the free
//      trailing gaps (x tail, then y tail), local wraps the local segment
//      in [y tail, x tail, walk, y lead, x lead], and an empty local walk
//      becomes all of x and all of y;
//   2. composes the merged profile: tape position p is output column
//      c = nmv - 1 - p, its sources the columns Cl - (x takes in 0..p)
//      and Cr - (y takes in 0..p); a gap column adds the other side's
//      member count to the gap count;
//   3. rescales the columns whose counts plus gaps exceed COUNT_LIMIT in
//      exact integers, (512 c + n) / (2 n);
//   4. looks up each column's inverse in a table of correctly rounded f32
//      reciprocals from its integer total, and scatters counts, gaps,
//      inverses, length and member count into the join's slot of the node
//      table.
//
// Design: several CTAs a join, one a tile of TILE tape positions (a
// thread a position), so a level of 32 joins at capacity 1279 runs 320
// CTAs.  Each CTA builds the full-coverage tape's parameters itself (in
// local mode from the walk's takes over the whole tape) and counts the
// takes of the tape before its tile (at most 2 C_cap bytes read from L2,
// no pass between CTAs), then a block scan gives each position its two
// source columns.  The columns' floats go through shared memory: the
// tile's threads read the two source rows and write the output rows in
// the order of the columns in memory, so a warp's loads and stores are
// contiguous runs; between the two, each position's thread sums its
// column, rescales it past COUNT_LIMIT and looks up its inverse.  Each
// column has exactly one writer, nothing is added atomically and nothing
// is read back: the column of a position by the CTA of that position, a
// column past the merged profile (zeroed) by the CTA whose tile index it
// has, the length, member count and nmv_out by the join's first CTA.
// Positions whose column falls past the capacity (a merged profile longer
// than C_cap, which the caller detects from nmv and retries at a larger
// capacity) are dropped; the length written is min(nmv, C_cap), so that a
// later DP never reads past its rows.  Every add is __fadd_rn and every
// value an integer below 2**24, so the sums are exact in any order; a
// column's own sum runs over a = 0 .. A - 1 as before.
//
// What bounds it on the H100: the bytes of two operand profiles read and
// one written a join (A + 2 floats a column), 0.0022 ms at J32 x 1279; the
// kernel takes 0.0172 ms there (0.0657 as one CTA a join), a few dependent
// rounds of L2 reads a CTA (the join's slots, the prefix, the source rows,
// the gaps, the inverse) and three barriers.  Its wrapper's host checks
// take longer than the kernel (python3 chip_smoke.py walk-times, NVIDIA
// H100 80GB HBM3 at 700 W, PERF.md section 6).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = THREADS;  // tape positions a CTA, one a thread
constexpr int MAX_ALPHABET = 32;
constexpr int STRIDE = MAX_ALPHABET + 1;  // a column's floats in shared memory (odd: no conflicts)
constexpr float COUNT_LIMIT = 992.0f;
constexpr int SEMIGLOBAL = 1, LOCAL = 2;  // kernels/scan.py MODES

// The full-coverage tape of one join as a function of its position.
struct Tape {
  const uint8_t* m;
  int mode, tx, ty, shift, after, y0, x0;

  __device__ int at(int p) const {
    if (mode == SEMIGLOBAL) return p < tx ? 2 : p < shift ? 3 : m[p - shift];
    if (mode != LOCAL) return m[p];
    if (p < ty) return 3;
    if (p < shift) return 2;
    if (p < after) return m[p - shift];
    if (p < after + y0) return 3;
    return p < after + y0 + x0 ? 2 : 0;
  }
};

// (x takes, y takes) of a move code.
__device__ __forceinline__ int2 takes(int v) {
  return make_int2(v == 1 || v == 2, v == 1 || v == 3);
}

// This thread's takes over positions t, t + THREADS, ... below `end` of
// tape(p), BATCH positions' bytes loaded at once.
constexpr int BATCH = 8;
template <typename F>
__device__ __forceinline__ int2 own_takes(int end, F tape) {
  int2 own = make_int2(0, 0);
  for (int p0 = threadIdx.x; p0 < end; p0 += BATCH * THREADS) {
    int v[BATCH];
#pragma unroll
    for (int q = 0; q < BATCH; ++q) {
      const int p = p0 + q * THREADS;
      v[q] = p < end ? tape(p) : 0;
    }
#pragma unroll
    for (int q = 0; q < BATCH; ++q) {
      const int2 tk = takes(v[q]);
      own = make_int2(own.x + tk.x, own.y + tk.y);
    }
  }
  return own;
}

__device__ __forceinline__ int4 add4(int4 a, int4 b) {
  return make_int4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Exclusive block-wide prefix sum of v; ``total`` gets the block's sum.
__device__ int4 exclusive_scan(int4 v, int4* warp_sums, int4& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int4 inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int4 u = make_int4(__shfl_up_sync(0xffffffffu, inc.x, o),
                             __shfl_up_sync(0xffffffffu, inc.y, o),
                             __shfl_up_sync(0xffffffffu, inc.z, o),
                             __shfl_up_sync(0xffffffffu, inc.w, o));
    if (lane >= o) inc = add4(inc, u);
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int4 w = lane < WARPS ? warp_sums[lane] : make_int4(0, 0, 0, 0);
#pragma unroll
    for (int o = 1; o < WARPS; o <<= 1) {
      const int4 u = make_int4(__shfl_up_sync(0xffffffffu, w.x, o),
                               __shfl_up_sync(0xffffffffu, w.y, o),
                               __shfl_up_sync(0xffffffffu, w.z, o),
                               __shfl_up_sync(0xffffffffu, w.w, o));
      if (lane >= o) w = add4(w, u);
    }
    if (lane < WARPS) warp_sums[lane] = w;
  }
  __syncthreads();
  const int4 before = warp ? warp_sums[warp - 1] : make_int4(0, 0, 0, 0);
  total = warp_sums[WARPS - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return add4(before, make_int4(inc.x - v.x, inc.y - v.y, inc.z - v.z, inc.w - v.w));
}

__global__ void __launch_bounds__(THREADS)
    compose_kernel(const uint8_t* __restrict__ moves,
                   const int* __restrict__ nmoves, const int* __restrict__ ti,
                   const int* __restrict__ tj, const int* __restrict__ li,
                   const int* __restrict__ ri, const int* __restrict__ oi,
                   float* counts, float* gaps, float* inv, int* lens,
                   int* mems, const float* __restrict__ inv_table,
                   int inv_size, int C, int A, int steps, int mode,
                   uint8_t* __restrict__ tape_out, int* __restrict__ nmv_out) {
  __shared__ int4 warp_sums[WARPS];
  __shared__ float vals[TILE * STRIDE];
  __shared__ int src_x[TILE], src_y[TILE];
  __shared__ uint8_t take[TILE];  // bit 0 x, bit 1 y; 0: no column
  const int j = blockIdx.y, p0 = blockIdx.x * TILE, t = threadIdx.x;
  const int l = li[j], r = ri[j], o = oi[j];
  const int Cl = lens[l], Cr = lens[r];
  const float fl = (float)mems[l], fr = (float)mems[r];
  const uint8_t* m = moves + (size_t)j * steps;
  int nmv = nmoves[j];

  Tape tape{m, mode, 0, 0, 0, 0, 0, 0};
  if (mode == SEMIGLOBAL) {
    tape.tx = Cl - ti[j];
    tape.ty = Cr - tj[j];
    tape.shift = tape.tx + tape.ty;
    nmv += tape.shift;
  } else if (mode == LOCAL) {
    const int2 own = own_takes(steps, [&](int p) { return (int)m[p]; });
    int4 walk;
    exclusive_scan(make_int4(own.x, own.y, 0, 0), warp_sums, walk);
    const bool empty = nmv == 0;
    const int ti_e = empty ? 0 : ti[j], tj_e = empty ? 0 : tj[j];
    tape.tx = Cl - ti_e;
    tape.ty = Cr - tj_e;
    tape.x0 = ti_e - walk.x;
    tape.y0 = tj_e - walk.y;
    tape.shift = tape.tx + tape.ty;
    tape.after = tape.shift + nmv;
    nmv += tape.shift + tape.x0 + tape.y0;
  }

  const size_t CA = (size_t)C * A;
  const float* cl = counts + (size_t)l * CA;
  const float* cr = counts + (size_t)r * CA;
  const float* gl = gaps + (size_t)l * C;
  const float* gr = gaps + (size_t)r * C;
  float* co = counts + (size_t)o * CA;
  float* go = gaps + (size_t)o * C;
  float* io = inv + (size_t)o * C;

  if (p0 < steps) {  // this CTA's tile of the tape
    // the takes before the tile (needed only where a position has a column)
    const int2 own = own_takes(min(p0, nmv), [&](int p) { return tape.at(p); });
    const int p = p0 + t;
    const int mv = p < steps ? tape.at(p) : 0;
    const int2 tk = takes(mv);
    int4 sums;
    const int4 ex = exclusive_scan(make_int4(tk.x, tk.y, own.x, own.y), warp_sums, sums);
    if (p < steps) tape_out[(size_t)j * steps + p] = (uint8_t)mv;
    const int rcx = sums.z + ex.x + tk.x, rcy = sums.w + ex.y + tk.y;  // takes in 0..p
    const int c = nmv - 1 - p;
    src_x[t] = min(max(Cl - rcx, 0), C - 1);
    src_y[t] = min(max(Cr - rcy, 0), C - 1);
    take[t] = mv != 0 && c >= 0 && c < C ? tk.x | tk.y << 1 : 0;
    __syncthreads();

    // the source rows, in the order of the output columns in memory
    // (column nmv - p0 - TILE + q is position TILE - 1 - q of the tile),
    // BATCH elements' loads in flight at once
    for (int f0 = t; f0 < TILE * A; f0 += BATCH * THREADS) {
      float x[BATCH], y[BATCH];
      int at[BATCH], w[BATCH];
#pragma unroll
      for (int q = 0; q < BATCH; ++q) {
        const int f = f0 + q * THREADS, col = f / A, a = f - col * A, u = TILE - 1 - col;
        w[q] = f < TILE * A ? take[u] : 0;
        at[q] = u * STRIDE + a;
        x[q] = w[q] & 1 ? cl[(size_t)src_x[u] * A + a] : 0.0f;
        y[q] = w[q] & 2 ? cr[(size_t)src_y[u] * A + a] : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < BATCH; ++q)
        if (w[q]) vals[at[q]] = w[q] == 3 ? __fadd_rn(x[q], y[q]) : w[q] & 1 ? x[q] : y[q];
    }
    __syncthreads();

    // each position's column: total, gaps, the rescale, the inverse
    if (const int w = take[t]) {
      float* v = vals + t * STRIDE;
      float sum = 0.0f;
      for (int a = 0; a < A; ++a) sum = __fadd_rn(sum, v[a]);
      float g = __fadd_rn(w & 1 ? gl[src_x[t]] : fl, w & 2 ? gr[src_y[t]] : fr);
      if (__fadd_rn(sum, g) > COUNT_LIMIT) {
        const int n = max((int)__fadd_rn(sum, g), 1);
        sum = 0.0f;
        for (int a = 0; a < A; ++a) {
          v[a] = (float)((512 * (int)v[a] + n) / (2 * n));
          sum = __fadd_rn(sum, v[a]);
        }
        g = (float)((512 * (int)g + n) / (2 * n));
      }
      go[c] = g;
      io[c] = inv_table[min(max((int)sum, 0), inv_size - 1)];
    }
    __syncthreads();

    for (int f = t; f < TILE * A; f += THREADS) {
      const int q = f / A, a = f - q * A, u = TILE - 1 - q;
      if (take[u]) co[(size_t)(nmv - TILE - p0 + q) * A + a] = vals[u * STRIDE + a];
    }
  }

  // columns past the merged profile whose index lies in this CTA's tile:
  // zero counts, inverse of a zero total
  const int z0 = max(min(max(nmv, 0), C), p0), z1 = min(C, p0 + TILE);
  if (z0 < z1) {
    for (int f = t; f < (z1 - z0) * A; f += THREADS) co[(size_t)z0 * A + f] = 0.0f;
    for (int c = z0 + t; c < z1; c += THREADS) {
      go[c] = 0.0f;
      io[c] = inv_table[0];
    }
  }
  if (blockIdx.x == 0 && t == 0) {
    lens[o] = min(nmv, C);
    mems[o] = mems[l] + mems[r];
    nmv_out[j] = nmv;
  }
}

}  // namespace

// moves uint8[J, steps] (the walk's tapes, terminal -> origin); nmoves, ti,
// tj, li, ri, oi int32[J]; the node table counts f32[M, C, A], gaps and
// inv f32[M, C], lens and mems int32[M] (slots oi written, li and ri read:
// the caller keeps them apart); inv_table f32[inv_size]; tape_out
// uint8[J, steps] (every byte written) and nmv_out int32[J].  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue.
extern "C" int praline_compose(const uint8_t* moves, const int* nmoves,
                               const int* ti, const int* tj, const int* li,
                               const int* ri, const int* oi, float* counts,
                               float* gaps, float* inv, int* lens, int* mems,
                               const float* inv_table, int inv_size, int J,
                               int C, int A, int steps, int mode,
                               uint8_t* tape_out, int* nmv_out, void* stream) {
  if (J < 1 || J > 65535 || C < 1 || A < 1 || A > MAX_ALPHABET ||
      steps < 1 || inv_size < 1 || mode < 0 || mode > LOCAL)
    return (int)cudaErrorInvalidValue;
  const int tiles = ((steps > C ? steps : C) + TILE - 1) / TILE;
  compose_kernel<<<dim3(tiles, J), THREADS, 0, (cudaStream_t)stream>>>(
      moves, nmoves, ti, tj, li, ri, oi, counts, gaps, inv, lens, mems,
      inv_table, inv_size, C, A, steps, mode, tape_out, nmv_out);
  return (int)cudaGetLastError();
}
