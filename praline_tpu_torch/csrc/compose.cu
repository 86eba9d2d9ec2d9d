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
// Design: one CTA a join.  The tape (2 C_cap bytes) is walked in tiles of
// THREADS * ITEMS positions, each thread ITEMS consecutive positions; a
// block-wide prefix sum of the x and y takes gives each position its two
// source columns, and the position's thread writes its output column.  A
// column receives exactly one position, so nothing is added atomically and
// nothing is read back; columns past the tape are zeroed.  Positions whose
// column falls past the capacity (a merged profile longer than C_cap, which
// the caller detects from nmv and retries at a larger capacity) are
// dropped; the length written is min(nmv, C_cap), so that a later DP never
// reads past its rows.  Every add is __fadd_rn and every value an integer
// below 2**24, so the sums are exact in any order.
//
// What bounds it on the H100: the bytes of two operand profiles read and
// one written a join (A + 2 floats a column) against the tape's dependent
// prefix sum; at msa128's widths the launch and the tile loop's barriers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 8;
constexpr int MAX_ALPHABET = 32;
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

// Exclusive block-wide prefix sum of (x, y); ``total`` gets the block's sum.
__device__ int2 exclusive_scan(int2 v, int2* warp_sums, int2& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int2 inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, inc.x, o);
    const int y = __shfl_up_sync(0xffffffffu, inc.y, o);
    if (lane >= o) inc = make_int2(inc.x + x, inc.y + y);
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int2 w = lane < WARPS ? warp_sums[lane] : make_int2(0, 0);
#pragma unroll
    for (int o = 1; o < WARPS; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, w.x, o);
      const int y = __shfl_up_sync(0xffffffffu, w.y, o);
      if (lane >= o) w = make_int2(w.x + x, w.y + y);
    }
    if (lane < WARPS) warp_sums[lane] = w;
  }
  __syncthreads();
  const int2 before = warp ? warp_sums[warp - 1] : make_int2(0, 0);
  total = warp_sums[WARPS - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return make_int2(inc.x - v.x + before.x, inc.y - v.y + before.y);
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
  __shared__ int2 warp_sums[WARPS];
  const int j = blockIdx.x, t = threadIdx.x;
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
    int2 own = make_int2(0, 0), takes;
    for (int p = t; p < steps; p += THREADS) {
      const int v = m[p];
      own.x += v == 1 || v == 2;
      own.y += v == 1 || v == 3;
    }
    exclusive_scan(own, warp_sums, takes);
    const bool empty = nmv == 0;
    const int ti_e = empty ? 0 : ti[j], tj_e = empty ? 0 : tj[j];
    tape.tx = Cl - ti_e;
    tape.ty = Cr - tj_e;
    tape.x0 = ti_e - takes.x;
    tape.y0 = tj_e - takes.y;
    tape.shift = tape.tx + tape.ty;
    tape.after = tape.shift + nmv;
    nmv += tape.shift + tape.x0 + tape.y0;
  }

  const float* cl = counts + (size_t)l * C * A;
  const float* cr = counts + (size_t)r * C * A;
  const float* gl = gaps + (size_t)l * C;
  const float* gr = gaps + (size_t)r * C;
  float* co = counts + (size_t)o * C * A;
  float* go = gaps + (size_t)o * C;
  float* io = inv + (size_t)o * C;
  uint8_t* out = tape_out + (size_t)j * steps;

  int2 carry = make_int2(0, 0);
  for (int base = 0; base < steps; base += THREADS * ITEMS) {
    const int p0 = base + t * ITEMS;
    int mv[ITEMS];
    int2 own = make_int2(0, 0);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int p = p0 + i;
      mv[i] = p < steps ? tape.at(p) : 0;
      own.x += mv[i] == 1 || mv[i] == 2;
      own.y += mv[i] == 1 || mv[i] == 3;
    }
    int2 tile;
    int2 rc = exclusive_scan(own, warp_sums, tile);
    rc = make_int2(rc.x + carry.x, rc.y + carry.y);
    carry = make_int2(carry.x + tile.x, carry.y + tile.y);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int p = p0 + i;
      if (p >= steps) break;
      out[p] = (uint8_t)mv[i];
      const bool tx = mv[i] == 1 || mv[i] == 2, ty = mv[i] == 1 || mv[i] == 3;
      rc = make_int2(rc.x + tx, rc.y + ty);  // inclusive of p
      const int c = nmv - 1 - p;
      if (mv[i] == 0 || c >= C) continue;
      const int xi = min(max(Cl - rc.x, 0), C - 1), yi = min(max(Cr - rc.y, 0), C - 1);
      const float* rx = cl + (size_t)xi * A;
      const float* ry = cr + (size_t)yi * A;
      float v[MAX_ALPHABET];
      float sum = 0.0f;
#pragma unroll
      for (int a = 0; a < MAX_ALPHABET; ++a) {
        if (a < A) {
          v[a] = tx && ty ? __fadd_rn(rx[a], ry[a]) : tx ? rx[a] : ry[a];
          sum = __fadd_rn(sum, v[a]);
        }
      }
      float g = __fadd_rn(tx ? gl[xi] : fl, ty ? gr[yi] : fr);
      if (__fadd_rn(sum, g) > COUNT_LIMIT) {
        const int n = max((int)__fadd_rn(sum, g), 1);
        sum = 0.0f;
#pragma unroll
        for (int a = 0; a < MAX_ALPHABET; ++a) {
          if (a < A) {
            v[a] = (float)((512 * (int)v[a] + n) / (2 * n));
            sum = __fadd_rn(sum, v[a]);
          }
        }
        g = (float)((512 * (int)g + n) / (2 * n));
      }
      float* dst = co + (size_t)c * A;
#pragma unroll
      for (int a = 0; a < MAX_ALPHABET; ++a)
        if (a < A) dst[a] = v[a];
      go[c] = g;
      io[c] = inv_table[min(max((int)sum, 0), inv_size - 1)];
    }
  }
  // columns past the merged profile: zero counts, inverse of a zero total
  for (int c = min(max(nmv, 0), C) + t; c < C; c += THREADS) {
    float* dst = co + (size_t)c * A;
    for (int a = 0; a < A; ++a) dst[a] = 0.0f;
    go[c] = 0.0f;
    io[c] = inv_table[0];
  }
  if (t == 0) {
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
  if (J < 1 || C < 1 || A < 1 || A > MAX_ALPHABET ||
      steps < 1 || inv_size < 1 || mode < 0 || mode > LOCAL)
    return (int)cudaErrorInvalidValue;
  compose_kernel<<<J, THREADS, 0, (cudaStream_t)stream>>>(
      moves, nmoves, ti, tj, li, ri, oi, counts, gaps, inv, lens, mems,
      inv_table, inv_size, C, A, steps, mode, tape_out, nmv_out);
  return (int)cudaGetLastError();
}
