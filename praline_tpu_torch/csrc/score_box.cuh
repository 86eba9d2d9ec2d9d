// Score boxes on Hopper's integer tensor cores, shared by the kernels that
// compute pair scores with mma.sync: csrc/scores_mma.cu (the producer's
// "mma" tier, which stores each box to hs), csrc/fused_dp.cu (the fused
// DP's "mma" tier, which keeps each box in shared memory for its own steps)
// and csrc/rows_box.cuh (the lane-tiled DP's "mma" tier, the same a visit).
//
// A box is TW lanes x TD diagonals of one problem, cells (i0 + m, d0 + dd)
// with score hs[d0 + dd, b, i0 + m] = ((Cx @ S @ Cy^T)[i-1, j] * inv_x) * inv_y,
// j = d - i - 1, +0 off the problem.  Its cells need H[i, j] for TW rows and
// the band of TW + TD - 1 columns j = d0 - i0 - TW + c, c = 0 .. TW + TD - 1.
// Rectangle element (m, c) of H_int = T_rows @ band^T is cell (dd, m) with
// dd = c + m - TW + 1.  A warp computes the 16-row m-tiles it owns with
// m16n8k32 tiles (s8 or u8 limbs of T times u8 limbs of Cy, s32
// accumulate), scales each element in the pinned order and writes it to its
// place in the box, staged diagonal-major: hk[dd * SS + m].  A band with a
// count past 255 (a "wide" band) adds the products of Cy's high limbs.  The
// proof that this gives the plain version's bits under
// fused_scores.tensor_core_exact is in csrc/scores_mma.cu.
//
// Also here: the prep kernel that writes the operands (T's limbs and a
// one-pass flag a row of x; the low and high limbs of the counts and a wide
// flag a row of y); the cp.async helpers are csrc/async_copy.cuh.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int BOX_MAXA = 32;          // largest alphabet: one k-step of 32 bytes
constexpr int KW = BOX_MAXA / 4;      // 32-bit words of one 32-byte operand row
constexpr int PREP_NT = 128;          // threads a block of the prep kernel

__device__ __forceinline__ void mma_s8u8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%10,%10,%10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(0));
}

__device__ __forceinline__ void mma_u8u8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%10,%10,%10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(0));
}

// The A fragment of m16n8k32 (8-bit, row major) for rows m0..m0+15 of a
// 32-byte-row operand: a0 row g bytes 4t.., a1 row g+8, a2 row g bytes
// 16+4t.., a3 row g+8.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint32_t* op, int m0, int g,
                                       int t) {
  a[0] = op[(m0 + g) * KW + t];
  a[1] = op[(m0 + g + 8) * KW + t];
  a[2] = op[(m0 + g) * KW + 4 + t];
  a[3] = op[(m0 + g + 8) * KW + 4 + t];
}

// The prep kernel's output in the caller's scratch, 16-byte aligned: y's
// low and high limbs (Cy & 255 and Cy >> 8, u8, 32 bytes a row each), x's
// low and high limbs (32 bytes a row each), then a byte a row of x (one
// pass: every |T| <= 127) and a byte a row of y (wide: some count past
// 255); kernels/fused_scores.py::mma_scratch_bytes counts it.
struct MmaOperands {
  uint4* ylo;
  uint4* yhi;
  uint4* xlo;
  uint4* xhi;
  unsigned char* xwide;
  unsigned char* ywide;
};

inline MmaOperands mma_operands(void* scratch, int B, int Lx, int Ly) {
  uint4* ylo = static_cast<uint4*>(scratch);
  uint4* xlo = ylo + 4LL * B * Ly;
  unsigned char* flags = reinterpret_cast<unsigned char*>(xlo + 4LL * B * Lx);
  return MmaOperands{ylo, ylo + 2LL * B * Ly, xlo, xlo + 2LL * B * Lx, flags,
                     flags + (long long)B * Lx};
}

// One problem's rows of y in the scratch: limbs, wide flags and inverses.
struct YRows {
  const uint4* lo;
  const uint4* hi;
  const unsigned char* wide;
  const float* ivy;
};

__device__ __forceinline__ YRows y_rows(const MmaOperands& op, const float* inv_y, int b,
                                        int Ly) {
  const size_t j0 = (size_t)b * Ly;
  return YRows{op.ylo + 2 * j0, op.yhi + 2 * j0, op.ywide + j0, inv_y + j0};
}

// One thread a row: rows of x (item < B * Lx) to T's limbs and flag, rows
// of y to the limbs of their counts and flag.
__global__ void __launch_bounds__(PREP_NT) skewed_scores_mma_prep_kernel(
    const float* __restrict__ cx, const float* __restrict__ cy, const float* __restrict__ s,
    MmaOperands op, long long nx, long long ny, int A) {
  // S as int32, zero padded to BOX_MAXA x BOX_MAXA: row a is 8 int4 (broadcast reads)
  __shared__ int4 s_sh[BOX_MAXA * BOX_MAXA / 4];
  int* s_int = reinterpret_cast<int*>(s_sh);
  for (int idx = threadIdx.x; idx < BOX_MAXA * BOX_MAXA; idx += PREP_NT) {
    const int a = idx / BOX_MAXA, col = idx % BOX_MAXA;
    s_int[idx] = a < A && col < A ? __float2int_rn(s[a * A + col]) : 0;
  }
  __syncthreads();
  const long long item = (long long)blockIdx.x * PREP_NT + threadIdx.x;
  if (item < nx) {
    const float* row = cx + item * A;
    // T's row, a row of S at a time: A x (8 loads, 32 multiply-adds)
    int t[BOX_MAXA];
#pragma unroll
    for (int col = 0; col < BOX_MAXA; ++col) t[col] = 0;
#pragma unroll
    for (int a = 0; a < BOX_MAXA; ++a) {
      if (a >= A) break;  // uniform
      const int c = __float2int_rn(row[a]);
#pragma unroll
      for (int q = 0; q < BOX_MAXA / 4; ++q) {
        const int4 sv = s_sh[a * (BOX_MAXA / 4) + q];
        t[4 * q] += c * sv.x;
        t[4 * q + 1] += c * sv.y;
        t[4 * q + 2] += c * sv.z;
        t[4 * q + 3] += c * sv.w;
      }
    }
    uint32_t lo[KW], hi[KW];
    bool wide = false;
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      lo[w] = 0;
      hi[w] = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int v = t[4 * w + k];
        wide |= v > 127 || v < -127;
        lo[w] |= ((uint32_t)v & 0xffu) << (8 * k);
        hi[w] |= ((uint32_t)(v >> 8) & 0xffu) << (8 * k);
      }
    }
    op.xlo[2 * item] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    op.xlo[2 * item + 1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
    op.xhi[2 * item] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    op.xhi[2 * item + 1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    op.xwide[item] = wide;
  } else if (item < nx + ny) {
    const long long j = item - nx;
    const float* row = cy + j * A;
    // Cy = 256 * (Cy >> 8) + (Cy & 255), both limbs u8 for counts up to 65535
    uint32_t lo[KW], hi[KW];
    bool wide = false;
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      lo[w] = 0;
      hi[w] = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * w + k < A) {
          const uint32_t c = __float2uint_rn(row[4 * w + k]);
          wide |= c > 255;
          lo[w] |= (c & 0xffu) << (8 * k);
          hi[w] |= ((c >> 8) & 0xffu) << (8 * k);
        }
    }
    op.ylo[2 * j] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    op.ylo[2 * j + 1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
    op.yhi[2 * j] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    op.yhi[2 * j + 1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    op.ywide[j] = wide;
  }
}

// Launches the prep kernel for B problems of Lx x Ly; returns
// cudaGetLastError().
inline int launch_mma_prep(const float* cx, const float* cy, const float* s,
                           const MmaOperands& op, int B, int Lx, int Ly, int A,
                           cudaStream_t st) {
  const long long nx = (long long)B * Lx, ny = (long long)B * Ly;
  skewed_scores_mma_prep_kernel<<<(unsigned)((nx + ny + PREP_NT - 1) / PREP_NT), PREP_NT, 0,
                                  st>>>(cx, cy, s, op, nx, ny, A);
  return (int)cudaGetLastError();
}

// Start the copy of `cols` 32-byte rows of y (one limb) for columns j =
// jbase .. jbase + cols - 1 of a problem into `dst`, two 16-byte pieces a
// column, by `nthreads` threads; columns off the problem are zero-filled.
__device__ __forceinline__ void copy_rows(uint32_t* dst, const uint4* __restrict__ src, int jbase,
                                          int cols, int Ly, int tid, int nthreads) {
  for (int p = tid; p < 2 * cols; p += nthreads) {
    const int j = jbase + p / 2;
    const bool ok = j >= 0 && j < Ly;
    copy_async<16>(&dst[4 * p], ok ? src + 2 * j + p % 2 : src, ok);
  }
}

// Start the copy of one box's band: `cols` columns j = jbase .. jbase +
// cols - 1 of a problem (the low limbs into `lo`, the high limbs into `hi`
// unless it is null) and their inverses, by `nthreads` threads; columns
// off the problem are zero-filled (their cells are +0).  Commits one
// cp.async group.
__device__ __forceinline__ void start_band(uint32_t* lo, uint32_t* hi, float* ivy, const YRows& y,
                                           int jbase, int cols, int Ly, int tid, int nthreads) {
  copy_rows(lo, y.lo, jbase, cols, Ly, tid, nthreads);
  if (hi) copy_rows(hi, y.hi, jbase, cols, Ly, tid, nthreads);
  for (int r = tid; r < cols; r += nthreads) {
    const int j = jbase + r;
    const bool ok = j >= 0 && j < Ly;
    copy_async<4>(&ivy[r], ok ? y.ivy + j : y.ivy, ok);
  }
  copy_commit();
}

// Whether one of the band's columns j = jbase .. jbase + cols - 1 that
// this thread reads the flag of is wide (some count past 255): the band is
// wide where that holds for some thread (__syncthreads_or).
__device__ __forceinline__ bool band_flags(const YRows& y, int jbase, int cols, int Ly, int tid,
                                           int nthreads) {
  bool wide = false;
  for (int r = tid; r < cols; r += nthreads) {
    const int j = jbase + r;
    wide |= j >= 0 && j < Ly && y.wide[j];
  }
  return wide;
}

// Whether the Cy_hi pieces this thread copied into `hi` by copy_rows
// (`cols` columns) hold a nonzero limb, once its copies have landed: the
// band is wide where that holds for some thread (__syncthreads_or).
__device__ __forceinline__ bool rows_nonzero(const uint32_t* hi, int cols, int tid,
                                             int nthreads) {
  bool any = false;
  for (int p = tid; p < 2 * cols; p += nthreads) {
    const uint4 v = reinterpret_cast<const uint4*>(hi)[p];
    any |= (v.x | v.y | v.z | v.w) != 0;
  }
  return any;
}

// One n-tile's product of the rows' limbs with 8 columns of one limb of Cy
// (32-byte rows at `rows`, tile columns n0 .. n0 + 7): one pass, or the
// two limbs of T recombined as 256 * P_hi + P_lo.
__device__ __forceinline__ void tile_product(int (&h)[4], const uint32_t (&alo)[4],
                                             const uint32_t (&ahi)[4], bool two_pass,
                                             const uint32_t* rows, int n0, int g, int t4) {
  const uint32_t b0 = rows[(n0 + g) * KW + t4];
  const uint32_t b1 = rows[(n0 + g) * KW + 4 + t4];
  if (two_pass) {
    int ph[4], pl[4];
    mma_s8u8(ph, ahi, b0, b1);
    mma_u8u8(pl, alo, b0, b1);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = ph[k] * 256 + pl[k];
  } else {
    mma_s8u8(h, alo, b0, b1);
  }
}

// Rows m0 .. m0 + 15 of a box of tw lanes x td diagonals into hk (row
// stride ss floats): the n-tiles of the band (tw + td columns: the low
// limbs in `band`, the high limbs in `band_hi`, read only when `wide`, the
// inverses in `ivy`) whose columns hold cells of the box, on the tensor
// cores, each element scaled into its place or set to +0 off the problem.
// alo / ahi: the rows' A fragments (ahi read only when two_pass); ivx /
// row_ok: rows m0 + g and m0 + g + 8 (g = lane / 4, t4 = lane % 4);
// rows_all / rows_none: every / no row of the m-tile is a row of x; jbase:
// column 0's j; Ly: the problem's columns; store(p, v) puts cell value v at
// p (BoxStore: *p = v).  Warp-uniform.
struct BoxStore {
  __device__ __forceinline__ void operator()(float* p, float v) const { *p = v; }
};

template <class Store = BoxStore>
__device__ __forceinline__ void box_rows(float* hk, int ss, int tw, int td,
                                         const uint32_t* band, const uint32_t* band_hi, bool wide,
                                         const float* ivy, const uint32_t (&alo)[4],
                                         const uint32_t (&ahi)[4], bool two_pass, int m0, int g,
                                         int t4, const float (&ivx)[2], const bool (&row_ok)[2],
                                         bool rows_all, bool rows_none, int jbase, int Ly,
                                         const Store& store = Store()) {
  // The n-tiles whose columns hold cells of the box for rows m0..m0+15:
  // c in [tw - 16 - m0, tw - 1 - m0 + td).
  const int ntile_lo = (tw - 16 - m0) / 8;
  const int ntile_hi = min((tw + td) / 8, (tw - 1 - m0 + td + 7) / 8);
  for (int n = ntile_lo; n < ntile_hi; ++n) {
    const int n0 = n * 8;
    const int jlo = jbase + n0;  // the tile's columns are j = jlo .. jlo + 7
    // Warp-uniform classes: no cell of the problem (every value +0, no
    // product), every element a cell of the problem, or a mix.
    const bool none = rows_none || jlo + 7 < 0 || jlo >= Ly;
    const bool all = rows_all && jlo >= 0 && jlo + 7 < Ly;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (!none) {
      int h[4];
      tile_product(h, alo, ahi, two_pass, band, n0, g, t4);
      if (wide) {  // H = 256 * (T @ Cy_hi^T) + T @ Cy_lo^T, each term below 2**24
        int hw[4];
        tile_product(hw, alo, ahi, two_pass, band_hi, n0, g, t4);
#pragma unroll
        for (int k = 0; k < 4; ++k) h[k] += hw[k] * 256;
      }
      // c0, c1: row g, columns 2t, 2t+1; c2, c3: row g+8.
      const float2 iv = *reinterpret_cast<const float2*>(&ivy[n0 + 2 * t4]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = jlo + 2 * t4 + (k % 2);
        if (all || (row_ok[k / 2] && j >= 0 && j < Ly))
          v[k] = __fmul_rn(__fmul_rn(__int2float_rn(h[k]), ivx[k / 2]), k % 2 ? iv.y : iv.x);
      }
    }
    // element (m, c) to cell (dd = c + m - tw + 1, lane m) where dd is in the box
    const int dd0 = n0 + 2 * t4 + m0 + g - tw + 1;  // of element k = 0
    float* dst = &hk[dd0 * ss + m0 + g];
    if (n0 + m0 - tw + 1 >= 0 && n0 + m0 - tw + 1 + 22 < td) {  // the whole tile in the box
      store(dst, v[0]);
      store(dst + ss, v[1]);
      store(dst + 8 * ss + 8, v[2]);
      store(dst + 9 * ss + 8, v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int dd = dd0 + (k % 2) + 8 * (k / 2);
        if (dd >= 0 && dd < td) store(dst + (k % 2) * ss + (k / 2) * (8 * ss + 8), v[k]);
      }
    }
  }
}

// The scores of a DP's box: cell (i, d) of the box at diagonals d0 .. d0 +
// T - 1 and lanes i0 .. i0 + W - 1, diagonal-major in shared memory.
struct BoxScores {
  const float* hk;
  int ss, d0, i0;
  __device__ __forceinline__ float operator()(int d, int i) const {
    return hk[(d - d0) * ss + (i - i0)];
  }
};

// A DP's box on the tensor cores, by every thread of a CTA of W lanes (W a
// multiple of 32; each warp owns the m-tiles warp * 16 and warp * 16 + W /
// 2): the scores of lanes i0 .. i0 + W - 1 (lane i is row i - 1 of x, a row
// where 1 <= i <= Lx) and diagonals d0 .. d0 + td - 1 into hk (row stride
// ss), from the rows' limbs a_lo / a_hi [W][32 B] (a_hi read only when
// two_pass) and inverses ivx [W], and the band's columns j = d0 - i0 - W ..
// (W + td of them; the low limbs in `band`, the high limbs in `band_hi`,
// read only when `wide`, the inverses in `ivy`), each cell put by `store`.
// Ly: the problem's columns.  Every cell of the box is put once, by the
// same thread whatever the operands.
template <class Store = BoxStore>
__device__ __forceinline__ void fill_box(float* hk, int ss, int W, int td, const uint32_t* a_lo,
                                         const uint32_t* a_hi, bool two_pass, const float* ivx,
                                         const uint32_t* band, const uint32_t* band_hi,
                                         bool wide, const float* ivy, int i0, int d0, int Lx,
                                         int Ly, const Store& store = Store()) {
  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, t4 = lane & 3;
  for (int m0 = warp * 16; m0 < W; m0 += W / 2) {
    uint32_t alo[4], ahi[4];
    load_a(alo, a_lo, m0, g, t4);
    load_a(ahi, a_hi, m0, g, t4);
    float rivx[2];
    bool row_ok[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = i0 + m0 + g + 8 * q;
      row_ok[q] = i >= 1 && i <= Lx;
      rivx[q] = ivx[m0 + g + 8 * q];
    }
    const bool rows_all = i0 + m0 >= 1 && i0 + m0 + 15 <= Lx;
    const bool rows_none = i0 + m0 + 15 < 1 || i0 + m0 > Lx;
    box_rows(hk, ss, W, td, band, band_hi, wide, ivy, alo, ahi, two_pass, m0, g, t4, rivx,
             row_ok, rows_all, rows_none, d0 - i0 - W, Ly, store);
  }
}

}  // namespace
