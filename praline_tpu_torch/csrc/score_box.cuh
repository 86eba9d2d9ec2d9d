// Score boxes on Hopper's integer tensor cores, shared by the kernels that
// compute pair scores with mma.sync: csrc/scores_mma.cu (the producer's
// "mma" tier, which stores each box to hs) and csrc/fused_dp.cu (the fused
// DP's "mma" tier, which keeps each box in shared memory for its own steps).
//
// A box is TW lanes x TD diagonals of one problem, cells (i0 + m, d0 + dd)
// with score hs[d0 + dd, b, i0 + m] = ((Cx @ S @ Cy^T)[i-1, j] * inv_x) * inv_y,
// j = d - i - 1, +0 off the problem.  Its cells need H[i, j] for TW rows and
// the band of TW + TD - 1 columns j = d0 - i0 - TW + c, c = 0 .. TW + TD - 1.
// Rectangle element (m, c) of H_int = T_rows @ band^T is cell (dd, m) with
// dd = c + m - TW + 1.  A warp computes the 16-row m-tiles it owns with
// m16n8k32 tiles (s8 or u8 limbs of T times u8 counts of Cy, s32
// accumulate), scales each element in the pinned order and writes it to its
// place in the box, staged diagonal-major: hk[dd * SS + m].  The proof that
// this gives the plain version's bits under fused_scores.tensor_core_exact
// is in csrc/scores_mma.cu.
//
// Also here: the prep kernel that writes the operands (T's limbs and a
// one-pass flag a row of x, u8 counts a row of y) and the cp.async helpers.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

// cp.async of `bytes` (4 or 16) from global to shared; where `valid` is
// false nothing is read (src-size 0: the destination is zero-filled).
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n));
  }
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void copy_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

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

// The prep kernel's output in the caller's scratch, 16-byte aligned: y's u8
// rows (32 bytes each), then x's low limbs, high limbs (32 bytes a row
// each) and one-pass flags (a byte a row); kernels/fused_scores.py::
// mma_scratch_bytes counts it.
struct MmaOperands {
  uint4* ybytes;
  uint4* xlo;
  uint4* xhi;
  unsigned char* xwide;
};

inline MmaOperands mma_operands(void* scratch, int B, int Lx, int Ly) {
  unsigned char* base = static_cast<unsigned char*>(scratch);
  unsigned char* xs = base + 32LL * B * Ly;
  uint4* xlo = reinterpret_cast<uint4*>(xs);
  return MmaOperands{reinterpret_cast<uint4*>(base), xlo, xlo + 2LL * B * Lx,
                     xs + 64LL * B * Lx};
}

// One thread a row: rows of x (item < B * Lx) to T's limbs and flag, rows
// of y to u8 counts.
__global__ void __launch_bounds__(PREP_NT) skewed_scores_mma_prep_kernel(
    const float* __restrict__ cx, const float* __restrict__ cy, const float* __restrict__ s,
    uint4* __restrict__ xlo, uint4* __restrict__ xhi, unsigned char* __restrict__ xwide,
    uint4* __restrict__ ybytes, long long nx, long long ny, int A) {
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
    xlo[2 * item] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    xlo[2 * item + 1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
    xhi[2 * item] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    xhi[2 * item + 1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    xwide[item] = wide;
  } else if (item < nx + ny) {
    const long long j = item - nx;
    const float* row = cy + j * A;
    uint32_t v[KW];
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      v[w] = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * w + k < A) v[w] |= (__float2uint_rn(row[4 * w + k]) & 0xffu) << (8 * k);
    }
    ybytes[2 * j] = make_uint4(v[0], v[1], v[2], v[3]);
    ybytes[2 * j + 1] = make_uint4(v[4], v[5], v[6], v[7]);
  }
}

// Launches the prep kernel for B problems of Lx x Ly; returns
// cudaGetLastError().
inline int launch_mma_prep(const float* cx, const float* cy, const float* s,
                           const MmaOperands& op, int B, int Lx, int Ly, int A,
                           cudaStream_t st) {
  const long long nx = (long long)B * Lx, ny = (long long)B * Ly;
  skewed_scores_mma_prep_kernel<<<(unsigned)((nx + ny + PREP_NT - 1) / PREP_NT), PREP_NT, 0,
                                  st>>>(cx, cy, s, op.xlo, op.xhi, op.xwide, op.ybytes, nx, ny,
                                        A);
  return (int)cudaGetLastError();
}

// Start the copy of one box's band: `cols` columns j = jbase .. jbase +
// cols - 1 of a problem (u8 rows of 32 bytes, two 16-byte pieces a column)
// and their inverses, by `nthreads` threads; columns off the problem are
// zero-filled (their cells are +0).  Commits one cp.async group.
__device__ __forceinline__ void start_band(uint32_t* band, float* ivy, const uint4* __restrict__ yb,
                                           const float* __restrict__ ivyb, int jbase, int cols,
                                           int Ly, int tid, int nthreads) {
  for (int p = tid; p < 2 * cols; p += nthreads) {
    const int j = jbase + p / 2;
    const bool ok = j >= 0 && j < Ly;
    copy_async<16>(&band[4 * p], ok ? yb + 2 * j + p % 2 : yb, ok);
  }
  for (int r = tid; r < cols; r += nthreads) {
    const int j = jbase + r;
    const bool ok = j >= 0 && j < Ly;
    copy_async<4>(&ivy[r], ok ? ivyb + j : ivyb, ok);
  }
  copy_commit();
}

// Rows m0 .. m0 + 15 of a box of tw lanes x td diagonals into hk (row
// stride ss floats): the n-tiles of the band (tw + td columns, u8 rows in
// `band`, inverses in `ivy`) whose columns hold cells of the box, on the
// tensor cores, each element scaled into its place or set to +0 off the
// problem.  alo / ahi: the rows' A fragments (ahi read only when
// two_pass); ivx / row_ok: rows m0 + g and m0 + g + 8 (g = lane / 4, t4 =
// lane % 4); rows_all / rows_none: every / no row of the m-tile is a row
// of x; jbase: column 0's j; Ly: the problem's columns.  Warp-uniform.
__device__ __forceinline__ void box_rows(float* hk, int ss, int tw, int td,
                                         const uint32_t* band, const float* ivy,
                                         const uint32_t (&alo)[4], const uint32_t (&ahi)[4],
                                         bool two_pass, int m0, int g, int t4,
                                         const float (&ivx)[2], const bool (&row_ok)[2],
                                         bool rows_all, bool rows_none, int jbase, int Ly) {
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
      const uint32_t b0 = band[(n0 + g) * KW + t4];
      const uint32_t b1 = band[(n0 + g) * KW + 4 + t4];
      int h[4];
      if (two_pass) {
        int ph[4], pl[4];
        mma_s8u8(ph, ahi, b0, b1);
        mma_u8u8(pl, alo, b0, b1);
#pragma unroll
        for (int k = 0; k < 4; ++k) h[k] = ph[k] * 256 + pl[k];
      } else {
        mma_s8u8(h, alo, b0, b1);
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
      dst[0] = v[0];
      dst[ss] = v[1];
      dst[8 * ss + 8] = v[2];
      dst[9 * ss + 8] = v[3];
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int dd = dd0 + (k % 2) + 8 * (k / 2);
        if (dd >= 0 && dd < td) dst[(k % 2) * ss + (k / 2) * (8 * ss + 8)] = v[k];
      }
    }
  }
}

}  // namespace
