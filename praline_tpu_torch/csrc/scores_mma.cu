// Skewed pair-score producer on Hopper's integer tensor cores (sm_90a).
//
// The "mma" tier of the producer: the same function as csrc/scores.cu (it
// replaces the same TPU kernels, praline_tpu/kernels/fused_scores.py
// ::fused_skewed_scores and ::fused_skewed_scores_strip, whose MXU tiers
// "fast"/"fast1" it stands for on this card), with the same output:
//
//     hs[d, b, i] = ((Cx[b] @ S @ Cy[b]^T)[i-1, d-i-1] * inv_x) * inv_y
//
// for 1 <= i <= Lx, 0 <= d-i-1 < Ly, and +0 elsewhere; hs is f32[D, B, Lx+1]
// with D = Lx + Ly + 1 (kernels/scores.py::skewed_pair_scores).
//
// Design.  Two kernels on one stream.
//   prep: one thread a row of Cx or Cy.  A row of x becomes T = Cx @ S,
//      exact in int32, split into limbs T = 256 * T_hi + T_lo with
//      T_hi = T >> 8 (s8) and T_lo = T & 255 (u8), 32 bytes each (the
//      alphabet, zero padded to 32, is one k-step of the tensor core), and
//      a flag: some |T| of the row is past 127.  A row of y becomes its
//      counts as u8, 32 bytes.
//   main: a block owns CHUNKS output boxes of one problem b, one after
//      another along the diagonals: TI lanes x TD diagonals each,
//      hs[d0:d0+TD, b, i0:i0+TI].  A box's cells need H[i, j] for the TI
//      rows i and the band of TI + TD - 1 columns j = d - i - 1.  The block
//      copies its rows' limbs once (cp.async); where no row is flagged, T
//      itself is an s8 operand (the low byte read as s8) and one pass
//      suffices.  For each box it
//      1. waits for the box's band (u8 columns and their inverses, copied
//         by cp.async while the previous box was computed and stored) and
//         starts the copy of the next box's band into the other buffer;
//      2. runs on the tensor cores, mma.sync m16n8k32 (s8 or u8 times u8,
//         s32 accumulate), the tiles of the TI x (TI + TD) rectangle
//         H_int = T @ Cy_band^T that hold cells of the box: one pass, or
//         two recombined as 256 * P_hi + P_lo in int32 (a tile with no cell
//         of the problem, about half of hs, skips the product; a tile of
//         cells of the problem only skips the checks).  Each element of a
//         fragment is converted to f32, scaled as
//         __fmul_rn(__fmul_rn(h, inv_x), inv_y) (the pinned order), or set
//         to +0 off the problem, and written to its place in the box,
//         staged diagonal-major in shared memory (hk[dd][lane], rows of SS
//         floats; warp w computes rows 16w .. 16w + 15);
//      3. copies the box to hs: each diagonal's TI lanes are 512
//         contiguous bytes, one warp a diagonal, 16 bytes a thread where
//         the rows allow it (Lx + 1 a multiple of 4).  Zero cells are
//         written by the same pass, so hs needs no memset.
// SS = TI + 4 = 132: SS % 32 == 4 makes a fragment's scattered stores
// (thread g, t of a warp to row dd = c + m - TI + 1, column m: bank
// 8t + 5g + const mod 32) hit 32 distinct banks, and keeps every row 16-byte
// aligned for the copy's 16-byte reads.
//
// What bounds it on the H100: the store of hs, D * (Lx+1) f32 a problem.
// The tensor-core work is 2 * 16 * 8 * 32 * passes operations a tile, about
// (TD + 15) / TD tiles a cell of the box: a few per cent of the card's int8
// rate against the store's bytes at 3.35 TB/s.  The prep reads Cx and Cy
// once and writes 97 bytes a row pair; the main kernel's loads are copies
// of those bytes (L2-resident), overlapped with the stores.
//
// Exactness: a proof that these kernels return the bits of the plain
// version whenever kernels/fused_scores.py::tensor_core_exact admits the
// operands.  The predicate requires (x: the Cx side over the chunk, y: the
// Cy side, m: the matrix):
//   (P1) every count of x and y is a non-negative integer, and S is integral;
//   (P2) y.cmax <= 255                       (every Cy count)
//   (P3) x.tmax <= 32767                     (max |T| = max |(Cx @ S)[i, c]|)
//   (P4) x.tot * max(m.max_s, 1) < 2**31     (x.tot: largest column total)
//   (P5) x.tot * y.tot * m.max_s < 2**24     (oracle/score.py::check_exactness)
// Operands exact in their types.  By P1 and P4 each count of x is an integer
// of at most x.tot < 2**31, so __float2int_rn gives it exactly; S entries
// are integers of magnitude max_s <= 2**31 (P4), exact in int32.  Each Cy
// count is an integer in [0, 255] (P1, P2), exact as u8.
// T exact.  Each partial sum of T[i, c] = sum_a Cx[i, a] * S[a, c] is
// bounded by sum_a Cx[i, a] * max_s <= x.tot * max_s < 2**31 (P1, P4), so
// the int32 loop never overflows and ends at the true T.
// Limbs exact.  By P3, T is in [-32767, 32767]; T >> 8 (arithmetic) is in
// [-128, 127], an s8, and T & 255 is in [0, 255], a u8, with
// T = 256 * (T >> 8) + (T & 255) for every int32 T.  When |T| <= 127 the
// low byte read as s8 is T itself.  Padded rows and columns are zero.
// Products exact.  The tensor core multiplies 8-bit integers into 16-bit
// products and sums the 32 of one k-step and the zero accumulator in s32:
// |P_hi| <= 32 * 128 * 255 < 2**20 and 0 <= P_lo <= 32 * 255 * 255 < 2**21,
// far inside int32, so each sum is exact whatever the hardware's order,
// and so is 256 * P_hi + P_lo (< 2**29 in magnitude).  It equals
// sum_c T[i, c] * Cy[j, c] = H_int[i, j] exactly (distributivity over the
// integers).
// Conversion exact.  |H_int| <= sum_c |T[i, c]| * Cy[j, c]
//   <= sum_c sum_a Cx[i, a] |S[a, c]| Cy[j, c] <= x.tot * y.tot * max_s
// < 2**24 (P5), and every integer below 2**24 in magnitude is an f32, so
// __int2float_rn(H_int) is exact.  The plain version's f32 products and sums
// are exact under the same bound (each partial sum is an integer below
// 2**24), so both hold the same f32 H; both then round the same two
// multiplies in the same order, and both write +0 off the problem: the same
// bits.  The scalar kernel (csrc/scores.cu) serves what P1-P5 refuse.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXA = 32;            // largest alphabet: one k-step of 32 bytes
constexpr int TI = 128;             // lanes a block
constexpr int TD = 64;              // diagonals a box
constexpr int CHUNKS = 2;           // boxes a block
constexpr int NT = 256;             // threads a block: warp w owns rows 16w..16w+15
constexpr int W = TI + TD;          // band columns (TI + TD - 1 used), 24 n-tiles
constexpr int SS = TI + 4;          // row stride of the staged box, in floats
constexpr int KW = MAXA / 4;        // 32-bit words of one 32-byte operand row
constexpr int PREP_NT = 128;        // threads a block of the prep kernel
static_assert(SS % 32 == 4, "conflict-free fragment stores, 16-byte rows");
static_assert(NT / 32 * 16 == TI, "one 16-row m-tile a warp");
static_assert(W % 8 == 0 && TI == 32 * 4, "whole n-tiles; one warp of float4 a diagonal");

struct Smem {
  float hk[TD * SS];           // the box, scaled, diagonal-major
  uint32_t a_lo[TI * KW];      // T & 255: u8, or s8 (= T) in one-pass blocks
  uint32_t a_hi[TI * KW];      // T >> 8, s8
  uint32_t band[2][W * KW];    // Cy band, u8, 32 bytes a column; two buffers
  float ivy[2][W];
};

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

// One thread a row: rows of x (item < B * Lx) to T's limbs and flag, rows
// of y to u8 counts.
__global__ void __launch_bounds__(PREP_NT) skewed_scores_mma_prep_kernel(
    const float* __restrict__ cx, const float* __restrict__ cy, const float* __restrict__ s,
    uint4* __restrict__ xlo, uint4* __restrict__ xhi, unsigned char* __restrict__ xwide,
    uint4* __restrict__ ybytes, long long nx, long long ny, int A) {
  // S as int32, zero padded to MAXA x MAXA: row a is 8 int4 (broadcast reads)
  __shared__ int4 s_sh[MAXA * MAXA / 4];
  int* s_int = reinterpret_cast<int*>(s_sh);
  for (int idx = threadIdx.x; idx < MAXA * MAXA; idx += PREP_NT) {
    const int a = idx / MAXA, col = idx % MAXA;
    s_int[idx] = a < A && col < A ? __float2int_rn(s[a * A + col]) : 0;
  }
  __syncthreads();
  const long long item = (long long)blockIdx.x * PREP_NT + threadIdx.x;
  if (item < nx) {
    const float* row = cx + item * A;
    // T's row, a row of S at a time: A x (8 loads, 32 multiply-adds)
    int t[MAXA];
#pragma unroll
    for (int col = 0; col < MAXA; ++col) t[col] = 0;
#pragma unroll
    for (int a = 0; a < MAXA; ++a) {
      if (a >= A) break;  // uniform
      const int c = __float2int_rn(row[a]);
#pragma unroll
      for (int q = 0; q < MAXA / 4; ++q) {
        const int4 sv = s_sh[a * (MAXA / 4) + q];
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

// Start the copy of one box's band: columns j = jbase .. jbase + W - 1 of
// problem b (u8 rows of 32 bytes, two 16-byte pieces a column) and their
// inverses; columns off the problem are zero-filled (their cells are +0).
__device__ __forceinline__ void start_band(Smem& sm, int buf, const uint4* __restrict__ yb,
                                           const float* __restrict__ ivyb, int jbase, int Ly,
                                           int tid) {
  for (int p = tid; p < 2 * W; p += NT) {
    const int j = jbase + p / 2;
    const bool ok = j >= 0 && j < Ly;
    copy_async<16>(&sm.band[buf][4 * p], ok ? yb + 2 * j + p % 2 : yb, ok);
  }
  for (int r = tid; r < W; r += NT) {
    const int j = jbase + r;
    const bool ok = j >= 0 && j < Ly;
    copy_async<4>(&sm.ivy[buf][r], ok ? ivyb + j : ivyb, ok);
  }
  copy_commit();
}

__global__ void __launch_bounds__(NT, 4) skewed_scores_mma_kernel(
    const unsigned char* __restrict__ scratch_x, const float* __restrict__ inv_x,
    const uint4* __restrict__ ybytes, const float* __restrict__ inv_y, float* __restrict__ hs,
    int B, int Lx, int Ly, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const uint4* xlo = reinterpret_cast<const uint4*>(scratch_x);
  const uint4* xhi = xlo + 2 * (size_t)B * Lx;
  const unsigned char* xwide = scratch_x + 64 * (size_t)B * Lx;

  const int Lp = Lx + 1;
  const int D = Lx + Ly + 1;
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * TI;
  const int dfirst = blockIdx.y * TD * CHUNKS;
  const int b = blockIdx.z;
  const uint4* yb = ybytes + 2 * (size_t)b * Ly;
  const float* ivyb = inv_y + (size_t)b * Ly;
  // Column c of a box's band is j = d0 - i0 - TI + c; lane i0 + m at
  // diagonal d0 + dd reads j = d0 + dd - i0 - m - 1, i.e. column
  // c = dd + TI - 1 - m: rectangle element (m, c) is cell (dd, m) with
  // dd = c + m - TI + 1.
  const int jshift = -i0 - TI;

  // The block's rows (lane i0 + m is row i0 + m - 1 of x): their limbs,
  // and whether any needs the second pass; the first box's band.
  bool wide = false;
  for (int p = tid; p < 2 * TI; p += NT) {
    const int m = p / 2, i = i0 + m;
    const bool ok = i >= 1 && i <= Lx;
    const size_t row = (size_t)b * Lx + (ok ? i - 1 : 0);
    copy_async<16>(&sm.a_lo[4 * p], xlo + 2 * row + p % 2, ok);
    copy_async<16>(&sm.a_hi[4 * p], xhi + 2 * row + p % 2, ok);
    if (p % 2 == 0 && ok) wide |= xwide[row] != 0;
  }
  start_band(sm, 0, yb, ivyb, dfirst + jshift, Ly, tid);

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int m0 = warp * 16;
  // This warp's rows m0 + g and m0 + g + 8: their inverses and whether
  // they are rows of x.
  float ivx[2];
  bool row_ok[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int i = i0 + m0 + g + 8 * k;
    row_ok[k] = i >= 1 && i <= Lx;
    ivx[k] = row_ok[k] ? inv_x[(size_t)b * Lx + i - 1] : 1.0f;
  }
  // The n-tiles whose columns hold cells of the box for rows m0..m0+15:
  // c in [TI - 16 - m0, TI - 1 - m0 + TD).
  const int ntile_lo = (TI - 16 - m0) / 8;
  const bool rows_all = i0 + m0 >= 1 && i0 + m0 + 15 <= Lx;
  const bool rows_none = i0 + m0 + 15 < 1 || i0 + m0 > Lx;
  const int ntile_hi = min(W / 8, (TI - 1 - m0 + TD + 7) / 8);

  copy_wait_all();
  const bool two_pass = __syncthreads_or(wide);
  uint32_t alo[4], ahi[4];
  load_a(alo, sm.a_lo, m0, g, t4);
  load_a(ahi, sm.a_hi, m0, g, t4);

  for (int chunk = 0; chunk < CHUNKS; ++chunk) {
    const int d0 = dfirst + chunk * TD;
    if (d0 >= D) break;  // uniform over the block
    const int buf = chunk % 2;
    if (chunk > 0) {
      copy_wait_all();
      __syncthreads();  // the band has landed, and the copy of hk is done
    }
    // 1. The next box's band into the other buffer, in flight meanwhile.
    if (chunk + 1 < CHUNKS && d0 + TD < D) start_band(sm, buf ^ 1, yb, ivyb, d0 + TD + jshift, Ly, tid);
    // 2. The rectangle's tiles on the tensor cores, each element scaled
    //    into its place in hk.
    const int jbase = d0 + jshift;
    const uint32_t* band = sm.band[buf];
    const float* ivy = sm.ivy[buf];
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
      // element (m, c) to cell (dd = c + m - TI + 1, lane m) where dd is in the box
      const int dd0 = n0 + 2 * t4 + m0 + g - TI + 1;  // of element k = 0
      float* dst = &sm.hk[dd0 * SS + m0 + g];
      if (n0 + m0 - TI + 1 >= 0 && n0 + m0 - TI + 1 + 22 < TD) {  // the whole tile in the box
        dst[0] = v[0];
        dst[SS] = v[1];
        dst[8 * SS + 8] = v[2];
        dst[9 * SS + 8] = v[3];
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int dd = dd0 + (k % 2) + 8 * (k / 2);
          if (dd >= 0 && dd < TD) dst[(k % 2) * SS + (k / 2) * (8 * SS + 8)] = v[k];
        }
      }
    }
    __syncthreads();
    // 3. The box to hs: warp w stores diagonals w, w + 8, ...
    const int dmax = min(TD, D - d0);
    if (vec) {
      const int i = i0 + 4 * lane;
      if (i < Lp) {
        for (int dd = warp; dd < dmax; dd += NT / 32)
          *reinterpret_cast<float4*>(&hs[((size_t)(d0 + dd) * B + b) * Lp + i]) =
              *reinterpret_cast<const float4*>(&sm.hk[dd * SS + 4 * lane]);
      }
    } else {
      for (int dd = warp; dd < dmax; dd += NT / 32) {
#pragma unroll
        for (int k = 0; k < TI / 32; ++k) {
          const int m = lane + 32 * k;
          if (i0 + m < Lp) hs[((size_t)(d0 + dd) * B + b) * Lp + i0 + m] = sm.hk[dd * SS + m];
        }
      }
    }
  }
}

}  // namespace

// hs must hold D * B * (Lx+1) floats, scratch 32 * B * Ly + 65 * B * Lx
// bytes, 16-byte aligned (kernels/fused_scores.py::mma_scratch_bytes).  The operands must satisfy
// kernels/fused_scores.py::tensor_core_exact (see the proof above); the
// wrapper launches these kernels only for tier "mma".  Returns
// cudaGetLastError() after the launches (0 = launched), or
// cudaErrorInvalidValue for shapes the kernels do not take.
extern "C" int praline_skewed_scores_mma(const float* cx, const float* inv_x,
                                         const float* cy, const float* inv_y,
                                         const float* s, float* hs, void* scratch, int B,
                                         int Lx, int Ly, int A, void* stream) {
  if (B < 1 || Lx < 1 || Ly < 1 || A < 1 || A > MAXA || B > 65535 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  // scratch: y's u8 rows, then x's low limbs, high limbs and flags
  unsigned char* base = static_cast<unsigned char*>(scratch);
  uint4* ybytes = reinterpret_cast<uint4*>(base);
  unsigned char* xs = base + 32LL * B * Ly;
  uint4* xlo = reinterpret_cast<uint4*>(xs);
  uint4* xhi = xlo + 2LL * B * Lx;
  unsigned char* xwide = xs + 64LL * B * Lx;
  const long long nx = (long long)B * Lx, ny = (long long)B * Ly;
  skewed_scores_mma_prep_kernel<<<(unsigned)((nx + ny + PREP_NT - 1) / PREP_NT), PREP_NT, 0,
                                  st>>>(cx, cy, s, xlo, xhi, xwide, ybytes, nx, ny, A);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int smem = (int)sizeof(Smem);
  err = cudaFuncSetAttribute(skewed_scores_mma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // 16-byte stores where every row of lanes starts 16-byte aligned
  const bool vec = (Lx + 1) % 4 == 0 && reinterpret_cast<uintptr_t>(hs) % 16 == 0;
  const int Lp = Lx + 1;
  const int D = Lx + Ly + 1;
  if ((D + TD * CHUNKS - 1) / (TD * CHUNKS) > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((Lp + TI - 1) / TI, (D + TD * CHUNKS - 1) / (TD * CHUNKS), B);
  skewed_scores_mma_kernel<<<grid, NT, smem, st>>>(xs, inv_x, ybytes, inv_y, hs, B, Lx, Ly,
                                                    vec);
  return (int)cudaGetLastError();
}
