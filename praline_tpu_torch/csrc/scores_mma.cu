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
// Design.  Two kernels on one stream (both, and the tile code of step 2,
// are in csrc/score_box.cuh, which csrc/fused_dp.cu shares).
//   prep: one thread a row of Cx or Cy.  A row of x becomes T = Cx @ S,
//      exact in int32, split into limbs T = 256 * T_hi + T_lo with
//      T_hi = T >> 8 (s8) and T_lo = T & 255 (u8), 32 bytes each (the
//      alphabet, zero padded to 32, is one k-step of the tensor core), and
//      a flag: some |T| of the row is past 127.  A row of y becomes the
//      limbs of its counts, Cy = 256 * Cy_hi + Cy_lo with Cy_hi = Cy >> 8
//      and Cy_lo = Cy & 255 (both u8, 32 bytes each), and a flag: some
//      count of the row is past 255 (the row is wide).
//   main: a block owns CHUNKS output boxes of one problem b, one after
//      another along the diagonals: TI lanes x TD diagonals each,
//      hs[d0:d0+TD, b, i0:i0+TI].  A box's cells need H[i, j] for the TI
//      rows i and the band of TI + TD - 1 columns j = d - i - 1.  The block
//      copies its rows' limbs once (cp.async) and keeps its A fragments in
//      registers; where no row is flagged, T itself is an s8 operand (the
//      low byte read as s8) and one pass suffices.  For each box it
//      1. waits for the box's band (Cy_lo columns and their inverses,
//         copied by cp.async while the previous box was computed and stored,
//         and the wide flags of those columns) and starts the copy of the
//         next box's band into the other buffer;
//      2. runs on the tensor cores, mma.sync m16n8k32 (s8 or u8 times u8,
//         s32 accumulate), the tiles of the TI x (TI + TD) rectangle
//         H_int = T @ Cy_band^T that hold cells of the box: one pass, or
//         two recombined as 256 * P_hi + P_lo in int32; a wide band (some
//         column flagged) runs the same passes again against Cy_hi and adds
//         256 times their sum (a tile with no cell of the problem, about half
//         of hs, skips the product; a tile of cells of the problem only
//         skips the checks).  Each element of a fragment is converted to
//         f32, scaled as __fmul_rn(__fmul_rn(h, inv_x), inv_y) (the pinned
//         order), or set to +0 off the problem, and written to its place in
//         the box, staged diagonal-major in shared memory (hk[dd][lane],
//         rows of SS floats; warp w computes rows 16w .. 16w + 15).  A wide
//         band's Cy_hi columns are copied once the band is known to be wide,
//         into the shared memory that staged the rows' limbs (the A
//         fragments are in registers by then), so a block keeps the shared
//         memory of four blocks an SM and a band with no wide column copies
//         and runs exactly what it did before Cy had two limbs;
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
// The tensor-core work is 2 * 16 * 8 * 32 * passes operations a tile (1 to
// 4 passes), about (TD + 15) / TD tiles a cell of the box: a few per cent
// of the card's int8 rate against the store's bytes at 3.35 TB/s.  The
// prep reads Cx and Cy once and writes 65 bytes a row of either side; the
// main kernel's loads are copies of those bytes (L2-resident), overlapped
// with the stores.
//
// Exactness: a proof that these kernels return the bits of the plain
// version whenever kernels/fused_scores.py::tensor_core_exact admits the
// operands.  The predicate requires (x: the Cx side over the chunk, y: the
// Cy side, m: the matrix):
//   (P1) every count of x and y is a non-negative integer, and S is integral;
//   (P2) y.cmax <= 65535                     (every Cy count: two u8 limbs)
//   (P3) x.tmax <= 32767                     (max |T| = max |(Cx @ S)[i, c]|)
//   (P4) x.tot * max(m.max_s, 1) < 2**31     (x.tot: largest column total)
//   (P5) x.tot * y.tot * m.max_s < 2**24     (oracle/score.py::check_exactness)
// Operands exact in their types.  By P1 and P4 each count of x is an integer
// of at most x.tot < 2**31, so __float2int_rn gives it exactly; S entries
// are integers of magnitude max_s <= 2**31 (P4), exact in int32.  Each Cy
// count is an integer in [0, 65535] (P1, P2): __float2uint_rn gives it
// exactly, and Cy_hi = Cy >> 8 and Cy_lo = Cy & 255 are in [0, 255], u8,
// with Cy = 256 * Cy_hi + Cy_lo.  A row with no count past 255 has Cy_hi = 0
// and Cy_lo = Cy.
// T exact.  Each partial sum of T[i, c] = sum_a Cx[i, a] * S[a, c] is
// bounded by sum_a Cx[i, a] * max_s <= x.tot * max_s < 2**31 (P1, P4), so
// the int32 loop never overflows and ends at the true T.
// Limbs exact.  By P3, T is in [-32767, 32767]; T >> 8 (arithmetic) is in
// [-128, 127], an s8, and T & 255 is in [0, 255], a u8, with
// T = 256 * (T >> 8) + (T & 255) for every int32 T.  When |T| <= 127 the
// low byte read as s8 is T itself.  Padded rows and columns are zero.
// Products exact.  For V either limb of Cy, the tensor core multiplies
// 8-bit integers into 16-bit products and sums the 32 of one k-step and the
// zero accumulator in s32: |P_hi| = |T_hi @ V^T| <= 32 * 128 * 255 < 2**20
// and 0 <= P_lo = T_lo @ V^T <= 32 * 255 * 255 < 2**21, far inside int32,
// so each sum is exact whatever the hardware's order, and so is
// 256 * P_hi + P_lo (< 2**29 in magnitude).  It equals
// G(V)[i, j] = sum_c T[i, c] * V[j, c] exactly (distributivity over the
// integers).  Where the band has no wide column, Cy_lo = Cy on it and
// G(Cy_lo) = H_int.  A wide band adds 256 * G(Cy_hi), and
// H_int = 256 * G(Cy_hi) + G(Cy_lo) since Cy = 256 * Cy_hi + Cy_lo.  Each
// term is bounded by the sum below: with 256 * Cy_hi <= Cy and Cy_lo <= Cy,
//   |256 * G(Cy_hi)[i, j]| <= sum_c |T[i, c]| * 256 * Cy_hi[j, c]
//                          <= sum_c |T[i, c]| * Cy[j, c]   (the same for G(Cy_lo)),
// so 256 * G(Cy_hi) (an int32 multiply) and the sum of the two terms are
// below 2**25 in magnitude: no partial sum leaves int32.
// Conversion exact.  |H_int| <= sum_c |T[i, c]| * Cy[j, c]
//   <= sum_c sum_a Cx[i, a] |S[a, c]| Cy[j, c] <= x.tot * y.tot * max_s
// < 2**24 (P5), and every integer below 2**24 in magnitude is an f32, so
// __int2float_rn(H_int) is exact.  The plain version's f32 products and sums
// are exact under the same bound (each partial sum is an integer below
// 2**24), so both hold the same f32 H; both then round the same two
// multiplies in the same order, and both write +0 off the problem: the same
// bits.  The scalar kernel (csrc/scores.cu) serves what P1-P5 refuse:
// dyadic or fractional counts, a fractional S, counts past 65535, |T| past
// 32767, and the accumulation bounds P4 and P5.

#include <cuda_runtime.h>
#include <stdint.h>

#include "score_box.cuh"

namespace {

constexpr int MAXA = BOX_MAXA;      // largest alphabet: one k-step of 32 bytes
constexpr int TI = 128;             // lanes a block
constexpr int TD = 64;              // diagonals a box
constexpr int CHUNKS = 2;           // boxes a block
constexpr int NT = 256;             // threads a block: warp w owns rows 16w..16w+15
constexpr int W = TI + TD;          // band columns (TI + TD - 1 used), 24 n-tiles
constexpr int SS = TI + 4;          // row stride of the staged box, in floats
static_assert(SS % 32 == 4, "conflict-free fragment stores, 16-byte rows");
static_assert(NT / 32 * 16 == TI, "one 16-row m-tile a warp");
static_assert(W % 8 == 0 && TI == 32 * 4, "whole n-tiles; one warp of float4 a diagonal");

struct Smem {
  float hk[TD * SS];           // the box, scaled, diagonal-major
  // The block's rows' limbs, a_lo (T & 255: u8, or s8 = T in one-pass
  // blocks) then a_hi (T >> 8, s8), until they are in registers; then a
  // wide band's Cy_hi columns (u8, 32 bytes a column).
  uint32_t rows[2 * TI * KW];
  uint32_t band[2][W * KW];    // Cy_lo band, u8, 32 bytes a column; two buffers
  float ivy[2][W];
};
static_assert(W <= 2 * TI, "a band's Cy_hi columns fit where the rows' limbs were staged");

__global__ void __launch_bounds__(NT, 4) skewed_scores_mma_kernel(
    const MmaOperands op, const float* __restrict__ inv_x, const float* __restrict__ inv_y,
    float* __restrict__ hs, int B, int Lx, int Ly, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  uint32_t* const a_lo = sm.rows;
  uint32_t* const a_hi = sm.rows + TI * KW;
  uint32_t* const band_hi = sm.rows;

  const int Lp = Lx + 1;
  const int D = Lx + Ly + 1;
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * TI;
  const int dfirst = blockIdx.y * TD * CHUNKS;
  const int b = blockIdx.z;
  const YRows y = y_rows(op, inv_y, b, Ly);
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
    copy_async<16>(&a_lo[4 * p], op.xlo + 2 * row + p % 2, ok);
    copy_async<16>(&a_hi[4 * p], op.xhi + 2 * row + p % 2, ok);
    if (p % 2 == 0 && ok) wide |= op.xwide[row] != 0;
  }
  start_band(sm.band[0], nullptr, sm.ivy[0], y, dfirst + jshift, W, Ly, tid, NT);
  bool band_wide = band_flags(y, dfirst + jshift, W, Ly, tid, NT);

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
  const bool rows_all = i0 + m0 >= 1 && i0 + m0 + 15 <= Lx;
  const bool rows_none = i0 + m0 + 15 < 1 || i0 + m0 > Lx;

  copy_wait_all();
  const bool two_pass = __syncthreads_or(wide);
  uint32_t alo[4], ahi[4];
  load_a(alo, a_lo, m0, g, t4);
  load_a(ahi, a_hi, m0, g, t4);
  // Every warp holds its rows in registers: a wide band's Cy_hi columns
  // may go where they were staged.
  band_wide = __syncthreads_or(band_wide);
  if (band_wide) {
    copy_rows(band_hi, y.hi, dfirst + jshift, W, Ly, tid, NT);
    copy_commit();
  }

  for (int chunk = 0; chunk < CHUNKS; ++chunk) {
    const int d0 = dfirst + chunk * TD;
    if (d0 >= D) break;  // uniform over the block
    const int buf = chunk % 2;
    if (chunk > 0 || band_wide) {
      copy_wait_all();
      __syncthreads();  // the band (and its Cy_hi columns) landed; the copy of hk is done
    }
    // 1. The next box's band into the other buffer, in flight meanwhile.
    bool next_wide = false;
    if (chunk + 1 < CHUNKS && d0 + TD < D) {
      start_band(sm.band[buf ^ 1], nullptr, sm.ivy[buf ^ 1], y, d0 + TD + jshift, W, Ly, tid, NT);
      next_wide = band_flags(y, d0 + TD + jshift, W, Ly, tid, NT);
    }
    // 2. The rectangle's tiles on the tensor cores, each element scaled
    //    into its place in hk.
    box_rows(sm.hk, SS, TI, TD, sm.band[buf], band_hi, band_wide, sm.ivy[buf], alo, ahi,
             two_pass, m0, g, t4, ivx, row_ok, rows_all, rows_none, d0 + jshift, Ly);
    // Every warp is done with this band: the next band's Cy_hi columns,
    // where it is wide, go in place of this one's.
    band_wide = __syncthreads_or(next_wide);
    if (band_wide) {
      copy_rows(band_hi, y.hi, d0 + TD + jshift, W, Ly, tid, NT);
      copy_commit();
    }
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

// hs must hold D * B * (Lx+1) floats, scratch 65 * B * (Lx + Ly) bytes,
// 16-byte aligned (kernels/fused_scores.py::mma_scratch_bytes).  The operands must satisfy
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
  // scratch: y's limbs, x's limbs, then x's and y's flags
  const MmaOperands op = mma_operands(scratch, B, Lx, Ly);
  cudaError_t err = (cudaError_t)launch_mma_prep(cx, cy, s, op, B, Lx, Ly, A, st);
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
  skewed_scores_mma_kernel<<<grid, NT, smem, st>>>(op, inv_x, inv_y, hs, B, Lx, Ly, vec);
  return (int)cudaGetLastError();
}
