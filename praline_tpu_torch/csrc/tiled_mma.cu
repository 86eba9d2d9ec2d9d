// The lane-tiled DP (K6, csrc/tiled_dp.cu) on the rows source's "mma" tier
// for Hopper (sm_90a): each visit's box of scores on the int8 tensor cores
// (csrc/rows_box.cuh), for the rows past the batch aligner's hs budget that
// kernels/fused_scores.py::tensor_core_exact admits.  Replaces, with
// csrc/tiled_dp.cu, the TPU kernel praline_tpu/kernels/pallas_dp_tiled.py:448
// wavefront_dp_tiled and the streamed scan praline_tpu/kernels/scan.py:106
// (wavefront_dp_streamed) that the JAX package takes for such rows.  The
// contract is csrc/tiled_dp.cu's, bit for bit: the plain DP over
// kernels/scores.py::skewed_pair_scores.
//
// Also here, for every in-place launch of K6 on either tier:
// praline_tiled_prep, the operands a chunk's launches share (made once a
// chunk: the checkpointed route's forward and resume launches and a ring
// rank's supersteps all read one).
//
// What bounds it on the H100: the chain of dependent diagonals, as on the
// hs source; the box of a visit (T diagonals x W lanes: W / 16 m-tiles of
// about (16 + T) / 8 n-tiles of mma.sync each) is filled by every warp
// before the visit's steps, from operands copied while the visit before it
// stepped.  Its own translation unit, so that its kernels build beside
// csrc/tiled_dp.cu's.

#include "hs_visits.cuh"
#include "tiled_walk.cuh"
#include "rows_box.cuh"

namespace {

// Block b: pwide[b] = 1 where a row of problem b's y holds a count past
// 255 (the prep's ywide flags), else left as it was.
__global__ void __launch_bounds__(PREP_NT) problem_flags_kernel(const unsigned char* ywide,
                                                                unsigned char* pwide, int Ly) {
  const unsigned char* yw = ywide + (size_t)blockIdx.x * Ly;
  bool wide = false;
  for (int j = threadIdx.x; j < Ly; j += PREP_NT) wide |= yw[j] != 0;
  if (__syncthreads_or(wide) && threadIdx.x == 0) pwide[blockIdx.x] = 1;
}

}  // namespace

// The operands of an in-place source for B problems of Lx x Ly: cx f32[B,
// Lx, A], cy f32[B, Ly, A], s f32[A, A] (A <= 32) into scratch, 16-byte
// aligned: tier 0 ("mma") kernels/fused_scores.py::mma_scratch_bytes(B, Lx,
// Ly) bytes of limbs and flags (csrc/score_box.cuh MmaOperands), and pwide
// u8[B] or-ed with whether a count of problem b's y passes 255 (zeroed by
// the caller, once for all the tracks of a composite); tier 1 ("scalar")
// T rows f32[B, Lx, AP] then Cy rows f32[B, Ly, AP] (AP = A rounded up to
// 4; csrc/fused_rows.cuh), pwide unused.  Returns cudaGetLastError() after
// the launches, or cudaErrorInvalidValue for arguments it does not take.
extern "C" int praline_tiled_prep(const float* cx, const float* cy, const float* s, int B,
                                  int Lx, int Ly, int A, int tier, void* scratch,
                                  unsigned char* pwide, void* stream) {
  if (B < 1 || Lx < 1 || Ly < 1 || A < 1 || A > MAXA || (tier != 0 && tier != 1) || !scratch ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0 || (tier == 0 && !pwide))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (tier == 1) {
    float* t = static_cast<float*>(scratch);
    return launch_prep(cx, cy, s, t, t + (size_t)B * Lx * padded_alphabet(A), B, Lx, Ly, A, st);
  }
  const MmaOperands op = mma_operands(scratch, B, Lx, Ly);
  const int rc = launch_mma_prep(cx, cy, s, op, B, Lx, Ly, A, st);
  if (rc != 0) return rc;
  problem_flags_kernel<<<B, PREP_NT, 0, st>>>(op.ywide, pwide, Ly);
  return (int)cudaGetLastError();
}

// How many clusters of R CTAs of W threads and m tiles (k levels, T) of
// the rows source's "mma" launches the card holds at once, into *clusters.
extern "C" int praline_tiled_mma_clusters(int k, int W, int R, int m, int T, int* clusters) {
  return box_clusters<false, 1>(k, W, R, m, T, clusters);
}

// csrc/tiled_dp.cu's praline_tiled_dp_rows on the "mma" tier: ops the
// scratch of praline_tiled_prep on tier 0 and pwide its problem flags (AP
// unused).
extern "C" int praline_tiled_mma_rows(const void* ops, const unsigned char* pwide,
                                      const float* inv_x, const float* inv_y, const int* lx,
                                      const int* ly, const float* gaps_host, int k, int mode,
                                      int traceback, int B, int Lx, int Ly, int /*AP*/, int W,
                                      int R, int m, int T, float* carry, float* score,
                                      float* length, int* ti, int* tj, int* tcode, uint8_t* tb,
                                      void* stream) {
  return rows_launch<false>(ops, pwide, inv_x, inv_y, lx, ly, gaps_host, k, mode, traceback, B,
                            Lx, Ly, W, R, m, T, carry, Outs{score, length, ti, tj, tcode, tb},
                            nullptr, 0, -1, 0.0f, stream);
}
