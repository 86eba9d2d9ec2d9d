// Fused score producer + wavefront DP for Hopper (sm_90a): the DP computes
// each cell's score where it consumes it, so the skewed score tensor hs
// never exists in device memory.
//
// Replaces three JAX functions that compute the same thing,
// kernels/scan.py::wavefront_dp over kernels/scores.py::skewed_pair_scores,
// without holding the score matrix in device memory:
//   praline_tpu/kernels/fused_dp.py:70   wavefront_dp_fused (a 128-diagonal
//                                        score band in VMEM, Pallas),
//   praline_tpu/kernels/chunked.py:26    wavefront_dp_chunked (one band
//                                        chunk of hs at a time, DP carries
//                                        across chunks),
//   praline_tpu/kernels/scan.py:106      wavefront_dp_streamed (each
//                                        diagonal's scores inside the scan).
// Their contract is the plain composition, bit for bit: score, length, ti,
// tj, tcode and, with traceback, the bytes tb uint8[D - 2, B, Lp] that
// csrc/replay.cu walks.  The recurrence is csrc/wavefront.cuh's, step for
// step; this file orders the steps and supplies the scores.
//
// Design: a thread-block cluster a problem.  The Lp = Lx + 1 lanes are cut
// into R <= 8 CTAs of W <= 512 lanes, one lane a thread (so
// __launch_bounds__(512, 1) leaves 128 registers for one lane's carries),
// launched as one cluster of R CTAs (cudaLaunchKernelEx with a cluster
// dimension) on R neighbouring SMs, one tile a CTA.  The walk is
// csrc/cluster_walk.cuh's, shared with the tiled kernel (csrc/tiled_dp.cu,
// which gives each CTA m tiles): the diagonals go in boxes of T (<= 32), in
// phase p rank r runs box p - r, one cluster barrier closes each phase, the
// tile edge goes from CTA to CTA through a double-buffered ring in
// distributed shared memory, and rank 0 picks the semiglobal or local
// terminal among the CTAs' candidates.  The plain twin of the schedule is
// kernels/tiled_dp.py::wavefront_dp_tiled_plain(rows, tile_lanes=W,
// steps_per_visit=T).  Scores mode stops at diagonal lx + ly and skips
// lanes past lx, so high ranks may have nothing to do but the barriers.
// This file sets up each box's scores (FusedVisits).
//
// Two score tiers, chosen per chunk by the caller from a proved predicate
// (kernels/fused_scores.py::tensor_core_exact), the same bits either way:
//   "mma"    before each box, the CTA computes the scores of its W lanes x
//            T diagonals on the int8 tensor cores (csrc/score_box.cuh, the
//            producer's tiles, limbs, prep kernel and exactness proof,
//            csrc/scores_mma.cu) into a diagonal-major box in shared memory,
//            from which each step reads its score; the next box's Cy band
//            is copied by cp.async while the DP steps through this one.
//            The tier is two launches of the kernel, built without and with
//            Cy_hi (WIDE); each problem runs in the launch that matches
//            whether a count of its y passes 255 (a "wide" problem), and
//            its CTAs exit at once in the other.  So a problem with no such
//            count runs the code it ran before Cy had two limbs; in a wide
//            one each band also carries its Cy_hi columns, and a band where
//            one of them is nonzero adds their products;
//   "scalar" each score computed in place from T = Cx @ S and Cy rows by
//            f32 dot products (csrc/fused_rows.cuh, bit-equal to
//            csrc/scores.cu), for every input check_exactness admits.
//
// What bounds it on the H100: the chain of dependent diagonals.  A problem
// runs (boxes + R - 1) x T steps in sequence, each a few dozen dependent
// instructions of one W-lane tile, a CTA barrier, and once per box a cluster
// barrier; the B x R CTAs of a launch fill the card's 132 SMs where B x R is
// large, and many problems in flight give the throughput.  Device memory
// carries the operands once (and, with traceback, one byte a cell).
// Memory is O(B * (Lx + Ly) * A), so Ly is unbounded.

#include "cluster_walk.cuh"
#include "fused_rows.cuh"
#include "score_box.cuh"

namespace {

using namespace praline_dp;

constexpr int MAX_W = 512;  // lanes (= threads) of a CTA
constexpr int MAX_R = 8;    // CTAs of a cluster: the portable cluster size
constexpr int MAX_T = 32;   // diagonals a box

struct FusedArgs {
  const float* t;            // scalar tier: the scratch of csrc/fused_rows.cuh
  const float* cyp;
  MmaOperands op;            // mma tier: the scratch of csrc/score_box.cuh
  const float* ivx;
  const float* ivy;
  const int* lx;
  const int* ly;
  Gaps gaps;
  int mode, traceback, B, Lx, Ly, AP, W, R, T;
  Outs out;
};

// Byte offsets of the dynamic shared memory: the cross-warp exchange
// xbuf[2][W / 32][NX], the edge ring[2][T][NX], the candidates red[W / 32
// + 1] (the last is the CTA's best, read by rank 0), and for the mma tier
// the box hk[T][W + 4], the rows' limbs a_lo / a_hi [W][32 B], the bands'
// Cy_lo columns band [2][W + T][32 B] (then, wide, their Cy_hi columns
// [2][W + T][32 B]), their inverses [2][W + T] and the rows' inverses [W].
// kernels/fused_dp.py::smem_bytes mirrors it (the wide layout).
struct Layout {
  int xbuf, ring, red, hk, a_lo, a_hi, band, ivy, ivx, total;
  __host__ __device__ Layout(int W, int T, int nx, bool mma, bool wide) {
    const int nw = W / 32, cols = W + T;
    xbuf = 0;
    ring = xbuf + round16(2 * nw * nx * 4);
    red = ring + round16(2 * T * nx * 4);
    total = red + round16((nw + 1) * (int)sizeof(Cand));
    hk = a_lo = a_hi = band = ivy = ivx = total;
    if (mma) {
      hk = total;
      a_lo = hk + round16(T * (W + 4) * 4);
      a_hi = a_lo + W * 32;
      band = a_hi + W * 32;
      ivy = band + (wide ? 4 : 2) * cols * 32;
      ivx = ivy + round16(2 * cols * 4);
      total = ivx + round16(W * 4);
    }
  }
};

// The mma tier's work before box k: wait for its band, start the next
// box's band, and fill hk with the box's scores on the tensor cores; WIDE:
// the bands carry Cy_hi (a count of the problem's y passes 255).
template <bool WIDE>
struct BoxProducer {
  float* hk;
  const uint32_t* a_lo;
  const uint32_t* a_hi;
  uint32_t* band;  // Cy_lo columns, two buffers of W + T; then Cy_hi's, two buffers
  float* ivy;
  const float* ivx;
  YRows y;
  int W, T, i0, Lx, Ly;
  bool two_pass;

  __device__ __forceinline__ int jbase(int d0) const { return d0 - i0 - W; }
  // buffer q's Cy_lo columns, and its Cy_hi columns (WIDE only)
  __device__ __forceinline__ uint32_t* lo_of(int q) const { return band + q * (W + T) * KW; }
  __device__ __forceinline__ uint32_t* hi_of(int q) const { return lo_of(q + 2); }

  __device__ void fill(int k, int d0, bool more) const {
    const int cols = W + T, t = threadIdx.x;
    copy_wait_all();
    // box k's band has landed; every step of box k - 1 is done; WIDE:
    // whether a Cy_hi limb of the band is nonzero
    bool band_wide = false;
    if constexpr (WIDE) band_wide = __syncthreads_or(rows_nonzero(hi_of(k & 1), cols, t, W));
    else __syncthreads();
    if (more) {
      const int q = (k + 1) & 1;
      start_band(lo_of(q), WIDE ? hi_of(q) : nullptr, ivy + q * cols, y, jbase(d0 + T), cols,
                 Ly, t, W);
    }
    fill_box(hk, W + 4, W, T, a_lo, a_hi, two_pass, ivx, lo_of(k & 1), hi_of(k & 1), band_wide,
             ivy + (k & 1) * cols, i0, d0, Lx, Ly);
    __syncthreads();
  }
};

// The score source of the walk (csrc/cluster_walk.cuh) on either tier:
// "mma" fills the box of each visit on the tensor cores (BoxProducer) and
// reads it back; "scalar" computes each score in place.
template <bool MMA, bool WIDE>
struct FusedVisits {
  BoxProducer<WIDE> box;
  FusedRows rows;
  int W, T;

  __device__ __forceinline__ auto prepare(int d0, int i0, int nd0, int) const {
    if constexpr (MMA) {
      box.fill((d0 - 2) / T, d0, nd0 >= 0);
      return BoxScores{box.hk, W + 4, d0, i0};
    } else {
      return rows;
    }
  }
};

template <int K, bool MMA, bool WIDE>
__global__ void __launch_bounds__(MAX_W, 1) fused_cluster_kernel(FusedArgs a) {
  constexpr int NX = Carries<K, 1>::NX;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Layout L(a.W, a.T, NX, MMA, WIDE);

  const int W = a.W, T = a.T, R = a.R;
  const int t = threadIdx.x;
  const int r = (int)cluster.block_rank();
  const int b = blockIdx.x / R;
  const int i0 = r * W;
  const int lx = a.lx[b], ly = a.ly[b], Lp = a.Lx + 1, D = a.Lx + a.Ly + 1;
  const Problem p = {b, lx, ly, a.mode, a.traceback, a.B, Lp};
  // Scores mode stops at the last diagonal that can hold a terminal and
  // skips lanes past lx; traceback mode fills every byte of tb.
  const int dend = a.traceback ? D - 1 : min(D - 1, lx + ly);
  const int lane_end = a.traceback ? Lp - 1 : min(Lp - 1, lx);
  const bool active = i0 <= lane_end;  // uniform over the CTA

  FusedVisits<MMA, WIDE> visits{};
  visits.W = W;
  visits.T = T;
  if constexpr (MMA) {
    // Whether a count of the problem's y passes 255, the same answer in
    // every CTA of the cluster: the problem runs in the launch of its kind.
    bool ywide = false;
    const unsigned char* yw = a.op.ywide + (size_t)b * a.Ly;
    for (int j = t; j < a.Ly; j += W) ywide |= yw[j] != 0;
    if ((__syncthreads_or(ywide) != 0) != WIDE) return;
    BoxProducer<WIDE>& box = visits.box;
    box.hk = reinterpret_cast<float*>(smem + L.hk);
    box.a_lo = reinterpret_cast<const uint32_t*>(smem + L.a_lo);
    box.a_hi = reinterpret_cast<const uint32_t*>(smem + L.a_hi);
    box.band = reinterpret_cast<uint32_t*>(smem + L.band);
    box.ivy = reinterpret_cast<float*>(smem + L.ivy);
    box.ivx = reinterpret_cast<const float*>(smem + L.ivx);
    box.y = y_rows(a.op, a.ivy, b, a.Ly);
    box.W = W;
    box.T = T;
    box.i0 = i0;
    box.Lx = a.Lx;
    box.Ly = a.Ly;
    // The CTA's rows (lane i0 + m is row i0 + m - 1 of x): their limbs and
    // inverses, and whether any needs the second pass; the first band.
    bool wide = false;
    if (active) {
      uint32_t* a_lo = reinterpret_cast<uint32_t*>(smem + L.a_lo);
      uint32_t* a_hi = reinterpret_cast<uint32_t*>(smem + L.a_hi);
      float* ivx = reinterpret_cast<float*>(smem + L.ivx);
      for (int q = t; q < 2 * W; q += W) {
        const int m = q / 2, ii = i0 + m;
        const bool ok = ii >= 1 && ii <= a.Lx;
        const size_t row = (size_t)b * a.Lx + (ok ? ii - 1 : 0);
        copy_async<16>(&a_lo[4 * q], a.op.xlo + 2 * row + q % 2, ok);
        copy_async<16>(&a_hi[4 * q], a.op.xhi + 2 * row + q % 2, ok);
        if (q % 2 == 0) {
          if (ok) wide |= a.op.xwide[row] != 0;
          ivx[m] = ok ? a.ivx[row] : 1.0f;
        }
      }
      start_band(box.lo_of(0), WIDE ? box.hi_of(0) : nullptr, box.ivy, box.y, box.jbase(2),
                 W + T, a.Ly, t, W);
    }
    box.two_pass = __syncthreads_or(wide);
  } else {
    visits.rows = fused_rows(a.t, a.cyp, a.ivx, a.ivy, b, a.Lx, a.Ly, a.AP);
  }

  const WalkSmem sm = {reinterpret_cast<float*>(smem + L.xbuf),
                       reinterpret_cast<float*>(smem + L.ring), nullptr,
                       reinterpret_cast<Cand*>(smem + L.red)};
  cluster_walk<K, false>(cluster, sm, WalkShape{R, 1, W, T}, p, a.gaps, a.out, dend, lane_end,
                         CarryStore{}, visits);
}

cudaLaunchConfig_t launch_config(const FusedArgs& a, int smem, cudaStream_t st,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * a.R);
  cfg.blockDim = dim3(a.W);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.R;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launches (or, with clusters != nullptr, asks how many clusters of this
// shape fit on the card at once: cudaOccupancyMaxActiveClusters).
template <int K, bool MMA, bool WIDE>
int launch_or_query(const FusedArgs& a, cudaStream_t st, int* clusters) {
  const int smem = Layout(a.W, a.T, Carries<K, 1>::NX, MMA, WIDE).total;
  auto kern = fused_cluster_kernel<K, MMA, WIDE>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(a, smem, st, attr);
  if (clusters) return (int)cudaOccupancyMaxActiveClusters(clusters, (void*)kern, &cfg);
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int K = 1>
int dispatch(int k, bool mma, const FusedArgs& a, cudaStream_t st, int* clusters) {
  if constexpr (K < MAXK) {
    if (k != K) return dispatch<K + 1>(k, mma, a, st, clusters);
  }
  if (!mma) return launch_or_query<K, false, false>(a, st, clusters);
  // the mma tier: the launch without Cy_hi, then the wide one (whose
  // shared memory, the larger, the occupancy query asks about)
  if (clusters) return launch_or_query<K, true, true>(a, st, clusters);
  const int rc = launch_or_query<K, true, false>(a, st, nullptr);
  return rc ? rc : launch_or_query<K, true, true>(a, st, nullptr);
}

bool geometry_ok(int k, int tier, int Lp, int W, int R, int T) {
  return k >= 1 && k <= MAXK && (tier == 0 || tier == 1) && W >= 32 && W <= MAX_W &&
         W % 32 == 0 && R >= 1 && R <= MAX_R && (long long)R * W >= Lp &&
         (long long)(R - 1) * W < Lp && T >= 8 && T <= MAX_T && T % 8 == 0;
}

}  // namespace

// Dynamic shared memory bytes of a CTA of W lanes, T diagonals a box, k
// gap levels, tier 0 ("mma") or 1 ("scalar"); -1 for arguments the kernel
// does not take.
extern "C" int praline_fused_dp_smem(int W, int T, int k, int tier) {
  if (k < 1 || k > MAXK || (tier != 0 && tier != 1)) return -1;
  const int kc = k == 2 ? 1 : k;
  return Layout(W, T, 6 + 2 * kc, tier == 0, tier == 0).total;
}

// How many clusters of R CTAs of W threads (k levels, tier, T) the card
// holds at once, into *clusters; returns the CUDA error of the query.
extern "C" int praline_fused_dp_clusters(int k, int tier, int W, int R, int T, int* clusters) {
  if (!geometry_ok(k, tier, (R - 1) * W + 1, W, R, T)) return (int)cudaErrorInvalidValue;
  FusedArgs a = {};
  a.B = 1;
  a.W = W;
  a.R = R;
  a.T = T;
  return dispatch(k, tier == 0, a, (cudaStream_t)0, clusters);
}

// cx f32[B, Lx, A], inv_x f32[B, Lx], cy f32[B, Ly, A], inv_y f32[B, Ly],
// s f32[A, A], lx/ly int32[B] with 1 <= lx <= Lx, 1 <= ly <= Ly; gaps: k
// host floats; tier 0 ("mma", only for operands that
// kernels/fused_scores.py::tensor_core_exact admits) or 1 ("scalar");
// geometry W, R, T (kernels/fused_dp.py::fused_geometry).  Scratch, 16-byte
// aligned: tier "mma" kernels/fused_scores.py::mma_scratch_bytes(B, Lx, Ly)
// bytes; tier "scalar" t f32[B, Lx, AP] then cyp f32[B, Ly, AP], AP = A
// rounded up to a multiple of 4.  Outputs as praline_wavefront_dp (tb
// uint8[Lx + Ly - 1, B, Lx + 1], ignored unless traceback).  Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int praline_fused_dp(const float* cx, const float* inv_x, const float* cy,
                                const float* inv_y, const float* s, const int* lx,
                                const int* ly, const float* gaps_host, int k, int mode,
                                int traceback, int B, int Lx, int Ly, int A, int tier, int W,
                                int R, int T, void* scratch, float* score, float* length,
                                int* ti, int* tj, int* tcode, uint8_t* tb, void* stream) {
  if (mode < 0 || mode > 2 || B < 1 || Lx < 1 || Ly < 1 || A < 1 || A > MAXA ||
      (long long)B * R > 0x7fffffffLL || !geometry_ok(k, tier, Lx + 1, W, R, T) ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  FusedArgs a = {};
  for (int l = 0; l < k; ++l) a.gaps.g[l] = gaps_host[l];
  const bool mma = tier == 0;
  int rc;
  if (mma) {
    a.op = mma_operands(scratch, B, Lx, Ly);
    rc = launch_mma_prep(cx, cy, s, a.op, B, Lx, Ly, A, st);
  } else {
    a.AP = padded_alphabet(A);
    a.t = static_cast<const float*>(scratch);
    a.cyp = a.t + (size_t)B * Lx * a.AP;
    rc = launch_prep(cx, cy, s, static_cast<float*>(scratch),
                     static_cast<float*>(scratch) + (size_t)B * Lx * a.AP, B, Lx, Ly, A, st);
  }
  if (rc != 0) return rc;
  a.ivx = inv_x;
  a.ivy = inv_y;
  a.lx = lx;
  a.ly = ly;
  a.mode = mode;
  a.traceback = traceback;
  a.B = B;
  a.Lx = Lx;
  a.Ly = Ly;
  a.W = W;
  a.R = R;
  a.T = T;
  a.out = {score, length, ti, tj, tcode, tb};
  return dispatch(k, mma, a, st, nullptr);
}
