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
// dimension) on R neighbouring SMs.  The diagonals are walked in boxes of T
// (<= 32): in phase p, rank r runs box p - r, and one cluster barrier closes
// each phase, so rank r runs box k right after rank r - 1 ran it.  The left
// neighbour of rank r's first lane at step s of a box is rank r - 1's last
// lane before its own step s: that lane writes its NX values into rank r's
// edge ring, in distributed shared memory, while it runs the box, and rank
// r reads them in the next phase; the ring is double-buffered by box
// parity.  This is the hand-off csrc/tiled_dp.cu makes in time on one SM,
// made across SMs, so the plain twin of the schedule is
// kernels/tiled_dp.py::wavefront_dp_tiled_plain(rows, tile_lanes=W,
// steps_per_visit=T).  Inside a CTA lanes cross warps as in
// csrc/wavefront.cuh.  Semiglobal and local terminals: each CTA picks its
// best candidate (block_best), and after a last cluster barrier rank 0 picks
// among the R through distributed shared memory (candidates are unique
// cells, so the order is free).  Scores mode stops at diagonal lx + ly and
// skips lanes past lx, so high ranks may have nothing to do but the
// barriers.
//
// Two score tiers, chosen per chunk by the caller from a proved predicate
// (kernels/fused_scores.py::tensor_core_exact), the same bits either way:
//   "mma"    before each box, the CTA computes the scores of its W lanes x
//            T diagonals on the int8 tensor cores (csrc/score_box.cuh, the
//            producer's tiles, limbs, prep kernel and exactness proof,
//            csrc/scores_mma.cu) into a diagonal-major box in shared memory,
//            from which each step reads its score; the next box's Cy band
//            is copied by cp.async while the DP steps through this one;
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

#include <cooperative_groups.h>

#include "fused_rows.cuh"
#include "score_box.cuh"
#include "wavefront.cuh"

namespace cg = cooperative_groups;

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

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// Byte offsets of the dynamic shared memory: the cross-warp exchange
// xbuf[2][W / 32][NX], the edge ring[2][T][NX], the candidates red[W / 32
// + 1] (the last is the CTA's best, read by rank 0), and for the mma tier
// the box hk[T][W + 4], the rows' limbs a_lo / a_hi [W][32 B], the bands
// [2][W + T][32 B], their inverses [2][W + T] and the rows' inverses [W].
// kernels/fused_dp.py::fused_geometry mirrors it.
struct Layout {
  int xbuf, ring, red, hk, a_lo, a_hi, band, ivy, ivx, total;
  __host__ __device__ Layout(int W, int T, int nx, bool mma) {
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
      ivy = band + 2 * cols * 32;
      ivx = ivy + round16(2 * cols * 4);
      total = ivx + round16(W * 4);
    }
  }
};

// The mma tier's score source for one box: cell (i, d) of the box at
// diagonals d0 .. d0 + T - 1 and lanes i0 .. i0 + W - 1.
struct BoxScores {
  const float* hk;
  int ss, d0, i0;
  __device__ __forceinline__ float operator()(int d, int i) const {
    return hk[(d - d0) * ss + (i - i0)];
  }
};

// The mma tier's work before box k: wait for its band, start the next
// box's band, and fill hk with the box's scores on the tensor cores.
struct BoxProducer {
  float* hk;
  const uint32_t* a_lo;
  const uint32_t* a_hi;
  uint32_t* band;
  float* ivy;
  const float* ivx;
  const uint4* yb;
  const float* ivyb;
  int W, T, i0, Lx, Ly;
  bool two_pass;

  __device__ __forceinline__ int jbase(int d0) const { return d0 - i0 - W; }

  __device__ void fill(int k, int d0, bool more) const {
    const int cols = W + T, t = threadIdx.x;
    copy_wait_all();
    __syncthreads();  // box k's band has landed; every step of box k - 1 is done
    if (more)
      start_band(band + ((k + 1) & 1) * cols * KW, ivy + ((k + 1) & 1) * cols, yb, ivyb,
                 jbase(d0 + T), cols, Ly, t, W);
    const uint32_t* bnd = band + (k & 1) * cols * KW;
    const float* iv = ivy + (k & 1) * cols;
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
      box_rows(hk, W + 4, W, T, bnd, iv, alo, ahi, two_pass, m0, g, t4, rivx, row_ok, rows_all,
               rows_none, jbase(d0), Ly);
    }
    __syncthreads();
  }
};

template <int K, bool MMA>
__global__ void __launch_bounds__(MAX_W, 1) fused_cluster_kernel(FusedArgs a) {
  using C = Carries<K, 1>;
  constexpr int NX = C::NX;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Layout L(a.W, a.T, NX, MMA);
  float* xbuf = reinterpret_cast<float*>(smem + L.xbuf);
  float* ring = reinterpret_cast<float*>(smem + L.ring);
  Cand* red = reinterpret_cast<Cand*>(smem + L.red);

  const int W = a.W, T = a.T, R = a.R;
  const int t = threadIdx.x, nw = W >> 5, warp = t >> 5, wl = t & 31;
  const int r = (int)cluster.block_rank();
  const int b = blockIdx.x / R;
  const int i0 = r * W, i = i0 + t;
  const int lx = a.lx[b], ly = a.ly[b], Lp = a.Lx + 1, D = a.Lx + a.Ly + 1;
  const Problem p = {b, lx, ly, a.mode, a.traceback, a.B, Lp};
  // Scores mode stops at the last diagonal that can hold a terminal and
  // skips lanes past lx; traceback mode fills every byte of tb.
  const int dend = a.traceback ? D - 1 : min(D - 1, lx + ly);
  const int lane_end = a.traceback ? Lp - 1 : min(Lp - 1, lx);
  const bool active = i0 <= lane_end;  // uniform over the CTA
  const int nbox = (dend - 2) / T + 1;
  float* next_ring = r + 1 < R ? cluster.map_shared_rank(ring, r + 1) : nullptr;

  BoxProducer box{};
  if constexpr (MMA) {
    box.hk = reinterpret_cast<float*>(smem + L.hk);
    box.a_lo = reinterpret_cast<const uint32_t*>(smem + L.a_lo);
    box.a_hi = reinterpret_cast<const uint32_t*>(smem + L.a_hi);
    box.band = reinterpret_cast<uint32_t*>(smem + L.band);
    box.ivy = reinterpret_cast<float*>(smem + L.ivy);
    box.ivx = reinterpret_cast<const float*>(smem + L.ivx);
    box.yb = a.op.ybytes + 2 * (size_t)b * a.Ly;
    box.ivyb = a.ivy + (size_t)b * a.Ly;
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
      start_band(box.band, box.ivy, box.yb, box.ivyb, box.jbase(2), W + T, a.Ly, t, W);
    }
    box.two_pass = __syncthreads_or(wide);
  }
  const FusedRows rows = fused_rows(a.t, a.cyp, a.ivx, a.ivy, b, a.Lx, a.Ly, a.AP);

  C c;
  c.init(0, i, a.mode, a.gaps.g[0]);
  Cand best = first_candidate<K>(a.mode, i == 0, lx, ly);
  Border<K> border(a.gaps);
  cluster.sync();  // every CTA of the cluster runs before any writes another's ring

  for (int ph = 0; ph < nbox + R - 1; ++ph) {
    const int k = ph - r;
    if (active && k >= 0 && k < nbox) {  // uniform over the CTA
      const int d0 = 2 + k * T, d1 = min(d0 + T - 1, dend);
      const float* edge = ring + (k & 1) * T * NX;
      float* out_edge = next_ring ? next_ring + (k & 1) * T * NX : nullptr;
      if constexpr (MMA) box.fill(k, d0, k + 1 < nbox);
      const BoxScores boxed{box.hk, W + 4, d0, i0};
      for (int d = d0; d <= d1; ++d) {
        const int s = d - d0, buf = d & 1;
        float sh[NX];
        c.shfl_in(0, sh);
        if (wl == 31) c.export_x(0, xbuf + (buf * nw + warp) * NX);
        // this lane's values before step s, for rank r + 1's first lane
        if (t == W - 1 && out_edge) c.export_x(0, out_edge + s * NX);
        __syncthreads();
        if (wl == 0) {
          const float* x = warp > 0 ? xbuf + (buf * nw + warp - 1) * NX
                                    : (r > 0 ? edge + s * NX : nullptr);
          if (x) {
#pragma unroll
            for (int v = 0; v < NX; ++v) sh[v] = x[v];
          }
        }
        if (i == 0) C::border_x(sh);
        border.next(a.gaps, d);
        if (i <= lane_end) {
          if constexpr (MMA) c.step(0, i, d, sh, border.cum, boxed, a.gaps, p, a.out, best);
          else c.step(0, i, d, sh, border.cum, rows, a.gaps, p, a.out, best);
        }
      }
    }
    cluster.sync();  // the ring writes of this phase are visible to the next
  }

  if (a.mode != GLOBAL) {
    const bool local = a.mode == LOCAL;
    const Cand cta = block_best(best, local, red);
    if (t == 0) red[nw] = cta;
    cluster.sync();
    if (r == 0 && t == 0) {
      Cand pick = cta;
      for (int q = 1; q < R; ++q) {
        const Cand o = *cluster.map_shared_rank(red + nw, q);
        if (beats(o, pick, local)) pick = o;
      }
      write_terminal(pick, b, a.out);
    }
    cluster.sync();  // no CTA leaves while rank 0 reads its candidate
  }
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
template <int K, bool MMA>
int launch_or_query(const FusedArgs& a, cudaStream_t st, int* clusters) {
  const int smem = Layout(a.W, a.T, Carries<K, 1>::NX, MMA).total;
  auto kern = fused_cluster_kernel<K, MMA>;
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
  return mma ? launch_or_query<K, true>(a, st, clusters)
             : launch_or_query<K, false>(a, st, clusters);
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
  return Layout(W, T, 6 + 2 * kc, tier == 0).total;
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
