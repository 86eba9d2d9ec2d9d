// Lane-tiled wavefront DP for Hopper (sm_90a): rows of any length on one
// thread-block cluster a problem.
//
// Replaces the TPU kernel praline_tpu/kernels/pallas_dp_tiled.py:448
// wavefront_dp_tiled (K6, register-tiled, k <= 2), and serves on the card
// what the JAX package's streamed scan praline_tpu/kernels/scan.py:106 takes
// for rows past the fused kernel's 4096 lanes: every mode, gap series of 1
// to 15 levels, any Lx and Ly.  The contract is kernels/scan.py::
// wavefront_dp (the plain version), bit for bit: score, length, ti, tj,
// tcode and, with traceback, the bytes tb uint8[D - 2, B, Lp] that
// csrc/replay.cu walks.  The recurrence is csrc/wavefront.cuh's, step for
// step; the order of the steps is csrc/cluster_walk.cuh's, shared with the
// fused kernel (csrc/fused_dp.cu).
//
// Design.  A problem runs on a cluster of R CTAs (up to 16: past the
// portable 8 with cudaFuncAttributeNonPortableClusterSizeAllowed), each
// owning m consecutive tiles of W <= 512 lanes, one lane a thread, so R m W
// >= Lp covers a row of any length (kernels/tiled_dp.py::tiled_geometry).
// In phase p rank r runs box p - r (T diagonals) over its m tiles, left to
// right; the tile edge goes from tile to tile through shared memory inside
// a CTA and from CTA to CTA through a double-buffered ring in distributed
// shared memory, one cluster barrier a phase: (boxes + R - 1) m T steps in
// sequence.  With m = 1 a
// tile's carries stay in registers; with m > 1 each visit loads and stores
// them (14 values a lane at k <= 2, 22 at k = 3) in shared memory where
// they fit beside the rest, else in a device-memory scratch f32[B, NS, Lp]
// that stays in L2.  On the hs source each thread copies its own lane's
// next T scores into shared memory by cp.async while the DP steps through
// the current visit (W contiguous floats a diagonal, a double buffer), so a
// step reads its score from shared memory and no step waits on device
// memory.
//
// Two score sources through the visit functor: HsVisits reads hs
// f32[D, B, Lp] from csrc/scores*.cu, K6's own contract; RowsVisits
// (csrc/fused_rows.cuh, with its prep kernel) computes each score in place
// for rows whose hs would pass the batch aligner's budget (kernels/batch.py).
//
// What bounds it on the H100: the chain of dependent diagonals.  A problem
// runs (boxes + R - 1) m T steps, each a few dozen dependent instructions
// of one W-lane tile and a CTA barrier, with one cluster barrier a box; the
// scores of a box are in shared memory before its first step.  More CTAs
// a cluster means fewer tiles a CTA (m), so fewer steps in sequence.
// Device memory carries hs once (or the T and Cy rows), tb once and, where
// the carries do not fit in shared memory, the carry scratch once a box.

#include "async_copy.cuh"
#include "cluster_walk.cuh"
#include "fused_rows.cuh"

namespace {

using namespace praline_dp;

constexpr int MAX_W = 512;    // lanes (= threads) of a CTA
constexpr int MAX_R = 16;     // CTAs of a cluster: the H100's non-portable size
constexpr int MAX_STEPS = 32; // T: diagonals a box
constexpr int MAX_SMEM = 232448;  // shared memory a CTA may use on the H100

struct TiledArgs {
  const float* hs;   // hs source: f32[D, B, Lp]
  const float* t;    // rows source: scratch of csrc/fused_rows.cuh
  const float* cyp;
  const float* ivx;
  const float* ivy;
  const int* lx;
  const int* ly;
  float* carry;      // f32[B, NS, Lp] where the carries do not fit in shared memory
  Gaps gaps;
  int mode, traceback, D, B, Lp, Lx, Ly, AP, W, R, m, T;
  Outs out;
  cudaStream_t stream;
};

// Byte offsets of the dynamic shared memory: the walk's cross-warp
// exchange xbuf[2][W / 32][NX], ring[2][T][NX] and tile edge edge[T][NX],
// the candidates red[W / 32 + 1]; on the hs source the double-buffered
// scores hbuf[2][T][W]; with m > 1 the carries carry[NS][m W] where the
// whole fits in MAX_SMEM (carry = -1 where it does not).
// kernels/tiled_dp.py::smem_bytes mirrors it.
struct Layout {
  int xbuf, ring, edge, red, hbuf, carry, total;
  __host__ __device__ Layout(int W, int T, int m, int nx, int ns, bool hs) {
    const int nw = W / 32;
    xbuf = 0;
    ring = xbuf + round16(2 * nw * nx * 4);
    edge = ring + round16(2 * T * nx * 4);
    red = edge + round16(T * nx * 4);
    hbuf = red + round16((nw + 1) * (int)sizeof(Cand));
    total = hbuf + (hs ? 2 * T * W * 4 : 0);
    carry = -1;
    if (m > 1 && total + (long long)ns * m * W * 4 <= MAX_SMEM) {
      carry = total;
      total += ns * m * W * 4;
    }
  }
};

// The hs source: each visit's scores copied into shared memory (one thread
// a lane, T diagonals) while the visit before it runs.
struct HsBox {
  const float* box;
  int W, d0, i0;
  __device__ __forceinline__ float operator()(int d, int i) const {
    return box[(d - d0) * W + (i - i0)];
  }
};

struct HsVisits {
  const float* hs;
  float* hbuf;
  int B, Lp, b, W, T, dend, slot;
  bool started;

  // This thread's lane of the visit (d0, i0) into half s of hbuf.
  __device__ __forceinline__ void fetch(int s, int d0, int i0) const {
    const int i = i0 + threadIdx.x;
    float* dst = hbuf + s * T * W + threadIdx.x;
    for (int q = 0; q < T; ++q) {
      const int d = d0 + q;
      const bool ok = d <= dend && i < Lp;
      copy_async<4>(dst + q * W, ok ? hs + ((size_t)d * B + b) * Lp + i : hs, ok);
    }
    copy_commit();
  }

  __device__ __forceinline__ HsBox prepare(int d0, int i0, int nd0, int ni0) {
    if (!started) {
      fetch(slot, d0, i0);
      started = true;
    }
    if (nd0 >= 0) {
      fetch(slot ^ 1, nd0, ni0);
      copy_wait_group<1>();
    } else {
      copy_wait_all();
    }
    const HsBox box{hbuf + slot * T * W, W, d0, i0};
    slot ^= 1;
    return box;  // each thread reads only the lane it copied: no barrier
  }
};

struct RowsVisits {
  FusedRows rows;
  __device__ __forceinline__ FusedRows prepare(int, int, int, int) const { return rows; }
};

template <int K, bool HS>
__global__ void __launch_bounds__(MAX_W, 1) tiled_cluster_kernel(TiledArgs a) {
  using C = Carries<K, 1>;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Layout L(a.W, a.T, a.m, C::NX, C::NS, HS);
  const int b = blockIdx.x / a.R;
  const int lx = a.lx[b], ly = a.ly[b], Lp = a.Lp;
  const Problem p = {b, lx, ly, a.mode, a.traceback, a.B, Lp};
  // Scores mode stops at the last diagonal that can hold a terminal and
  // skips lanes past lx; traceback mode fills every byte of tb.
  const int dend = a.traceback ? a.D - 1 : min(a.D - 1, lx + ly);
  const int lane_end = a.traceback ? Lp - 1 : min(Lp - 1, lx);
  const CarryStore store =
      L.carry >= 0
          ? CarryStore{reinterpret_cast<float*>(smem + L.carry), a.m * a.W, false}
          : CarryStore{a.carry + (size_t)b * C::NS * Lp, Lp, true};
  const WalkSmem sm = {reinterpret_cast<float*>(smem + L.xbuf),
                       reinterpret_cast<float*>(smem + L.ring),
                       reinterpret_cast<float*>(smem + L.edge),
                       reinterpret_cast<Cand*>(smem + L.red)};
  const WalkShape shape{a.R, a.m, a.W, a.T};
  if constexpr (HS) {
    HsVisits visits{a.hs, reinterpret_cast<float*>(smem + L.hbuf), a.B, Lp, b, a.W, a.T, dend,
                    0, false};
    cluster_walk<K, true>(cluster, sm, shape, p, a.gaps, a.out, dend, lane_end, store, visits);
  } else {
    RowsVisits visits{fused_rows(a.t, a.cyp, a.ivx, a.ivy, b, a.Lx, a.Ly, a.AP)};
    cluster_walk<K, true>(cluster, sm, shape, p, a.gaps, a.out, dend, lane_end, store, visits);
  }
}

int smem_of(int k, bool hs, int W, int m, int T) {
  const int kc = k == 2 ? 1 : k;
  return Layout(W, T, m, 6 + 2 * kc, 10 + 4 * kc, hs).total;
}

// Launches (or, with clusters != nullptr, asks how many clusters of this
// shape fit on the card at once: cudaOccupancyMaxActiveClusters).
template <int K, bool HS>
int launch_or_query(const TiledArgs& a, int* clusters) {
  const int smem = smem_of(K, HS, a.W, a.m, a.T);
  auto kern = tiled_cluster_kernel<K, HS>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * a.R);
  cfg.blockDim = dim3(a.W);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.R;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters) return (int)cudaOccupancyMaxActiveClusters(clusters, (void*)kern, &cfg);
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int K = 1>
int dispatch(int k, bool hs, const TiledArgs& a, int* clusters) {
  if constexpr (K < MAXK) {
    if (k != K) return dispatch<K + 1>(k, hs, a, clusters);
  }
  return hs ? launch_or_query<K, true>(a, clusters) : launch_or_query<K, false>(a, clusters);
}

bool geometry_ok(int k, int Lp, int W, int R, int m, int T) {
  return k >= 1 && k <= MAXK && W >= 32 && W <= MAX_W && W % 32 == 0 && R >= 1 &&
         R <= MAX_R && m >= 1 && (long long)R * m * W >= Lp && T >= 1 && T <= MAX_STEPS &&
         smem_of(k, true, W, m, T) <= MAX_SMEM;
}

// Common checks and fields of both entry points.
bool fill_args(TiledArgs* a, bool hs, const int* lx, const int* ly, const float* gaps_host,
               int k, int mode, int traceback, int B, int Lp, int W, int R, int m, int T,
               float* carry, float* score, float* length, int* ti, int* tj, int* tcode,
               uint8_t* tb, void* stream) {
  if (mode < 0 || mode > 2 || B < 1 || Lp < 2 || (long long)B * R > 0x7fffffffLL ||
      !geometry_ok(k, Lp, W, R, m, T))
    return false;
  const int kc = k == 2 ? 1 : k;
  if (m > 1 && Layout(W, T, m, 6 + 2 * kc, 10 + 4 * kc, hs).carry < 0 && carry == nullptr)
    return false;  // the carries need the device-memory scratch
  for (int l = 0; l < k; ++l) a->gaps.g[l] = gaps_host[l];
  a->lx = lx;
  a->ly = ly;
  a->carry = carry;
  a->mode = mode;
  a->traceback = traceback;
  a->B = B;
  a->Lp = Lp;
  a->W = W;
  a->R = R;
  a->m = m;
  a->T = T;
  a->out = {score, length, ti, tj, tcode, tb};
  a->stream = (cudaStream_t)stream;
  return true;
}

}  // namespace

// Dynamic shared memory bytes of a CTA of W lanes and m tiles, T diagonals
// a box, k gap levels, on the hs source (hs = 1) or the rows source;
// -1 for arguments the kernel does not take.
extern "C" int praline_tiled_dp_smem(int W, int T, int m, int k, int hs) {
  if (k < 1 || k > MAXK || m < 1 || W < 32 || T < 1) return -1;
  return smem_of(k, hs != 0, W, m, T);
}

// How many clusters of R CTAs of W threads and m tiles (k levels, source,
// T) the card holds at once, into *clusters; returns the CUDA error of the
// query.
extern "C" int praline_tiled_dp_clusters(int k, int hs, int W, int R, int m, int T,
                                         int* clusters) {
  if (!geometry_ok(k, 2, W, R, m, T)) return (int)cudaErrorInvalidValue;
  TiledArgs a = {};
  a.B = 1;
  a.W = W;
  a.R = R;
  a.m = m;
  a.T = T;
  return dispatch(k, hs != 0, a, clusters);
}

// The hs source.  hs f32[D, B, Lp]; lx, ly int32[B] with 1 <= lx < Lp,
// 1 <= ly <= D - Lp; gaps: k host floats; geometry (kernels/tiled_dp.py::
// tiled_geometry): W lanes a tile (= threads a CTA), a multiple of 32 up to
// 512; R CTAs a cluster, 1 to 16; m tiles a CTA with R m W >= Lp; T
// diagonals a box, 1 to 32.  Scratch carry f32[B, 10 + 4 k', Lp] (k' = 1 at
// k = 2, else k) where m > 1 and the carries do not fit in shared memory
// (praline_tiled_dp_smem without them), else unused.  Outputs f32/int32
// [B]; tb uint8[D - 2, B, Lp] (ignored unless traceback).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int praline_tiled_dp_hs(const float* hs, const int* lx, const int* ly,
                                   const float* gaps_host, int k, int mode, int traceback,
                                   int D, int B, int Lp, int W, int R, int m, int T,
                                   float* carry, float* score, float* length, int* ti, int* tj,
                                   int* tcode, uint8_t* tb, void* stream) {
  TiledArgs a = {};
  if (D < Lp + 1 ||
      !fill_args(&a, true, lx, ly, gaps_host, k, mode, traceback, B, Lp, W, R, m, T, carry,
                 score, length, ti, tj, tcode, tb, stream))
    return (int)cudaErrorInvalidValue;
  a.hs = hs;
  a.D = D;
  return dispatch(k, true, a, nullptr);
}

// The in-place source.  cx f32[B, Lx, A], inv_x f32[B, Lx], cy f32[B, Ly,
// A], inv_y f32[B, Ly], s f32[A, A], lx/ly int32[B] with 1 <= lx <= Lx,
// 1 <= ly <= Ly.  Scratch t f32[B, Lx, AP] and cyp f32[B, Ly, AP] (AP = A
// rounded up to a multiple of 4) for the prep kernel, and carry as above
// with Lp = Lx + 1.  Outputs as praline_tiled_dp_hs with D = Lx + Ly + 1.
extern "C" int praline_tiled_dp_rows(const float* cx, const float* inv_x, const float* cy,
                                     const float* inv_y, const float* s, const int* lx,
                                     const int* ly, const float* gaps_host, int k, int mode,
                                     int traceback, int B, int Lx, int Ly, int A, int W, int R,
                                     int m, int T, float* t, float* cyp, float* carry,
                                     float* score, float* length, int* ti, int* tj,
                                     int* tcode, uint8_t* tb, void* stream) {
  TiledArgs a = {};
  if (Lx < 1 || Ly < 1 ||
      !fill_args(&a, false, lx, ly, gaps_host, k, mode, traceback, B, Lx + 1, W, R, m, T,
                 carry, score, length, ti, tj, tcode, tb, stream))
    return (int)cudaErrorInvalidValue;
  const int rc = launch_prep(cx, cy, s, t, cyp, B, Lx, Ly, A, a.stream);
  if (rc != 0) return rc;
  a.t = t;
  a.cyp = cyp;
  a.ivx = inv_x;
  a.ivy = inv_y;
  a.D = Lx + Ly + 1;
  a.Lx = Lx;
  a.Ly = Ly;
  a.AP = padded_alphabet(A);
  return dispatch(k, false, a, nullptr);
}
