// Anti-diagonal M/Ix/Iy wavefront DP for Hopper (sm_90a).
//
// Replaces the TPU kernels praline_tpu/kernels/strip.py::wavefront_dp_strip
// and praline_tpu/kernels/pallas_dp.py::wavefront_dp_pallas.  The contract
// is that of kernels/scan.py::wavefront_dp (the plain version beside this
// kernel), bit for bit: the same NEG = -1e30 sentinel, the same f32 adds,
// subtracts and compares in the same order, ties resolved M > Ix levels
// ascending > Iy levels ascending, the k = 2 collapse with its carried stay
// bits, the same border runs, terminal rules and traceback bytes.
//
// Design: one thread block per problem; lane i of a diagonal (cell
// (i, d - i)) belongs to thread i % nt, as its (i / nt)-th lane, with nt =
// min(1024, Lp rounded up to a warp) threads, so a block holds up to two
// lanes per thread (buckets up to 2047).  The block walks the diagonals
// d = 2 .. D-1 in order.  The only values that cross lanes are lane i-1's
// carries (M and the gap levels from d-1, the best state from d-2, their
// lengths, codes and the x stay bit): they move by __shfl_up_sync inside a
// warp, and the one lane at each warp's edge reads them from a
// double-buffered shared-memory slot written before the diagonal's single
// __syncthreads.  All per-lane state stays in registers.
//
// What bounds it on the H100: the dependency chain along the diagonals.
// A diagonal costs roughly a hundred dependent instructions per lane plus
// one block barrier, and a problem needs Lx + Ly of them in sequence, so a
// problem is latency bound and throughput comes from many problems in
// flight (one block each, every SM busy).  Device memory traffic is one
// f32 read per cell (hs, coalesced along the lanes) and, with traceback,
// one byte written per cell.  In scores mode the walk stops at diagonal
// lx + ly and lanes past lx are not computed: neither can reach a
// terminal (praline_tpu/kernels/scan.py:14-17).
//
// Gap series of 1 to 15 levels (the JAX package's limit) are compiled in,
// k = 2 collapsed; the levels are a template parameter so the carries stay
// in registers (deep series spill to local memory).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1.0e30f;
constexpr int PTR_NONE = 31;
constexpr int MAXK = 15;
constexpr int MAXT = 1024;
constexpr int MAXW = MAXT / 32;
constexpr unsigned FULL = 0xffffffffu;

enum { GLOBAL = 0, SEMIGLOBAL = 1, LOCAL = 2 };

struct Gaps {
  float g[MAXK];
};

// Terminal candidate, ordered lexicographically by the mode's rule.
struct Cand {
  float v, l;
  int i, j, c;
};

// semiglobal: larger value, then larger i, then larger j;
// local: larger value, then smaller i, then smaller j.
__device__ __forceinline__ bool beats(const Cand& a, const Cand& b, bool local) {
  if (a.v != b.v) return a.v > b.v;
  if (local) return a.i < b.i || (a.i == b.i && a.j < b.j);
  return a.i > b.i || (a.i == b.i && a.j > b.j);
}

template <int K, int Q>
__global__ void __launch_bounds__(MAXT) wavefront_kernel(
    const float* __restrict__ hs, const int* __restrict__ lxs,
    const int* __restrict__ lys, Gaps gaps,
    int mode, int traceback, int D, int B, int Lp,
    float* __restrict__ out_score, float* __restrict__ out_length,
    int* __restrict__ out_ti, int* __restrict__ out_tj,
    int* __restrict__ out_tcode, uint8_t* __restrict__ tb) {
  constexpr bool COLL = K == 2;
  constexpr int KC = COLL ? 1 : K;
  // Cross-lane values: M, best(d-2) value/length/code, M length, x stay,
  // then the Ix levels and their lengths.
  constexpr int XM = 0, XBV = 1, XBL = 2, XBC = 3, XLM = 4, XPS = 5;
  constexpr int XIX = 6, XLIX = 6 + KC, NX = 6 + 2 * KC;
  __shared__ float xbuf[2][Q][MAXW][NX];
  __shared__ Cand red[MAXW];

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int warp = t >> 5, wl = t & 31, nw = nt >> 5;
  const int lx = lxs[b], ly = lys[b];
  const bool local = mode == LOCAL, semi = mode == SEMIGLOBAL;
  const float border_m = local ? 0.0f : NEG;

  float m1[Q], lm1[Q], r1v[Q], r1l[Q], r2v[Q], r2l[Q];
  int r1c[Q], r2c[Q], psx[Q], psy[Q];
  float ix1[KC][Q], lix1[KC][Q], iy1[KC][Q], liy1[KC][Q];

  // Border gap run cost cum = sum over m = 1 .. d of g[min(m, k) - 1],
  // summed in f32 one diagonal at a time, in the order of the plain
  // version's np.cumsum.
  float cum = gaps.g[0];

  // ---- carries at d = 1: cells (0, 1) on lane 0 and (1, 0) on lane 1 ----
  const float bval1 = semi ? 0.0f : -cum;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int i = t + q * nt;
    m1[q] = (i == 0 || i == 1) ? border_m : NEG;
    lm1[q] = 0.0f;
#pragma unroll
    for (int l = 0; l < KC; ++l) {
      ix1[l][q] = NEG;
      iy1[l][q] = NEG;
      lix1[l][q] = 0.0f;
      liy1[l][q] = 0.0f;
    }
    if (!local) {
      ix1[0][q] = i == 1 ? bval1 : NEG;
      iy1[0][q] = i == 0 ? bval1 : NEG;
      lix1[0][q] = i == 1 ? 1.0f : 0.0f;
      liy1[0][q] = i == 0 ? 1.0f : 0.0f;
    }
    r2v[q] = i == 0 ? 0.0f : NEG;
    r2l[q] = 0.0f;
    r2c[q] = 0;
    float bv = m1[q], bl = lm1[q];
    int bc = 0;
#pragma unroll
    for (int l = 0; l < KC; ++l)
      if (ix1[l][q] > bv) { bv = ix1[l][q]; bl = lix1[l][q]; bc = 1 + l; }
#pragma unroll
    for (int l = 0; l < KC; ++l)
      if (iy1[l][q] > bv) { bv = iy1[l][q]; bl = liy1[l][q]; bc = 1 + K + l; }
    r1v[q] = bv;
    r1l[q] = bl;
    r1c[q] = bc;
    psx[q] = 0;
    psy[q] = 0;
  }

  // ---- this thread's running terminal candidate (semiglobal / local) ----
  Cand best = {NEG, 0.0f, 0, 0, 0};
  if (semi && t == 0) {
    // diagonal-1 border cells are candidates when a side has length 1
    if (lx == 1) best = {0.0f, 1.0f, 1, 0, 1};
    else if (ly == 1) best = {0.0f, 1.0f, 0, 1, 1 + K};
  }

  // Scores mode stops at the last diagonal that can hold a terminal and
  // skips lanes past lx; traceback mode fills every byte of tb.
  const int dend = traceback ? D - 1 : min(D - 1, lx + ly);
  const int lane_end = traceback ? Lp - 1 : min(Lp - 1, lx);

  for (int d = 2; d <= dend; ++d) {
    const int buf = d & 1;
    if (wl == 31) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        float* x = xbuf[buf][q][warp];
        x[XM] = m1[q];
        x[XBV] = r2v[q];
        x[XBL] = r2l[q];
        x[XBC] = __int_as_float(r2c[q]);
        x[XLM] = lm1[q];
        x[XPS] = __int_as_float(psx[q]);
#pragma unroll
        for (int l = 0; l < KC; ++l) {
          x[XIX + l] = ix1[l][q];
          x[XLIX + l] = lix1[l][q];
        }
      }
    }
    __syncthreads();

    float gstep = gaps.g[K - 1];
#pragma unroll
    for (int l = 1; l < K - 1; ++l)
      if (d == l + 1) gstep = gaps.g[l];
    cum = __fadd_rn(cum, gstep);
    const float bx = semi ? 0.0f : -cum;
    const int lvl_d = min(d, K);

#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int i = t + q * nt;
      // ---- lane i-1's carries ----
      float sh[NX];
      sh[XM] = __shfl_up_sync(FULL, m1[q], 1);
      sh[XBV] = __shfl_up_sync(FULL, r2v[q], 1);
      sh[XBL] = __shfl_up_sync(FULL, r2l[q], 1);
      sh[XBC] = __shfl_up_sync(FULL, __int_as_float(r2c[q]), 1);
      sh[XLM] = __shfl_up_sync(FULL, lm1[q], 1);
      sh[XPS] = __shfl_up_sync(FULL, __int_as_float(psx[q]), 1);
#pragma unroll
      for (int l = 0; l < KC; ++l) {
        sh[XIX + l] = __shfl_up_sync(FULL, ix1[l][q], 1);
        sh[XLIX + l] = __shfl_up_sync(FULL, lix1[l][q], 1);
      }
      if (wl == 0) {
        if (i == 0) {
          sh[XM] = NEG;
          sh[XBV] = NEG;
          sh[XBL] = 0.0f;
          sh[XBC] = __int_as_float(0);
          sh[XLM] = 0.0f;
          sh[XPS] = __int_as_float(0);
#pragma unroll
          for (int l = 0; l < KC; ++l) {
            sh[XIX + l] = NEG;
            sh[XLIX + l] = 0.0f;
          }
        } else {
          const float* x = (warp > 0) ? xbuf[buf][q][warp - 1]
                                      : xbuf[buf][q > 0 ? q - 1 : 0][nw - 1];
#pragma unroll
          for (int v = 0; v < NX; ++v) sh[v] = x[v];
        }
      }
      if (i > lane_end) continue;

      const float m1s = sh[XM], b2vs = sh[XBV], lm1s = sh[XLM], b2ls = sh[XBL];
      const int b2cs = __float_as_int(sh[XBC]);
      const int psxs = __float_as_int(sh[XPS]);

      // ---- gap states ----
      float nix[KC], niy[KC], nlix[KC], nliy[KC];
      bool sx = false, sy = false, stay_x = false, stay_y = false;
      if constexpr (COLL) {
        const float open_x = __fsub_rn(m1s, gaps.g[0]);
        const float ext_x = __fsub_rn(sh[XIX], gaps.g[1]);
        sx = ext_x > open_x;
        nix[0] = sx ? ext_x : open_x;
        nlix[0] = __fadd_rn(sx ? sh[XLIX] : lm1s, 1.0f);
        const float open_y = __fsub_rn(m1[q], gaps.g[0]);
        const float ext_y = __fsub_rn(iy1[0][q], gaps.g[1]);
        sy = ext_y > open_y;
        niy[0] = sy ? ext_y : open_y;
        nliy[0] = __fadd_rn(sy ? liy1[0][q] : lm1[q], 1.0f);
      } else if constexpr (K == 1) {
        stay_x = sh[XIX] > m1s;
        nix[0] = __fsub_rn(stay_x ? sh[XIX] : m1s, gaps.g[0]);
        nlix[0] = __fadd_rn(stay_x ? sh[XLIX] : lm1s, 1.0f);
        stay_y = iy1[0][q] > m1[q];
        niy[0] = __fsub_rn(stay_y ? iy1[0][q] : m1[q], gaps.g[0]);
        nliy[0] = __fadd_rn(stay_y ? liy1[0][q] : lm1[q], 1.0f);
      } else {
        nix[0] = __fsub_rn(m1s, gaps.g[0]);
        nlix[0] = __fadd_rn(lm1s, 1.0f);
        niy[0] = __fsub_rn(m1[q], gaps.g[0]);
        nliy[0] = __fadd_rn(lm1[q], 1.0f);
#pragma unroll
        for (int l = 1; l < K - 1; ++l) {
          nix[l] = __fsub_rn(sh[XIX + l - 1], gaps.g[l]);
          nlix[l] = __fadd_rn(sh[XLIX + l - 1], 1.0f);
          niy[l] = __fsub_rn(iy1[l - 1][q], gaps.g[l]);
          nliy[l] = __fadd_rn(liy1[l - 1][q], 1.0f);
        }
        constexpr int T1 = K - 1, T2 = K - 2;
        stay_x = sh[XIX + T1] > sh[XIX + T2];
        nix[T1] = __fsub_rn(stay_x ? sh[XIX + T1] : sh[XIX + T2], gaps.g[T1]);
        nlix[T1] = __fadd_rn(stay_x ? sh[XLIX + T1] : sh[XLIX + T2], 1.0f);
        stay_y = iy1[T1][q] > iy1[T2][q];
        niy[T1] = __fsub_rn(stay_y ? iy1[T1][q] : iy1[T2][q], gaps.g[T1]);
        nliy[T1] = __fadd_rn(stay_y ? liy1[T1][q] : liy1[T2][q], 1.0f);
      }

      // ---- M state ----
      const float hrow = hs[((size_t)d * B + b) * Lp + i];
      float nm = __fadd_rn(hrow, b2vs);
      float nlm = __fadd_rn(b2ls, 1.0f);
      int mcode = b2cs;
      if (local) {
        if (nm < 0.0f) {
          nm = 0.0f;
          mcode = PTR_NONE;
        }
        if (nm <= 0.0f) nlm = 0.0f;
      }

      // ---- borders: lane 0 = cell (0, d), lane d = cell (d, 0) ----
      const bool at0 = i == 0, atd = i == d, edge = at0 || atd;
      if (edge) {
        nm = border_m;
        nlm = 0.0f;
      }
#pragma unroll
      for (int l = 0; l < KC; ++l) {
        if (local) {
          if (edge) {
            nix[l] = NEG;
            niy[l] = NEG;
            nlix[l] = 0.0f;
            nliy[l] = 0.0f;
          }
        } else {
          const float run = (COLL || lvl_d == l + 1) ? bx : NEG;
          if (atd) {
            nix[l] = run;
            niy[l] = NEG;
            nlix[l] = (float)d;
            nliy[l] = 0.0f;
          } else if (at0) {
            nix[l] = NEG;
            niy[l] = run;
            nlix[l] = 0.0f;
            nliy[l] = (float)d;
          }
        }
      }

      // ---- best state ----
      float bv = nm, bl = nlm;
      int bc = 0;
      if constexpr (COLL) {
        if (local) {
          if (edge) sx = sy = false;
        } else {
          sx = atd || (sx && !at0);
          sy = at0 || (sy && !atd);
        }
        if (nix[0] > bv) { bv = nix[0]; bl = nlix[0]; bc = 1 + (int)sx; }
        if (niy[0] > bv) { bv = niy[0]; bl = nliy[0]; bc = 1 + K + (int)sy; }
      } else {
#pragma unroll
        for (int l = 0; l < KC; ++l)
          if (nix[l] > bv) { bv = nix[l]; bl = nlix[l]; bc = 1 + l; }
#pragma unroll
        for (int l = 0; l < KC; ++l)
          if (niy[l] > bv) { bv = niy[l]; bl = nliy[l]; bc = 1 + K + l; }
      }

      // ---- terminals ----
      const int j = d - i;
      if (mode == GLOBAL) {
        if (i == lx && j == ly) {
          out_score[b] = bv;
          out_length[b] = bl;
          out_ti[b] = lx;
          out_tj[b] = ly;
          out_tcode[b] = bc;
        }
      } else if (semi) {
        // last-column cell (d - ly, ly) and last-row cell (lx, d - lx)
        if ((j == ly && i <= lx) || (i == lx && j >= 0 && j <= ly)) {
          const Cand c = {bv, bl, i, j, bc};
          if (beats(c, best, false)) best = c;
        }
      } else if (i >= 1 && i <= lx && j >= 1 && j <= ly) {
        const Cand c = {nm, nlm, i, j, 0};
        if (beats(c, best, true)) best = c;
      }

      if (traceback) {
        int bits = mcode;
        if (local && nm <= 0.0f) bits |= 1 << 7;
        if constexpr (COLL) bits |= (psxs << 5) | (psy[q] << 6);
        else bits |= ((int)stay_x << 5) | ((int)stay_y << 6);
        tb[((size_t)(d - 2) * B + b) * Lp + i] = (uint8_t)bits;
      }

      // ---- carries for d + 1 ----
      m1[q] = nm;
      lm1[q] = nlm;
#pragma unroll
      for (int l = 0; l < KC; ++l) {
        ix1[l][q] = nix[l];
        iy1[l][q] = niy[l];
        lix1[l][q] = nlix[l];
        liy1[l][q] = nliy[l];
      }
      r2v[q] = r1v[q];
      r2l[q] = r1l[q];
      r2c[q] = r1c[q];
      r1v[q] = bv;
      r1l[q] = bl;
      r1c[q] = bc;
      psx[q] = (int)sx;
      psy[q] = (int)sy;
    }
  }

  if (mode == GLOBAL) return;
  // ---- block-wide terminal reduction (each candidate cell is unique, so
  // the lexicographic best does not depend on the order) ----
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Cand o;
    o.v = __shfl_down_sync(FULL, best.v, off);
    o.l = __shfl_down_sync(FULL, best.l, off);
    o.i = __shfl_down_sync(FULL, best.i, off);
    o.j = __shfl_down_sync(FULL, best.j, off);
    o.c = __shfl_down_sync(FULL, best.c, off);
    if (wl + off < 32 && beats(o, best, local)) best = o;
  }
  if (wl == 0) red[warp] = best;
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < nw; ++w)
      if (beats(red[w], best, local)) best = red[w];
    out_score[b] = best.v;
    out_length[b] = best.l;
    out_ti[b] = best.i;
    out_tj[b] = best.j;
    out_tcode[b] = best.c;
  }
}

// Launches the kernel instantiated for k levels (the recursion compiles
// K = 1 .. MAXK) and q lanes per thread.
template <int K>
int launch(int k, int q, const float* hs, const int* lx, const int* ly,
           Gaps gaps, int mode, int traceback, int D, int B,
           int Lp, int nt, float* score, float* length, int* ti, int* tj,
           int* tcode, uint8_t* tb, cudaStream_t stream) {
  if constexpr (K < MAXK) {
    if (k != K)
      return launch<K + 1>(k, q, hs, lx, ly, gaps, mode, traceback, D, B,
                           Lp, nt, score, length, ti, tj, tcode, tb, stream);
  }
  if (q == 1)
    wavefront_kernel<K, 1><<<B, nt, 0, stream>>>(
        hs, lx, ly, gaps, mode, traceback, D, B, Lp, score, length, ti, tj,
        tcode, tb);
  else
    wavefront_kernel<K, 2><<<B, nt, 0, stream>>>(
        hs, lx, ly, gaps, mode, traceback, D, B, Lp, score, length, ti, tj,
        tcode, tb);
  return (int)cudaGetLastError();
}

}  // namespace

// hs f32[D, B, Lp]; lx, ly int32[B] with 1 <= lx < Lp, 1 <= ly <= D - Lp;
// gaps: k host floats.  Outputs f32/int32
// [B]; tb uint8[D - 2, B, Lp] (ignored unless traceback).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// shapes and series the kernel does not take.
extern "C" int praline_wavefront_dp(const float* hs, const int* lx,
                                    const int* ly,
                                    const float* gaps_host, int k, int mode,
                                    int traceback, int D, int B, int Lp,
                                    float* score, float* length, int* ti,
                                    int* tj, int* tcode, uint8_t* tb,
                                    void* stream) {
  if (k < 1 || k > MAXK || mode < 0 || mode > 2 || B < 1 || Lp < 2 ||
      Lp > 2 * MAXT || D < Lp + 1)
    return (int)cudaErrorInvalidValue;
  Gaps gaps = {};
  for (int l = 0; l < k; ++l) gaps.g[l] = gaps_host[l];
  const int nt = Lp >= MAXT ? MAXT : (Lp + 31) / 32 * 32;
  const int q = (Lp + nt - 1) / nt;
  return launch<1>(k, q, hs, lx, ly, gaps, mode, traceback, D, B, Lp, nt,
                   score, length, ti, tj, tcode, tb, (cudaStream_t)stream);
}
