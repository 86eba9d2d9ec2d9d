// The anti-diagonal M/Ix/Iy recurrence of the Hopper DP kernels, written
// once and included by all of them: csrc/wavefront_dp.cu (scores from the
// skewed tensor hs), csrc/fused_dp.cu (scores computed on chip) and
// csrc/tiled_dp.cu (hs or scores computed in place, rows of any length),
// each walking it in lane tiles on a thread-block cluster
// (csrc/cluster_walk.cuh).  The score source is a functor `score(d, i)`
// giving cell (i, d - i)'s entry of hs[d, b, i] (kernels/scores.py::
// skewed_pair_scores); everything else is this file.
//
// Contract: kernels/scan.py::wavefront_dp (the plain version), bit for bit:
// the same NEG = -1e30 sentinel, the same f32 adds, subtracts and compares
// in the same order, ties resolved M > Ix levels ascending > Iy levels
// ascending, the k = 2 collapse with its carried stay bits, the same border
// runs, terminal rules and traceback bytes.
//
// The pieces, which the walk puts together:
//   Carries<K, Q>   the per-thread state of Q lanes: each lane's values at
//                   diagonal d - 1 (and its best state at d - 2), with their
//                   d = 1 initialisation (init), the NX values a lane hands
//                   to lane i + 1 (export_x, shfl_in) and one diagonal step
//                   (step) that takes the left neighbour's NX values;
//   Border          the border run cost of a diagonal, summed in f32;
//   block_best      the block-wide pick of the semiglobal / local terminal
//                   candidate, and write_terminal, which writes it.
//
// Lane i of diagonal d is cell (i, d - i).  The only values that cross
// lanes are lane i-1's carries (M and the gap levels from d-1, the best
// state from d-2, their lengths, codes and the x stay bit): they move by
// __shfl_up_sync inside a warp and through shared memory between warps,
// tiles and CTAs.
//
// In scores mode the walks stop at diagonal lx + ly and lanes past lx are
// not computed: neither can reach a terminal
// (praline_tpu/kernels/scan.py:14-17).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace praline_dp {

constexpr float NEG = -1.0e30f;
constexpr int PTR_NONE = 31;
constexpr int MAXK = 15;
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

// Per-problem outputs: f32/int32 [B] terminals and, with traceback, the
// bytes tb uint8[D - 2, B, Lp].
struct Outs {
  float* score;
  float* length;
  int* ti;
  int* tj;
  int* tcode;
  uint8_t* tb;
  // Where non-null, csrc/cluster_walk.cuh adds the lane slots it ran (W a
  // step of each visit): a measurement, null on the main path.
  unsigned long long* slots;
};

// What one step needs of its problem besides the carries.
struct Problem {
  int b, lx, ly, mode, traceback, B, Lp;
};

// semiglobal: larger value, then larger i, then larger j;
// local: larger value, then smaller i, then smaller j.
__device__ __forceinline__ bool beats(const Cand& a, const Cand& b, bool local) {
  if (a.v != b.v) return a.v > b.v;
  if (local) return a.i < b.i || (a.i == b.i && a.j < b.j);
  return a.i > b.i || (a.i == b.i && a.j > b.j);
}

// The border gap run of diagonal d: cum = sum over m = 1 .. d of
// g[min(m, k) - 1], summed in f32 one diagonal at a time, in the order of
// the plain version's np.cumsum.  Starts at diagonal 1.
template <int K>
struct Border {
  float cum;
  __device__ __forceinline__ explicit Border(const Gaps& gaps) : cum(gaps.g[0]) {}
  // Advance to diagonal d (called once per diagonal, in order).
  __device__ __forceinline__ void next(const Gaps& gaps, int d) {
    float gstep = gaps.g[K - 1];
#pragma unroll
    for (int l = 1; l < K - 1; ++l)
      if (d == l + 1) gstep = gaps.g[l];
    cum = __fadd_rn(cum, gstep);
  }
};

// A semiglobal problem's diagonal-1 border cells are candidates when a side
// has length 1; only lane 0's thread holds them.
template <int K>
__device__ __forceinline__ Cand first_candidate(int mode, bool lane0, int lx, int ly) {
  Cand best = {NEG, 0.0f, 0, 0, 0};
  if (mode == SEMIGLOBAL && lane0) {
    if (lx == 1) best = {0.0f, 1.0f, 1, 0, 1};
    else if (ly == 1) best = {0.0f, 1.0f, 0, 1, 1 + K};
  }
  return best;
}

template <int K, int Q>
struct Carries {
  static constexpr bool COLL = K == 2;
  static constexpr int KC = COLL ? 1 : K;
  // Cross-lane values: M, best(d-2) value/length/code, M length, x stay,
  // then the Ix levels and their lengths.
  static constexpr int XM = 0, XBV = 1, XBL = 2, XBC = 3, XLM = 4, XPS = 5;
  static constexpr int XIX = 6, XLIX = 6 + KC, NX = 6 + 2 * KC;
  // Values a lane carries from one diagonal to the next (the tiled kernel's
  // scratch row count): the cross-lane ones, r1 value/length/code, the y
  // stay bit and the Iy levels with their lengths.
  static constexpr int NS = NX + 4 + 2 * KC;

  float m1[Q], lm1[Q], r1v[Q], r1l[Q], r2v[Q], r2l[Q];
  int r1c[Q], r2c[Q], psx[Q], psy[Q];
  float ix1[KC][Q], lix1[KC][Q], iy1[KC][Q], liy1[KC][Q];

  // ---- carries at d = 1: cells (0, 1) on lane 0 and (1, 0) on lane 1 ----
  __device__ __forceinline__ void init(int q, int i, int mode, float cum1) {
    const bool local = mode == LOCAL, semi = mode == SEMIGLOBAL;
    const float border_m = local ? 0.0f : NEG;
    const float bval1 = semi ? 0.0f : -cum1;
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

  // Lane q's NX cross-lane values into x.
  __device__ __forceinline__ void export_x(int q, float* x) const {
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

  // The warp lane below's cross-lane values of its lane q (every thread of
  // the warp must call it).
  __device__ __forceinline__ void shfl_in(int q, float* sh) const {
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
  }

  // Lane 0's left neighbour: the border fill.
  static __device__ __forceinline__ void border_x(float* sh) {
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
  }

  // Lane q's carries to and from a lane-major scratch row set: value v of
  // lane i at s[v * stride + i].
  __device__ __forceinline__ void store(int q, float* s, int stride, int i) const {
    float x[NX];
    export_x(q, x);
#pragma unroll
    for (int v = 0; v < NX; ++v) s[(size_t)v * stride + i] = x[v];
    float* r = s + (size_t)NX * stride + i;
    r[0] = r1v[q];
    r[(size_t)stride] = r1l[q];
    r[(size_t)2 * stride] = __int_as_float(r1c[q]);
    r[(size_t)3 * stride] = __int_as_float(psy[q]);
#pragma unroll
    for (int l = 0; l < KC; ++l) {
      r[(size_t)(4 + l) * stride] = iy1[l][q];
      r[(size_t)(4 + KC + l) * stride] = liy1[l][q];
    }
  }

  __device__ __forceinline__ void load(int q, const float* s, int stride, int i) {
    m1[q] = s[(size_t)XM * stride + i];
    r2v[q] = s[(size_t)XBV * stride + i];
    r2l[q] = s[(size_t)XBL * stride + i];
    r2c[q] = __float_as_int(s[(size_t)XBC * stride + i]);
    lm1[q] = s[(size_t)XLM * stride + i];
    psx[q] = __float_as_int(s[(size_t)XPS * stride + i]);
#pragma unroll
    for (int l = 0; l < KC; ++l) {
      ix1[l][q] = s[(size_t)(XIX + l) * stride + i];
      lix1[l][q] = s[(size_t)(XLIX + l) * stride + i];
    }
    const float* r = s + (size_t)NX * stride + i;
    r1v[q] = r[0];
    r1l[q] = r[(size_t)stride];
    r1c[q] = __float_as_int(r[(size_t)2 * stride]);
    psy[q] = __float_as_int(r[(size_t)3 * stride]);
#pragma unroll
    for (int l = 0; l < KC; ++l) {
      iy1[l][q] = r[(size_t)(4 + l) * stride];
      liy1[l][q] = r[(size_t)(4 + KC + l) * stride];
    }
  }

  // One diagonal d for lane q = cell (i, d - i): sh holds lane i-1's
  // cross-lane values, `cum` the border run cost of diagonal d.  Writes
  // the global terminal or folds this cell into `best`, writes the
  // traceback byte, and advances the lane's carries to diagonal d.
  template <class Scores>
  __device__ __forceinline__ void step(int q, int i, int d, const float* sh, float cum,
                                       const Scores& score, const Gaps& gaps,
                                       const Problem& p, const Outs& out, Cand& best) {
    const bool local = p.mode == LOCAL, semi = p.mode == SEMIGLOBAL;
    const float border_m = local ? 0.0f : NEG;
    const float bx = semi ? 0.0f : -cum;
    const int lvl_d = min(d, K);

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
    const float hrow = score(d, i);
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
    if (p.mode == GLOBAL) {
      if (i == p.lx && j == p.ly) {
        out.score[p.b] = bv;
        out.length[p.b] = bl;
        out.ti[p.b] = p.lx;
        out.tj[p.b] = p.ly;
        out.tcode[p.b] = bc;
      }
    } else if (semi) {
      // last-column cell (d - ly, ly) and last-row cell (lx, d - lx)
      if ((j == p.ly && i <= p.lx) || (i == p.lx && j >= 0 && j <= p.ly)) {
        const Cand c = {bv, bl, i, j, bc};
        if (beats(c, best, false)) best = c;
      }
    } else if (i >= 1 && i <= p.lx && j >= 1 && j <= p.ly) {
      const Cand c = {nm, nlm, i, j, 0};
      if (beats(c, best, true)) best = c;
    }

    if (p.traceback) {
      int bits = mcode;
      if (local && nm <= 0.0f) bits |= 1 << 7;
      if constexpr (COLL) bits |= (psxs << 5) | (psy[q] << 6);
      else bits |= ((int)stay_x << 5) | ((int)stay_y << 6);
      out.tb[((size_t)(d - 2) * p.B + p.b) * p.Lp + i] = (uint8_t)bits;
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
};

// Block-wide pick of the semiglobal / local terminal candidates (each
// candidate cell is unique, so the lexicographic best does not depend on the
// order in which the threads met them); the block's best in thread 0.  Every
// thread of the block calls it; red holds a candidate a warp.
__device__ __forceinline__ Cand block_best(Cand best, bool local, Cand* red) {
  const int t = threadIdx.x, warp = t >> 5, wl = t & 31, nw = blockDim.x >> 5;
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
  if (t == 0)
    for (int w = 1; w < nw; ++w)
      if (beats(red[w], best, local)) best = red[w];
  return best;
}

// The problem's terminal, written by one thread.
__device__ __forceinline__ void write_terminal(const Cand& best, int b, const Outs& out) {
  out.score[b] = best.v;
  out.length[b] = best.l;
  out.ti[b] = best.i;
  out.tj[b] = best.j;
  out.tcode[b] = best.c;
}

}  // namespace praline_dp
