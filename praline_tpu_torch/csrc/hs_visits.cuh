// The hs score source of the walks over the skewed score tensor hs
// f32[D, B, Lp] (csrc/scores*.cu's output): csrc/wavefront_dp.cu (K2/K4)
// and csrc/tiled_dp.cu (K6 on its hs source).  The walk
// (csrc/cluster_walk.cuh) calls prepare() for each visit it runs, and each
// thread copies its own lane's scores of the next visit into shared memory
// by cp.async while the DP steps through the current one, so a step reads
// its score from shared memory and no step waits on device memory (with Q
// lanes a thread, each thread copies its Q lanes).
// HsSource is the source walk_kernel (csrc/cluster_walk.cuh) takes.

#pragma once

#include "async_copy.cuh"
#include "cluster_walk.cuh"

namespace praline_dp {

// The scores of one visit: box d0 .. d0 + T - 1 on the tile at lane i0,
// diagonal-major in shared memory.
struct HsBox {
  const float* box;
  int W, d0, i0;
  __device__ __forceinline__ float operator()(int d, int i) const {
    return box[(d - d0) * W + (i - i0)];
  }
};

// Double-buffered boxes hbuf[2][T][W] (Q lanes a thread: thread t's are
// t Q .. t Q + Q - 1).
template <int Q = 1>
struct HsVisits {
  const float* hs;
  float* hbuf;
  int B, Lp, b, W, T, dend, slot;
  bool started;

  // This thread's lanes of the visit (d0, i0) into half s of hbuf.
  __device__ __forceinline__ void fetch(int s, int d0, int i0) const {
    const int i = i0 + threadIdx.x * Q;
    float* dst = hbuf + s * T * W + threadIdx.x * Q;
    for (int q = 0; q < T; ++q) {
      const int d = d0 + q;
#pragma unroll
      for (int l = 0; l < Q; ++l) {
        const bool ok = d <= dend && i + l < Lp;
        copy_async<4>(dst + q * W + l, ok ? hs + ((size_t)d * B + b) * Lp + i + l : hs, ok);
      }
    }
    copy_commit();
  }

  // The visit (d0, i0) ready, the next one (nd0, ni0; nd0 < 0: none) on
  // its way.
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
    return box;  // each thread reads only the lanes it copied: no barrier
  }
};

// walk_kernel's score source hs f32[D, B, Lp], at Q lanes a thread.
struct HsSource {
  const float* hs;
  __host__ __device__ static constexpr int smem(int W, int T) { return hs_smem(W, T); }
  __device__ __forceinline__ bool takes(int) const { return true; }
  template <int Q = 1>
  __device__ __forceinline__ HsVisits<Q> visits(const WalkArgs& a, int b, int dend,
                                                float* hbuf) const {
    return HsVisits<Q>{hs, hbuf, a.B, a.Lp, b, a.W, a.T, dend, 0, false};
  }
};

}  // namespace praline_dp
