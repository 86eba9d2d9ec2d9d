// cp.async helpers of the Hopper kernels that stage operands in shared
// memory: csrc/score_box.cuh (the producer's and the fused DP's bands and
// limbs) and csrc/tiled_dp.cu (the next box of hs).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void copy_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
