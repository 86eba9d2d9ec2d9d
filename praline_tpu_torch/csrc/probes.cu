// Roofline and write probes for Hopper (sm_90a).
//
// Replace the TPU kernels of the repository's benchmark:
//
//   alu_chains    bench.py::bench_utilization.run_alu (K8): NACC = 4
//                 independent chains per element (the TPU kernel's NACC),
//                 seeded x * (1 + 0.125 c), each taking
//                 `links` links of v = max(v * 0.999, v - 1.0), then summed
//                 in chain order ((a0 + a1) + a2) + ...
//   smem_chain    bench.py::bench_utilization.run_vmem (K7): `links` links of
//                 the same step per element, every link a round trip through
//                 on-chip memory (VMEM on the TPU, shared memory here).
//   write_blocks  tools/onchip_wprobe.py::make_writer (K9): fills a tensor
//                 with x[0], one (pb, rows, lanes) write block a block (the
//                 TPU text's "x + zeros" is a broadcast: XLA folds the add,
//                 so -0.0 stays -0.0).
//
// Every multiply, subtract and add of the chains is one IEEE-rounded f32
// operation (__fmul_rn, __fsub_rn, __fadd_rn; the build passes --fmad=false
// and no flush-to-zero), so the results equal the plain PyTorch versions in
// kernels/probes.py bit for bit, subnormals included.  fmaxf does not
// propagate a NaN as torch.maximum does; no link makes one from a number.
//
// What bounds each on the H100:
//   alu_chains   operations.  Each thread keeps its NACC chains in registers
//                (NACC independent dependency chains give the scheduler
//                instruction-level parallelism); one thread an element, so
//                the array shape decides how many of the 132 SMs work.
//   smem_chain   operations in the roofline's count (three a link), but the
//                link itself is a dependent round trip through shared memory:
//                each thread reads its element through a volatile pointer,
//                applies one link and writes it back, so no link's value can
//                stay in a register.  What it measures is the rate at which
//                a dependent chain through shared memory runs, the Hopper
//                counterpart of a VMEM round trip.
//   write_blocks bytes: the output is written once and nothing is read but
//                one float.  A block owns one write block (the blocks in
//                the order of the grid, the store pattern the probe
//                measures); each of its 16 warps writes whole rows of it,
//                16 bytes a thread (st.global.v4: 512 contiguous bytes a
//                warp instruction), with scalar stores only for the floats
//                before a row's first 16-byte boundary and after its last.
//                Sixteen warps a block rather than four keep more blocks'
//                stores in flight at the grid's ragged last wave.  The
//                caller picks the block shape, and strides let a view of
//                the port's hs layout f32[D, B, Lp] be walked as the
//                producers walk it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NACC = 4;
constexpr int ALU_THREADS = 256;
constexpr int SMEM_THREADS = 256;
constexpr int WRITE_THREADS = 512;  // 16 warps, each writing whole rows

__device__ __forceinline__ float chain_link(float v) {
  return fmaxf(__fmul_rn(v, 0.999f), __fsub_rn(v, 1.0f));
}

__global__ void __launch_bounds__(ALU_THREADS)
    alu_chains_kernel(const float* __restrict__ x, float* __restrict__ out,
                      long long n, long long links) {
  const long long e = (long long)blockIdx.x * ALU_THREADS + threadIdx.x;
  if (e >= n) return;
  const float x0 = x[e];
  float acc[NACC];
#pragma unroll
  for (int c = 0; c < NACC; ++c) acc[c] = __fmul_rn(x0, 1.0f + 0.125f * c);
#pragma unroll 16
  for (long long l = 0; l < links; ++l) {
#pragma unroll
    for (int c = 0; c < NACC; ++c) acc[c] = chain_link(acc[c]);
  }
  float sum = acc[0];
#pragma unroll
  for (int c = 1; c < NACC; ++c) sum = __fadd_rn(sum, acc[c]);
  out[e] = sum;
}

__global__ void __launch_bounds__(SMEM_THREADS)
    smem_chain_kernel(const float* __restrict__ x, float* __restrict__ out,
                      long long n, long long links) {
  __shared__ float slice[SMEM_THREADS];
  const int t = threadIdx.x;
  const long long e = (long long)blockIdx.x * SMEM_THREADS + t;
  if (e >= n) return;  // no barrier follows: each thread owns its own word
  volatile float* v = slice;
  v[t] = x[e];
#pragma unroll 16
  for (long long l = 0; l < links; ++l) v[t] = chain_link(v[t]);
  out[e] = v[t];
}

// Axis 2 is contiguous; block q = (q0, q1, q2) of the grid g0 x g1 x g2
// (q2 fastest, as csrc/scores.cu's grid runs x fastest) writes the elements
// [q0*b0, +b0) x [q1*b1, +b1) x [q2*b2, +b2), clipped at the edges: warp w
// its rows w, w + 16, ..., each as a ragged head, float4 stores and a
// ragged tail.
__global__ void __launch_bounds__(WRITE_THREADS)
    write_blocks_kernel(const float* __restrict__ x, float* __restrict__ out,
                        int n0, int n1, int n2, long long s0, long long s1,
                        int b0, int b1, int b2, int g1, int g2) {
  const float v = x[0];
  const float4 v4 = make_float4(v, v, v, v);
  long long q = blockIdx.x;
  const int q2 = (int)(q % g2);
  q /= g2;
  const int q1 = (int)(q % g1);
  const int q0 = (int)(q / g1);
  const int i0 = q0 * b0, i1 = q1 * b1, i2 = q2 * b2;
  const int e0 = min(b0, n0 - i0), e1 = min(b1, n1 - i1), e2 = min(b2, n2 - i2);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int row = warp; row < e0 * e1; row += WRITE_THREADS / 32) {
    const int a = row / e1, r = row - a * e1;
    float* p = out + (i0 + a) * s0 + (i1 + r) * s1 + i2;
    // floats before the first 16-byte boundary (0 to 3)
    const int head = min(e2, (int)((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / 4);
    if (lane < head) p[lane] = v;
    const int n4 = (e2 - head) / 4;
    float4* p4 = reinterpret_cast<float4*>(p + head);
    for (int c = lane; c < n4; c += 32) p4[c] = v4;
    const int tail = head + 4 * n4;
    if (tail + lane < e2) p[tail + lane] = v;
  }
}

}  // namespace

// Each entry point returns cudaGetLastError() after the launch (0 =
// launched), or cudaErrorInvalidValue for arguments the kernel does not take.

// out f32[n] from x f32[n]: NACC chains of `links` links each.
extern "C" int praline_alu_chains(const float* x, float* out, long long n, long long links,
                                  void* stream) {
  if (n < 1 || links < 0 || (n + ALU_THREADS - 1) / ALU_THREADS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n + ALU_THREADS - 1) / ALU_THREADS;
  alu_chains_kernel<<<(unsigned)blocks, ALU_THREADS, 0, (cudaStream_t)stream>>>(x, out, n,
                                                                               links);
  return (int)cudaGetLastError();
}

// out f32[n] from x f32[n]: `links` links each, through shared memory.
extern "C" int praline_smem_chain(const float* x, float* out, long long n, long long links,
                                  void* stream) {
  if (n < 1 || links < 0 || (n + SMEM_THREADS - 1) / SMEM_THREADS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n + SMEM_THREADS - 1) / SMEM_THREADS;
  smem_chain_kernel<<<(unsigned)blocks, SMEM_THREADS, 0, (cudaStream_t)stream>>>(
      x, out, n, links);
  return (int)cudaGetLastError();
}

// Every element of the strided view out[n0, n1, n2] (strides s0, s1, 1, in
// floats) set to x[0], in write blocks of b0 x b1 x b2.
extern "C" int praline_write_blocks(const float* x, float* out, int n0, int n1, int n2,
                                    long long s0, long long s1, int b0, int b1, int b2,
                                    void* stream) {
  if (n0 < 1 || n1 < 1 || n2 < 1 || b0 < 1 || b1 < 1 || b2 < 1)
    return (int)cudaErrorInvalidValue;
  const long long g0 = (n0 + b0 - 1) / b0, g1 = (n1 + b1 - 1) / b1, g2 = (n2 + b2 - 1) / b2;
  if (g0 * g1 * g2 > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  write_blocks_kernel<<<(unsigned)(g0 * g1 * g2), WRITE_THREADS, 0, (cudaStream_t)stream>>>(
      x, out, n0, n1, n2, s0, s1, b0, b1, b2, (int)g1, (int)g2);
  return (int)cudaGetLastError();
}
