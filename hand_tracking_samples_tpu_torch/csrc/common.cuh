// Shared device helpers of the port's kernels.  Built with -fmad=false: every
// a*b+c rounds twice, as the plain PyTorch versions do.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define HTS_EXPORT extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ int hts_warp_incl_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

// Exclusive prefix sum over the block (blockDim.x a multiple of 32, at most
// 1024).  sh: 33 ints of shared memory.  Writes the block total to *total.
// Every thread of the block must call it.
__device__ __forceinline__ int hts_block_excl_scan(int v, int* sh,
                                                   int* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int inc = hts_warp_incl_scan(v);
  if (lane == 31) sh[wid] = inc;
  __syncthreads();
  if (wid == 0) {
    const int w = lane < nw ? sh[lane] : 0;
    const int wi = hts_warp_incl_scan(w);
    if (lane < nw) sh[lane] = wi - w;
    if (lane == 31) sh[32] = wi;
  }
  __syncthreads();
  const int res = sh[wid] + inc - v;
  *total = sh[32];
  __syncthreads();
  return res;
}

// The JAX CPU build's contracted arithmetic (maths/fma.py in the package):
// a fused multiply-add, rounded once.  The plain PyTorch versions compute
// the same correctly rounded value, so kernel and plain version stay
// bit-identical.  (-fmad=false leaves explicit fmaf calls fused.)
__device__ __forceinline__ float hts_fma(float a, float b, float c) {
  return fmaf(a, b, c);
}
// a0*b0 + a1*b1 + a2*b2 as fma(a2, b2, fma(a0, b0, a1*b1))
__device__ __forceinline__ float hts_dot3(float a0, float a1, float a2,
                                          float b0, float b1, float b2) {
  return hts_fma(a2, b2, hts_fma(a0, b0, a1 * b1));
}
// a*b - c*d as fma(a, b, -(c*d))
__device__ __forceinline__ float hts_subp(float a, float b, float c,
                                          float d) {
  return hts_fma(a, b, -(c * d));
}

// ---- 1-D bulk copies (TMA) completing on mbarriers (sm_90) -----------------
// One thread asks for `bytes` (a multiple of 16; both addresses 16-byte
// aligned) to be copied from device memory into shared memory; the copy
// completes on an mbarrier in shared memory, which the consumers wait on
// with the phase parity of its use (0, 1, 0, ... for a barrier's uses in
// order).  Every barrier is initialised with an arrival count of 1: the
// asking thread's arrive.expect_tx is that arrival.
__device__ __forceinline__ unsigned hts_smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void hts_mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   hts_smem_addr(bar))
               : "memory");
}
// after the inits, before the first copy: the barriers visible to the
// async proxy
__device__ __forceinline__ void hts_fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// orders this thread's earlier generic-proxy accesses (device or shared
// memory) before later bulk copies that read or overwrite the same bytes
__device__ __forceinline__ void hts_fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}
// the asking thread's arrival on bar (which then waits for `bytes` to
// land), and the copy
__device__ __forceinline__ void hts_bulk_load(void* dst, const void* src,
                                              unsigned bytes,
                                              uint64_t* bar) {
  const unsigned b = hts_smem_addr(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(b),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(hts_smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
}
__device__ __forceinline__ void hts_mbar_wait(uint64_t* bar,
                                              unsigned parity) {
  const unsigned b = hts_smem_addr(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
  } while (!done);
}
