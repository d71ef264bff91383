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
