// Point -> hull correspondence and ray-clip reductions: replaces the Pallas
// kernel hand_tracking_samples_tpu/ops/correspondence.py:32 (_kernel,
// launched by correspondence_reductions at :76).  The same function as
// correspondence_reductions_plain in ops/correspondence.py.
//
// For every (track t, body b, point n), over the body's P world planes
// (x, y, z, w) and the origin's plane dots d0:
//   d1[p]    = fma(z, pz, fma(y, py, x*px)) + w    (the plane value)
//   hull_val = max_p d1,  pidx = first p reaching it
//   miss     = any_p (d0 >= 0 && d1 >= 0)
//   t[p]     = denom != 0 ? d0 / denom : 0,  denom = d0 - d1
//   t_enter  = max_p (d0 >= 0 && d1 < 0 ? t : 0)
//   t_exit   = min_p (d0 <= 0 && d1 > 0 ? t : 1)
//
// Design: 512-point blocks, grid (N / 512, T), 4 points a thread (128
// threads a block).  Each block stages its track's planes (x, y, z, w as a
// float4, and d0, of all B x P planes: 32.6 KB at 17 x 96) in dynamic
// shared memory; every thread of a warp reads the same plane at the same
// time (a broadcast), and each plane read serves the thread's 4 points.
// No MXU tile: the TPU kernel's (P, 8) x (8, N) matmul becomes 3
// multiply-adds a plane.
// Division is IEEE (-fmad=false leaves the fmaf calls fused and nothing
// else contracted), and the quotient is taken only where a clip condition
// holds (elsewhere JAX's value is discarded by its select) and only where
// it can raise t_enter or lower t_exit: that test is exact (the sign of
// one fused multiply-add), so the result is the plain version's, and most
// of the ~0.8 G divisions a T=512 frame would take are skipped.
//
// Bound on the H100: operations.  Per plane evaluation 1 mul, 2 fma, 1 add
// (the value), 2 compares (max), 4 compares and selects (slab), plus a
// subtract and a division where a clip condition holds (chip_smoke.py
// counts those from the data): 512 tracks x 17 x 96 x 2048 points = 1.71 G
// evaluations, ~22 G operations, 0.33 ms at 67 TFLOP/s.  Bytes: 5 x 4 B out a (track, body, point), 356 MB at T=512:
// 0.11 ms at 3.35 TB/s.
#include "common.cuh"

#define CO_BLOCK 512      // points a block
#define CO_PPT 4          // points a thread
#define CO_THREADS (CO_BLOCK / CO_PPT)

__global__ void __launch_bounds__(CO_THREADS)
correspondence_kernel(const float* __restrict__ pts_h,   // (T, 8, N)
                      const float* __restrict__ planes,  // (T, B, P, 8)
                      const float* __restrict__ d0g,     // (T, B, P)
                      float* __restrict__ hull_val,      // (T, B, N)
                      int* __restrict__ pidx_out,
                      float* __restrict__ t_enter_out,
                      float* __restrict__ t_exit_out,
                      int* __restrict__ miss_out,
                      int B, int P, int N) {
  extern __shared__ float4 sh4[];                // B*P planes, then d0
  const int t = blockIdx.y;
  const int BP = B * P;
  float4* spl = sh4;
  float* sd = (float*)(sh4 + BP);
  const float* pl = planes + (size_t)t * BP * 8;
  const float* dd = d0g + (size_t)t * BP;
  for (int i = threadIdx.x; i < BP; i += blockDim.x) {
    spl[i] = make_float4(pl[i * 8 + 0], pl[i * 8 + 1], pl[i * 8 + 2],
                         pl[i * 8 + 3]);
    sd[i] = dd[i];
  }
  __syncthreads();
  // point j of this thread: n = base + j * CO_THREADS (coalesced stores)
  const int base = blockIdx.x * CO_BLOCK + threadIdx.x;
  const float* pt = pts_h + (size_t)t * 8 * N;
  float px[CO_PPT], py[CO_PPT], pz[CO_PPT];
#pragma unroll
  for (int j = 0; j < CO_PPT; ++j) {
    const int n = min(base + j * CO_THREADS, N - 1);
    px[j] = pt[n];
    py[j] = pt[N + n];
    pz[j] = pt[2 * N + n];
  }
  for (int b = 0; b < B; ++b) {
    float best[CO_PPT], te[CO_PPT], tx[CO_PPT];
    int bi[CO_PPT], miss[CO_PPT];
#pragma unroll
    for (int j = 0; j < CO_PPT; ++j) {
      best[j] = 0.0f;
      te[j] = 0.0f;
      tx[j] = 1.0f;
      bi[j] = 0;
      miss[j] = 0;
    }
    for (int p = 0; p < P; ++p) {
      const int i = b * P + p;
      const float4 w = spl[i];
      const float a = sd[i];
#pragma unroll
      for (int j = 0; j < CO_PPT; ++j) {
        const float d1 =
            hts_fma(w.z, pz[j], hts_fma(w.y, py[j], w.x * px[j])) + w.w;
        if (p == 0 || d1 > best[j]) {
          best[j] = d1;
          bi[j] = p;
        }
        if (a >= 0.0f && d1 >= 0.0f) miss[j] = 1;
        const bool enter = a >= 0.0f && d1 < 0.0f;
        const bool exit_ = a <= 0.0f && d1 > 0.0f;
        if (enter || exit_) {
          // the quotient a / denom can move the running bound b only if
          // a - b * denom >= 0 (denom > 0 entering, < 0 leaving); the
          // fused multiply-add has the exact difference's sign, so a
          // skipped division could not have changed the result
          const float denom = a - d1;
          const float bnd = enter ? te[j] : tx[j];
          if (fmaf(-bnd, denom, a) >= 0.0f) {
            const float tt = denom != 0.0f ? a / denom : 0.0f;
            if (enter) te[j] = fmaxf(te[j], tt);
            else tx[j] = fminf(tx[j], tt);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < CO_PPT; ++j) {
      const int n = base + j * CO_THREADS;
      if (n >= N) continue;
      const size_t o = ((size_t)t * B + b) * N + n;
      hull_val[o] = best[j];
      pidx_out[o] = bi[j];
      t_enter_out[o] = te[j];
      t_exit_out[o] = tx[j];
      miss_out[o] = miss[j];
    }
  }
}

HTS_EXPORT int hts_correspondence(const float* pts_h, const float* planes,
                                  const float* d0, float* hull_val,
                                  int* pidx, float* t_enter, float* t_exit,
                                  int* miss, int T, int B, int P, int N,
                                  void* stream) {
  if (T <= 0) return 0;
  const size_t smem = (size_t)B * P * (sizeof(float4) + sizeof(float));
  dim3 grid((N + CO_BLOCK - 1) / CO_BLOCK, T);
  correspondence_kernel<<<grid, CO_THREADS, smem, (cudaStream_t)stream>>>(
      pts_h, planes, d0, hull_val, pidx, t_enter, t_exit, miss, B, P, N);
  return (int)cudaGetLastError();
}
