// Point -> hull correspondence and ray-clip reductions: replaces the Pallas
// kernel hand_tracking_samples_tpu/ops/correspondence.py:32 (_kernel,
// launched by correspondence_reductions at :76).  The same function as
// correspondence_reductions_plain in ops/correspondence.py.
//
// For every (track t, body b, point n), over the body's P world planes
// (x, y, z, w) and the origin's plane dots a = d0:
//   d1[p]    = fma(z, pz, fma(y, py, x*px)) + w    (the plane value)
//   hull_val = max_p d1,  pidx = first p reaching it
//   miss     = any_p (a >= 0 && d1 >= 0)
//   t[p]     = denom != 0 ? a / denom : 0,  denom = a - d1
//   t_enter  = max_p (a >= 0 && d1 < 0 ? t : 0)
//   t_exit   = min_p (a <= 0 && d1 > 0 ? t : 1)
//
// Design: 512-point blocks, grid (N / 512, T), 4 consecutive points a
// thread, so a warp's 128 points are consecutive in the cloud (loads and
// stores are float4 / int4).  Each block stages its track's planes
// (x, y, z, w as a float4, and a, of all B x P planes: 32.6 KB at 17 x 96)
// in dynamic shared memory; every thread of the block reads the same plane
// at the same time (a broadcast), and each plane read serves the thread's
// 4 points.  No MXU tile: the TPU kernel's (P, 8) x (8, N) matmul becomes
// 3 multiply-adds a plane.
//
// The slab clip, split by the side of each plane's origin dot a.  a is the
// same for every point of the block, so a branch on its sign is uniform: an
// a > 0 plane can touch only miss and the enter bound (d1 >= 0 sets miss,
// d1 < 0 is an enter candidate), an a < 0 plane only the exit bound (d1 > 0
// is an exit candidate), an a == 0 plane miss and the exit bound (its enter
// quotients are 0 and never raise the bound).
//
// No division in the plane loop.  Each bound is carried as the fraction
// (aw, dw) of its best candidate so far, starting at 0/1 (enter) and -1/-1
// (exit, = 1); a candidate (a, den = a - d1) replaces it where its quotient
// is exactly larger (enter) or smaller (exit).  The denominators of a clip
// condition have the carried one's sign and are never 0 (a >= 0 > d1 or
// a <= 0 < d1), so that is aw*den < a*dw (enter) or a*dw < aw*den (exit):
// co_less compares the rounded products, which order the exact ones unless
// they are equal, and equal ones again in float64, where a product of two
// float32 numbers is exact.  One IEEE division a (point, body, side) after
// the loop turns the kept fraction into the bound; rounding is monotone, so
// max_p RN(a_p / den_p) = RN(max_p a_p / den_p) (tied quotients round
// alike), and the result is the plain version's bit for bit.
//
// A filter keeps that comparison off most candidates.  A candidate can beat
// the kept enter fraction only if d1 > -a K, K = dw / (aw (1 - 2^-24)) - 1
// (den is a - d1 rounded, within 2^-24 of it), and the kept exit fraction
// (a, den) = (-A, -D) only if d1 > A L, L = Dw / (Aw (1 + 2^-24)) - 1.
// Each point carries a K no smaller and an L no larger (co_enter_slope,
// co_exit_slope: an approximate reciprocal within 2^-22, margins of 2^-20
// in directed rounding), so every winning candidate passes
// fmaf(a, K, d1) * d1 <= 0 (enter: -a K <= d1 <= 0; one compare on the ALU
// pipe, the rest on the FMA pipes) or fmaf(a, L, d1) >= 0 (exit): the
// filter only lets through more candidates than win, never fewer (on the
// dyn30 clouds it passes 6.8% of the plane evaluations, replacements
// 6.79%).  K starts infinite (every enter candidate beats 0/1).  Where some
// lane of the warp passes (at 24% of a warp's planes on those clouds), the
// warp compares all its candidates of that plane exactly and each lane
// replaces its fraction and recomputes its slope where its candidate wins.
//
// Bound on the H100: operations.  Per plane evaluation 1 mul, 2 fma, 1 add
// (the value), 2 compares (max), 4 compares and selects (slab), plus a
// subtract and a division where a clip condition holds (chip_smoke.py
// counts those from the data): 512 tracks x 17 x 96 x 2048 points = 1.71 G
// evaluations, ~22 G operations, 0.33 ms at 67 TFLOP/s.  Bytes: 5 x 4 B out
// a (track, body, point), 356 MB at T=512: 0.11 ms at 3.35 TB/s.  The
// issue floor of the first-max scan alone (4 instructions for the value,
// 3 for the max and its index) is 0.36 ms at the card's largest SM clock
// (chip_smoke.py's issue_floor_ms).  On an H100 (700 W) at T=512 the
// kernel takes ~1.25 ms: the scan with the per-plane side branch ~0.72,
// the filters ~0.27, the exact branch ~0.26 (variants without them).
#include "common.cuh"

#define CO_BLOCK 512      // points a block
#define CO_PPT 4          // points a thread, consecutive (one float4)
static_assert(CO_PPT == 4, "the stores below write one float4 a thread");
#define CO_THREADS (CO_BLOCK / CO_PPT)

// The exact comparison of a warp's candidates, where the filter let one
// through: less[j] = cand[j] && x0[j]*y0[j] < x1[j]*y1[j], exactly, for
// float32 numbers (see the note above).  The float64 comparison sits behind
// one warp vote, so only a warp with some lane's rounded products equal
// takes it.  Every lane of the warp calls it.
__device__ __forceinline__ void co_less(const bool (&cand)[CO_PPT],
                                        const float (&x0)[CO_PPT],
                                        const float (&y0)[CO_PPT],
                                        const float (&x1)[CO_PPT],
                                        const float (&y1)[CO_PPT],
                                        bool (&less)[CO_PPT]) {
  bool tie[CO_PPT], any_tie = false;
#pragma unroll
  for (int j = 0; j < CO_PPT; ++j) {
    const float p0 = x0[j] * y0[j], p1 = x1[j] * y1[j];
    less[j] = cand[j] && p0 < p1;
    tie[j] = cand[j] && p0 == p1;
    any_tie |= tie[j];
  }
  if (__any_sync(0xffffffffu, any_tie)) {
#pragma unroll
    for (int j = 0; j < CO_PPT; ++j)
      if (tie[j])
        less[j] =
            (double)x0[j] * (double)y0[j] < (double)x1[j] * (double)y1[j];
  }
}

// A plane's r, taken where the warp compares its candidates exactly: 1/|a|
// within 2^-22 (an approximate reciprocal) for 2^-100 <= |a|; where |a| is
// smaller (a subnormal among them) the reciprocal may overflow, so
// r = infinity for a > 0 (K infinite: every candidate passes) and r = 0
// for a < 0 (L = -1: every candidate passes); for a = 0, r = infinity (L
// infinite: a quotient of 0 is the least, nothing passes; no enter slope
// is taken at a = 0).
__device__ __forceinline__ float co_plane_rcp(float a) {
  const float A = fabsf(a);
  if (A == 0.0f) return INFINITY;
  if (!(A >= 0x1p-100f)) return a > 0.0f ? INFINITY : 0.0f;
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(A));
  return r;
}
// K >= den / (a (1 - 2^-24)) - 1 for the kept enter fraction (a, den)
__device__ __forceinline__ float co_enter_slope(float den, float r) {
  return __fmaf_ru(__fmul_ru(den, r), 1.0f + 0x1p-20f, -1.0f);
}
// L <= D / (A (1 + 2^-24)) - 1 for the kept exit fraction (-A, -D)
__device__ __forceinline__ float co_exit_slope(float den, float r) {
  return __fmaf_rd(__fmul_rd(-den, r), 1.0f - 0x1p-20f, -1.0f);
}

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
  extern __shared__ float4 sh4[];                // B*P planes, then their a
  const int t = blockIdx.y;
  const int BP = B * P;
  float4* spl = sh4;
  float* sd = (float*)(sh4 + BP);
  const float4* pl = (const float4*)(planes + (size_t)t * BP * 8);
  const float* dd = d0g + (size_t)t * BP;
  for (int i = threadIdx.x; i < BP; i += blockDim.x) {
    spl[i] = pl[2 * i];                          // lanes 0-3 of the record
    sd[i] = dd[i];
  }
  __syncthreads();
  // points n0 .. n0 + 3 of this thread: a warp's 128 points are
  // consecutive in the cloud, so its lanes' clip candidates win at much
  // the same planes (the exact branch below is taken for the warp at ~24%
  // of its planes on the dyn30 clouds, against ~41% with its points 128
  // apart); loads and stores are float4 (int4)
  const int n0 = (blockIdx.x * CO_THREADS + threadIdx.x) * CO_PPT;
  const float* pt = pts_h + (size_t)t * 8 * N + n0;
  float px[CO_PPT], py[CO_PPT], pz[CO_PPT];
#pragma unroll
  for (int j = 0; j < CO_PPT; ++j) {
    px[j] = pt[j];
    py[j] = pt[N + j];
    pz[j] = pt[2 * N + j];
  }
  for (int b = 0; b < B; ++b) {
    // best plane value and its index; the largest d1 of an a >= 0 plane
    // (miss = it is >= 0); the enter and exit fractions and filter slopes
    float best[CO_PPT], mp[CO_PPT], ae[CO_PPT], de[CO_PPT], ke[CO_PPT],
        ax[CO_PPT], dx[CO_PPT], lx[CO_PPT];
    int bi[CO_PPT];
#pragma unroll
    for (int j = 0; j < CO_PPT; ++j) {
      best[j] = 0.0f;
      bi[j] = 0;
      mp[j] = -INFINITY;
      ae[j] = 0.0f;
      de[j] = 1.0f;
      ke[j] = INFINITY;
      ax[j] = -1.0f;
      dx[j] = -1.0f;
      lx[j] = co_exit_slope(-1.0f, 1.0f);
    }
    const float4* wp = spl + b * P;
    const float* ap = sd + b * P;
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
      const float4 w = wp[p];
      const float a = ap[p];
      float d1[CO_PPT];
#pragma unroll
      for (int j = 0; j < CO_PPT; ++j) {
        d1[j] = hts_fma(w.z, pz[j], hts_fma(w.y, py[j], w.x * px[j])) + w.w;
        if (p == 0 || d1[j] > best[j]) {
          best[j] = d1[j];
          bi[j] = p;
        }
      }
      bool any = false;
      if (a > 0.0f) {        // uniform: miss and the enter candidates
#pragma unroll
        for (int j = 0; j < CO_PPT; ++j) {
          mp[j] = fmaxf(mp[j], d1[j]);
          // a candidate that can win has -a K < d1 < 0, so the product of
          // fmaf(a, K, d1) (never below d1) and d1 is <= 0
          any |= fmaf(a, ke[j], d1[j]) * d1[j] <= 0.0f;
        }
        if (__any_sync(0xffffffffu, any)) {
          bool cand[CO_PPT], less[CO_PPT];
          float den[CO_PPT], av[CO_PPT];
#pragma unroll
          for (int j = 0; j < CO_PPT; ++j) {
            cand[j] = d1[j] < 0.0f;
            den[j] = a - d1[j];
            av[j] = a;
          }
          co_less(cand, ae, den, av, de, less);     // ae/de < a/den
          const float r = co_plane_rcp(a);
#pragma unroll
          for (int j = 0; j < CO_PPT; ++j)
            if (less[j]) {
              ae[j] = a;
              de[j] = den[j];
              ke[j] = co_enter_slope(den[j], r);
            }
        }
      } else {  // uniform: exit candidates (a = 0: miss too; a NaN: none)
#pragma unroll
        for (int j = 0; j < CO_PPT; ++j) {
          if (a == 0.0f) mp[j] = fmaxf(mp[j], d1[j]);
          any |= fmaf(a, lx[j], d1[j]) >= 0.0f;
        }
        if (__any_sync(0xffffffffu, any)) {
          bool cand[CO_PPT], less[CO_PPT];
          float den[CO_PPT], av[CO_PPT];
#pragma unroll
          for (int j = 0; j < CO_PPT; ++j) {
            cand[j] = d1[j] > 0.0f;
            den[j] = a - d1[j];
            av[j] = a;
          }
          co_less(cand, av, dx, ax, den, less);     // a/den < ax/dx
          const float r = co_plane_rcp(a);
#pragma unroll
          for (int j = 0; j < CO_PPT; ++j)
            if (less[j]) {
              ax[j] = a;
              dx[j] = den[j];
              lx[j] = co_exit_slope(den[j], r);
            }
        }
      }
    }
    const size_t o = ((size_t)t * B + b) * N + n0;
    *(float4*)(hull_val + o) = make_float4(best[0], best[1], best[2],
                                           best[3]);
    *(int4*)(pidx_out + o) = make_int4(bi[0], bi[1], bi[2], bi[3]);
    *(float4*)(t_enter_out + o) = make_float4(
        ae[0] / de[0], ae[1] / de[1], ae[2] / de[2], ae[3] / de[3]);
    *(float4*)(t_exit_out + o) = make_float4(
        ax[0] / dx[0], ax[1] / dx[1], ax[2] / dx[2], ax[3] / dx[3]);
    *(int4*)(miss_out + o) = make_int4(mp[0] >= 0.0f, mp[1] >= 0.0f,
                                       mp[2] >= 0.0f, mp[3] >= 0.0f);
  }
}

HTS_EXPORT int hts_correspondence(const float* pts_h, const float* planes,
                                  const float* d0, float* hull_val,
                                  int* pidx, float* t_enter, float* t_exit,
                                  int* miss, int T, int B, int P, int N,
                                  void* stream) {
  if (T <= 0) return 0;
  if (N % CO_BLOCK) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)planes | (uintptr_t)hull_val | (uintptr_t)pidx
       | (uintptr_t)t_enter | (uintptr_t)t_exit | (uintptr_t)miss) % 16)
    return (int)cudaErrorMisalignedAddress;   // float4 loads and stores
  const size_t smem = (size_t)B * P * (sizeof(float4) + sizeof(float));
  dim3 grid((N + CO_BLOCK - 1) / CO_BLOCK, T);
  correspondence_kernel<<<grid, CO_THREADS, smem, (cudaStream_t)stream>>>(
      pts_h, planes, d0, hull_val, pidx, t_enter, t_exit, miss, B, P, N);
  return (int)cudaGetLastError();
}
