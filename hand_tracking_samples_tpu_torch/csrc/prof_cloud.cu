// The kernels of the profiling tools: the cloud kernel cut after each of its
// stages, and the sum-only kernel at several tracks a block.
//
// cloud_stage_kernel<STAGE> replaces the Pallas kernel
// tools/prof_cloud_kernel.py:38 (make_stage_kernel, launched at :172).  The
// TPU tool cuts its cloud kernel after each stage and writes a value that
// depends on everything before the cut, so that nothing is dropped as dead
// code; this kernel cuts the port's own cloud kernel (cloud_kernel.cu) after
// the matching pass and writes the value the TPU stage writes, so its stage
// times attribute the H100 kernel.  Input: a track's depth raster as f32
// (R, 128) (R = H*W/128 rows of 128 pixels, each pixel a u16 depth as an
// integer-valued float) and the scalars lo, hi, scale; output (S, 8) f32:
//   stage 0: the load and one reduction: sum of draw*scale everywhere
//   stage 1: + the valid count and ranks: total + sum(kept) + sum(k_in),
//            k_in the kept count of a pixel's 128-pixel row up to it
//   stage 2: + the compaction: total + sum(cz) + sum(cl) over the kept
//            pixels (cz the raw depth, cl the lane = pixel % 128)
//   stage 3: + the slot pick: the sum over slots of the high depth byte of
//            the first kept pixel of the row the slot picks (the TPU's
//            one-hot row pick: the largest row whose kept base <= t_s,
//            t_s = s*K/S when K > S, else s)
//   stage 4: the full output, (px, py, z*scale, ok, 0, 0, 0, 0) a slot
// Stages 0-3 write their value into every element.  The kept rule is the
// TPU's float rule floor(r*inv)*frac == r on the valid rank r, and a row's
// kept base its floor((base + frac - 1)*inv); for frac <= 16 and ranks
// below 2^20 both equal the integer forms r % frac == 0 and
// ceil(base/frac) (checked over every rank by tests/test_torch_tools.py),
// which the kernel uses.  Stages 1-3 sum integers exactly (64-bit) and
// round once to float32; stage 0 sums the float32 products in float64 in a
// fixed order.  Stage 4 is bit for bit the TPU stage's output.
//
// group_sum_kernel replaces the Pallas kernels tools/prof_cloud_mt.py:35
// (launched at :41) and tools/prof_cloud_pre.py:29 (launched at :34): the
// sum of draw*scale over a group of trk tracks' rasters, broadcast to
// (8, 128).  One block a group; each thread sums its float4 loads in
// float64, then a warp-shuffle tree and the warps' totals in order: one
// fixed order.
//
// Bound on the H100: bytes.  A track's f32 raster is 307.2 KB (240 x 320);
// the outputs are 64 KB a track (stages) and 4 KB a group (sums).
#include "common.cuh"

#define PS_THREADS 512    // threads a block of the stage kernel (a track)
#define PS_NW (PS_THREADS / 32)
#define GS_THREADS 1024   // threads a block of the group sum (a group)
#define GS_UNROLL 4       // float4 loads in flight a thread

// Pixel k (0..7) of a unit of 8 pixels (two float4 loads).
__device__ __forceinline__ float ps_px(const float4& a, const float4& b,
                                       int k) {
  const float4& v = k < 4 ? a : b;
  const int j = k & 3;
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ long long ps_ceil_div(long long x, int f) {
  return (x + f - 1) / f;
}

// Block sums in one fixed order: each warp's shuffle tree, then warp 0
// adds the warps' totals in warp order.  sh: 32 entries.  Every thread of
// the block calls it; every thread gets the total.
template <typename V>
__device__ __forceinline__ V ps_block_sum(V v, V* sh) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();
  if (lane == 0) sh[wid] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    V s = sh[0];
    for (int w = 1; w < nw; ++w) s += sh[w];
    sh[0] = s;
  }
  __syncthreads();
  return sh[0];
}

// Exclusive scan of the (tile, warp) totals a[i * PS_NW + w] in tile-major
// order (cloud_kernel.cu's ck_block_scan): afterwards (tile i, warp w)
// starts at tt[i] + a[i * PS_NW + w], and tt[ntile] is the total.
__device__ __forceinline__ void ps_block_scan(int* a, int* tt, int ntile) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();
  for (int i = wid; i < ntile; i += PS_NW) {
    const int c = lane < PS_NW ? a[i * PS_NW + lane] : 0;
    const int inc = hts_warp_incl_scan(c);
    if (lane < PS_NW) a[i * PS_NW + lane] = inc - c;
    if (lane == 31) tt[i] = inc;
  }
  __syncthreads();
  if (wid == 0) {
    const int run = (ntile + 31) / 32;
    const int i0 = min(lane * run, ntile), i1 = min(i0 + run, ntile);
    int s = 0;
    for (int i = i0; i < i1; ++i) s += tt[i];
    const int inc = hts_warp_incl_scan(s);
    int r = inc - s;
    for (int i = i0; i < i1; ++i) {
      const int c = tt[i];
      tt[i] = r;
      r += c;
    }
    if (lane == 31) tt[ntile] = inc;
  }
  __syncthreads();
}

// Shared memory of a stage-kernel block: per unit its valid mask byte and
// its warp prefix byte, the (tile, warp) totals, the tile totals, then R
// kept bases and R row values (stages 3-4), then 32 int64 for the sums.
__host__ __device__ __forceinline__ size_t ps_smem(int ntile, int R) {
  const size_t units = (size_t)ntile * PS_THREADS;
  return ((2 * units + 15) & ~(size_t)15) +
         (((size_t)ntile * (PS_NW + 1) + 1 + 2 * (size_t)R) * sizeof(int) +
          15 & ~(size_t)15) +
         32 * sizeof(long long);
}

// Writes v into every element of the track's (S, 8) output.
__device__ __forceinline__ void ps_fill(float* o, int S, float v) {
  float4* o4 = reinterpret_cast<float4*>(o);
  const float4 q = make_float4(v, v, v, v);
  for (int i = threadIdx.x; i < 2 * S; i += blockDim.x) o4[i] = q;
}

template <int STAGE>
__global__ void __launch_bounds__(PS_THREADS)
cloud_stage_kernel(const float* __restrict__ draw, float* __restrict__ out,
                   int HW, int W, int frac, int S, float lo, float hi,
                   float scale) {
  extern __shared__ __align__(16) unsigned char ps_sh[];
  const int t = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, wid = tid >> 5;
  const int nu = HW >> 3;             // units of 8 pixels
  const int R = HW >> 7;              // rows of 128 pixels
  const int ntile = (nu + PS_THREADS - 1) / PS_THREADS;
  const size_t units = (size_t)ntile * PS_THREADS;
  unsigned char* msk = ps_sh;
  unsigned char* pre = ps_sh + units;
  int* wt = (int*)(ps_sh + ((2 * units + 15) & ~(size_t)15));
  int* tt = wt + ntile * PS_NW;       // ntile + 1
  int* kbase = tt + ntile + 1;        // R
  int* rowv = kbase + R;              // R
  long long* red = (long long*)(ps_sh + ps_smem(ntile, R) -
                                32 * sizeof(long long));
  const float4* d4 = reinterpret_cast<const float4*>(draw + (size_t)t * HW);
  float* o = out + (size_t)t * S * 8;

  if (STAGE == 0) {
    double acc = 0.0;
    for (int l = tid; l < nu; l += PS_THREADS) {
      const float4 a = __ldg(d4 + 2 * l), b = __ldg(d4 + 2 * l + 1);
#pragma unroll
      for (int k = 0; k < 8; ++k) acc += (double)__fmul_rn(ps_px(a, b, k),
                                                           scale);
    }
    const double s = ps_block_sum(acc, (double*)red);
    ps_fill(o, S, (float)s);
    return;
  }

  // pass 1: the valid masks, a warp's exclusive prefix a unit
  for (int i = 0; i < ntile; ++i) {
    const int l = i * PS_THREADS + tid;
    unsigned m = 0u;
    if (l < nu) {
      const float4 a = __ldg(d4 + 2 * l), b = __ldg(d4 + 2 * l + 1);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float d = __fmul_rn(ps_px(a, b, k), scale);
        m |= (d >= lo && d < hi) ? 1u << k : 0u;
      }
    }
    const int c = __popc(m);
    const int inc = hts_warp_incl_scan(c);
    msk[l] = (unsigned char)m;
    pre[l] = (unsigned char)(inc - c);
    if (lane == 31) wt[i * PS_NW + wid] = inc;
  }
  ps_block_scan(wt, tt, ntile);
  // the valid rank of unit l's first pixel
  auto rank = [&](int l) {
    return tt[l / PS_THREADS] + wt[(l / PS_THREADS) * PS_NW +
                                   ((l % PS_THREADS) >> 5)] + pre[l];
  };
  const int V = tt[ntile];
  const long long K = ps_ceil_div(V, frac);   // the kept count (= total)

  if (STAGE == 1) {
    long long acc = 0;
    for (int l = tid; l < nu; l += PS_THREADS) {
      const long long r0 = rank(l);
      const long long kb = ps_ceil_div(rank((l >> 4) << 4), frac);
      const unsigned m = msk[l];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        acc += ps_ceil_div(r0 + __popc(m & ((2u << k) - 1u)), frac) - kb;
    }
    const long long s = ps_block_sum(acc, red);
    ps_fill(o, S, (float)(2 * K + s));
    return;
  }

  if (STAGE >= 3) {
    for (int r = tid; r < R; r += PS_THREADS) {
      kbase[r] = (int)ps_ceil_div(rank(r << 4), frac);
      rowv[r] = 0;
    }
    __syncthreads();
  }

  // pass 2: the kept pixels of each unit (read again, from L2)
  const bool thin = K > S;
  long long acc = 0;
  for (int l = tid; l < nu; l += PS_THREADS) {
    const unsigned m = msk[l];
    if (m == 0u) continue;
    const float4 a = __ldg(d4 + 2 * l), b = __ldg(d4 + 2 * l + 1);
    long long r = rank(l);
    for (unsigned bits = m; bits != 0u; bits &= bits - 1u, ++r) {
      if (r % frac) continue;
      const long long kr = r / frac;          // the kept rank
      const int k = __ffs(bits) - 1;
      const int p = 8 * l + k;                // the pixel
      const float raw = ps_px(a, b, k);
      if (STAGE == 2) {
        acc += (long long)raw + (p & 127);
      } else if (STAGE == 3) {
        if (kr == kbase[p >> 7]) rowv[p >> 7] = (int)raw >> 8;
      } else {
        long long s = kr;       // the slot whose t_s is kr, if any
        if (thin) {
          s = (kr * S + K - 1) / K;
          if (s >= S || s * K >= (kr + 1) * S) continue;
        }
        float4* q = reinterpret_cast<float4*>(o + 8 * s);
        q[0] = make_float4((float)(p % W), (float)(p / W),
                           __fmul_rn(raw, scale), 1.0f);
        q[1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
  }
  if (STAGE == 2) {
    const long long s = ps_block_sum(acc, red);
    ps_fill(o, S, (float)(K + s));
    return;
  }
  if (STAGE == 3) {
    __syncthreads();
    for (int s = tid; s < S; s += PS_THREADS) {
      const long long ts = thin ? (long long)s * K / S : s;
      int a = 0, b = R - 1;     // the largest row with kbase <= ts
      while (a < b) {
        const int c = (a + b + 1) >> 1;
        if (kbase[c] <= ts) a = c; else b = c - 1;
      }
      acc += rowv[a];
    }
    const long long s = ps_block_sum(acc, red);
    ps_fill(o, S, (float)s);
    return;
  }
  // stage 4: the empty slots pick the last row and no lane
  const int pl = (R - 1) * 128;
  const float4 e = make_float4((float)(pl % W), (float)(pl / W), 0.0f, 0.0f);
  for (long long s = (K < S ? K : S) + tid; s < S; s += PS_THREADS) {
    float4* q = reinterpret_cast<float4*>(o + 8 * s);
    q[0] = e;
    q[1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

__global__ void __launch_bounds__(GS_THREADS)
group_sum_kernel(const float4* __restrict__ draw, float* __restrict__ out,
                 long long n4, float scale) {
  __shared__ double sh[32];
  const float4* d = draw + (size_t)blockIdx.x * n4;
  double acc = 0.0;
  for (long long i0 = threadIdx.x; i0 < n4;
       i0 += (long long)GS_UNROLL * GS_THREADS) {
    float4 v[GS_UNROLL];
#pragma unroll
    for (int u = 0; u < GS_UNROLL; ++u) {
      const long long i = i0 + (long long)u * GS_THREADS;
      v[u] = i < n4 ? __ldg(d + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < GS_UNROLL; ++u) {
      acc += (double)__fmul_rn(v[u].x, scale);
      acc += (double)__fmul_rn(v[u].y, scale);
      acc += (double)__fmul_rn(v[u].z, scale);
      acc += (double)__fmul_rn(v[u].w, scale);
    }
  }
  const float s = (float)ps_block_sum(acc, sh);
  float4* o = reinterpret_cast<float4*>(out + (size_t)blockIdx.x * 1024);
  if (threadIdx.x < 256) o[threadIdx.x] = make_float4(s, s, s, s);
}

// draw: (T, H*W) f32 (each track's raster as rows of 128); out: (T, S, 8)
// f32.  Requires HW a positive multiple of 128, 1 <= frac <= 16, S >= 1,
// 0 <= stage <= 4, and the block's shared memory within 227 KB.
HTS_EXPORT int hts_cloud_stage(const void* draw, void* out, int T, int HW,
                               int W, int frac, int S, int stage, float lo,
                               float hi, float scale, void* stream) {
  if (HW < 128 || HW % 128 != 0 || W < 1 || frac < 1 || frac > 16 ||
      S < 1 || stage < 0 || stage > 4)
    return (int)cudaErrorInvalidValue;
  const int ntile = (HW / 8 + PS_THREADS - 1) / PS_THREADS;
  const size_t smem = ps_smem(ntile, HW / 128);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (T <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
#define PS_LAUNCH(N)                                                        \
  case N: {                                                                 \
    if (smem > 48 * 1024) {                                                 \
      const cudaError_t e = cudaFuncSetAttribute(                           \
          cloud_stage_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
          (int)smem);                                                       \
      if (e != cudaSuccess) return (int)e;                                  \
    }                                                                       \
    cloud_stage_kernel<N><<<T, PS_THREADS, smem, st>>>(                     \
        (const float*)draw, (float*)out, HW, W, frac, S, lo, hi, scale);    \
    break;                                                                  \
  }
  switch (stage) {
    PS_LAUNCH(0)
    PS_LAUNCH(1)
    PS_LAUNCH(2)
    PS_LAUNCH(3)
    PS_LAUNCH(4)
  }
#undef PS_LAUNCH
  return (int)cudaGetLastError();
}

// draw: (G, n) f32 with n a positive multiple of 4 (a group's rasters);
// out: (G, 8, 128) f32, each group's sum of draw*scale.
HTS_EXPORT int hts_group_sum(const void* draw, void* out, int G,
                             long long n, float scale, void* stream) {
  if (n < 4 || n % 4 != 0) return (int)cudaErrorInvalidValue;
  if (G <= 0) return (int)cudaGetLastError();
  group_sum_kernel<<<G, GS_THREADS, 0, (cudaStream_t)stream>>>(
      (const float4*)draw, (float*)out, n / 4, scale);
  return (int)cudaGetLastError();
}
