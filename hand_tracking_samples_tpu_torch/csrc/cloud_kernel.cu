// Depth raster -> the budgeted point cloud in the (8, budget) planes carrier.
//
// Replaces the Pallas kernel hand_tracking_samples_tpu/ops/cloud_kernel.py:26
// (_make_kernel, launched at :209 and :229).  Same function as
// imaging.image_ops.cloud_from_depth: range threshold -> every frac-th valid
// pixel in raster order, by the float32 rule floor(r*inv_frac)*frac == r on
// the valid rank r -> exact kept count K -> slot s takes kept rank
// floor(s*K/S) when K > S (uniform thinning, never a tail cut) ->
// deprojection with the reciprocal focal lengths.  Output rows
// [x, y, z, 1, mask, 0, 0, 0]; an empty slot carries the deprojected last
// pixel with mask 0, as the JAX route does.
//
// Bound on the H100: bytes.  A track reads its u16 raster once (320*240*2
// = 153.6 KB) and writes 8*S floats (64 KB at S = 2048): 0.0335 ms at
// 512 tracks and 3.35 TB/s.
//
// Design: one block of CK_THREADS threads a track, three passes.
//   1. One coalesced read.  The raster is read as 16-byte loads of 8
//      pixels, neighbouring threads on neighbouring loads, in tiles of
//      CK_THREADS loads (load l = tile * CK_THREADS + thread), CK_UNROLL
//      tiles in flight a thread.  The range test runs in integers: the
//      wrapper finds the u16 depths [ulo, uhi) whose float32 product with
//      the scale passes it (ops/cloud_kernel.valid_range, over all 65,536
//      values), so a pixel costs a subtract and a compare, no conversion.
//      Each load leaves two bytes in shared memory: its 8-bit valid mask
//      and the exclusive prefix of its warp's valid counts (at most
//      31 * 8 = 248); lane 31 leaves the warp's total.  Raster order is
//      tile-major, then thread, then pixel, so a scan of the (tile, warp)
//      totals (ck_block_scan, in two levels) gives every load's valid rank.
//   2. Kept ranks.  For a power-of-two frac the rule is exact and means
//      r % frac == 0: ceil(X / frac) pixels are kept below valid rank X,
//      arithmetic, with no second pass (the JAX kernel's pow2 branch).  A
//      general frac evaluates the float rule per valid pixel and scans the
//      kept counts as pass 1 scanned the valid ones.
//   3. Each kept pixel writes its own slot.  K <= S: kept rank k goes to
//      slot k.  K > S: to slot s = ceil(k*S/K) when s < S and
//      s*K < (k+1)*S, i.e. floor(s*K/S) == k (the interval
//      [k*S/K, (k+1)*S/K) is shorter than 1, so no other slot takes k).
//      A load with a kept pixel is read again, from L2.  A strided loop
//      writes rows 3 and 5-7 and the empty slots s >= min(K, S).  Each
//      output float is written once; no scratch row in device memory.
// Bit-identical to the plain version: the same float32 operations in the
// same order, and no FMA contraction (-fmad=false).  The deprojection
// (x - c) / f multiplies by the float32 reciprocal of f (rfx, rfy), as the
// JAX package's compiled version does with its constant focal length.
// tests/test_torch_cloud_tiles.py states this order in PyTorch and holds
// it to the plain version bit for bit.
// Measured on an H100 at T=512 on the dynamics frame's rasters (PERF.md,
// chip_ab.py): 0.071 ms (0.220 before this design).  What holds it at
// twice its bound, from clock64 stamps a block: 512 blocks run in about
// two rounds (3-4 an SM); a block spends ~43k cycles in pass 1, ~5k in
// the scan and ~24k in pass 3, whose divergent per-pixel work runs while
// the SM's other blocks are in the same pass.  Reading pass 3's loads one
// ahead, prefetching them into L1 or L2, keeping the loads with a valid
// pixel in shared memory, or spreading a warp's kept pixels over its
// lanes by shuffles did not speed it up; 1024 threads or 8 tiles in
// flight were up to 7% faster in some runs and slower in others.
#include "common.cuh"

#define CK_THREADS 512    // threads a block (a track)
#define CK_UNROLL 4       // tiles of loads in flight a thread, pass 1
#define CK_NW (CK_THREADS / 32)

// Pixel k (0..7) of a load.
__device__ __forceinline__ unsigned ck_px(const uint4& v, int k) {
  const unsigned w = (k >> 1) == 0 ? v.x
                     : (k >> 1) == 1 ? v.y
                     : (k >> 1) == 2 ? v.z
                                     : v.w;
  return (k & 1) ? (w >> 16) : (w & 0xFFFFu);
}

// Exclusive scan, in place, of n ints in shared memory by one warp (each
// lane a contiguous run); writes the total to a[n].  Called by warp 0.
__device__ __forceinline__ void ck_warp_scan(int* a, int n) {
  const int lane = threadIdx.x & 31;
  const int run = (n + 31) / 32;
  const int i0 = min(lane * run, n), i1 = min(i0 + run, n);
  int s = 0;
  for (int i = i0; i < i1; ++i) s += a[i];
  const int inc = hts_warp_incl_scan(s);
  int r = inc - s;
  for (int i = i0; i < i1; ++i) {
    const int c = a[i];
    a[i] = r;
    r += c;
  }
  if (lane == 31) a[n] = inc;
}

// Exclusive scan of the (tile, warp) totals a[i * CK_NW + w] in tile-major
// order, in two levels: warp w scans tiles w, w + CK_NW, ... in place
// (one shuffle scan a tile) and leaves each tile's total in tt[i]; then
// warp 0 scans tt.  Afterwards (tile i, warp w) starts at
// tt[i] + a[i * CK_NW + w], and tt[ntile] is the total.  Every thread of
// the block calls it.
__device__ __forceinline__ void ck_block_scan(int* a, int* tt, int ntile) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();
  for (int i = wid; i < ntile; i += CK_NW) {
    const int c = lane < CK_NW ? a[i * CK_NW + lane] : 0;
    const int inc = hts_warp_incl_scan(c);
    if (lane < CK_NW) a[i * CK_NW + lane] = inc - c;
    if (lane == 31) tt[i] = inc;
  }
  __syncthreads();
  if (wid == 0) ck_warp_scan(tt, ntile);
  __syncthreads();
}

// Shared memory of a block: per load (ntile * CK_THREADS) its mask byte
// and its warp prefix byte, then the valid and the kept (tile, warp)
// totals (ntile * CK_NW ints each) and tile totals (ntile + 1 each).
__host__ __device__ __forceinline__ size_t ck_smem(int ntile) {
  const size_t loads = (size_t)ntile * CK_THREADS;
  return ((2 * loads + 15) & ~(size_t)15) +
         2 * ((size_t)ntile * (CK_NW + 1) + 1) * sizeof(int);
}

// [ulo, uhi): the u16 depths whose float32 product with scale lies in
// [lo, hi), found by the wrapper over all 65,536 values (an interval, as
// the rounded product is monotone in u): the range test in integers.
__global__ void __launch_bounds__(CK_THREADS)
cloud_from_depth_kernel(const uint16_t* __restrict__ depth,
                        float* __restrict__ out, int HW, int W, int frac,
                        int log2frac, int S, unsigned ulo, unsigned uhi,
                        float scale, float inv_frac, float cx, float cy,
                        float rfx, float rfy) {
  extern __shared__ __align__(16) unsigned char ck_sh[];
  const int t = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, wid = tid >> 5;
  const int nl = HW >> 3;             // loads
  const int ntile = (nl + CK_THREADS - 1) / CK_THREADS;
  const int nwt = ntile * CK_NW;
  unsigned char* msk = ck_sh;
  unsigned char* pre = ck_sh + (size_t)ntile * CK_THREADS;
  int* vt = (int*)(ck_sh + ((2 * (size_t)ntile * CK_THREADS + 15) &
                            ~(size_t)15));
  int* kt = vt + nwt;
  int* vtt = kt + nwt;                // tile totals, ntile + 1 each
  int* ktt = vtt + ntile + 1;
  const uint16_t* d = depth + (size_t)t * HW;
  float* o = out + (size_t)t * 8 * S;
  const uint4* d4 = reinterpret_cast<const uint4*>(d);   // H*W % 8 == 0
  const unsigned urange = uhi - ulo;

  // pass 1: the valid masks, CK_UNROLL tiles of loads in flight
  for (int i0 = 0; i0 < ntile; i0 += CK_UNROLL) {
    uint4 v[CK_UNROLL];
#pragma unroll
    for (int u = 0; u < CK_UNROLL; ++u)
      v[u] = (i0 + u) * CK_THREADS + tid < nl
                 ? __ldg(d4 + (i0 + u) * CK_THREADS + tid)
                 : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int u = 0; u < CK_UNROLL; ++u) {
      if (i0 + u >= ntile) break;                       // block-uniform
      const int l = (i0 + u) * CK_THREADS + tid;
      unsigned m = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        m |= ck_px(v[u], k) - ulo < urange ? 1u << k : 0u;
      if (l >= nl) m = 0u;                  // past the raster
      const int c = __popc(m);
      const int inc = hts_warp_incl_scan(c);
      msk[l] = (unsigned char)m;
      pre[l] = (unsigned char)(inc - c);
      if (lane == 31) vt[(i0 + u) * CK_NW + wid] = inc;
    }
  }
  ck_block_scan(vt, vtt, ntile);
  const int V = vtt[ntile];
  const bool pow2 = log2frac >= 0;
  int K;
  if (pow2) {
    K = (V + frac - 1) >> log2frac;
  } else {
    // pass 2: the float rule per valid pixel; the kept masks and the
    // warps' kept prefixes replace the valid ones
    const float fracf = (float)frac;
    for (int i = 0; i < ntile; ++i) {
      const int l = i * CK_THREADS + tid;
      const unsigned m = msk[l];
      int r = vtt[i] + vt[i * CK_NW + wid] + pre[l];
      unsigned km = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (m >> k & 1u) {
          const float rf = (float)r;
          if (__fmul_rn(floorf(__fmul_rn(rf, inv_frac)), fracf) == rf)
            km |= 1u << k;
          ++r;
        }
      }
      const int c = __popc(km);
      const int inc = hts_warp_incl_scan(c);
      msk[l] = (unsigned char)km;
      pre[l] = (unsigned char)(inc - c);
      if (lane == 31) kt[i * CK_NW + wid] = inc;
    }
    ck_block_scan(kt, ktt, ntile);
    K = ktt[ntile];
  }

  // pass 3: each kept pixel into its slot.  A load with a kept pixel is
  // read again (from L2); its kept bits come first (pow2: the valid bits
  // whose rank is a multiple of frac), then only they are visited.
  const int fm = pow2 ? frac - 1 : 0;
  const int* wbase = pow2 ? vt : kt;
  const int* tbase = pow2 ? vtt : ktt;
  const bool thin = K > S;
  const bool fit32 = (unsigned long long)K * (S + 1) < (1ull << 32);
  for (int i = 0; i < ntile; ++i) {
    const int l = i * CK_THREADS + tid;
    const unsigned m = msk[l];
    if (m == 0u) continue;
    const int r0 = tbase[i] + wbase[i * CK_NW + wid] + pre[l];
    unsigned km = m;      // the kept bits; kr: the first one's kept rank
    unsigned kr = r0;
    if (pow2) {
      km = 0u;
      int r = r0;
      for (unsigned b = m; b != 0u; b &= b - 1u, ++r)
        if ((r & fm) == 0) km |= b & (0u - b);
      kr = (unsigned)(r0 + fm) >> log2frac;
    }
    if (km == 0u) continue;
    const uint4 v = __ldg(d4 + l);
    // the load's first pixel's column and row (a load spans at most
    // ceil(8 / W) + 1 rows)
    const int row0 = 8 * l / W, col0 = 8 * l - row0 * W;
    for (; km != 0u; km &= km - 1u, ++kr) {
      const int k = __ffs(km) - 1;
      unsigned s = kr;
      if (thin) {          // s = ceil(kr*S/K), taken when s*K < (kr+1)*S
        s = fit32 ? (kr * S + K - 1) / K
                  : (unsigned)(((unsigned long long)kr * S + K - 1) / K);
        if (s >= (unsigned)S ||
            (unsigned long long)s * K >= (unsigned long long)(kr + 1) * S)
          continue;
      }
      int col = col0 + k, row = row0;
      while (col >= W) {
        col -= W;
        ++row;
      }
      const float z = __fmul_rn((float)ck_px(v, k), scale);
      const float px = (float)col;
      const float py = (float)row;
      o[0 * S + s] = __fmul_rn(__fmul_rn(__fsub_rn(px, cx), rfx), z);
      o[1 * S + s] = __fmul_rn(__fmul_rn(__fsub_rn(py, cy), rfy), z);
      o[2 * S + s] = z;
      o[4 * S + s] = 1.0f;
    }
  }

  // the constant rows, and the empty slots: the last pixel, mask 0
  const int filled = min(K, S);
  const float zl = __fmul_rn((float)d[HW - 1], scale);
  const float xl = __fmul_rn(
      __fmul_rn(__fsub_rn((float)((HW - 1) % W), cx), rfx), zl);
  const float yl = __fmul_rn(
      __fmul_rn(__fsub_rn((float)((HW - 1) / W), cy), rfy), zl);
  for (int s = tid; s < S; s += CK_THREADS) {
    if (s >= filled) {
      o[0 * S + s] = xl;
      o[1 * S + s] = yl;
      o[2 * S + s] = zl;
      o[4 * S + s] = 0.0f;
    }
    o[3 * S + s] = 1.0f;
    o[5 * S + s] = 0.0f;
    o[6 * S + s] = 0.0f;
    o[7 * S + s] = 0.0f;
  }
}

// depth: (T, H, W) u16 (uploaded as int16, bit for bit); out: (T, 8, S)
// f32; [ulo, uhi) the valid depths.  Requires frac >= 1, S >= 1, H*W a
// positive multiple of 8 (16-byte loads), 0 <= ulo <= uhi <= 65536.
HTS_EXPORT int hts_cloud_from_depth(const void* depth, void* out, int T,
                                    int H, int W, int frac, int S, int ulo,
                                    int uhi, float scale, float inv_frac,
                                    float cx, float cy, float rfx, float rfy,
                                    void* stream) {
  const int HW = H * W;
  if (frac < 1 || S < 1 || HW < 8 || HW % 8 != 0 || ulo < 0 || uhi < ulo ||
      uhi > 65536)
    return (int)cudaErrorInvalidValue;
  const int ntile = ((HW + 7) / 8 + CK_THREADS - 1) / CK_THREADS;
  const size_t smem = ck_smem(ntile);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (T <= 0) return (int)cudaGetLastError();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cloud_from_depth_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int log2frac = (frac & (frac - 1)) == 0 ? __builtin_ctz(frac) : -1;
  cloud_from_depth_kernel<<<T, CK_THREADS, smem, (cudaStream_t)stream>>>(
      (const uint16_t*)depth, (float*)out, HW, W, frac, log2frac, S,
      (unsigned)ulo, (unsigned)uhi, scale, inv_frac, cx, cy, rfx, rfy);
  return (int)cudaGetLastError();
}
