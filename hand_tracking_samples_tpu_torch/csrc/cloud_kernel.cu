// Depth raster -> the budgeted point cloud in the (8, budget) planes carrier.
//
// Replaces the Pallas kernel hand_tracking_samples_tpu/ops/cloud_kernel.py:26
// (_make_kernel, launched at :209 and :229).  Same function as
// imaging.image_ops.cloud_from_depth: range threshold -> every frac-th valid
// pixel in raster order -> exact kept count K -> slot s takes kept point
// (s*K)//budget when K > budget (uniform thinning, never a tail cut) ->
// deprojection.  Output rows [x, y, z, 1, mask, 0, 0, 0]; an empty slot
// carries the deprojected last pixel with mask 0, as the JAX route does.
//
// Design: one block of 1024 threads per track; each thread owns a contiguous
// run of pixels, so the raster-order ranks come from two block-wide prefix
// sums (valid counts, then kept counts).  The kept pixels' flat indices go to
// a per-track scratch row in device memory; each slot then reads its pick.
// Bit-identical to the plain version: the same float32 operations in the
// same order, and no FMA contraction (-fmad=false).  The deprojection
// (x - c) / f multiplies by the float32 reciprocal of f (rfx, rfy), as the
// JAX package's compiled version does with its constant focal length.
//
// Bound on the H100: bytes.  Per track it must read the u16 raster
// (320*240*2 = 153.6 KB) and write 8*budget floats (64 KB at 2048).
// The three passes re-read the raster from L1/L2, not device memory.
// Left for later: one pass with the valid/kept flags kept in registers, and
// coalesced (strided) pixel reads with per-tile scans.
#include "common.cuh"

__global__ void __launch_bounds__(1024)
cloud_from_depth_kernel(const uint16_t* __restrict__ depth,
                        float* __restrict__ out, int* __restrict__ scratch,
                        int HW, int W, int frac, int S, int maxkept,
                        float lo, float hi, float scale, float inv_frac,
                        float cx, float cy, float rfx, float rfy) {
  __shared__ int sh[33];
  const int t = blockIdx.x;
  const uint16_t* d = depth + (size_t)t * HW;
  int* kidx = scratch + (size_t)t * maxkept;
  float* o = out + (size_t)t * 8 * S;
  const int nt = blockDim.x;
  const int chunk = (HW + nt - 1) / nt;
  const int p0 = min(threadIdx.x * chunk, HW);
  const int p1 = min(p0 + chunk, HW);
  const float fracf = (float)frac;

  int nv = 0;
  for (int p = p0; p < p1; ++p) {
    const float dd = __fmul_rn((float)d[p], scale);
    nv += (dd >= lo && dd < hi) ? 1 : 0;
  }
  int total_v;
  const int vbase = hts_block_excl_scan(nv, sh, &total_v);

  int nk = 0;
  int r = vbase;
  for (int p = p0; p < p1; ++p) {
    const float dd = __fmul_rn((float)d[p], scale);
    if (dd >= lo && dd < hi) {
      const float rf = (float)r;
      if (__fmul_rn(floorf(__fmul_rn(rf, inv_frac)), fracf) == rf) ++nk;
      ++r;
    }
  }
  int K;
  int kb = hts_block_excl_scan(nk, sh, &K);

  r = vbase;
  for (int p = p0; p < p1; ++p) {
    const float dd = __fmul_rn((float)d[p], scale);
    if (dd >= lo && dd < hi) {
      const float rf = (float)r;
      if (__fmul_rn(floorf(__fmul_rn(rf, inv_frac)), fracf) == rf) {
        if (kb < maxkept) kidx[kb] = p;
        ++kb;
      }
      ++r;
    }
  }
  __syncthreads();

  for (int s = threadIdx.x; s < S; s += nt) {
    const int ti = K > S ? (int)(((long long)s * K) / S) : s;
    const bool ok = ti < K;
    const int flat = ok ? kidx[ti] : HW - 1;
    const float z = __fmul_rn((float)d[flat], scale);
    const float px = (float)(flat % W);
    const float py = (float)(flat / W);
    o[0 * S + s] = __fmul_rn(__fmul_rn(__fsub_rn(px, cx), rfx), z);
    o[1 * S + s] = __fmul_rn(__fmul_rn(__fsub_rn(py, cy), rfy), z);
    o[2 * S + s] = z;
    o[3 * S + s] = 1.0f;
    o[4 * S + s] = ok ? 1.0f : 0.0f;
    o[5 * S + s] = 0.0f;
    o[6 * S + s] = 0.0f;
    o[7 * S + s] = 0.0f;
  }
}

// depth: (T, H, W) u16 (uploaded as int16, bit for bit); out: (T, 8, S) f32;
// scratch: (T, maxkept) int32, maxkept >= ceil(H*W/frac).
HTS_EXPORT int hts_cloud_from_depth(const void* depth, void* out,
                                    void* scratch, int T, int H, int W,
                                    int frac, int S, int maxkept, float lo,
                                    float hi, float scale, float inv_frac,
                                    float cx, float cy, float rfx,
                                    float rfy, void* stream) {
  if (T > 0) {
    cloud_from_depth_kernel<<<T, 1024, 0, (cudaStream_t)stream>>>(
        (const uint16_t*)depth, (float*)out, (int*)scratch, H * W, W, frac,
        S, maxkept, lo, hi, scale, inv_frac, cx, cy, rfx, rfy);
  }
  return (int)cudaGetLastError();
}
