// Per static collide pair: face-axis SAT over both hulls, support
// refinement, and the NPT-point contact manifold.
//
// Replaces the Pallas kernel hand_tracking_samples_tpu/physics/
// contact_kernel.py:46 (_make_kernel, launched by _contact_fields_call at
// :217).  Same function as physics/contact_kernel.py:contact_fields_plain
// in this package (see its docstring for the layouts).
//
// Design: one block of CK_WARPS warps per track, a warp per near pair.
// - Staging: the track's world geometry goes once into dynamic shared
//   memory as records a warp reads as broadcasts: each vertex a float4
//   (x, y, z, 0) (17 x 48 x 16 B = 13 KB), each plane a float4
//   (nx, ny, nz, d) (26 KB), the aux rows (1 KB): 40 KB a block.
// - Near-pair list: thread i tests pair i's bounding spheres
//   (dc2 <= rsum * rsum) and a block scan lists the near pairs in pair
//   order; every culled pair's skip rows are then written by the whole
//   block, coalesced.
// - A warp per near pair, the warps taking the list's pairs in turn:
//   * face scans: the lanes own the scanning hull's planes (p = lane,
//     lane + 32, lane + 64; their normals in registers) and loop over the
//     other hull's vertices, which every lane reads at once; each plane's
//     min is folded with fminf in vertex order, the dot n0*x + n1*y + n2*z
//     left to right as in the plain version;
//   * support refinement: the lanes own the vertices (v = lane, lane + 32)
//     of both hulls;
//   * manifold: the other hull's plane values live in registers across the
//     lanes (2 a lane); NPT rounds of a first-argmin, each masking its
//     winner; lane k computes and writes manifold point k.
//   Each arg-reduction is lane-local in index order, then a butterfly of
//   shuffles on (value, index) that takes the lower index on a tie.
// - Size: 16 warps (512 threads).  The dynamics frame's poses have 11.0
//   near pairs of the 87 a track, the contact poses 27.3 (chip_smoke.py
//   phases 5 and 9 print both): 16 warps take them in 1-2 rounds.  At 64
//   registers two blocks fit an SM (the 40 KB of shared memory would take
//   5), so T=512 tracks run in two waves.  On an H100 (700 W), T=512:
//   4 warps took 0.047 / 0.132 ms (phase 5 / contact poses), 8 warps
//   0.043 / 0.121 (and spilled 4 bytes), 12 warps 0.045 / 0.099, 16 warps
//   0.043 / 0.099, 32 warps 0.051 / 0.091.
//
// Exactness: each reduction is a max or a min, taken here in another order
// than the plain version's, with the first index on a tie; the maximum of
// a set does not depend on the order, so every index and every written
// value is the plain version's bit for bit.  The one choice that could
// differ is which zero a tie of -0 and +0 keeps (fminf(-0, +0) may return
// either): that touches only a plane's min, hence sep, which is compared
// and never written.
//
// Bound on the H100: bytes, at the hand's poses.  Per near pair the two
// face scans evaluate 2 x 96 x 48 vert-plane pairs (6 float32 operations
// each), about 59 kFLOP with the refinement and the manifold; at 87 pairs
// and 512 tracks, if every pair were near, 2.6 GFLOP (0.04 ms at
// 67 TFLOP/s), but most pairs are culled.  Bytes: 37 KB of geometry in and
// 87 x 48 x 4 = 16.7 KB out a track, 0.008 ms at 512 tracks.  The issue
// floor: the face scans of a near pair take 2 x 48 vertices x (3 planes x
// 6 + 1 load) = 1,824 warp instructions, so the 11 near pairs a track of
// the dynamics frame at T=512 are ~10 M warp instructions, ~0.01 ms on 132
// SMs x 4 schedulers at 1.98 GHz (chip_smoke.py's issue_floor_ms).
#include "common.cuh"

#define CK_WARPS 16
#define CK_THREADS (CK_WARPS * 32)
#define CK_MAXV 64     // 2 vertices a lane
#define CK_MAXP 96     // 3 planes a lane
#define CK_MAXNPT 32   // a manifold point a lane
#define CK_FULL 0xffffffffu

// Butterfly reductions of (value, index) over the warp: every lane ends
// with the largest (smallest) value and the lowest index holding it.
__device__ __forceinline__ void ck_argmax(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(CK_FULL, v, o);
    const int oi = __shfl_xor_sync(CK_FULL, i, o);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}
__device__ __forceinline__ void ck_argmin(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(CK_FULL, v, o);
    const int oi = __shfl_xor_sync(CK_FULL, i, o);
    if (ov < v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

// the plain version's n0*x + n1*y + n2*z, left to right (-fmad=false)
__device__ __forceinline__ float ck_dot(float4 n, float4 x) {
  return n.x * x.x + n.y * x.y + n.z * x.z;
}

// Hull h's planes against hull o's vertices: sep = max_p (min_v n_p.v +
// d_p), first = the first p reaching it.  Lanes own planes lane + 32 k.
__device__ __forceinline__ void ck_face_scan(const float4* __restrict__ hp,
                                             const float4* __restrict__ ov,
                                             int P, int V, int lane,
                                             float& sep, int& first) {
  float4 n[3];
  float m[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) n[k] = hp[min(lane + 32 * k, P - 1)];
  {
    const float4 x = ov[0];
#pragma unroll
    for (int k = 0; k < 3; ++k) m[k] = ck_dot(n[k], x);
  }
#pragma unroll 4
  for (int v = 1; v < V; ++v) {
    const float4 x = ov[v];                      // a broadcast
#pragma unroll
    for (int k = 0; k < 3; ++k) m[k] = fminf(m[k], ck_dot(n[k], x));
  }
  // lane-local first max in plane order, then across the lanes
  sep = -INFINITY;
  first = CK_MAXP;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int p = lane + 32 * k;
    const float val = m[k] + n[k].w;
    if (p < P && (first == CK_MAXP || val > sep)) {
      sep = val;
      first = p;
    }
  }
  ck_argmax(sep, first);
}

__global__ void __launch_bounds__(CK_THREADS)
contact_fields_kernel(const float* __restrict__ vw,
                      const float* __restrict__ nw,
                      const float* __restrict__ dw,
                      const float* __restrict__ aux,
                      const int* __restrict__ pairs,
                      float* __restrict__ out, int B, int V, int P, int NP,
                      int NPT, int refine, float driftmax) {
  extern __shared__ float4 ck_sh[];
  const int t = blockIdx.x;
  const int BV = B * V, BP = B * P;
  float4* sv = ck_sh;                             // (B, V) vertex records
  float4* spl = sv + BV;                          // (B, P) plane records
  float* sax = (float*)(spl + BP);                // (B, 16) aux rows
  int* slist = (int*)(sax + 16 * B);              // near pairs, in order
  int* snear = slist + NP;                        // near flag of each pair
  int* sscan = snear + NP;                        // 33 ints of scan space
  {
    const float* v = vw + (size_t)t * 3 * BV;
    for (int i = threadIdx.x; i < BV; i += blockDim.x)
      sv[i] = make_float4(v[i], v[BV + i], v[2 * BV + i], 0.0f);
    const float* n = nw + (size_t)t * 3 * BP;
    const float* d = dw + (size_t)t * BP;
    for (int i = threadIdx.x; i < BP; i += blockDim.x)
      spl[i] = make_float4(n[i], n[BP + i], n[2 * BP + i], d[i]);
    const float* ax = aux + (size_t)t * 16 * B;
    for (int i = threadIdx.x; i < 16 * B; i += blockDim.x) sax[i] = ax[i];
  }
  __syncthreads();
#define AX(b, k) sax[(b) * 16 + (k)]
  int count = 0;                                  // the same in every thread
  for (int i0 = 0; i0 < NP; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    int near = 0;
    if (i < NP) {
      const int a = pairs[2 * i], b = pairs[2 * i + 1];
      const float dcx = AX(a, 6) - AX(b, 6), dcy = AX(a, 7) - AX(b, 7);
      const float dcz = AX(a, 8) - AX(b, 8);
      const float dc2 = dcx * dcx + dcy * dcy + dcz * dcz;
      const float rsum = AX(a, 9) + AX(b, 9);
      near = dc2 <= rsum * rsum ? 1 : 0;
      snear[i] = near;
    }
    int total;
    const int pos = hts_block_excl_scan(near, sscan, &total);
    if (near) slist[count + pos] = i;
    count += total;
  }
  __syncthreads();
  // the culled pairs' skip rows: zeros, n = (0, 0, -1)
  const int row = 12 * NPT;
  float* ot = out + (size_t)t * NP * row;
  for (int e = threadIdx.x; e < NP * row; e += blockDim.x)
    if (!snear[e / row]) ot[e] = e % row >= 11 * NPT ? -1.0f : 0.0f;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int q = warp; q < count; q += blockDim.x >> 5) {
    const int i = slist[q];
    const int a = pairs[2 * i], b = pairs[2 * i + 1];
    float* o = ot + (size_t)i * row;
    // face scans: hull a's planes against b's verts, then b's against a's
    float sep_a, sep_b;
    int fa, fb;
    ck_face_scan(spl + a * P, sv + b * V, P, V, lane, sep_a, fa);
    ck_face_scan(spl + b * P, sv + a * V, P, V, lane, sep_b, fb);
    const bool use_a = sep_a >= sep_b;
    const float4 nfa = spl[a * P + fa], nfb = spl[b * P + fb];
    float n[3];
    n[0] = use_a ? nfa.x : -nfb.x;
    n[1] = use_a ? nfa.y : -nfb.y;
    n[2] = use_a ? nfa.z : -nfb.z;

    // support refinement of the separation along m: lanes own vertices
    // lane and lane + 32 of both hulls
    const bool has0 = lane < V, has1 = lane + 32 < V;
    const float4 va0 = sv[a * V + min(lane, V - 1)];
    const float4 va1 = sv[a * V + min(lane + 32, V - 1)];
    const float4 vb0 = sv[b * V + min(lane, V - 1)];
    const float4 vb1 = sv[b * V + min(lane + 32, V - 1)];
    float m[3] = {n[0], n[1], n[2]};
    float best = -3.0e38f, s = 0.0f;
    for (int it = 0; it <= refine; ++it) {
      const float nm0 = -m[0], nm1 = -m[1], nm2 = -m[2];
      float mxa = -INFINITY, mxb = -INFINITY;
      int ia = CK_MAXV, ib = CK_MAXV;
      if (has0) {
        mxa = va0.x * m[0] + va0.y * m[1] + va0.z * m[2];
        mxb = vb0.x * nm0 + vb0.y * nm1 + vb0.z * nm2;
        ia = ib = lane;
      }
      if (has1) {
        const float da = va1.x * m[0] + va1.y * m[1] + va1.z * m[2];
        const float db = vb1.x * nm0 + vb1.y * nm1 + vb1.z * nm2;
        if (da > mxa) { mxa = da; ia = lane + 32; }
        if (db > mxb) { mxb = db; ib = lane + 32; }
      }
      ck_argmax(mxa, ia);
      ck_argmax(mxb, ib);
      const float4 pa = sv[a * V + ia], pb = sv[b * V + ib];
      const float d[3] = {pb.x - pa.x, pb.y - pa.y, pb.z - pa.z};
      s = d[0] * m[0] + d[1] * m[1] + d[2] * m[2];
      if (it == refine) break;
      best = fmaxf(best, s);
      const float norm = fmaxf(sqrtf(d[0] * d[0] + d[1] * d[1]
                                     + d[2] * d[2]), 1e-20f);
      for (int c = 0; c < 3; ++c) m[c] = d[c] / norm;
    }
    const bool active_pair = fmaxf(best, s) < driftmax;

    // manifold: the NPT deepest verts of the other hull under the face
    const float4 nf = use_a ? nfa : nfb;
    const int ob = use_a ? b : a;
    const float4 w0 = use_a ? vb0 : va0, w1 = use_a ? vb1 : va1;
    float dv0 = has0 ? nf.x * w0.x + nf.y * w0.y + nf.z * w0.z + nf.w
                     : INFINITY;
    float dv1 = has1 ? nf.x * w1.x + nf.y * w1.y + nf.z * w1.z + nf.w
                     : INFINITY;
    int myf = 0;
    float mysp = 0.0f;
    for (int k = 0; k < NPT; ++k) {
      float mn = dv0;
      int f = has0 ? lane : CK_MAXV;
      if (dv1 < mn) { mn = dv1; f = lane + 32; }
      ck_argmin(mn, f);
      if (f == lane) dv0 = 3.0e38f;
      if (f == lane + 32) dv1 = 3.0e38f;
      if (lane == k) { myf = f; mysp = mn; }
    }
    if (lane < NPT) {
      const int k = lane;
      const float sp = mysp;
      const float4 dp = sv[ob * V + myf];
      const float deep[3] = {dp.x, dp.y, dp.z};
      float p0w[3], p1w[3];
      for (int c = 0; c < 3; ++c) {
        const float shift = n[c] * sp;
        p1w[c] = use_a ? deep[c] : deep[c] + shift;
        p0w[c] = use_a ? deep[c] - shift : deep[c];
      }
      const bool act = active_pair && sp < driftmax;
      float r0[3], r1[3], v0[3], v1[3];
      for (int c = 0; c < 3; ++c) {
        r0[c] = p0w[c] - AX(a, 6 + c);
        r1[c] = p1w[c] - AX(b, 6 + c);
      }
      v0[0] = AX(a, 1) * r0[2] - AX(a, 2) * r0[1] + AX(a, 3);
      v0[1] = AX(a, 2) * r0[0] - AX(a, 0) * r0[2] + AX(a, 4);
      v0[2] = AX(a, 0) * r0[1] - AX(a, 1) * r0[0] + AX(a, 5);
      v1[0] = AX(b, 1) * r1[2] - AX(b, 2) * r1[1] + AX(b, 3);
      v1[1] = AX(b, 2) * r1[0] - AX(b, 0) * r1[2] + AX(b, 4);
      v1[2] = AX(b, 0) * r1[1] - AX(b, 1) * r1[0] + AX(b, 5);
      const float vdotn = (v0[0] - v1[0]) * (-n[0]) + (v0[1] - v1[1]) * (-n[1])
                          + (v0[2] - v1[2]) * (-n[2]);
      o[0 * NPT + k] = sp;
      o[1 * NPT + k] = vdotn;
      for (int c = 0; c < 3; ++c) {
        o[(2 + c) * NPT + k] = r0[c];
        o[(5 + c) * NPT + k] = r1[c];
        o[(9 + c) * NPT + k] = n[c];
      }
      o[8 * NPT + k] = act ? 1.0f : 0.0f;
    }
  }
#undef AX
}

// The dynamic shared memory a block takes (contact_fields_kernel's layout).
static size_t ck_smem(int B, int V, int P, int NP) {
  return (size_t)(B * V + B * P) * sizeof(float4)
         + (size_t)(16 * B + 2 * NP + 33) * sizeof(float);
}

// vw (T,3,B,V); nw (T,3,B,P); dw (T,B,P); aux (T,B,16); pairs (NP,2) int32;
// out (T, NP, 12, NPT).
HTS_EXPORT int hts_contact_fields(const void* vw, const void* nw,
                                  const void* dw, const void* aux,
                                  const void* pairs, void* out, int T, int B,
                                  int V, int P, int NP, int NPT, int refine,
                                  float driftmax, void* stream) {
  const size_t smem = ck_smem(B, V, P, NP);
  if (V < 1 || V > CK_MAXV || P < 1 || P > CK_MAXP || NPT < 1
      || NPT > CK_MAXNPT || smem > 232448)
    return (int)cudaErrorInvalidValue;
  if (T > 0 && NP > 0) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          contact_fields_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    contact_fields_kernel<<<T, CK_THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)vw, (const float*)nw, (const float*)dw,
        (const float*)aux, (const int*)pairs, (float*)out, B, V, P, NP, NPT,
        refine, driftmax);
  }
  return (int)cudaGetLastError();
}
