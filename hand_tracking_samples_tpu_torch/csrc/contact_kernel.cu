// Per static collide pair: face-axis SAT over both hulls, support
// refinement, and the 4-point contact manifold.
//
// Replaces the Pallas kernel hand_tracking_samples_tpu/physics/
// contact_kernel.py:46 (_make_kernel, launched by _contact_fields_call at
// :217).  Same function as physics/contact_kernel.py:contact_fields_plain
// in this package (see its docstring for the layouts).
//
// Design: one block per track, one thread per collide pair (87 for the
// hand).  The track's world geometry (17 hulls: 48 verts, 96 planes each,
// plus the per-body aux rows, 37 KB) is read once into shared memory; each
// thread then runs its pair's SAT from there.  A pair whose bounding spheres
// do not meet writes the skip rows at once.
//
// Bound on the H100: bytes, at the hand's poses.  Per near pair the two
// face scans evaluate 2 x 96 x 48 vert-plane pairs (6 float32 operations
// each), about 59 kFLOP with the refinement and the manifold; at 87 pairs
// and 512 tracks, if every pair were near, 2.6 GFLOP (0.04 ms at
// 67 TFLOP/s), but most pairs are culled.  Bytes: 37 KB of geometry in and
// 87 x 48 x 4 = 16.7 KB out a track, 0.008 ms at 512 tracks.
// Left for later: 87 threads a block leave most of each SM idle, and the
// near pairs of a track serialise on one warp's divergent branches; a warp
// per pair (lanes over planes) would spread the face scans.
#include "common.cuh"

#define CK_MAXV 48
#define CK_MAXF 12288

__global__ void contact_fields_kernel(const float* __restrict__ vw,
                                      const float* __restrict__ nw,
                                      const float* __restrict__ dw,
                                      const float* __restrict__ aux,
                                      const int* __restrict__ pairs,
                                      float* __restrict__ out, int B, int V,
                                      int P, int NP, int NPT, int refine,
                                      float driftmax) {
  __shared__ float sh[CK_MAXF];
  const int t = blockIdx.x;
  const int nv = 3 * B * V, nn = 3 * B * P, nd = B * P, na = 16 * B;
  float* svw = sh;
  float* snw = svw + nv;
  float* sdw = snw + nn;
  float* sax = sdw + nd;
  for (int i = threadIdx.x; i < nv; i += blockDim.x)
    svw[i] = vw[(size_t)t * nv + i];
  for (int i = threadIdx.x; i < nn; i += blockDim.x)
    snw[i] = nw[(size_t)t * nn + i];
  for (int i = threadIdx.x; i < nd; i += blockDim.x)
    sdw[i] = dw[(size_t)t * nd + i];
  for (int i = threadIdx.x; i < na; i += blockDim.x)
    sax[i] = aux[(size_t)t * na + i];
  __syncthreads();
#define VX(c, b, v) svw[((c) * B + (b)) * V + (v)]
#define NX(c, b, p) snw[((c) * B + (b)) * P + (p)]
#define DW(b, p) sdw[(b) * P + (p)]
#define AX(b, k) sax[(b) * 16 + (k)]

  for (int i = threadIdx.x; i < NP; i += blockDim.x) {
    const int a = pairs[2 * i], b = pairs[2 * i + 1];
    float* o = out + ((size_t)t * NP + i) * 12 * NPT;
    const float dcx = AX(a, 6) - AX(b, 6), dcy = AX(a, 7) - AX(b, 7);
    const float dcz = AX(a, 8) - AX(b, 8);
    const float dc2 = dcx * dcx + dcy * dcy + dcz * dcz;
    const float rsum = AX(a, 9) + AX(b, 9);
    if (!(dc2 <= rsum * rsum)) {
      for (int k = 0; k < 12 * NPT; ++k) o[k] = k >= 11 * NPT ? -1.0f : 0.0f;
      continue;
    }
    // face scans: hull h's planes against hull o's verts
    float sep2[2], nf2[2][3], df2[2];
    for (int side = 0; side < 2; ++side) {
      const int h = side == 0 ? a : b, ot = side == 0 ? b : a;
      float sep = 0.0f;
      int first = 0;
      for (int p = 0; p < P; ++p) {
        const float n0 = NX(0, h, p), n1 = NX(1, h, p), n2 = NX(2, h, p);
        float dmin = 0.0f;
        for (int v = 0; v < V; ++v) {
          const float d = n0 * VX(0, ot, v) + n1 * VX(1, ot, v)
                          + n2 * VX(2, ot, v);
          dmin = v == 0 ? d : fminf(dmin, d);
        }
        dmin = dmin + DW(h, p);
        if (p == 0 || dmin > sep) { sep = dmin; first = p; }
      }
      sep2[side] = sep;
      for (int c = 0; c < 3; ++c) nf2[side][c] = NX(c, h, first);
      df2[side] = DW(h, first);
    }
    const bool use_a = sep2[0] >= sep2[1];
    float n[3];
    for (int c = 0; c < 3; ++c) n[c] = use_a ? nf2[0][c] : -nf2[1][c];

    // support refinement of the separation along m
    float m[3] = {n[0], n[1], n[2]};
    float best = -3.0e38f, s = 0.0f;
    for (int it = 0; it <= refine; ++it) {
      int ia = 0, ib = 0;
      float mxa = 0.0f, mxb = 0.0f;
      for (int v = 0; v < V; ++v) {
        const float da = VX(0, a, v) * m[0] + VX(1, a, v) * m[1]
                         + VX(2, a, v) * m[2];
        const float db = VX(0, b, v) * (-m[0]) + VX(1, b, v) * (-m[1])
                         + VX(2, b, v) * (-m[2]);
        if (v == 0 || da > mxa) { mxa = da; ia = v; }
        if (v == 0 || db > mxb) { mxb = db; ib = v; }
      }
      float d[3];
      for (int c = 0; c < 3; ++c) d[c] = VX(c, b, ib) - VX(c, a, ia);
      s = d[0] * m[0] + d[1] * m[1] + d[2] * m[2];
      if (it == refine) break;
      best = fmaxf(best, s);
      const float norm = fmaxf(sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]),
                               1e-20f);
      for (int c = 0; c < 3; ++c) m[c] = d[c] / norm;
    }
    const bool active_pair = fmaxf(best, s) < driftmax;

    // manifold: the NPT deepest verts of the other hull under the face
    const int sidx = use_a ? 0 : 1;
    const int ob = use_a ? b : a;
    float dv[CK_MAXV];
    for (int v = 0; v < V; ++v)
      dv[v] = nf2[sidx][0] * VX(0, ob, v) + nf2[sidx][1] * VX(1, ob, v)
              + nf2[sidx][2] * VX(2, ob, v) + df2[sidx];
    for (int k = 0; k < NPT; ++k) {
      int f = 0;
      float mn = dv[0];
      for (int v = 1; v < V; ++v)
        if (dv[v] < mn) { mn = dv[v]; f = v; }
      const float sp = dv[f];
      dv[f] = 3.0e38f;
      float deep[3], p0w[3], p1w[3];
      for (int c = 0; c < 3; ++c) {
        deep[c] = VX(c, ob, f);
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
#undef VX
#undef NX
#undef DW
#undef AX
}

// vw (T,3,B,V); nw (T,3,B,P); dw (T,B,P); aux (T,B,16); pairs (NP,2) int32;
// out (T, NP, 12, NPT).
HTS_EXPORT int hts_contact_fields(const void* vw, const void* nw,
                                  const void* dw, const void* aux,
                                  const void* pairs, void* out, int T, int B,
                                  int V, int P, int NP, int NPT, int refine,
                                  float driftmax, void* stream) {
  if (V > CK_MAXV || 3 * B * V + 4 * B * P + 16 * B > CK_MAXF)
    return (int)cudaErrorInvalidValue;
  if (T > 0 && NP > 0) {
    const int threads = ((NP + 31) / 32) * 32;
    contact_fields_kernel<<<T, threads > 1024 ? 1024 : threads, 0,
                            (cudaStream_t)stream>>>(
        (const float*)vw, (const float*)nw, (const float*)dw,
        (const float*)aux, (const int*)pairs, (float*)out, B, V, P, NP, NPT,
        refine, driftmax);
  }
  return (int)cudaGetLastError();
}
