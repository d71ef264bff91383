// Cloud correspondence + CloudConstraint rows + solve prep + per-body slot
// pack, the 12-channel solve variant.
//
// Replaces the Pallas kernel hand_tracking_samples_tpu/ops/cloud_rows.py:34
// (_make_kernel with solve_ch=True, launched by _cloud_rows_call_b at :387).
// Same function as ops/cloud_rows.py:cloud_rows_solve_plain in this package:
//   winner      strict-< scan over [17 sphere, 17 hull most-above] values
//   normal      sphere: (p - pos)/|p - pos|; hull: mean of the winner
//               body's maximal planes (blend on exact ties)
//   ray clip    slab ConvexHitCheck of origin->p against the winner's hull
//   row         attach point, normal, targetdist, lever r1
//   solve prep  J1 = r1 x n, K1 = Iinv_w J1, dinv, tsm = td/dt
//   pack        stable per-body rank among active points (slot order =
//               point order), uniform thinning to C slots, force scale
//               compensated by count/C
//
// Design: one block of 1024 threads per track, points p = k*1024 + tid.
// The track's world planes (5P x B floats) and body scalars sit in shared
// memory; every thread reads the same plane at the same time (broadcast).
// Ranks: __match_any_sync groups a warp's points by winner body; the group
// leader writes the group size into a (segment, body) table in shared
// memory (a segment is 32 consecutive points); one thread per body turns
// the table into exclusive prefix counts.  No atomics, so the slot order is
// the point order.
//
// Bound on the H100: operations.  Per point 17 x 96 hull-plane
// evaluations of 7 float32 operations, then ~23 operations on each of the
// winner's 96 planes: about 14 kFLOP a point, 28 MFLOP a track at 2048
// points; at 512 tracks ~15 GFLOP, 0.22 ms at 67 TFLOP/s.  Bytes:
// 2048 x 8 x 4 in, 12 x 24 x 128 x 4 out a track (213 KB), 0.03 ms at 512
// tracks.
// Left for later: the plane loop is latency-bound on shared-memory reads;
// several points a thread with register-blocked planes would raise the
// arithmetic rate.
#include "common.cuh"

#define CR_THREADS 1024
#define CR_MAXPB 8192
#define CR_MAXSEG 64
#define CR_BP 24
#define CR_CH 12

__global__ void __launch_bounds__(CR_THREADS)
cloud_rows_solve_kernel(const float* __restrict__ pts,
                        const float* __restrict__ planes,
                        const float* __restrict__ body,
                        const float* __restrict__ misc,
                        float* __restrict__ packed,
                        float* __restrict__ counts, int N, int P, int B,
                        int C) {
  __shared__ float spl[CR_MAXPB];
  __shared__ float sb[16 * CR_BP];
  __shared__ int seg[CR_MAXSEG * CR_BP];
  __shared__ int cnt_sh[CR_BP];
  const int t = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const int PB = 5 * P * B;
  const int nseg = N >> 5;
  const float* pt = pts + (size_t)t * 8 * N;
  float* out = packed + (size_t)t * CR_CH * CR_BP * C;
  for (int i = tid; i < PB; i += CR_THREADS)
    spl[i] = planes[(size_t)t * PB + i];
  for (int i = tid; i < 16 * CR_BP; i += CR_THREADS)
    sb[i] = body[(size_t)t * 16 * CR_BP + i];
  for (int i = tid; i < nseg * CR_BP; i += CR_THREADS) seg[i] = 0;
  for (int i = tid; i < CR_CH * CR_BP * C; i += CR_THREADS) out[i] = 0.0f;
  __syncthreads();
  const float ox = misc[t * 8 + 0], oy = misc[t * 8 + 1];
  const float oz = misc[t * 8 + 2], dt = misc[t * 8 + 3];
  // planes_t rows: channel k of plane q of body b at spl[(k*P + q)*B + b]
#define PL(k, q, b) spl[((k) * P + (q)) * B + (b)]
#define SB(r, b) sb[(r) * CR_BP + (b)]

  float vals[2][CR_CH];
  int key[2], lrank[2];
  for (int k = 0; k < 2; ++k) {
    const int p = k * CR_THREADS + tid;
    key[k] = -1;
    lrank[k] = 0;
    if ((k * CR_THREADS + (tid & ~31)) >= N) continue;  // warp-uniform
    const float px = pt[0 * N + p], py = pt[1 * N + p], pz = pt[2 * N + p];
    const bool active = pt[4 * N + p] > 0.0f;
    // winner: strict-< scan, spheres first (first minimum wins)
    float best = 0.0f;
    int widx = 0;
    for (int b = 0; b < B; ++b) {
      const float dx = px - SB(0, b), dy = py - SB(1, b), dz = pz - SB(2, b);
      const float sv = sqrtf(dx * dx + dy * dy + dz * dz) - SB(3, b);
      if (b == 0 || sv < best) { best = sv; widx = b; }
    }
    for (int b = 0; b < B; ++b) {
      float hv = -INFINITY;
      for (int q = 0; q < P; ++q) {
        const float v = PL(0, q, b) * px + PL(1, q, b) * py
                        + PL(2, q, b) * pz + PL(3, q, b);
        hv = fmaxf(hv, v);
      }
      if (hv < best) { best = hv; widx = B + b; }
    }
    const bool use_hull = widx >= B;
    const int wb = use_hull ? widx - B : widx;
    const float wpx = SB(0, wb), wpy = SB(1, wb), wpz = SB(2, wb);
    float wnx, wny, wnz;
    {
      const float dx = px - wpx, dy = py - wpy, dz = pz - wpz;
      const float inv = 1.0f / fmaxf(sqrtf(dx * dx + dy * dy + dz * dz),
                                     1e-20f);
      wnx = dx * inv;
      wny = dy * inv;
      wnz = dz * inv;
    }
    // the winner body's planes: maximal set, slab clip
    float dmax = -INFINITY;
    for (int q = 0; q < P; ++q) {
      const float v = PL(0, q, wb) * px + PL(1, q, wb) * py
                      + PL(2, q, wb) * pz + PL(3, q, wb);
      dmax = fmaxf(dmax, v);
    }
    float sx = 0.0f, sy = 0.0f, sz = 0.0f, cnt = 0.0f;
    bool miss = false;
    float te = 0.0f, tx = 1.0f;
    for (int q = 0; q < P; ++q) {
      const float nx = PL(0, q, wb), ny = PL(1, q, wb), nz = PL(2, q, wb);
      const float dw = nx * px + ny * py + nz * pz + PL(3, q, wb);
      const float dw0 = PL(4, q, wb);
      if (dw == dmax) { sx += nx; sy += ny; sz += nz; cnt += 1.0f; }
      if (dw0 >= 0.0f && dw >= 0.0f) miss = true;
      const float den = dw0 - dw;
      const float tt = den != 0.0f ? dw0 / den : 0.0f;
      te = fmaxf(te, (dw0 >= 0.0f && dw < 0.0f) ? tt : 0.0f);
      tx = fminf(tx, (dw0 <= 0.0f && dw > 0.0f) ? tt : 1.0f);
    }
    if (use_hull) {
      cnt = fmaxf(cnt, 1.0f);
      wnx = sx / cnt;
      wny = sy / cnt;
      wnz = sz / cnt;
    }
    const bool hit = !miss && te <= tx;
    const float rx = px - ox, ry = py - oy, rz = pz - oz;
    const float rinv = 1.0f / fmaxf(sqrtf(rx * rx + ry * ry + rz * rz),
                                    1e-20f);
    const bool front = (rx * wnx + ry * wny + rz * wnz) > 0.0f;
    const bool use_ray = front && hit;
    const float w1x = use_ray ? ox + rx * te : px - wnx * best;
    const float w1y = use_ray ? oy + ry * te : py - wny * best;
    const float w1z = use_ray ? oz + rz * te : pz - wnz * best;
    const float nxf = use_ray ? rx * rinv : wnx;
    const float nyf = use_ray ? ry * rinv : wny;
    const float nzf = use_ray ? rz * rinv : wnz;
    const float td = (w1x - px) * nxf + (w1y - py) * nyf + (w1z - pz) * nzf;
    const float r1x = w1x - wpx, r1y = w1y - wpy, r1z = w1z - wpz;
    const float Jx = r1y * nzf - r1z * nyf;
    const float Jy = r1z * nxf - r1x * nzf;
    const float Jz = r1x * nyf - r1y * nxf;
    const float Kx = SB(6, wb) * Jx + SB(7, wb) * Jy + SB(8, wb) * Jz;
    const float Ky = SB(9, wb) * Jx + SB(10, wb) * Jy + SB(11, wb) * Jz;
    const float Kz = SB(12, wb) * Jx + SB(13, wb) * Jy + SB(14, wb) * Jz;
    const float ccx = Ky * r1z - Kz * r1y;
    const float ccy = Kz * r1x - Kx * r1z;
    const float ccz = Kx * r1y - Ky * r1x;
    const float den = SB(5, wb) + (ccx * nxf + ccy * nyf + ccz * nzf);
    const float dinv = (active && den != 0.0f) ? 1.0f / den : 0.0f;
    float* v = vals[k];
    v[0] = nxf; v[1] = nyf; v[2] = nzf;
    v[3] = Jx; v[4] = Jy; v[5] = Jz;
    v[6] = Kx; v[7] = Ky; v[8] = Kz;
    v[9] = dinv;
    v[10] = td / dt;
    v[11] = 0.0f;
    key[k] = active ? wb : -1;
  }
  // ranks: group each warp's points by winner body
  for (int k = 0; k < 2; ++k) {
    if ((k * CR_THREADS + (tid & ~31)) >= N) continue;  // warp-uniform
    const unsigned m = __match_any_sync(0xffffffffu, key[k]);
    lrank[k] = __popc(m & ((1u << lane) - 1u));
    if (key[k] >= 0 && lane == __ffs(m) - 1)
      seg[((k * CR_THREADS + tid) >> 5) * CR_BP + key[k]] = __popc(m);
  }
  __syncthreads();
  if (tid < CR_BP) {
    int run = 0;
    for (int s = 0; s < nseg; ++s) {
      const int c = seg[s * CR_BP + tid];
      seg[s * CR_BP + tid] = run;
      run += c;
    }
    cnt_sh[tid] = run;
    counts[(size_t)t * CR_BP + tid] = (float)run;
  }
  __syncthreads();
  const float Cf = (float)C;
  const float invC = (float)(1.0 / (double)C);
  for (int k = 0; k < 2; ++k) {
    const int b = key[k];
    if (b < 0) continue;
    const int p = k * CR_THREADS + tid;
    const float rankf = (float)(seg[(p >> 5) * CR_BP + b] + lrank[k]);
    const float cntf = (float)cnt_sh[b];
    const bool thin = cntf > Cf;
    const float safe = fmaxf(cntf, 1.0f);
    const float nr = thin ? floorf(rankf * Cf / safe) : rankf;
    const float prev = floorf((rankf - 1.0f) * Cf / safe);
    const bool keep = !thin || rankf == 0.0f || nr > prev;
    if (!keep || nr >= Cf) continue;
    const float comp = thin ? cntf * invC : 1.0f;
    vals[k][11] = SB(4, b) * comp;
    const int col = b * C + (int)nr;
    for (int ch = 0; ch < CR_CH; ++ch) out[ch * CR_BP * C + col] = vals[k][ch];
  }
#undef PL
#undef SB
}

// pts (T, 8, N); planes (T, 5P, B); body (T, 16, 24); misc (T, 8)
// [origin, dt]; packed (T, 12, 24*C); counts (T, 24).  Requires N % 32 == 0,
// N <= 2048, 5*P*B <= 8192, bp == 24.
HTS_EXPORT int hts_cloud_rows_solve(const void* pts, const void* planes,
                                    const void* body, const void* misc,
                                    void* packed, void* counts, int T, int N,
                                    int P, int B, int C, int bp,
                                    void* stream) {
  if (N % 32 != 0 || N > CR_THREADS * 2 || 5 * P * B > CR_MAXPB ||
      bp != CR_BP || B > CR_BP)
    return (int)cudaErrorInvalidValue;
  if (T > 0) {
    cloud_rows_solve_kernel<<<T, CR_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)pts, (const float*)planes, (const float*)body,
        (const float*)misc, (float*)packed, (float*)counts, N, P, B, C);
  }
  return (int)cudaGetLastError();
}
