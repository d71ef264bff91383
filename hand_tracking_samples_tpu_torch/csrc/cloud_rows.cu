// Cloud correspondence, three variants of the Pallas kernel
// hand_tracking_samples_tpu/ops/cloud_rows.py:34 (_make_kernel):
//
//   cloud_rows_solve_kernel   solve_ch=True (launched by _cloud_rows_call_b
//                             at :387): rows + solve prep + slot pack
//   cloud_rows_unpacked_kernel  pack=False (_cloud_rows_unpacked_call_b,
//                             :430): per-point directed rows, UnibodyFit
//   cloud_vals_kernel         vals_only=True (same call): winner body and
//                             value per point, FitError
//
// Each is the same function as its plain version in ops/cloud_rows.py
// (cloud_rows_solve_plain, cloud_rows_unpacked_plain, cloud_vals_plain).
// The solve variant:
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
// The unpacked and vals variants: one thread a point, 256-point blocks
// (grid tracks x point blocks), the track's planes staged in shared memory
// by every block.  Vals: 17 x 96 plane evaluations a point and one value
// out, bound by operations (2.6 kFLOP a point: 512 tracks x 2048 points,
// 0.04 ms at 67 TFLOP/s).  Unpacked: the same plus the winner's 96 planes,
// 8 floats out a point.
// The plane values that pick the winner and the hull-normal blend, the
// world inertia behind K1 and dinv use the JAX CPU build's contracted
// expressions (hts_fma/hts_dot3/hts_subp, common.cuh), so the rows equal
// the JAX package's bit for bit on the CPU.
// Left for later: the plane loop is latency-bound on shared-memory reads;
// several points a thread with register-blocked planes would raise the
// arithmetic rate.
#include "common.cuh"

#define CR_THREADS 1024
#define CR_MAXPB 8192
#define CR_MAXSEG 64
#define CR_BP 24
#define CR_CH 12
#define CU_THREADS 256

// planes_t rows: channel k of plane q of body b at spl[(k*P + q)*B + b]
#define PL(k, q, b) spl[((k) * P + (q)) * B + (b)]
#define SB(r, b) sb[(r) * CR_BP + (b)]

// The strict-< winner scan: 17 sphere candidates, then 17 hull most-above
// candidates (the first minimum wins).  widx < B: sphere of body widx;
// widx >= B: hull of body widx - B.
__device__ __forceinline__ void cr_winner(const float* spl, const float* sb,
                                          int P, int B, float px, float py,
                                          float pz, float* best_out,
                                          int* widx_out) {
  float best = 0.0f;
  int widx = 0;
  for (int b = 0; b < B; ++b) {
    const float dx = px - SB(0, b), dy = py - SB(1, b), dz = pz - SB(2, b);
    const float sv = sqrtf(hts_dot3(dx, dy, dz, dx, dy, dz)) - SB(3, b);
    if (b == 0 || sv < best) { best = sv; widx = b; }
  }
  for (int b = 0; b < B; ++b) {
    float hv = -INFINITY;
    for (int q = 0; q < P; ++q) {
      const float v = hts_dot3(PL(0, q, b), PL(1, q, b), PL(2, q, b), px, py,
                               pz) + PL(3, q, b);
      hv = fmaxf(hv, v);
    }
    if (hv < best) { best = hv; widx = B + b; }
  }
  *best_out = best;
  *widx_out = widx;
}

struct CrRow {
  int wb;                 // winner body
  float best;             // winner value
  float nx, ny, nz;       // row normal
  float w1x, w1y, w1z;    // world attach point
  float td;               // target distance
};

// Correspondence + CloudConstraint row of one point (directed: the slab
// clip of the ray origin->p against the winner's hull).
__device__ __forceinline__ CrRow cr_row(const float* spl, const float* sb,
                                        int P, int B, float px, float py,
                                        float pz, float ox, float oy,
                                        float oz, bool directed) {
  float best;
  int widx;
  cr_winner(spl, sb, P, B, px, py, pz, &best, &widx);
  const bool use_hull = widx >= B;
  const int wb = use_hull ? widx - B : widx;
  float wnx, wny, wnz;
  {
    const float dx = px - SB(0, wb), dy = py - SB(1, wb), dz = pz - SB(2, wb);
    const float inv = 1.0f / fmaxf(sqrtf(hts_dot3(dx, dy, dz, dx, dy, dz)),
                                   1e-20f);
    wnx = dx * inv;
    wny = dy * inv;
    wnz = dz * inv;
  }
  // the winner body's planes: maximal set, slab clip
  float dmax = -INFINITY;
  for (int q = 0; q < P; ++q) {
    const float v = hts_dot3(PL(0, q, wb), PL(1, q, wb), PL(2, q, wb), px, py,
                             pz) + PL(3, q, wb);
    dmax = fmaxf(dmax, v);
  }
  float sx = 0.0f, sy = 0.0f, sz = 0.0f, cnt = 0.0f;
  bool miss = false;
  float te = 0.0f, tx = 1.0f;
  for (int q = 0; q < P; ++q) {
    const float nx = PL(0, q, wb), ny = PL(1, q, wb), nz = PL(2, q, wb);
    const float dw = hts_dot3(nx, ny, nz, px, py, pz) + PL(3, q, wb);
    if (dw == dmax) { sx += nx; sy += ny; sz += nz; cnt += 1.0f; }
    if (directed) {
      const float dw0 = PL(4, q, wb);
      if (dw0 >= 0.0f && dw >= 0.0f) miss = true;
      const float den = dw0 - dw;
      const float tt = den != 0.0f ? dw0 / den : 0.0f;
      te = fmaxf(te, (dw0 >= 0.0f && dw < 0.0f) ? tt : 0.0f);
      tx = fminf(tx, (dw0 <= 0.0f && dw > 0.0f) ? tt : 1.0f);
    }
  }
  if (use_hull) {
    cnt = fmaxf(cnt, 1.0f);
    wnx = sx / cnt;
    wny = sy / cnt;
    wnz = sz / cnt;
  }
  CrRow r;
  r.wb = wb;
  r.best = best;
  bool use_ray = false;
  float rx = 0.0f, ry = 0.0f, rz = 0.0f, rinv = 0.0f;
  if (directed) {
    const bool hit = !miss && te <= tx;
    rx = px - ox;
    ry = py - oy;
    rz = pz - oz;
    rinv = 1.0f / fmaxf(sqrtf(hts_dot3(rx, ry, rz, rx, ry, rz)), 1e-20f);
    const bool front = hts_dot3(rx, ry, rz, wnx, wny, wnz) > 0.0f;
    use_ray = front && hit;
  }
  r.w1x = use_ray ? hts_fma(rx, te, ox) : hts_fma(-wnx, best, px);
  r.w1y = use_ray ? hts_fma(ry, te, oy) : hts_fma(-wny, best, py);
  r.w1z = use_ray ? hts_fma(rz, te, oz) : hts_fma(-wnz, best, pz);
  r.nx = use_ray ? rx * rinv : wnx;
  r.ny = use_ray ? ry * rinv : wny;
  r.nz = use_ray ? rz * rinv : wnz;
  r.td = hts_dot3(r.w1x - px, r.w1y - py, r.w1z - pz, r.nx, r.ny, r.nz);
  return r;
}

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

  float vals[2][CR_CH];
  int key[2], lrank[2];
  for (int k = 0; k < 2; ++k) {
    const int p = k * CR_THREADS + tid;
    key[k] = -1;
    lrank[k] = 0;
    if ((k * CR_THREADS + (tid & ~31)) >= N) continue;  // warp-uniform
    const float px = pt[0 * N + p], py = pt[1 * N + p], pz = pt[2 * N + p];
    const bool active = pt[4 * N + p] > 0.0f;
    const CrRow r = cr_row(spl, sb, P, B, px, py, pz, ox, oy, oz, true);
    const int wb = r.wb;
    const float nxf = r.nx, nyf = r.ny, nzf = r.nz;
    const float r1x = r.w1x - SB(0, wb), r1y = r.w1y - SB(1, wb),
                r1z = r.w1z - SB(2, wb);
    const float Jx = hts_subp(r1y, nzf, r1z, nyf);
    const float Jy = hts_subp(r1z, nxf, r1x, nzf);
    const float Jz = hts_subp(r1x, nyf, r1y, nxf);
    const float Kx = hts_dot3(SB(6, wb), SB(7, wb), SB(8, wb), Jx, Jy, Jz);
    const float Ky = hts_dot3(SB(9, wb), SB(10, wb), SB(11, wb), Jx, Jy, Jz);
    const float Kz = hts_dot3(SB(12, wb), SB(13, wb), SB(14, wb), Jx, Jy, Jz);
    const float ccx = hts_subp(Ky, r1z, Kz, r1y);
    const float ccy = hts_subp(Kz, r1x, Kx, r1z);
    const float ccz = hts_subp(Kx, r1y, Ky, r1x);
    const float den = SB(5, wb) + hts_dot3(ccx, ccy, ccz, nxf, nyf, nzf);
    const float dinv = (active && den != 0.0f) ? 1.0f / den : 0.0f;
    float* v = vals[k];
    v[0] = nxf; v[1] = nyf; v[2] = nzf;
    v[3] = Jx; v[4] = Jy; v[5] = Jz;
    v[6] = Kx; v[7] = Ky; v[8] = Kz;
    v[9] = dinv;
    v[10] = r.td / dt;
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
}


// Per-point rows without a pack (pack=False, directed) or the winner alone
// (vals_only).  One thread a point, grid (tracks, point blocks).
__global__ void __launch_bounds__(CU_THREADS)
cloud_rows_unpacked_kernel(const float* __restrict__ pts,
                           const float* __restrict__ planes,
                           const float* __restrict__ body,
                           const float* __restrict__ misc,
                           float* __restrict__ out, int N, int P, int B,
                           int vals_only) {
  __shared__ float spl[CR_MAXPB];
  __shared__ float sb[16 * CR_BP];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int PB = 5 * P * B;
  for (int i = tid; i < PB; i += CU_THREADS)
    spl[i] = planes[(size_t)t * PB + i];
  for (int i = tid; i < 16 * CR_BP; i += CU_THREADS)
    sb[i] = body[(size_t)t * 16 * CR_BP + i];
  __syncthreads();
  const int p = blockIdx.y * CU_THREADS + tid;
  if (p >= N) return;
  const float* pt = pts + (size_t)t * 8 * N;
  const float px = pt[0 * N + p], py = pt[1 * N + p], pz = pt[2 * N + p];
  if (vals_only) {
    // out (T, 2, N): [winner value, winner body]
    float best;
    int widx;
    cr_winner(spl, sb, P, B, px, py, pz, &best, &widx);
    float* o = out + (size_t)t * 2 * N;
    o[p] = best;
    o[N + p] = (float)(widx >= B ? widx - B : widx);
    return;
  }
  // out (T, 8, N): [n(3), w1(3), td, active]
  const float ox = misc[t * 8 + 0], oy = misc[t * 8 + 1];
  const float oz = misc[t * 8 + 2];
  const CrRow r = cr_row(spl, sb, P, B, px, py, pz, ox, oy, oz, true);
  float* o = out + (size_t)t * 8 * N;
  o[0 * N + p] = r.nx;
  o[1 * N + p] = r.ny;
  o[2 * N + p] = r.nz;
  o[3 * N + p] = r.w1x;
  o[4 * N + p] = r.w1y;
  o[5 * N + p] = r.w1z;
  o[6 * N + p] = r.td;
  o[7 * N + p] = pt[4 * N + p] > 0.0f ? 1.0f : 0.0f;
}
#undef PL
#undef SB
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

// pts (T, 8, N); planes (T, 5P, B); body (T, 16, 24); misc (T, 8);
// out (T, 8, N) rows, or (T, 2, N) [value, body] when vals_only.
// Requires 5*P*B <= 8192.
HTS_EXPORT int hts_cloud_rows_unpacked(const void* pts, const void* planes,
                                       const void* body, const void* misc,
                                       void* out, int T, int N, int P, int B,
                                       int vals_only, void* stream) {
  if (5 * P * B > CR_MAXPB || B > CR_BP || N <= 0)
    return (int)cudaErrorInvalidValue;
  if (T > 0) {
    dim3 grid(T, (N + CU_THREADS - 1) / CU_THREADS);
    cloud_rows_unpacked_kernel<<<grid, CU_THREADS, 0,
                                 (cudaStream_t)stream>>>(
        (const float*)pts, (const float*)planes, (const float*)body,
        (const float*)misc, (float*)out, N, P, B, vals_only);
  }
  return (int)cudaGetLastError();
}
