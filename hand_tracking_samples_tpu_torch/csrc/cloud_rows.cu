// Cloud correspondence, four variants of the Pallas kernel
// hand_tracking_samples_tpu/ops/cloud_rows.py:34 (_make_kernel):
//
//   cloud_rows_pack_kernel<12, K>  solve_ch=True (launched by
//                             _cloud_rows_call_b at :387): rows + solve prep
//                             + slot pack (kernel 2)
//   cloud_rows_pack_kernel<16, K>  pack=True, solve_ch=False
//                             (_cloud_rows_call :357, _cloud_rows_call_b
//                             :387): the same pack with the 16 parity
//                             channels (kernel 2.5)
//   cloud_rows_unpacked_kernel  pack=False (_cloud_rows_unpacked_call_b,
//                             :430): per-point directed rows, UnibodyFit
//                             (kernel 6)
//   cloud_vals_kernel         vals_only=True (its branch at :118, launched
//                             at :409 and :430): winner body and value per
//                             point, FitError (kernel 7)
//
// Each is the same function as its plain version in ops/cloud_rows.py
// (cloud_rows_solve_plain, cloud_rows_packed_plain,
// cloud_rows_unpacked_plain, cloud_vals_plain).  The pack variants:
//   winner      strict-< scan over [17 sphere, 17 hull most-above] values
//   normal      sphere: (p - pos)/|p - pos|; hull: mean of the winner
//               body's maximal planes (blend on exact ties)
//   ray clip    slab ConvexHitCheck of origin->p against the winner's hull
//   row         attach point, normal, targetdist, lever r1
//   solve prep  J1 = r1 x n, K1 = Iinv_w J1, dinv; then tsm = td/dt (12
//               channels) or r1, td and active (16 channels)
//   pack        stable per-body rank among active points (slot order =
//               point order), uniform thinning to C slots, force scale
//               compensated by count/C
//
// Bound on the H100: operations.  The winner scan is 17 x 96 hull-plane
// evaluations of 7 float32 operations a point (11.4 kFLOP; the spheres
// add ~0.2 kFLOP), the pack then ~23 operations on each of the winner's
// 96 planes: about 14 kFLOP a point, 28 MFLOP a track at 2048 points; at
// 512 tracks ~15 GFLOP, 0.22 ms at 67 TFLOP/s (a quarter at 512 points).
// Bytes: 2048 x 8 x 4 in, CH x 24 x 128 x 4 out a track (213 KB at 12
// channels, 262 KB at 16), 0.03-0.04 ms at 512 tracks.  An exact kernel
// issues more than that count: a plane evaluation is 5 float32
// instructions (FMUL, FFMA, FFMA, FADD, FMNMX), so the winner scan alone
// needs 0.256 ms of the card's float32 issue at 512 x 2048 points.
//
// The pack's design (one block per track, its planes in shared memory):
//   staging   the track's world planes as one float4 (n.x, n.y, n.z, d)
//             per (body, plane), bodies P + 1 records apart (a body's
//             planes on other banks than the next body's), the slab
//             clip's d-at-origin in an array of its own, the body scalars
//   phase A   the winner scan, register-blocked: each thread holds K
//             points (p = j * threads + tid, so each warp's 32 points of a
//             j are one 32-point segment) and updates their K running
//             maxima from one broadcast 16-byte load a plane; the block
//             has N / K threads (at least a warp)
//   ranks     __match_any_sync groups a segment's points by winner body;
//             the group leader writes the group size into a (segment,
//             body) table; one thread per body turns it into exclusive
//             prefix counts.  No atomics: slot order = point order
//   slot map  each kept point (active, kept by the thinning, rank < C)
//             writes (point << 1 | hull won) into its body's slot; a body
//             fills its first min(count, C) slots
//   phase B   the threads walk the filled slots in order (balanced however
//             the points split among the bodies; a warp's plane reads are
//             broadcasts or a few on distinct banks), recompute the winner
//             value (the hull's: the same fmax chain as the scan; the
//             sphere's: |p - pos| - radius), the row and its prep, and
//             write every channel of the slot; then zeros into the empty
//             slots.  Each output float is written once, coalesced, and no
//             row work is done for points the pack drops.
//   Measured on an H100 at T=512: 0.41 ms at N=2048 (the winner scan's
//   float32 issue ~0.3 ms of it), 0.15 ms at N=512.
// Each (body, slot) receives at most one point, so the TPU kernel's
// scatter matmul (a 3-way bf16 split through a one-hot, exact only because
// every output is a single term) is a direct store here.
//
// The unpacked variant (kernel 6): the vals kernel's blocked scan, then
// the row pass on what the scan kept.
//   staging   the vals kernel's float4 records and sphere rows, plus the
//             slab clip's d-at-origin d0[b * SP + q] (planes_t row 4);
//             one block of 512 threads a track at UnibodyFit's N = 512
//   scan      the vals kernel's with one point a thread (a warp's 32
//             points one run of the cloud): spheres first, then the hulls
//             with the warp exit.  A body that wins is scanned to its end,
//             so a hull winner's best is the fmax chain's value that the
//             blend compares against (no dmax pass)
//   row pass  per point, cr_dirrow on the kept (best, winner): the sphere
//             normal, the blend of the maximal planes for a hull winner
//             only, the slab clip only where the ray meets the normal from
//             the front; 8 floats out a point, a warp's stores coalesced
// Bound on the H100: operations, the scan's evaluations made plus the row
// pass: 0.021 ms at T=512 on the CNN frame's reset inputs, whose scan
// skips 66% of the hull-plane evaluations.  Measured there (chip_ab.py):
// 0.095 ms (0.353 before this design), 0.032 ms at the T=128 the CNN
// frame launches (0.097); the row pass takes a third of it, its slab clip
// (43% of these points meet the normal from the front) 0.020 ms.
//
// The vals kernel (kernel 7): the winner value and body of each point,
// bound by the scan's operations: 11.4 kFLOP a point, 0.18 ms at 512
// tracks x 2048 points and 67 TFLOP/s (its issue floor, 5 instructions a
// plane evaluation, 0.256 ms).  Design: the pack's phase A on the planes
// of its own block, with a warp-uniform exit.
//   staging   the track's planes as float4 records, bodies P8 + 1 records
//             apart, P8 = P rounded up to 8 with (0, 0, 0, -inf) pads;
//             up to 2048 points a block (grid tracks x point blocks)
//   scan      4 consecutive points a thread (a warp's 128 points are one
//             run of the cloud: neighbouring pixels, mostly one winner),
//             one broadcast 16-byte load a plane for the 4; the spheres'
//             strict-< scan gives the first best, then the hulls in order
//             with the same fmax chain as the pack's scan
//   exit      after every 8 planes of a hull, __all_sync over the warp's
//             "partial max >= best" for every point: the hull's value can
//             only grow, so under strict < the body cannot win and its
//             value is never read, and the warp leaves the body.  A body
//             that wins is scanned to its end, so its value keeps its
//             bits.  On the dyn30 clouds the warps scan 33-42% of the
//             planes (tests/test_torch_vals_exit.py states this order;
//             a thread's points 512 apart would scan 58-75%)
// Measured on an H100 at T=512 on the CNN frame's FitError inputs
// (PERF.md, chip_ab.py): 0.156 ms (1.128 before this design), 0.340
// without the exit.  The exit leaves a third of the evaluations there:
// their bound is 0.062 ms and their issue floor 0.084 ms.
// The plane values that pick the winner and the hull-normal blend, the
// world inertia behind K1 and dinv use the JAX CPU build's contracted
// expressions (hts_fma/hts_dot3/hts_subp, common.cuh), so the rows equal
// the JAX package's bit for bit on the CPU.
#include "common.cuh"

#define CR_MAXPB 8192
#define CR_BP 24

#define SB(r, b) sb[(r) * CR_BP + (b)]

struct CrDirRow {
  float nx, ny, nz;       // row normal
  float w1x, w1y, w1z;    // world attach point
  float td;               // target distance
};

// The directed CloudConstraint row (physmodel.h:137-181) of point p won by
// body b: pb and db its plane records and d-at-origin values, (dx, dy, dz)
// = p - c (c its centre) and dist = |p - c|; hull: its hull won with the
// most-above value best (the fmax chain of its planes), else its sphere
// did.  The normal is the sphere's (p - c) / |p - c| or the mean of the
// hull's maximal planes (dw == best).
// The slab clip of origin->p against the hull runs only where the ray
// meets the normal from the front (use_ray needs it; otherwise te, tx and
// miss are never read): for a camera's own cloud a few points in a
// hundred, for UnibodyFit's rows at the PoseFromScratch pose about 43%.
// The same operations in the same order as the plain version
// (ops/cloud_rows.py _rows_plain), so the same bits.
__device__ __forceinline__ CrDirRow cr_dirrow(const float4* pb,
                                              const float* db, int P,
                                              float px, float py, float pz,
                                              float dx, float dy, float dz,
                                              float dist, bool hull,
                                              float best, float ox,
                                              float oy, float oz) {
  const float inv = 1.0f / fmaxf(dist, 1e-20f);
  float wnx = dx * inv, wny = dy * inv, wnz = dz * inv;
  if (hull) {          // the blend of the maximal planes
    float sx = 0.0f, sy = 0.0f, sz = 0.0f, cnt = 0.0f;
#pragma unroll 4
    for (int q = 0; q < P; ++q) {
      const float4 w = pb[q];
      const float dw = hts_dot3(w.x, w.y, w.z, px, py, pz) + w.w;
      if (dw == best) { sx += w.x; sy += w.y; sz += w.z; cnt += 1.0f; }
    }
    cnt = fmaxf(cnt, 1.0f);
    wnx = sx / cnt;
    wny = sy / cnt;
    wnz = sz / cnt;
  }
  const float rx = px - ox, ry = py - oy, rz = pz - oz;
  const bool front = hts_dot3(rx, ry, rz, wnx, wny, wnz) > 0.0f;
  bool use_ray = false;
  float te = 0.0f;
  if (front) {         // the slab clip of origin->p against the hull
    bool miss = false;
    float tx = 1.0f;
#pragma unroll 4
    for (int q = 0; q < P; ++q) {
      const float4 w = pb[q];
      const float dw = hts_dot3(w.x, w.y, w.z, px, py, pz) + w.w;
      const float dw0 = db[q];
      if (dw0 >= 0.0f && dw >= 0.0f) miss = true;
      const float den = dw0 - dw;
      const float tt = den != 0.0f ? dw0 / den : 0.0f;
      te = fmaxf(te, (dw0 >= 0.0f && dw < 0.0f) ? tt : 0.0f);
      tx = fminf(tx, (dw0 <= 0.0f && dw > 0.0f) ? tt : 1.0f);
    }
    use_ray = !miss && te <= tx;
  }
  const float rinv =
      1.0f / fmaxf(sqrtf(hts_dot3(rx, ry, rz, rx, ry, rz)), 1e-20f);
  CrDirRow r;
  r.w1x = use_ray ? hts_fma(rx, te, ox) : hts_fma(-wnx, best, px);
  r.w1y = use_ray ? hts_fma(ry, te, oy) : hts_fma(-wny, best, py);
  r.w1z = use_ray ? hts_fma(rz, te, oz) : hts_fma(-wnz, best, pz);
  r.nx = use_ray ? rx * rinv : wnx;
  r.ny = use_ray ? ry * rinv : wny;
  r.nz = use_ray ? rz * rinv : wnz;
  r.td = hts_dot3(r.w1x - px, r.w1y - py, r.w1z - pz, r.nx, r.ny, r.nz);
  return r;
}

// ---- the pack (kernels 2 and 2.5) -----------------------------------------
// One block's shared memory (dynamic, crp_layout): the planes as float4
// records pl4[b * SP + q] (SP = P + 1), the slab clip's d at the origin
// d0[b * SP + q], the body scalars sb[r * CR_BP + b], the (segment, body)
// table, the per-body counts (32 ints) and filled-slot offsets (32), and
// the slot map slot[b * C + r].
struct CrpLayout {
  int SP, nseg;
  size_t pl4, d0, sb, seg, cnt, slot, bytes;
};

__host__ __device__ __forceinline__ CrpLayout crp_layout(int N, int P, int B,
                                                         int C) {
  CrpLayout L;
  L.SP = P + 1;
  L.nseg = N >> 5;
  size_t o = 0;
  L.pl4 = o;
  o += (size_t)B * L.SP * 16;
  L.d0 = o;
  o += (size_t)B * L.SP * 4;
  L.sb = o;
  o += 16 * CR_BP * 4;
  L.seg = o;
  o += (size_t)L.nseg * CR_BP * 4;
  L.cnt = o;
  o += 64 * 4;
  L.slot = o;
  o += (size_t)CR_BP * C * 2;
  L.bytes = (o + 15) & ~(size_t)15;
  return L;
}

// Phase B of one filled slot: point (px, py, pz) won by body b (its hull
// if `hull`, else its sphere); the winner value, cr_dirrow's row and the
// solve prep, the same operations in the same order as the plain version,
// so the same bits.  v: CH channels.
template <int CH>
__device__ __forceinline__ void crp_slot(float* v, const float4* pb,
                                         const float* db, const float* sb,
                                         int b, int P, float px, float py,
                                         float pz, bool hull, float ox,
                                         float oy, float oz, float dt,
                                         float wsc) {
  const float dx = px - SB(0, b), dy = py - SB(1, b), dz = pz - SB(2, b);
  const float dist = sqrtf(hts_dot3(dx, dy, dz, dx, dy, dz));
  // the winner value: the hull's most-above plane (the scan's fmax chain)
  // or the sphere's |p - pos| - radius
  float dmax = -INFINITY;
#pragma unroll 4
  for (int q = 0; q < P; ++q) {
    const float4 w = pb[q];
    dmax = fmaxf(dmax, hts_dot3(w.x, w.y, w.z, px, py, pz) + w.w);
  }
  const float best = hull ? dmax : dist - SB(3, b);
  const CrDirRow r = cr_dirrow(pb, db, P, px, py, pz, dx, dy, dz, dist,
                               hull, best, ox, oy, oz);
  // the solve prep
  const float r1x = r.w1x - SB(0, b), r1y = r.w1y - SB(1, b),
              r1z = r.w1z - SB(2, b);
  const float Jx = hts_subp(r1y, r.nz, r1z, r.ny);
  const float Jy = hts_subp(r1z, r.nx, r1x, r.nz);
  const float Jz = hts_subp(r1x, r.ny, r1y, r.nx);
  const float Kx = hts_dot3(SB(6, b), SB(7, b), SB(8, b), Jx, Jy, Jz);
  const float Ky = hts_dot3(SB(9, b), SB(10, b), SB(11, b), Jx, Jy, Jz);
  const float Kz = hts_dot3(SB(12, b), SB(13, b), SB(14, b), Jx, Jy, Jz);
  const float ccx = hts_subp(Ky, r1z, Kz, r1y);
  const float ccy = hts_subp(Kz, r1x, Kx, r1z);
  const float ccz = hts_subp(Kx, r1y, Ky, r1x);
  const float den = SB(5, b) + hts_dot3(ccx, ccy, ccz, r.nx, r.ny, r.nz);
  v[0] = r.nx; v[1] = r.ny; v[2] = r.nz;
  v[3] = Jx; v[4] = Jy; v[5] = Jz;
  v[6] = Kx; v[7] = Ky; v[8] = Kz;
  v[9] = den != 0.0f ? 1.0f / den : 0.0f;      // a kept point is active
  if constexpr (CH == 12) {
    v[10] = r.td / dt;
    v[11] = wsc;
  } else {
    v[10] = r1x; v[11] = r1y; v[12] = r1z;
    v[13] = r.td;
    v[14] = wsc;
    v[15] = 1.0f;
  }
}

// CH = 12: [n(3), J1(3), K1(3), dinv, tsm, scale] (kernel 2);
// CH = 16: [n(3), J1(3), K1(3), dinv, r1(3), td, scale, active] (2.5).
// K: points a thread in the winner scan; at most 2048 / K threads, and
// K / 2 blocks an SM at 64 registers a thread.
template <int CH, int K>
__global__ void __launch_bounds__(2048 / K, K / 2)
cloud_rows_pack_kernel(const float* __restrict__ pts,
                       const float* __restrict__ planes,
                       const float* __restrict__ body,
                       const float* __restrict__ misc,
                       float* __restrict__ packed,
                       float* __restrict__ counts, int N, int P, int B,
                       int C) {
  extern __shared__ __align__(16) unsigned char crp_sh[];
  const CrpLayout L = crp_layout(N, P, B, C);
  float4* pl4 = (float4*)(crp_sh + L.pl4);
  float* d0 = (float*)(crp_sh + L.d0);
  float* sb = (float*)(crp_sh + L.sb);
  int* seg = (int*)(crp_sh + L.seg);
  int* cnt_sh = (int*)(crp_sh + L.cnt);
  int* off = cnt_sh + 32;
  short* slot = (short*)(crp_sh + L.slot);
  const int SP = L.SP, nseg = L.nseg, S = CR_BP * C;
  const int t = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int nt = blockDim.x;
  const float* pt = pts + (size_t)t * 8 * N;
  float* out = packed + (size_t)t * CH * S;

  // staging: planes_t (5P, B) transposed into the records
  {
    const float* src = planes + (size_t)t * 5 * P * B;
    float* rec = (float*)pl4;
    const int PB = P * B;
    for (int i = tid; i < 5 * PB; i += nt) {
      const int k = i / PB, r = i - k * PB;
      const int q = r / B, b = r - q * B;
      if (k < 4)
        rec[(b * SP + q) * 4 + k] = src[i];
      else
        d0[b * SP + q] = src[i];
    }
  }
  for (int i = tid; i < 16 * CR_BP; i += nt)
    sb[i] = body[(size_t)t * 16 * CR_BP + i];
  for (int i = tid; i < nseg * CR_BP; i += nt) seg[i] = 0;
  for (int i = tid; i < S; i += nt) slot[i] = -1;
  __syncthreads();

  // phase A: the winner scan of K points a thread
  float px[K], py[K], pz[K], best[K];
  int widx[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int p = j * nt + tid;
    const bool in = p < N;
    px[j] = in ? pt[p] : 0.0f;
    py[j] = in ? pt[N + p] : 0.0f;
    pz[j] = in ? pt[2 * N + p] : 0.0f;
    best[j] = 0.0f;
    widx[j] = 0;
  }
  for (int b = 0; b < B; ++b) {
    const float cx = SB(0, b), cy = SB(1, b), cz = SB(2, b), rad = SB(3, b);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float dx = px[j] - cx, dy = py[j] - cy, dz = pz[j] - cz;
      const float sv = sqrtf(hts_dot3(dx, dy, dz, dx, dy, dz)) - rad;
      if (b == 0 || sv < best[j]) { best[j] = sv; widx[j] = b; }
    }
  }
  for (int b = 0; b < B; ++b) {
    const float4* pb = pl4 + b * SP;
    float hv[K];
#pragma unroll
    for (int j = 0; j < K; ++j) hv[j] = -INFINITY;
#pragma unroll 8
    for (int q = 0; q < P; ++q) {
      const float4 w = pb[q];
#pragma unroll
      for (int j = 0; j < K; ++j)
        hv[j] = fmaxf(hv[j],
                      hts_dot3(w.x, w.y, w.z, px[j], py[j], pz[j]) + w.w);
    }
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (hv[j] < best[j]) { best[j] = hv[j]; widx[j] = B + b; }
  }

  // ranks: group each segment's active points by winner body
  int key[K], lrank[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int p = j * nt + tid;
    key[j] = -1;
    lrank[j] = 0;
    if (j * nt + (tid & ~31) >= N) continue;          // warp-uniform
    if (pt[4 * N + p] > 0.0f) key[j] = widx[j] >= B ? widx[j] - B : widx[j];
    const unsigned m = __match_any_sync(0xffffffffu, key[j]);
    lrank[j] = __popc(m & ((1u << lane) - 1u));
    if (key[j] >= 0 && lane == __ffs(m) - 1)
      seg[(p >> 5) * CR_BP + key[j]] = __popc(m);
  }
  __syncthreads();
  if (tid < 32) {
    int run = 0;
    if (tid < CR_BP) {
      for (int s = 0; s < nseg; ++s) {
        const int c = seg[s * CR_BP + tid];
        seg[s * CR_BP + tid] = run;
        run += c;
      }
      cnt_sh[tid] = run;
      counts[(size_t)t * CR_BP + tid] = (float)run;
    }
    // body b fills its first min(count, C) slots (the thinning's floors
    // step by C / count < 1 and so meet every slot): their offsets
    const int inc = hts_warp_incl_scan(run < C ? run : C);
    if (tid < CR_BP) off[tid + 1] = inc;
    if (tid == 0) off[0] = 0;
  }
  __syncthreads();

  // the slot map: each kept point into its body's slot
  const float Cf = (float)C;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int b = key[j];
    if (b < 0) continue;
    const int p = j * nt + tid;
    const float rankf = (float)(seg[(p >> 5) * CR_BP + b] + lrank[j]);
    const float cntf = (float)cnt_sh[b];
    const bool thin = cntf > Cf;
    const float safe = fmaxf(cntf, 1.0f);
    const float nr = thin ? floorf(rankf * Cf / safe) : rankf;
    const float prev = floorf((rankf - 1.0f) * Cf / safe);
    const bool keep = !thin || rankf == 0.0f || nr > prev;
    if (!keep || nr >= Cf) continue;
    slot[b * C + (int)nr] = (short)((p << 1) | (widx[j] >= B ? 1 : 0));
  }
  __syncthreads();

  // phase B: the filled slots' channels, the threads over them in order
  // (a warp's 32 slots one body's or a few adjacent bodies', whose records
  // lie on other banks), then zeros into the empty slots: each output
  // float written once
  const float ox = misc[t * 8 + 0], oy = misc[t * 8 + 1];
  const float oz = misc[t * 8 + 2], dt = misc[t * 8 + 3];
  const float invC = (float)(1.0 / (double)C);
  for (int i = tid; i < off[CR_BP]; i += nt) {
    int b = 0;
    while (off[b + 1] <= i) ++b;
    const int s = b * C + (i - off[b]);
    const int e = slot[s];
    float v[CH];
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) v[ch] = 0.0f;
    if (e >= 0) {
      const int p = e >> 1;
      const float cntf = (float)cnt_sh[b];
      const float comp = cntf > Cf ? cntf * invC : 1.0f;
      crp_slot<CH>(v, pl4 + b * SP, d0 + b * SP, sb, b, P, pt[p],
                   pt[N + p], pt[2 * N + p], (e & 1) != 0, ox, oy, oz, dt,
                   SB(4, b) * comp);
    }
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) out[ch * S + s] = v[ch];
  }
  for (int s = tid; s < S; s += nt) {
    const int b = s / C;
    if (s - b * C < off[b + 1] - off[b]) continue;
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) out[ch * S + s] = 0.0f;
  }
}

// ---- the blocked winner scan (kernels 6 and 7) ---------------------------
// A block takes up to its threads x K points of a track (grid (tracks,
// point blocks)); each thread K consecutive points, so a warp's 32 * K
// points are one run of the cloud (neighbouring pixels, which mostly
// share their winner).  Shared memory (dynamic): the track's hull planes
// as float4 records (n.x, n.y, n.z, d), body b's at pl4[b * SP], SP = P8 + 1
// with P8 = P rounded up to CV_CHUNK (the pad records (0, 0, 0, -inf) leave
// a max unchanged), then the spheres' centres and radii sb[r * B + b],
// r = 0..3; kernel 6 adds the slab clip's d at the origin d0[b * SP + q].
#define CV_THREADS 512
#define CV_K 4
#define CV_CHUNK 8

__host__ __device__ __forceinline__ int cv_p8(int P) {
  return (P + CV_CHUNK - 1) / CV_CHUNK * CV_CHUNK;
}
__host__ __device__ __forceinline__ size_t cv_smem(int P, int B) {
  return (size_t)B * (cv_p8(P) + 1) * 16 + (size_t)4 * B * 4;
}

// One track's staging: src its planes_t (5P, B), body_t its body
// scalars (16, CR_BP); d0 null or the d-at-origin array.
__device__ __forceinline__ void cv_stage(const float* __restrict__ src,
                                         const float* __restrict__ body_t,
                                         float4* pl4, float* sb, float* d0,
                                         int P, int B) {
  const int P8 = cv_p8(P), SP = P8 + 1, PB = P * B;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < B * P8; i += nt) {
    const int q = i / B, b = i - q * B;
    pl4[b * SP + q] =
        q < P ? make_float4(src[i], src[PB + i], src[2 * PB + i],
                            src[3 * PB + i])
              : make_float4(0.0f, 0.0f, 0.0f, -INFINITY);
    if (d0 != nullptr && q < P) d0[b * SP + q] = src[4 * PB + i];
  }
  for (int i = tid; i < 4 * B; i += nt) {
    const int r = i / B, b = i - r * B;
    sb[i] = body_t[r * CR_BP + b];
  }
}

// The winner scan of the K points p0 + j (those at or past N count as
// lost): the spheres' strict-< scan gives the first best, then the hulls
// in order with the pack's fmax chain.  Once every point of the warp has a
// partial max >= its best, the body cannot win under strict < and its
// value is never read: the warp leaves the body.  A body that wins is
// scanned to its end, so its value keeps its bits.  widx < B: sphere of
// body widx; widx >= B: hull of body widx - B.  Returns the planes the
// warp scanned (of B * P8).
template <int K>
__device__ __forceinline__ int cv_scan(const float4* pl4, const float* sb,
                                       int P8, int B, int N, int p0,
                                       const float (&px)[K],
                                       const float (&py)[K],
                                       const float (&pz)[K],
                                       float (&best)[K], int (&widx)[K]) {
  const int SP = P8 + 1;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    best[j] = 0.0f;
    widx[j] = 0;
  }
  for (int b = 0; b < B; ++b) {
    const float cx = sb[b], cy = sb[B + b], cz = sb[2 * B + b];
    const float rad = sb[3 * B + b];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float dx = px[j] - cx, dy = py[j] - cy, dz = pz[j] - cz;
      const float sv = sqrtf(hts_dot3(dx, dy, dz, dx, dy, dz)) - rad;
      if (b == 0 || sv < best[j]) { best[j] = sv; widx[j] = b; }
    }
  }
  int scanned = 0;
  for (int b = 0; b < B; ++b) {
    const float4* pb = pl4 + b * SP;
    float hv[K];
#pragma unroll
    for (int j = 0; j < K; ++j) hv[j] = -INFINITY;
    int q0 = 0;
    while (q0 < P8) {
#pragma unroll
      for (int i = 0; i < CV_CHUNK; ++i) {
        const float4 w = pb[q0 + i];
#pragma unroll
        for (int j = 0; j < K; ++j)
          hv[j] = fmaxf(hv[j],
                        hts_dot3(w.x, w.y, w.z, px[j], py[j], pz[j]) + w.w);
      }
      q0 += CV_CHUNK;
      bool lost = true;
#pragma unroll
      for (int j = 0; j < K; ++j)
        lost = lost && (p0 + j >= N || hv[j] >= best[j]);
      if (__all_sync(0xffffffffu, lost)) break;
    }
    scanned += q0;
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (hv[j] < best[j]) { best[j] = hv[j]; widx[j] = B + b; }
  }
  return scanned;
}

// The K points p0 + j of a track's planes carrier pt (T, 8, N) (zeros
// past N).
template <int K>
__device__ __forceinline__ void cv_points(const float* pt, int N, int p0,
                                          float (&px)[K], float (&py)[K],
                                          float (&pz)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const bool in = p0 + j < N;
    px[j] = in ? pt[p0 + j] : 0.0f;
    py[j] = in ? pt[N + p0 + j] : 0.0f;
    pz[j] = in ? pt[2 * N + p0 + j] : 0.0f;
  }
}

// ---- kernel 6: per-point directed rows without a pack --------------------
// UR_THREADS x UR_K points a block: one block of 16 warps a track at the
// reset's N = 512 (UnibodyFit's stride-4 subsample of the 2048-point
// cloud), a warp's 32 points one run of it.  The scan and the row pass are
// latency-bound: on an H100, 2 or 4 points a thread (fewer warps, the
// pack's register blocking) were 4% and 18% slower at T=512 and 47% and
// 126% at the CNN frame's T=128; 2 or 4 blocks a track 1-7% slower.
#define UR_THREADS 512
#define UR_K 1

__host__ __device__ __forceinline__ size_t ur_smem(int P, int B) {
  return cv_smem(P, B) + (size_t)B * (cv_p8(P) + 1) * 4;
}

// out (T, 8, N): [n(3), w1(3), td, active].  evals, when not null, (T,)
// counts: each warp adds the planes its scan took (of B * P8 a warp).
__global__ void __launch_bounds__(UR_THREADS, 512 / UR_THREADS)
cloud_rows_unpacked_kernel(const float* __restrict__ pts,
                           const float* __restrict__ planes,
                           const float* __restrict__ body,
                           const float* __restrict__ misc,
                           float* __restrict__ out,
                           unsigned long long* __restrict__ evals, int N,
                           int P, int B) {
  extern __shared__ __align__(16) unsigned char ur_sh[];
  const int P8 = cv_p8(P), SP = P8 + 1;
  float4* pl4 = (float4*)ur_sh;
  float* sb = (float*)(ur_sh + (size_t)B * SP * 16);
  float* d0 = sb + 4 * B;
  const int t = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  cv_stage(planes + (size_t)t * 5 * P * B, body + (size_t)t * 16 * CR_BP,
           pl4, sb, d0, P, B);
  __syncthreads();

  const float* pt = pts + (size_t)t * 8 * N;
  const int p0 = blockIdx.y * (nt * UR_K) + tid * UR_K;
  float px[UR_K], py[UR_K], pz[UR_K], best[UR_K];
  int widx[UR_K];
  cv_points<UR_K>(pt, N, p0, px, py, pz);
  const int scanned =
      cv_scan<UR_K>(pl4, sb, P8, B, N, p0, px, py, pz, best, widx);

  // the row pass on the kept (best, winner)
  const float ox = misc[t * 8 + 0], oy = misc[t * 8 + 1];
  const float oz = misc[t * 8 + 2];
  float* o = out + (size_t)t * 8 * N;
#pragma unroll
  for (int j = 0; j < UR_K; ++j) {
    const int p = p0 + j;
    if (p >= N) continue;
    const bool hull = widx[j] >= B;
    const int b = hull ? widx[j] - B : widx[j];
    const float dx = px[j] - sb[b], dy = py[j] - sb[B + b];
    const float dz = pz[j] - sb[2 * B + b];
    const CrDirRow r = cr_dirrow(
        pl4 + b * SP, d0 + b * SP, P, px[j], py[j], pz[j], dx, dy, dz,
        sqrtf(hts_dot3(dx, dy, dz, dx, dy, dz)), hull, best[j], ox, oy, oz);
    o[p] = r.nx;
    o[N + p] = r.ny;
    o[2 * N + p] = r.nz;
    o[3 * N + p] = r.w1x;
    o[4 * N + p] = r.w1y;
    o[5 * N + p] = r.w1z;
    o[6 * N + p] = r.td;
    o[7 * N + p] = pt[4 * N + p] > 0.0f ? 1.0f : 0.0f;
  }
  if (evals != nullptr && (tid & 31) == 0)
    atomicAdd(evals + t, (unsigned long long)scanned);
}

// ---- kernel 7: the winner value and body of each point -------------------
// out (T, 2, N): [winner value, winner body].  evals, when not null,
// (T,) counts: each warp adds the planes it scanned (of B * P8 a warp).
__global__ void __launch_bounds__(CV_THREADS, 2)
cloud_vals_kernel(const float* __restrict__ pts,
                  const float* __restrict__ planes,
                  const float* __restrict__ body, float* __restrict__ out,
                  unsigned long long* __restrict__ evals, int N, int P,
                  int B) {
  extern __shared__ __align__(16) unsigned char cv_sh[];
  const int P8 = cv_p8(P), SP = P8 + 1;
  float4* pl4 = (float4*)cv_sh;
  float* sb = (float*)(cv_sh + (size_t)B * SP * 16);
  const int t = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  cv_stage(planes + (size_t)t * 5 * P * B, body + (size_t)t * 16 * CR_BP,
           pl4, sb, nullptr, P, B);
  __syncthreads();

  const float* pt = pts + (size_t)t * 8 * N;
  const int p0 = blockIdx.y * (nt * CV_K) + tid * CV_K;
  float px[CV_K], py[CV_K], pz[CV_K], best[CV_K];
  int widx[CV_K];
  cv_points<CV_K>(pt, N, p0, px, py, pz);
  const int scanned =
      cv_scan<CV_K>(pl4, sb, P8, B, N, p0, px, py, pz, best, widx);
  float* o = out + (size_t)t * 2 * N;
#pragma unroll
  for (int j = 0; j < CV_K; ++j) {
    const int p = p0 + j;
    if (p >= N) continue;
    o[p] = best[j];
    o[N + p] = (float)(widx[j] >= B ? widx[j] - B : widx[j]);
  }
  if (evals != nullptr && (tid & 31) == 0)
    atomicAdd(evals + t, (unsigned long long)scanned);
}
#undef SB

// K = 4 points a thread: 512 threads at the dynamics pass's N = 2048 (2
// blocks an SM, 64 registers, no spill), 128 at MultiStepSim's N = 512.
// On an H100 K = 8 (256 and 64 threads) was 16% slower at N = 2048 and 33%
// at N = 512, K = 2 (1024, 256) 21% slower at N = 2048 and even at 512.
template <int CH>
static int cloud_rows_pack_launch(const void* pts, const void* planes,
                                  const void* body, const void* misc,
                                  void* packed, void* counts, int T, int N,
                                  int P, int B, int C, int bp,
                                  void* stream) {
  constexpr int K = 4;
  const CrpLayout L = crp_layout(N, P, B, C);
  if (N % 32 != 0 || N > 2048 || 5 * P * B > CR_MAXPB || bp != CR_BP ||
      B > CR_BP || C <= 0 || L.bytes > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  if (T <= 0) return (int)cudaGetLastError();
  if (L.bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cloud_rows_pack_kernel<CH, K>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int nt = N / K > 32 ? (N / K + 31) / 32 * 32 : 32;
  cloud_rows_pack_kernel<CH, K><<<T, nt, L.bytes, (cudaStream_t)stream>>>(
      (const float*)pts, (const float*)planes, (const float*)body,
      (const float*)misc, (float*)packed, (float*)counts, N, P, B, C);
  return (int)cudaGetLastError();
}

// pts (T, 8, N); planes (T, 5P, B); body (T, 16, 24); misc (T, 8)
// [origin, dt]; packed (T, 12, 24*C); counts (T, 24).  Requires N % 32 == 0,
// N <= 2048, 5*P*B <= 8192, bp == 24, C > 0.
HTS_EXPORT int hts_cloud_rows_solve(const void* pts, const void* planes,
                                    const void* body, const void* misc,
                                    void* packed, void* counts, int T, int N,
                                    int P, int B, int C, int bp,
                                    void* stream) {
  return cloud_rows_pack_launch<12>(pts, planes, body, misc, packed, counts,
                                    T, N, P, B, C, bp, stream);
}

// The same arguments; packed (T, 16, 24*C), the parity channels.
HTS_EXPORT int hts_cloud_rows_packed(const void* pts, const void* planes,
                                     const void* body, const void* misc,
                                     void* packed, void* counts, int T,
                                     int N, int P, int B, int C, int bp,
                                     void* stream) {
  return cloud_rows_pack_launch<16>(pts, planes, body, misc, packed, counts,
                                    T, N, P, B, C, bp, stream);
}

// pts (T, 8, N); planes (T, 5P, B); body (T, 16, 24); misc (T, 8);
// out (T, 8, N) rows; evals null or (T,) uint64 counts of the planes the
// warps scanned.  Requires N >= 1, P >= 1, 1 <= B <= 24 and the staged
// planes in a block's shared memory (ur_smem(P, B) <= 227 KB).
HTS_EXPORT int hts_cloud_rows_unpacked(const void* pts, const void* planes,
                                       const void* body, const void* misc,
                                       void* out, void* evals, int T, int N,
                                       int P, int B, void* stream) {
  const size_t smem = ur_smem(P, B);
  if (N <= 0 || P <= 0 || B <= 0 || B > CR_BP || smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  if (T <= 0) return (int)cudaGetLastError();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cloud_rows_unpacked_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // UR_THREADS threads a block, fewer (whole warps) for a smaller cloud
  const int per = UR_THREADS * UR_K;
  const int nt = N >= per ? UR_THREADS
                          : ((N + UR_K - 1) / UR_K + 31) / 32 * 32;
  dim3 grid(T, (N + per - 1) / per);
  cloud_rows_unpacked_kernel<<<grid, nt, smem, (cudaStream_t)stream>>>(
      (const float*)pts, (const float*)planes, (const float*)body,
      (const float*)misc, (float*)out, (unsigned long long*)evals, N, P, B);
  return (int)cudaGetLastError();
}

// pts (T, 8, N); planes (T, 5P, B); body (T, 16, 24); out (T, 2, N)
// [winner value, winner body]; evals null or (T,) uint64 counts of the
// planes the warps scanned.  Requires N >= 1, P >= 1, 1 <= B <= 24.
HTS_EXPORT int hts_cloud_vals(const void* pts, const void* planes,
                              const void* body, void* out, void* evals,
                              int T, int N, int P, int B, void* stream) {
  const size_t smem = cv_smem(P, B);
  if (N <= 0 || P <= 0 || B <= 0 || B > CR_BP || smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  if (T <= 0) return (int)cudaGetLastError();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cloud_vals_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // a block of CV_THREADS threads a 2048 points, fewer (whole warps) for a
  // smaller cloud
  const int per = CV_THREADS * CV_K;
  const int nt = N >= per ? CV_THREADS
                          : ((N + CV_K - 1) / CV_K + 31) / 32 * 32;
  dim3 grid(T, (N + per - 1) / per);
  cloud_vals_kernel<<<grid, nt, smem, (cudaStream_t)stream>>>(
      (const float*)pts, (const float*)planes, (const float*)body,
      (float*)out, (unsigned long long*)evals, N, P, B);
  return (int)cudaGetLastError();
}
