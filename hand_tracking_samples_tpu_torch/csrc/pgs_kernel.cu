// The whole 16+4-sweep projected Gauss-Seidel solve of one FitPointCloud.
//
// Replaces the Pallas kernel hand_tracking_samples_tpu/physics/
// pgs_kernel.py:185 (_make_kernel, launched by _pallas_solve at :479).  Same
// function as physics/pgs_kernel.py:pgs_solve_plain in this package (see its
// docstring for the layouts): single-body slot steps, pair-class groups of
// body-disjoint units (friction rows read their contact normal row's
// accumulated impulse), bias-free target speeds in the post sweeps, the
// slot loop cut at the last slot with an active row, and contact groups
// whose rows are all inactive skipped.  Every skipped step is an exact
// no-op (a zero impulse), so the cuts change no value.
//
// Design: one warp (block of 32 threads) per track.  The momenta (6 x BP)
// live in shared memory.  In a slot step lane b owns body b, so slot steps
// need no synchronisation.  In a pair group lane w owns unit w; the units of
// a group touch disjoint bodies, so their gathers and scatters never meet,
// and __syncwarp() orders one group after the next.  Sums run in a fixed
// order and nothing is atomic: Gauss-Seidel rows keep their order.  The
// accumulated impulses (a column per lane) live in a per-track scratch row
// in device memory.
//
// Bound on the H100: bytes.  Each track must read its rows once, at most:
// singles 133 x 14 x 24 x 4 = 179 KB, joint and angular rows (~10 KB
// each), contact rows (~88 KB), and write 2 x 6 x 24 floats; at 512 tracks
// at most ~150 MB, 0.045 ms at 3.35 TB/s (less where slots and contact
// groups are empty: the cuts skip reading them).  The solve itself is
// sequential: 20 sweeps x (active slots + groups) dependent steps of ~20
// FLOP a lane.
// Left for later: with one warp per track the card holds few warps and each
// step waits on memory; staging each slot's rows in shared memory ahead of
// use, or several tracks per block, would hide that latency.
#include "common.cuh"

#define PGS_MAXC 4
#define PGS_MAXG 256

struct PgsClass {
  const float* rows;  // (T, n_groups*U, nch, W)
  const int* ub0;     // (n_groups, W)
  const int* ub1;
  int U, W, n_groups, friction;
};

struct PgsArgs {
  const float* mom0;  // (T, 6, BP)
  const float* mi;    // (BP,)
  const float* singles;  // (T, CS, 14, BP)
  float* out;         // (T, 2, 6, BP)
  float* scratch;     // (T, scratch_per_track)
  int T, CS, BP, iters, iters_post, n_lin, n_ang, scratch_per_track;
  PgsClass lin[PGS_MAXC];
  PgsClass ang[PGS_MAXC];
};

__global__ void __launch_bounds__(32) pgs_kernel(const PgsArgs a) {
  __shared__ float mom[6 * 32];
  __shared__ unsigned char gact[PGS_MAXC][PGS_MAXG];
  const int t = blockIdx.x, lane = threadIdx.x;
  const int BP = a.BP;
  const unsigned FULL = 0xffffffffu;
  for (int i = lane; i < 6 * BP; i += 32)
    mom[i] = a.mom0[(size_t)t * 6 * BP + i];
  float* scr = a.scratch + (size_t)t * a.scratch_per_track;
  for (int i = lane; i < a.scratch_per_track; i += 32) scr[i] = 0.0f;
  float* isum_s = scr;
  float* lin_isum[PGS_MAXC];
  float* ang_torq[PGS_MAXC];
  {
    float* p = scr + a.CS * BP;
    for (int k = 0; k < a.n_lin; ++k) {
      lin_isum[k] = p;
      p += a.lin[k].n_groups * a.lin[k].U * a.lin[k].W;
    }
    for (int k = 0; k < a.n_ang; ++k) {
      ang_torq[k] = p;
      p += a.ang[k].n_groups * a.ang[k].U * a.ang[k].W;
    }
  }
  const float* S =
      a.singles ? a.singles + (size_t)t * a.CS * 14 * BP : nullptr;
  const float mi = lane < BP ? a.mi[lane] : 0.0f;

  // last active slot (dinv plane non-zero for some body)
  int nact = 0;
  for (int c = 0; c < a.CS; ++c) {
    const float v = lane < BP ? fabsf(S[(c * 14 + 9) * BP + lane]) : 0.0f;
    if (__any_sync(FULL, v > 0.0f)) nact = c + 1;
  }
  // per-group activity of the friction (contact) classes
  for (int k = 0; k < a.n_lin; ++k) {
    const PgsClass& c = a.lin[k];
    if (!c.friction) continue;
    const float* R = c.rows + (size_t)t * c.n_groups * c.U * 23 * c.W;
    for (int g = 0; g < c.n_groups; ++g) {
      bool act = false;
      for (int u = 0; u < c.U; ++u)
        if (lane < c.W &&
            fabsf(R[((g * c.U + u) * 23 + 15) * c.W + lane]) > 0.0f)
          act = true;
      const bool any = __any_sync(FULL, act);
      if (lane == 0) gact[k][g] = any ? 1 : 0;
    }
  }
  __syncwarp();

  for (int sweep = 0; sweep < a.iters + a.iters_post; ++sweep) {
    const bool post = sweep >= a.iters;
    if (sweep == a.iters) {
      __syncwarp();
      for (int i = lane; i < 6 * BP; i += 32)
        a.out[((size_t)t * 2 + 0) * 6 * BP + i] = mom[i];
    }
    // single-body slots: lane b owns body b
    if (lane < BP) {
      const int b = lane;
      const int o = post ? 11 : 10;
      for (int c = 0; c < nact; ++c) {
        const float* blk = S + (size_t)c * 14 * BP;
        const float n0 = blk[0 * BP + b], n1 = blk[1 * BP + b],
                    n2 = blk[2 * BP + b];
        const float l0 = mom[0 * BP + b], l1 = mom[1 * BP + b],
                    l2 = mom[2 * BP + b];
        const float g0 = mom[3 * BP + b], g1 = mom[4 * BP + b],
                    g2 = mom[5 * BP + b];
        const float vn = (l0 * n0 + l1 * n1 + l2 * n2) * mi
                         + g0 * blk[6 * BP + b] + g1 * blk[7 * BP + b]
                         + g2 * blk[8 * BP + b];
        float imp = (-blk[o * BP + b] - vn) * blk[9 * BP + b];
        const float isc = isum_s[c * BP + b];
        imp = fminf(imp, blk[13 * BP + b] - isc);
        imp = fmaxf(imp, blk[12 * BP + b] - isc);
        isum_s[c * BP + b] = isc + imp;
        mom[0 * BP + b] = l0 + n0 * imp;
        mom[1 * BP + b] = l1 + n1 * imp;
        mom[2 * BP + b] = l2 + n2 * imp;
        mom[3 * BP + b] = g0 + blk[3 * BP + b] * imp;
        mom[4 * BP + b] = g1 + blk[4 * BP + b] * imp;
        mom[5 * BP + b] = g2 + blk[5 * BP + b] * imp;
      }
    }
    __syncwarp();
    // linear pair classes
    for (int k = 0; k < a.n_lin; ++k) {
      const PgsClass& c = a.lin[k];
      const int U = c.U, W = c.W;
      const float* R = c.rows + (size_t)t * c.n_groups * U * 23 * W;
      float* isum = lin_isum[k];
      for (int g = 0; g < c.n_groups; ++g) {
        if (c.friction && !gact[k][g]) continue;
        if (lane < W) {
          const int w = lane;
          const int b0 = c.ub0[g * W + w], b1 = c.ub1[g * W + w];
          float l0m[3], a0[3], l1m[3], a1[3];
          for (int j = 0; j < 3; ++j) {
            l0m[j] = b0 >= 0 ? mom[j * BP + b0] * a.mi[b0] : 0.0f;
            a0[j] = b0 >= 0 ? mom[(3 + j) * BP + b0] : 0.0f;
            l1m[j] = b1 >= 0 ? mom[j * BP + b1] * a.mi[b1] : 0.0f;
            a1[j] = b1 >= 0 ? mom[(3 + j) * BP + b1] : 0.0f;
          }
          float sdl[3] = {0, 0, 0}, sa0[3] = {0, 0, 0}, sa1[3] = {0, 0, 0};
          for (int u = 0; u < U; ++u) {
            const int p = g * U + u;
            const float* blk = R + (size_t)p * 23 * W;
#define CH(i) blk[(i) * W + w]
            float v3[3];
            for (int j = 0; j < 3; ++j)
              v3[j] = (l1m[j] - l0m[j]) * CH(j) + a1[j] * CH(12 + j)
                      - a0[j] * CH(9 + j);
            const float vn = v3[0] + v3[1] + v3[2];
            float imp = (-CH(post ? 17 : 16) - vn) * CH(15);
            const float isc = isum[p * W + w];
            const float mst = (c.friction && (u % 3) != 0)
                                  ? isum[(g * U + (u / 3) * 3) * W + w]
                                  : isc;
            const float hi = CH(19) + CH(20) * mst;
            const float lo = CH(18) - CH(20) * mst;
            imp = fminf(imp, hi - isc);
            imp = fmaxf(imp, lo - isc);
            isum[p * W + w] = isc + imp;
            for (int j = 0; j < 3; ++j) {
              const float dl = CH(j) * imp;
              const float d0 = CH(3 + j) * imp;
              const float d1 = CH(6 + j) * imp;
              if (u == 0) {
                sdl[j] = dl; sa0[j] = d0; sa1[j] = d1;
              } else {
                sdl[j] = sdl[j] + dl;
                sa0[j] = sa0[j] + d0;
                sa1[j] = sa1[j] + d1;
              }
              if (u + 1 < U) {
                l0m[j] = l0m[j] - CH(21) * dl;
                l1m[j] = l1m[j] + CH(22) * dl;
                a0[j] = a0[j] - d0;
                a1[j] = a1[j] + d1;
              }
            }
#undef CH
          }
          for (int j = 0; j < 3; ++j) {
            if (b0 >= 0) {
              mom[j * BP + b0] = mom[j * BP + b0] - sdl[j];
              mom[(3 + j) * BP + b0] = mom[(3 + j) * BP + b0] - sa0[j];
            }
            if (b1 >= 0) {
              mom[j * BP + b1] = mom[j * BP + b1] + sdl[j];
              mom[(3 + j) * BP + b1] = mom[(3 + j) * BP + b1] + sa1[j];
            }
          }
        }
        __syncwarp();
      }
    }
    // angular pair classes
    for (int k = 0; k < a.n_ang; ++k) {
      const PgsClass& c = a.ang[k];
      const int U = c.U, W = c.W;
      const float* R = c.rows + (size_t)t * c.n_groups * U * 14 * W;
      float* torq = ang_torq[k];
      for (int g = 0; g < c.n_groups; ++g) {
        if (lane < W) {
          const int w = lane;
          const int b0 = c.ub0[g * W + w], b1 = c.ub1[g * W + w];
          float a0[3], a1[3], sv[3] = {0, 0, 0};
          for (int j = 0; j < 3; ++j) {
            a0[j] = b0 >= 0 ? mom[(3 + j) * BP + b0] : 0.0f;
            a1[j] = b1 >= 0 ? mom[(3 + j) * BP + b1] : 0.0f;
          }
          for (int u = 0; u < U; ++u) {
            const int p = g * U + u;
            const float* blk = R + (size_t)p * 14 * W;
#define CH(i) blk[(i) * W + w]
            float c3[3];
            for (int j = 0; j < 3; ++j)
              c3[j] = a1[j] * CH(6 + j) - a0[j] * CH(3 + j);
            const float cur = c3[0] + c3[1] + c3[2];
            float dtq = (CH(post ? 11 : 10) - cur) * CH(9);
            const float tq = torq[p * W + w];
            dtq = fminf(dtq, CH(13) - tq);
            dtq = fmaxf(dtq, CH(12) - tq);
            torq[p * W + w] = tq + dtq;
            for (int j = 0; j < 3; ++j) {
              const float da = CH(j) * dtq;
              sv[j] = u == 0 ? da : sv[j] + da;
              if (u + 1 < U) {
                a0[j] = a0[j] - da;
                a1[j] = a1[j] + da;
              }
            }
#undef CH
          }
          for (int j = 0; j < 3; ++j) {
            if (b0 >= 0)
              mom[(3 + j) * BP + b0] = mom[(3 + j) * BP + b0] - sv[j];
            if (b1 >= 0)
              mom[(3 + j) * BP + b1] = mom[(3 + j) * BP + b1] + sv[j];
          }
        }
        __syncwarp();
      }
    }
  }
  __syncwarp();
  if (a.iters_post == 0)
    for (int i = lane; i < 6 * BP; i += 32)
      a.out[((size_t)t * 2 + 0) * 6 * BP + i] = mom[i];
  for (int i = lane; i < 6 * BP; i += 32)
    a.out[((size_t)t * 2 + 1) * 6 * BP + i] = mom[i];
}

HTS_EXPORT int hts_pgs_solve(const void* args, void* stream) {
  const PgsArgs a = *(const PgsArgs*)args;
  if (a.BP > 32 || a.n_lin > PGS_MAXC || a.n_ang > PGS_MAXC)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < a.n_lin; ++k)
    if (a.lin[k].W > 32 || a.lin[k].n_groups > PGS_MAXG)
      return (int)cudaErrorInvalidValue;
  for (int k = 0; k < a.n_ang; ++k)
    if (a.ang[k].W > 32 || a.ang[k].n_groups > PGS_MAXG)
      return (int)cudaErrorInvalidValue;
  if (a.T > 0) pgs_kernel<<<a.T, 32, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
