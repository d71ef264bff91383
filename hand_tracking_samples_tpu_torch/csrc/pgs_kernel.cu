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
// no-op (a zero impulse), so the cuts change no value.  A jacobi class
// (contacts_mode="jacobi", JAX pgs_kernel.py:109) is one group of units
// that share bodies: every unit runs its U phases on the momenta of the
// group's start, carrying its own impulses from phase to phase, and each
// body then adds its units' deltas in unit order and applies the sum once.
//
// Design: one warp (block of 32 threads) per track.  The momenta (6 x BP)
// live in shared memory.  In a slot step lane b owns body b (its momenta
// held in registers across the slot loop), so slot steps need no
// synchronisation of their own.  In a pair group lane w owns unit w; the
// units of a group touch disjoint bodies, so their gathers and scatters
// never meet, and __syncwarp() orders one group after the next.  A jacobi
// group (at most 96 units) gives lane l the units l, l + 32 and l + 64:
// after their phases each unit's three sums (dl, da0, da1) go to shared
// memory, and lane b adds body b's from a per-body list of (unit, side)
// that the plan builds on the host; no atomics.  Sums run
// in a fixed order and nothing is atomic: Gauss-Seidel rows keep their
// order.  The accumulated impulses (a column per lane) and the classes'
// unit body ids live in shared memory.
//
// The rows do not depend on the momenta and the walk is static (slots
// 0..nact-1, then the active groups of each class, one step a unit phase),
// so they are staged ahead.  The prologue lists the sweep's stages: runs of
// up to SI consecutive steps whose blocks (a slot's (14, BP), a linear
// phase's (23, W), an angular phase's (14, W)) lie back to back in device
// memory.  A ring of NS stage buffers in shared memory is filled by lane 0,
// one bulk copy (TMA) a stage completing on the buffer's mbarrier, NS - 1
// stages ahead of the step being solved and across the sweep boundaries;
// a buffer is refilled as soon as its last step is done.  A step then
// costs its shared-memory reads and ~20 float operations (the next slot's
// channels are read while this one is solved), not a trip to device
// memory.
//
// Bound on the H100: bytes.  Each track must read its rows once, at most:
// singles 133 x 14 x 24 x 4 = 179 KB, joint and angular rows (~10 KB
// each), contact rows (~88 KB), and write 2 x 6 x 24 floats; at 512 tracks
// at most ~150 MB, 0.045 ms at 3.35 TB/s (less where slots and contact
// groups are empty: the cuts skip reading them).  This design streams
// every step's block every sweep (20 times that: the singles alone 1.8 GB
// at T=512, ~0.55 ms), and the solve is sequential: 20 sweeps x (active
// slots + group phases) dependent steps of ~20 FLOP a lane.
#include "common.cuh"

#define PGS_MAXC 4
#define PGS_MAXG 256
#define PGS_STAGE_BYTES 8192     // a stage's steps, at most (one step more)
#define PGS_RING_BYTES 24576     // the ring, at most (two stages at least)
#define PGS_MAXST 8              // stages in the ring, at most

struct PgsClass {
  const float* rows;  // (T, n_groups*U, nch, W)
  const int* ub0;     // (n_groups, W)
  const int* ub1;
  const int* boff;    // jacobi: (BP + 1,) offsets into bent
  const int* bent;    // jacobi: (n_ent,) unit << 1 | side, by body
  int U, W, n_groups, friction, jacobi, n_ent;
};

struct PgsArgs {
  const float* mom0;  // (T, 6, BP)
  const float* mi;    // (BP,)
  const float* singles;  // (T, CS, 14, BP)
  float* out;         // (T, 2, 6, BP)
  long long* cycles;  // (T, 4) clock64 counters, or null
  int T, CS, BP, iters, iters_post, n_lin, n_ang;
  PgsClass lin[PGS_MAXC];
  PgsClass ang[PGS_MAXC];
};

// What the launch derives from the plan: the step stride (the largest
// step block but a jacobi phase's), the steps a stage (SI), the bytes of a
// ring slot (SI steps, or one jacobi phase) and the stages of the ring
// (NS), the accumulators' and the stage table's sizes, the jacobi sums'
// and lists' sizes, the shared bytes.
struct PgsLayout {
  int stride, SI, slot, NS, acc_floats, max_stages, unit_ids, jd_floats,
      jl_ints;
  size_t smem;
};

static PgsLayout pgs_layout(const PgsArgs& a) {
  PgsLayout L;
  int stride = a.CS ? 14 * a.BP * 4 : 16, jstride = 0;
  int acc = a.CS * a.BP, items = a.CS, ids = 0, jd = 0, jl = 0;
  for (int k = 0; k < a.n_lin; ++k) {
    const PgsClass& c = a.lin[k];
    if (c.jacobi) {
      jstride = jstride > 23 * c.W * 4 ? jstride : 23 * c.W * 4;
      jd = jd > 9 * c.W ? jd : 9 * c.W;
      jl += a.BP + 1 + c.n_ent;
    } else {
      stride = stride > 23 * c.W * 4 ? stride : 23 * c.W * 4;
    }
    acc += c.n_groups * c.U * c.W;
    items += c.n_groups * c.U;
    ids += 2 * c.n_groups * c.W;
  }
  for (int k = 0; k < a.n_ang; ++k) {
    const PgsClass& c = a.ang[k];
    stride = stride > 14 * c.W * 4 ? stride : 14 * c.W * 4;
    acc += c.n_groups * c.U * c.W;
    items += c.n_groups * c.U;
    ids += 2 * c.n_groups * c.W;
  }
  int SI = PGS_STAGE_BYTES / stride;
  SI = SI < 1 ? 1 : (SI > 15 ? 15 : SI);
  const int slot = SI * stride > jstride ? SI * stride : jstride;
  int NS = PGS_RING_BYTES / slot;
  NS = NS < 2 ? 2 : (NS > PGS_MAXST ? PGS_MAXST : NS);
  L.stride = stride;
  L.SI = SI;
  L.slot = slot;
  L.NS = NS;
  L.acc_floats = acc + 1;              // and a slot idle lanes write to
  L.max_stages = items;
  L.unit_ids = ids;
  L.jd_floats = jd;
  L.jl_ints = jl;
  // bars, ring, mom (6 x 32), mi (32), the accumulators, the stage table,
  // the classes' unit body ids, the jacobi sums and per-body lists
  L.smem = PGS_MAXST * 8 + (size_t)NS * slot + (6 * 32 + 32) * 4
           + (((size_t)L.acc_floats * 4 + 15) & ~(size_t)15)
           + (size_t)items * 4 + (size_t)ids * 4 + (size_t)jd * 4
           + (size_t)jl * 4;
  return L;
}

__global__ void __launch_bounds__(32)
    pgs_kernel(const PgsArgs a, const PgsLayout Lo) {
  extern __shared__ __align__(16) unsigned char sm[];
  __shared__ unsigned char gact[PGS_MAXC][PGS_MAXG];
  __shared__ const float* src_base[1 + 2 * PGS_MAXC];
  __shared__ int src_floats[1 + 2 * PGS_MAXC];
  const int t = blockIdx.x, lane = threadIdx.x;
  const int BP = a.BP, SI = Lo.SI, NS = Lo.NS, slot = Lo.slot;
  const unsigned FULL = 0xffffffffu;
  uint64_t* bars = (uint64_t*)sm;
  unsigned char* ring = sm + PGS_MAXST * 8;
  float* mom = (float*)(ring + (size_t)NS * slot);
  float* mis = mom + 6 * 32;
  float* acc = mis + 32;
  unsigned* stab = (unsigned*)(acc + ((Lo.acc_floats + 3) & ~3));
  int* uid = (int*)(stab + Lo.max_stages);   // per class: b0s, then b1s
  float* jd = (float*)(uid + Lo.unit_ids);    // a jacobi group's sums
  int* jl = (int*)(jd + Lo.jd_floats);        // per jacobi class: lists
  float* trash = acc + Lo.acc_floats - 1;
  const long long c0 = clock64();
  for (int i = lane; i < 6 * BP; i += 32)
    mom[i] = a.mom0[(size_t)t * 6 * BP + i];
  for (int i = lane; i < BP; i += 32) mis[i] = a.mi[i];
  for (int i = lane; i < Lo.acc_floats; i += 32) acc[i] = 0.0f;
  float* isum_s = acc;
  float* lin_isum[PGS_MAXC];
  float* ang_torq[PGS_MAXC];
  const int* lin_ids[PGS_MAXC];
  const int* ang_ids[PGS_MAXC];
  const int* jac_lists[PGS_MAXC];   // boff (BP + 1), then bent
  {
    float* p = acc + a.CS * BP;
    int* q = uid;
    int* jq = jl;
    for (int k = 0; k < a.n_lin + a.n_ang; ++k) {
      const bool lin = k < a.n_lin;
      const PgsClass& c = lin ? a.lin[k] : a.ang[k - a.n_lin];
      const int n = c.n_groups * c.W;
      (lin ? lin_isum[k] : ang_torq[k - a.n_lin]) = p;
      (lin ? lin_ids[k] : ang_ids[k - a.n_lin]) = q;
      for (int i = lane; i < n; i += 32) {
        q[i] = c.ub0[i];
        q[n + i] = c.ub1[i];
      }
      p += c.n_groups * c.U * c.W;
      q += 2 * n;
      if (lin && c.jacobi) {
        jac_lists[k] = jq;
        for (int i = lane; i < BP + 1; i += 32) jq[i] = c.boff[i];
        for (int i = lane; i < c.n_ent; i += 32) jq[BP + 1 + i] = c.bent[i];
        jq += BP + 1 + c.n_ent;
      }
    }
  }
  const float* S =
      a.singles ? a.singles + (size_t)t * a.CS * 14 * BP : nullptr;
  const float mi = lane < BP ? a.mi[lane] : 0.0f;

  // last active slot (dinv plane non-zero for some body): lanes over slots
  int last = 0;
  for (int c = lane; c < a.CS; c += 32) {
    bool act = false;
    for (int b = 0; b < BP; ++b)
      if (fabsf(S[(c * 14 + 9) * BP + b]) > 0.0f) act = true;
    if (act) last = c + 1;
  }
  const int nact = __reduce_max_sync(FULL, last);
  // per-group activity of the friction (contact) classes: lanes over groups
  for (int k = 0; k < a.n_lin; ++k) {
    const PgsClass& c = a.lin[k];
    if (!c.friction) continue;
    const float* R = c.rows + (size_t)t * c.n_groups * c.U * 23 * c.W;
    for (int g = lane; g < c.n_groups; g += 32) {
      bool act = false;
      for (int u = 0; u < c.U; ++u)
        for (int w = 0; w < c.W; ++w)
          if (fabsf(R[((g * c.U + u) * 23 + 15) * c.W + w]) > 0.0f)
            act = true;
      gact[k][g] = act ? 1 : 0;
    }
  }
  __syncwarp();
  // The stages of one sweep (lane 0): the steps in order, consecutive
  // steps that lie back to back in device memory merged, SI at most:
  // source << 28 | steps << 24 | float offset.
  int n_st = 0, n_steps = 0;
  if (lane == 0) {
    int cur_id = -1, cur_n = 0, cur_end = 0;
    auto add = [&](int id, int off) {
      ++n_steps;
      if (id == cur_id && off == cur_end && cur_n < SI
          && (cur_n + 1) * src_floats[id] * 4 <= slot) {
        stab[n_st - 1] += 1u << 24;
        ++cur_n;
      } else {
        stab[n_st++] = ((unsigned)id << 28) | (1u << 24) | (unsigned)off;
        cur_id = id;
        cur_n = 1;
      }
      cur_end = off + src_floats[id];
    };
    src_base[0] = S;
    src_floats[0] = 14 * BP;
    for (int c = 0; c < nact; ++c) add(0, c * 14 * BP);
    for (int k = 0; k < a.n_lin; ++k) {
      const PgsClass& c = a.lin[k];
      src_base[1 + k] = c.rows + (size_t)t * c.n_groups * c.U * 23 * c.W;
      src_floats[1 + k] = 23 * c.W;
      for (int g = 0; g < c.n_groups; ++g) {
        if (c.friction && !gact[k][g]) continue;
        for (int u = 0; u < c.U; ++u) add(1 + k, (g * c.U + u) * 23 * c.W);
      }
    }
    for (int k = 0; k < a.n_ang; ++k) {
      const PgsClass& c = a.ang[k];
      src_base[1 + PGS_MAXC + k] =
          c.rows + (size_t)t * c.n_groups * c.U * 14 * c.W;
      src_floats[1 + PGS_MAXC + k] = 14 * c.W;
      for (int g = 0; g < c.n_groups; ++g)
        for (int u = 0; u < c.U; ++u)
          add(1 + PGS_MAXC + k, (g * c.U + u) * 14 * c.W);
    }
  }
  n_st = __shfl_sync(FULL, n_st, 0);
  __syncwarp();
  const int total = n_st * (a.iters + a.iters_post);
  // the producer (lane 0): the next stage's table entry and ring slot
  int pi = 0, ps = 0, filled = 0;
  auto fill_next = [&]() {
    const unsigned e = stab[pi];
    const int id = e >> 28;
    hts_bulk_load(ring + (size_t)ps * slot,
                  src_base[id] + (e & 0xFFFFFFu),
                  ((e >> 24) & 15) * src_floats[id] * 4, &bars[ps]);
    if (++pi == n_st) pi = 0;
    if (++ps == NS) ps = 0;
    ++filled;
  };
  if (lane == 0) {
    for (int i = 0; i < NS; ++i) hts_mbar_init(&bars[i]);
    hts_fence_mbar_init();
    while (filled < NS && filled < total) fill_next();
  }
  __syncwarp();
  const long long c1 = clock64();
  // The consumers read the steps in order (a read cursor: the stage, its
  // ring slot and phase parity, the step within it) and release a stage
  // once every step of it is done (a done cursor, at most one step
  // behind): lane 0 then fills its slot with the stage NS ahead.
  int rsi = 0, rslot = 0, rph = 0, ri = 0, rn = 0, rstep = 0;
  const unsigned char* rbase = ring;
  int dsi = 0, di = 0, dn = (n_st ? (stab[0] >> 24) & 15 : 0);
  auto next_block = [&]() -> const float* {
    if (ri == rn) {                      // the next stage
      hts_mbar_wait(&bars[rslot], (unsigned)rph);
      const unsigned e = stab[rsi];
      rn = (e >> 24) & 15;
      rstep = src_floats[e >> 28] * 4;   // the stage's steps, back to back
      rbase = ring + (size_t)rslot * slot;
      ri = 0;
      if (++rsi == n_st) rsi = 0;
      if (++rslot == NS) {
        rslot = 0;
        rph ^= 1;
      }
    }
    return (const float*)(rbase + (size_t)(ri++) * rstep);
  };
  auto step_done = [&]() {
    if (++di == dn) {                    // the stage is done: refill
      __syncwarp();
      if (lane == 0 && filled < total) fill_next();
      if (++dsi == n_st) dsi = 0;
      di = 0;
      dn = (stab[dsi] >> 24) & 15;
    }
  };

  for (int sweep = 0; sweep < a.iters + a.iters_post; ++sweep) {
    const bool post = sweep >= a.iters;
    if (sweep == a.iters) {
      __syncwarp();
      for (int i = lane; i < 6 * BP; i += 32)
        a.out[((size_t)t * 2 + 0) * 6 * BP + i] = mom[i];
    }
    // single-body slots: lane b owns body b; the next slot's channels and
    // accumulated impulse are read while this one is solved
    if (nact > 0) {
      const int b = lane < BP ? lane : 0;
      float l0 = mom[0 * BP + b], l1 = mom[1 * BP + b], l2 = mom[2 * BP + b];
      float g0 = mom[3 * BP + b], g1 = mom[4 * BP + b], g2 = mom[5 * BP + b];
      float x[14], y[14], xs, ys = 0.0f;
#define SLOT_LOAD(v, vs, c)                                           \
  do {                                                                \
    const float* blk = next_block();                                  \
    _Pragma("unroll") for (int i = 0; i < 14; ++i) v[i] = blk[i * BP + b]; \
    vs = lane < BP ? isum_s[(c) * BP + b] : 0.0f;                     \
  } while (0)
#define SLOT_SOLVE(v, vs, c)                                          \
  do {                                                                \
    const float vn = (l0 * v[0] + l1 * v[1] + l2 * v[2]) * mi         \
                     + g0 * v[6] + g1 * v[7] + g2 * v[8];             \
    float imp = (-(post ? v[11] : v[10]) - vn) * v[9];                \
    imp = fminf(imp, v[13] - vs);                                     \
    imp = fmaxf(imp, v[12] - vs);                                     \
    *(lane < BP ? &isum_s[(c) * BP + b] : trash) = vs + imp;          \
    l0 = l0 + v[0] * imp;                                             \
    l1 = l1 + v[1] * imp;                                             \
    l2 = l2 + v[2] * imp;                                             \
    g0 = g0 + v[3] * imp;                                             \
    g1 = g1 + v[4] * imp;                                             \
    g2 = g2 + v[5] * imp;                                             \
    step_done();                                                      \
  } while (0)
      SLOT_LOAD(x, xs, 0);
      for (int c = 0; c < nact; c += 2) {
        if (c + 1 < nact) SLOT_LOAD(y, ys, c + 1);
        SLOT_SOLVE(x, xs, c);
        if (c + 1 >= nact) break;
        if (c + 2 < nact) SLOT_LOAD(x, xs, c + 2);
        SLOT_SOLVE(y, ys, c + 1);
      }
#undef SLOT_LOAD
#undef SLOT_SOLVE
      if (lane < BP) {
        mom[0 * BP + b] = l0; mom[1 * BP + b] = l1; mom[2 * BP + b] = l2;
        mom[3 * BP + b] = g0; mom[4 * BP + b] = g1; mom[5 * BP + b] = g2;
      }
    }
    __syncwarp();
    // linear pair classes: one step a unit phase
    for (int k = 0; k < a.n_lin; ++k) {
      const PgsClass& c = a.lin[k];
      const int U = c.U, W = c.W;
      float* isum = lin_isum[k];
      if (c.jacobi) {
        // ---- a jacobi group: lane l solves units l, l + 32, l + 64 on
        // the momenta of the group's start; then each body's sums ----
        if (c.friction && !gact[k][0]) continue;
        float l0m[3][3], a0[3][3], l1m[3][3], a1[3][3];
        float sdl[3][3], sa0[3][3], sa1[3][3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int wr = lane + 32 * j;
          const int b0 = wr < W ? lin_ids[k][wr] : -1;
          const int b1 = wr < W ? lin_ids[k][W + wr] : -1;
#pragma unroll
          for (int jx = 0; jx < 3; ++jx) {
            l0m[j][jx] = b0 >= 0 ? mom[jx * BP + b0] * mis[b0] : 0.0f;
            a0[j][jx] = b0 >= 0 ? mom[(3 + jx) * BP + b0] : 0.0f;
            l1m[j][jx] = b1 >= 0 ? mom[jx * BP + b1] * mis[b1] : 0.0f;
            a1[j][jx] = b1 >= 0 ? mom[(3 + jx) * BP + b1] : 0.0f;
            sdl[j][jx] = sa0[j][jx] = sa1[j][jx] = 0.0f;
          }
        }
        for (int u = 0; u < U; ++u) {
          const float* blk = next_block();
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const bool on = lane + 32 * j < W;
            const int w = on ? lane + 32 * j : 0;
#define CH(i) blk[(i) * W + w]
            float v3[3];
#pragma unroll
            for (int jx = 0; jx < 3; ++jx)
              v3[jx] = (l1m[j][jx] - l0m[j][jx]) * CH(jx)
                       + a1[j][jx] * CH(12 + jx) - a0[j][jx] * CH(9 + jx);
            const float vn = v3[0] + v3[1] + v3[2];
            float imp = (-CH(post ? 17 : 16) - vn) * CH(15);
            const float isc = isum[u * W + w];
            const float mst = (c.friction && (u % 3) != 0)
                                  ? isum[((u / 3) * 3) * W + w]
                                  : isc;
            const float hi = CH(19) + CH(20) * mst;
            const float lo = CH(18) - CH(20) * mst;
            imp = fminf(imp, hi - isc);
            imp = fmaxf(imp, lo - isc);
            *(on ? &isum[u * W + w] : trash) = isc + imp;
#pragma unroll
            for (int jx = 0; jx < 3; ++jx) {
              const float dl = CH(jx) * imp;
              const float d0 = CH(3 + jx) * imp;
              const float d1 = CH(6 + jx) * imp;
              if (u == 0) {
                sdl[j][jx] = dl; sa0[j][jx] = d0; sa1[j][jx] = d1;
              } else {
                sdl[j][jx] = sdl[j][jx] + dl;
                sa0[j][jx] = sa0[j][jx] + d0;
                sa1[j][jx] = sa1[j][jx] + d1;
              }
              if (u + 1 < U) {
                l0m[j][jx] = l0m[j][jx] - CH(21) * dl;
                l1m[j][jx] = l1m[j][jx] + CH(22) * dl;
                a0[j][jx] = a0[j][jx] - d0;
                a1[j][jx] = a1[j][jx] + d1;
              }
            }
#undef CH
          }
          step_done();
        }
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int w = lane + 32 * j;
          if (w < W) {
#pragma unroll
            for (int jx = 0; jx < 3; ++jx) {
              jd[jx * W + w] = sdl[j][jx];
              jd[(3 + jx) * W + w] = sa0[j][jx];
              jd[(6 + jx) * W + w] = sa1[j][jx];
            }
          }
        }
        __syncwarp();
        // lane b: body b's (unit, side) in unit order; side 0 takes -dl,
        // -da0, side 1 dl, da1; the sum applied once
        if (lane < BP) {
          const int* lst = jac_lists[k];
          const int e0 = lst[lane], e1 = lst[lane + 1];
          if (e1 > e0) {
            float dl[3], da[3];
            for (int e = e0; e < e1; ++e) {
              const int x = lst[BP + 1 + e], u = x >> 1;
              const bool s1 = x & 1;
#pragma unroll
              for (int jx = 0; jx < 3; ++jx) {
                const float vl = jd[jx * W + u];
                const float dlv = s1 ? vl : -vl;
                const float dav = s1 ? jd[(6 + jx) * W + u]
                                     : -jd[(3 + jx) * W + u];
                dl[jx] = e == e0 ? dlv : dl[jx] + dlv;
                da[jx] = e == e0 ? dav : da[jx] + dav;
              }
            }
#pragma unroll
            for (int jx = 0; jx < 3; ++jx) {
              mom[jx * BP + lane] = mom[jx * BP + lane] + dl[jx];
              mom[(3 + jx) * BP + lane] = mom[(3 + jx) * BP + lane] + da[jx];
            }
          }
        }
        __syncwarp();
        continue;
      }
      for (int g = 0; g < c.n_groups; ++g) {
        if (c.friction && !gact[k][g]) continue;
        const int w = lane < W ? lane : 0;
        const int b0 = lin_ids[k][g * W + w];
        const int b1 = lin_ids[k][(c.n_groups + g) * W + w];
        float l0m[3], a0[3], l1m[3], a1[3];
        float sdl[3] = {0, 0, 0}, sa0[3] = {0, 0, 0}, sa1[3] = {0, 0, 0};
        for (int jx = 0; jx < 3; ++jx) {
          l0m[jx] = b0 >= 0 ? mom[jx * BP + b0] * mis[b0] : 0.0f;
          a0[jx] = b0 >= 0 ? mom[(3 + jx) * BP + b0] : 0.0f;
          l1m[jx] = b1 >= 0 ? mom[jx * BP + b1] * mis[b1] : 0.0f;
          a1[jx] = b1 >= 0 ? mom[(3 + jx) * BP + b1] : 0.0f;
        }
        for (int u = 0; u < U; ++u) {
          const float* blk = next_block();
          const int p = g * U + u;
#define CH(i) blk[(i) * W + w]
          float v3[3];
          for (int jx = 0; jx < 3; ++jx)
            v3[jx] = (l1m[jx] - l0m[jx]) * CH(jx) + a1[jx] * CH(12 + jx)
                     - a0[jx] * CH(9 + jx);
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
          *(lane < W ? &isum[p * W + w] : trash) = isc + imp;
          for (int jx = 0; jx < 3; ++jx) {
            const float dl = CH(jx) * imp;
            const float d0 = CH(3 + jx) * imp;
            const float d1 = CH(6 + jx) * imp;
            if (u == 0) {
              sdl[jx] = dl; sa0[jx] = d0; sa1[jx] = d1;
            } else {
              sdl[jx] = sdl[jx] + dl;
              sa0[jx] = sa0[jx] + d0;
              sa1[jx] = sa1[jx] + d1;
            }
            if (u + 1 < U) {
              l0m[jx] = l0m[jx] - CH(21) * dl;
              l1m[jx] = l1m[jx] + CH(22) * dl;
              a0[jx] = a0[jx] - d0;
              a1[jx] = a1[jx] + d1;
            }
          }
#undef CH
          step_done();
        }
        if (lane < W)
          for (int jx = 0; jx < 3; ++jx) {
            if (b0 >= 0) {
              mom[jx * BP + b0] = mom[jx * BP + b0] - sdl[jx];
              mom[(3 + jx) * BP + b0] = mom[(3 + jx) * BP + b0] - sa0[jx];
            }
            if (b1 >= 0) {
              mom[jx * BP + b1] = mom[jx * BP + b1] + sdl[jx];
              mom[(3 + jx) * BP + b1] = mom[(3 + jx) * BP + b1] + sa1[jx];
            }
          }
        __syncwarp();
      }
    }
    // angular pair classes
    for (int k = 0; k < a.n_ang; ++k) {
      const PgsClass& c = a.ang[k];
      const int U = c.U, W = c.W;
      float* torq = ang_torq[k];
      for (int g = 0; g < c.n_groups; ++g) {
        const int w = lane < W ? lane : 0;
        const int b0 = ang_ids[k][g * W + w];
        const int b1 = ang_ids[k][(c.n_groups + g) * W + w];
        float a0[3], a1[3], sv[3] = {0, 0, 0};
        for (int jx = 0; jx < 3; ++jx) {
          a0[jx] = b0 >= 0 ? mom[(3 + jx) * BP + b0] : 0.0f;
          a1[jx] = b1 >= 0 ? mom[(3 + jx) * BP + b1] : 0.0f;
        }
        for (int u = 0; u < U; ++u) {
          const float* blk = next_block();
          const int p = g * U + u;
#define CH(i) blk[(i) * W + w]
          float c3[3];
          for (int jx = 0; jx < 3; ++jx)
            c3[jx] = a1[jx] * CH(6 + jx) - a0[jx] * CH(3 + jx);
          const float cur = c3[0] + c3[1] + c3[2];
          float dtq = (CH(post ? 11 : 10) - cur) * CH(9);
          const float tq = torq[p * W + w];
          dtq = fminf(dtq, CH(13) - tq);
          dtq = fmaxf(dtq, CH(12) - tq);
          *(lane < W ? &torq[p * W + w] : trash) = tq + dtq;
          for (int jx = 0; jx < 3; ++jx) {
            const float da = CH(jx) * dtq;
            sv[jx] = u == 0 ? da : sv[jx] + da;
            if (u + 1 < U) {
              a0[jx] = a0[jx] - da;
              a1[jx] = a1[jx] + da;
            }
          }
#undef CH
          step_done();
        }
        if (lane < W)
          for (int jx = 0; jx < 3; ++jx) {
            if (b0 >= 0)
              mom[(3 + jx) * BP + b0] = mom[(3 + jx) * BP + b0] - sv[jx];
            if (b1 >= 0)
              mom[(3 + jx) * BP + b1] = mom[(3 + jx) * BP + b1] + sv[jx];
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
  if (a.cycles && lane == 0) {
    long long* cy = a.cycles + (size_t)t * 4;
    cy[0] = c1 - c0;                    // prologue
    cy[1] = clock64() - c1;             // the sweeps
    cy[2] = n_steps;                    // steps a sweep
    cy[3] = nact;                       // active slots
  }
}

// The layout for this plan, the attributes set; smem 0 if the kernel
// cannot take it.
static PgsLayout pgs_prepare(const PgsArgs& a) {
  PgsLayout L = pgs_layout(a);
  // the bulk copies need 16-byte multiples: BP even, W a multiple of 4;
  // a stage's float offset fits 24 bits
  bool ok = a.BP <= 32 && a.BP % 2 == 0 && a.n_lin <= PGS_MAXC
            && a.n_ang <= PGS_MAXC && (long long)a.CS * 14 * a.BP < (1 << 24)
            && L.smem <= 232448;
  for (int k = 0; ok && k < a.n_lin + a.n_ang; ++k) {
    const PgsClass& c = k < a.n_lin ? a.lin[k] : a.ang[k - a.n_lin];
    ok = c.W <= (c.jacobi ? 96 : 32) && c.W % 4 == 0
         && c.n_groups <= PGS_MAXG
         && (long long)c.n_groups * c.U * 23 * c.W < (1 << 24)
         && (!c.jacobi || (k < a.n_lin && c.n_groups == 1));
  }
  if (!ok
      || cudaFuncSetAttribute(pgs_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)L.smem) != cudaSuccess
      || cudaFuncSetAttribute(pgs_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              100) != cudaSuccess)
    L.smem = 0;
  return L;
}

// Tracks (blocks) an SM holds at once for this plan; 0 if none.
HTS_EXPORT int hts_pgs_occupancy(const void* args) {
  const PgsLayout L = pgs_prepare(*(const PgsArgs*)args);
  int n = 0;
  if (L.smem)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, pgs_kernel, 32,
                                                  L.smem);
  return n;
}

HTS_EXPORT int hts_pgs_solve(const void* args, void* stream) {
  const PgsArgs a = *(const PgsArgs*)args;
  const PgsLayout L = pgs_prepare(a);
  if (!L.smem) return (int)cudaErrorInvalidValue;
  if (a.T > 0)
    pgs_kernel<<<a.T, 32, L.smem, (cudaStream_t)stream>>>(a, L);
  return (int)cudaGetLastError();
}
