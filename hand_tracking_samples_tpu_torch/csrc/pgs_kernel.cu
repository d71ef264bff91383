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
// never meet, and __syncwarp() orders one group after the next.  Sums run
// in a fixed order and nothing is atomic: Gauss-Seidel rows keep their
// order.  The accumulated impulses (a column per lane) and the classes'
// unit body ids live in shared memory.
//
// A jacobi class is solved on its active units only (pgs_kernel.py's
// jacobi_order_plain states the order).  Its rows do not depend on the
// momenta, so the prologue finds once a solve the units with an active
// row (a ballot over the units, compacted in unit order, at most 96) and
// the phases in which some row is active, and writes the active units'
// columns of those phases into a compact per-track copy in device memory
// (the wrapper's scratch): a phase's block is then (23, Ap), Ap the active
// count rounded up to 4, and lane l solves the compact units l, l + 32 and
// l + 64 below the count.  Each body's per-body list (the plan's
// (unit, side) entries, by body) is filtered to the active units, in unit
// order; after its phases each unit's three sums (dl, da0, da1) go to
// shared memory and lane b adds body b's and applies them once; no
// atomics.  An idle unit, and every row of a dropped phase, takes a zero
// impulse and carries its momenta unchanged, so dropping them changes no
// value.  The jacobi code is a template instance of its own (JAC): the
// exact plans' instance compiles without it.
//
// The rows do not depend on the momenta and the walk is static (slots
// 0..nact-1, then the active groups of each class, one step a unit phase),
// so they are staged ahead.  The prologue lists the sweep's stages: runs of
// up to SI consecutive steps (15 for a jacobi class's compact phases) whose
// blocks (a slot's (14, BP), a linear phase's (23, W), an angular phase's
// (14, W), a compact jacobi phase's (23, Ap)) lie back to back in device
// memory.  A ring of NS stage buffers in shared memory is filled by lane 0,
// one bulk copy (TMA) a stage completing on the buffer's mbarrier, NS - 1
// stages ahead of the step being solved and across the sweep boundaries;
// a buffer is refilled as soon as its last step is done.  A step then
// costs its shared-memory reads and ~20 float operations (the next slot's
// channels are read while this one is solved), not a trip to device
// memory.  A pair step reads its channels into registers before it uses
// any: ptxas gives the exact instance fewer registers than the jacobi one
// and otherwise waits on each read at its use (4-15% slower there).
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
#define PGS_JMAXW 96             // a jacobi class's units, at most
#define PGS_JMAXU 32             // a jacobi class's phases, at most
#define PGS_JHDR 36              // a jacobi class's header: A, Ap, NK, 0,
                                 // then the kept phases (PGS_JMAXU)

struct PgsClass {
  const float* rows;  // (T, n_groups*U, nch, W)
  const int* ub0;     // (n_groups, W)
  const int* ub1;
  const int* boff;    // jacobi: (BP + 1,) offsets into bent
  const int* bent;    // jacobi: (n_ent,) unit << 1 | side, by body
  float* jrows;       // jacobi: (T, U * 23 * W) scratch, the compact copy
  int U, W, n_groups, friction, jacobi, n_ent;
};

struct PgsArgs {
  const float* mom0;  // (T, 6, BP)
  const float* mi;    // (BP,)
  const float* singles;  // (T, CS, 14, BP)
  float* out;         // (T, 2, 6, BP)
  long long* cycles;  // (T, 8) clock64 counters, or null
  int T, CS, BP, iters, iters_post, n_lin, n_ang;
  PgsClass lin[PGS_MAXC];
  PgsClass ang[PGS_MAXC];
};

// What the launch derives from the plan: the step stride (the largest
// step block but a jacobi phase's), the steps a stage (SI), the bytes of a
// ring slot (SI steps, or one full-width jacobi phase) and the stages of
// the ring (NS), the accumulators' and the stage table's sizes, the jacobi
// sums' and lists' sizes, the shared bytes.
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
      // the sums (9 W); in the prologue the unit maps (2 W) and a copy of
      // the per-body lists
      const int need = 2 * c.W + a.BP + 1 + c.n_ent;
      jd = jd > 9 * c.W ? jd : 9 * c.W;
      jd = jd > need ? jd : need;
      jl += PGS_JHDR + a.BP + 1 + c.n_ent;
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

// JAC: the plan holds a jacobi class; without, the kernel compiles with no
// jacobi code.
template <bool JAC>
__global__ void __launch_bounds__(32)
    pgs_kernel(const PgsArgs a, const PgsLayout Lo) {
  extern __shared__ __align__(16) unsigned char sm[];
  __shared__ unsigned char gact[PGS_MAXC][PGS_MAXG];
  __shared__ const float* src_base[1 + 2 * PGS_MAXC];
  __shared__ int src_floats[1 + 2 * PGS_MAXC];
  __shared__ int acc_off[2 * PGS_MAXC];   // a class's accumulators in acc
  __shared__ int uid_off[2 * PGS_MAXC];   // its unit body ids in uid
  __shared__ int jl_off[PGS_MAXC];        // a jacobi class's header in jl
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
  int* jl = (int*)(jd + Lo.jd_floats);        // per jacobi class: header,
                                              //   then its filtered lists
  float* trash = acc + Lo.acc_floats - 1;
  const long long c0 = clock64();
  for (int i = lane; i < 6 * BP; i += 32)
    mom[i] = a.mom0[(size_t)t * 6 * BP + i];
  for (int i = lane; i < BP; i += 32) mis[i] = a.mi[i];
  for (int i = lane; i < Lo.acc_floats; i += 32) acc[i] = 0.0f;
  float* isum_s = acc;
  {
    int p = a.CS * BP, q = 0, jq = 0;
    for (int k = 0; k < a.n_lin + a.n_ang; ++k) {
      const bool lin = k < a.n_lin;
      const PgsClass& c = lin ? a.lin[k] : a.ang[k - a.n_lin];
      const int n = c.n_groups * c.W;
      if (lane == 0) {
        acc_off[k] = p;
        uid_off[k] = q;
      }
      for (int i = lane; i < n; i += 32) {
        uid[q + i] = c.ub0[i];
        uid[q + n + i] = c.ub1[i];
      }
      p += c.n_groups * c.U * c.W;
      q += 2 * n;
      if (JAC && lin && c.jacobi) {
        if (lane == 0) jl_off[k] = jq;
        jq += PGS_JHDR + BP + 1 + c.n_ent;
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
  // per-group activity of the exact friction (contact) classes: lanes over
  // groups
  for (int k = 0; k < a.n_lin; ++k) {
    const PgsClass& c = a.lin[k];
    if (!c.friction || (JAC && c.jacobi)) continue;
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
  // The jacobi classes' active units and phases, once a solve: the
  // compact unit ids, the header, the filtered per-body lists and the
  // compact copy of the rows.
  long long cj_pro = 0;
  int n_units = 0, n_kept = 0;
  if constexpr (JAC) {
    const long long cp0 = clock64();
    const unsigned lt = (1u << lane) - 1u;
    for (int k = 0; k < a.n_lin; ++k) {
      const PgsClass& c = a.lin[k];
      if (!c.jacobi) continue;
      const int U = c.U, W = c.W;
      const float* R = c.rows + (size_t)t * U * 23 * W;
      int* hdr = jl + jl_off[k];
      int* lst = hdr + PGS_JHDR;
      int* ids = uid + uid_off[k];
      int* cmap = (int*)jd;             // unit -> compact index, -1 idle
      int* csrc = cmap + W;             // compact index -> unit
      int* hl = csrc + W;               // the plan's lists: offsets, entries
      for (int i = lane; i < BP + 1; i += 32) hl[i] = c.boff[i];
      for (int i = lane; i < c.n_ent; i += 32) hl[BP + 1 + i] = c.bent[i];
      // each unit's phases with an active row (dinv non-zero), 12 loads a
      // lane in flight
      unsigned pm = 0, um[3] = {0u, 0u, 0u}, am[3];
      for (int u0 = 0; u0 < U; u0 += 4) {
        float v[3][4];
#pragma unroll
        for (int j = 0; j < 3; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int w = lane + 32 * j, u = u0 + r;
            v[j][r] = w < W && u < U ? __ldg(&R[(u * 23 + 15) * W + w])
                                     : 0.0f;
          }
#pragma unroll
        for (int j = 0; j < 3; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (fabsf(v[j][r]) > 0.0f) um[j] |= 1u << (u0 + r);
      }
      int ob0[3], ob1[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int w = lane + 32 * j;
        ob0[j] = w < W ? ids[w] : -1;
        ob1[j] = w < W ? ids[W + w] : -1;
        am[j] = __ballot_sync(FULL, um[j] != 0u);
        pm |= um[j];
      }
      pm = __reduce_or_sync(FULL, pm);
      const int A = __popc(am[0]) + __popc(am[1]) + __popc(am[2]);
      const int Ap = (A + 3) & ~3, NK = __popc(pm);
      __syncwarp();
      int before = 0;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int w = lane + 32 * j;
        const bool act = (am[j] >> lane) & 1;
        const int ci = before + __popc(am[j] & lt);
        if (w < W) cmap[w] = act ? ci : -1;
        if (act) {
          csrc[ci] = w;
          ids[ci] = ob0[j];
          ids[W + ci] = ob1[j];
        }
        before += __popc(am[j]);
      }
      for (int i = A + lane; i < Ap; i += 32) ids[i] = ids[W + i] = -1;
      if (lane == 0) {
        hdr[0] = A;
        hdr[1] = Ap;
        hdr[2] = NK;
        hdr[3] = 0;
        int kk = 0;
        for (int u = 0; u < U; ++u)
          if ((pm >> u) & 1) hdr[4 + kk++] = u;
      }
      __syncwarp();
      // lane b: body b's entries on active units, in unit order, as
      // compact unit << 1 | side
      int cnt = 0, e0 = 0, e1 = 0;
      if (lane < BP) {
        e0 = hl[lane];
        e1 = hl[lane + 1];
        for (int e = e0; e < e1; ++e) cnt += cmap[hl[BP + 1 + e] >> 1] >= 0;
      }
      const int inc = hts_warp_incl_scan(cnt);
      if (lane < BP) {
        lst[lane] = inc - cnt;
        if (lane == BP - 1) lst[BP] = inc;
        int o = BP + 1 + inc - cnt;
        for (int e = e0; e < e1; ++e) {
          const int x = hl[BP + 1 + e], ci = cmap[x >> 1];
          if (ci >= 0) lst[o++] = (ci << 1) | (x & 1);
        }
      }
      // the compact copy: kept phase kk's block (23, Ap) at kk * 23 * Ap,
      // the padding units' columns zero; 8 loads a lane in flight
      float* D = c.jrows + (size_t)t * U * 23 * W;
      const int tot = NK * 23 * Ap;
      for (int i0 = 0; i0 < tot; i0 += 32 * 8) {
        float v[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = i0 + 32 * r + lane;
          v[r] = 0.0f;
          if (i < tot) {
            const int j = i % Ap, row = i / Ap;
            if (j < A)
              v[r] = __ldg(&R[(hdr[4 + row / 23] * 23 + row % 23) * W
                              + csrc[j]]);
          }
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = i0 + 32 * r + lane;
          if (i < tot) D[i] = v[r];
        }
      }
      n_units += A;
      n_kept += NK;
      __syncwarp();                     // cmap and csrc free again
    }
    // the copies' generic writes before the bulk copies read them
    hts_fence_proxy_async();
    __syncwarp();
    cj_pro = clock64() - cp0;
  }
  // The stages of one sweep (lane 0): the steps in order, consecutive
  // steps that lie back to back in device memory merged, SI at most (15
  // for a jacobi class's compact phases): source << 28 | steps << 24 |
  // float offset.
  int n_st = 0, n_steps = 0;
  if (lane == 0) {
    int cur_id = -1, cur_n = 0, cur_end = 0;
    auto add = [&](int id, int off, int lim) {
      ++n_steps;
      if (id == cur_id && off == cur_end && cur_n < lim
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
    for (int c = 0; c < nact; ++c) add(0, c * 14 * BP, SI);
    for (int k = 0; k < a.n_lin; ++k) {
      const PgsClass& c = a.lin[k];
      if (JAC && c.jacobi) {
        const int* hdr = jl + jl_off[k];
        src_base[1 + k] = c.jrows + (size_t)t * c.U * 23 * c.W;
        src_floats[1 + k] = 23 * hdr[1];
        if (hdr[0] > 0)
          for (int kk = 0; kk < hdr[2]; ++kk)
            add(1 + k, kk * 23 * hdr[1], 15);
        continue;
      }
      src_base[1 + k] = c.rows + (size_t)t * c.n_groups * c.U * 23 * c.W;
      src_floats[1 + k] = 23 * c.W;
      for (int g = 0; g < c.n_groups; ++g) {
        if (c.friction && !gact[k][g]) continue;
        for (int u = 0; u < c.U; ++u)
          add(1 + k, (g * c.U + u) * 23 * c.W, SI);
      }
    }
    for (int k = 0; k < a.n_ang; ++k) {
      const PgsClass& c = a.ang[k];
      src_base[1 + PGS_MAXC + k] =
          c.rows + (size_t)t * c.n_groups * c.U * 14 * c.W;
      src_floats[1 + PGS_MAXC + k] = 14 * c.W;
      for (int g = 0; g < c.n_groups; ++g)
        for (int u = 0; u < c.U; ++u)
          add(1 + PGS_MAXC + k, (g * c.U + u) * 14 * c.W, SI);
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
  long long cj = 0;                      // cycles in the jacobi classes
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
      float* isum = acc + acc_off[k];
      const int* ids = uid + uid_off[k];
      if constexpr (JAC) {
        if (c.jacobi) {
          // ---- a jacobi group: lane l solves the compact units l, l +
          // 32, l + 64 below A on the momenta of the group's start, the
          // kept phases in order; then each body's sums ----
          const int* hdr = jl + jl_off[k];
          const int A = hdr[0];
          if (A == 0) continue;
          const long long cj0 = clock64();
          const int Ap = hdr[1], NK = hdr[2], J = (A + 31) >> 5;
          float l0m[3][3], a0[3][3], l1m[3][3], a1[3][3];
          float sdl[3][3], sa0[3][3], sa1[3][3];
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const int wr = lane + 32 * j;
            const int b0 = j < J && wr < A ? ids[wr] : -1;
            const int b1 = j < J && wr < A ? ids[W + wr] : -1;
#pragma unroll
            for (int jx = 0; jx < 3; ++jx) {
              l0m[j][jx] = b0 >= 0 ? mom[jx * BP + b0] * mis[b0] : 0.0f;
              a0[j][jx] = b0 >= 0 ? mom[(3 + jx) * BP + b0] : 0.0f;
              l1m[j][jx] = b1 >= 0 ? mom[jx * BP + b1] * mis[b1] : 0.0f;
              a1[j][jx] = b1 >= 0 ? mom[(3 + jx) * BP + b1] : 0.0f;
              sdl[j][jx] = sa0[j][jx] = sa1[j][jx] = 0.0f;
            }
          }
          for (int kk = 0; kk < NK; ++kk) {
            const int u = hdr[4 + kk];     // the kept phase's own index
            const float* blk = next_block();
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              if (j >= J) continue;
              const bool on = lane + 32 * j < A;
              const int w = on ? lane + 32 * j : 0;
              float ch[23];      // the step's channels (see above)
#pragma unroll
              for (int i = 0; i < 23; ++i) ch[i] = blk[i * Ap + w];
#define CH(i) ch[i]
              float v3[3];
#pragma unroll
              for (int jx = 0; jx < 3; ++jx)
                v3[jx] = (l1m[j][jx] - l0m[j][jx]) * CH(jx)
                         + a1[j][jx] * CH(12 + jx) - a0[j][jx] * CH(9 + jx);
              const float vn = v3[0] + v3[1] + v3[2];
              float imp = (-(post ? CH(17) : CH(16)) - vn) * CH(15);
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
                if (kk == 0) {
                  sdl[j][jx] = dl; sa0[j][jx] = d0; sa1[j][jx] = d1;
                } else {
                  sdl[j][jx] = sdl[j][jx] + dl;
                  sa0[j][jx] = sa0[j][jx] + d0;
                  sa1[j][jx] = sa1[j][jx] + d1;
                }
                if (kk + 1 < NK) {
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
            if (j < J && w < A) {
#pragma unroll
              for (int jx = 0; jx < 3; ++jx) {
                jd[jx * W + w] = sdl[j][jx];
                jd[(3 + jx) * W + w] = sa0[j][jx];
                jd[(6 + jx) * W + w] = sa1[j][jx];
              }
            }
          }
          __syncwarp();
          // lane b: body b's (compact unit, side) in unit order; side 0
          // takes -dl, -da0, side 1 dl, da1; the sum applied once
          if (lane < BP) {
            const int* lst = hdr + PGS_JHDR;
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
                mom[(3 + jx) * BP + lane] =
                    mom[(3 + jx) * BP + lane] + da[jx];
              }
            }
          }
          __syncwarp();
          cj += clock64() - cj0;
          continue;
        }
      }
      for (int g = 0; g < c.n_groups; ++g) {
        if (c.friction && !gact[k][g]) continue;
        const int w = lane < W ? lane : 0;
        const int b0 = ids[g * W + w];
        const int b1 = ids[(c.n_groups + g) * W + w];
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
          float ch[23];          // the step's channels (see above)
#pragma unroll
          for (int i = 0; i < 23; ++i) ch[i] = blk[i * W + w];
#define CH(i) ch[i]
          float v3[3];
          for (int jx = 0; jx < 3; ++jx)
            v3[jx] = (l1m[jx] - l0m[jx]) * CH(jx) + a1[jx] * CH(12 + jx)
                     - a0[jx] * CH(9 + jx);
          const float vn = v3[0] + v3[1] + v3[2];
          float imp = (-(post ? CH(17) : CH(16)) - vn) * CH(15);
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
      float* torq = acc + acc_off[a.n_lin + k];
      const int* ids = uid + uid_off[a.n_lin + k];
      for (int g = 0; g < c.n_groups; ++g) {
        const int w = lane < W ? lane : 0;
        const int b0 = ids[g * W + w];
        const int b1 = ids[(c.n_groups + g) * W + w];
        float a0[3], a1[3], sv[3] = {0, 0, 0};
        for (int jx = 0; jx < 3; ++jx) {
          a0[jx] = b0 >= 0 ? mom[(3 + jx) * BP + b0] : 0.0f;
          a1[jx] = b1 >= 0 ? mom[(3 + jx) * BP + b1] : 0.0f;
        }
        for (int u = 0; u < U; ++u) {
          const float* blk = next_block();
          const int p = g * U + u;
          float ch[14];          // the step's channels (see above)
#pragma unroll
          for (int i = 0; i < 14; ++i) ch[i] = blk[i * W + w];
#define CH(i) ch[i]
          float c3[3];
          for (int jx = 0; jx < 3; ++jx)
            c3[jx] = a1[jx] * CH(6 + jx) - a0[jx] * CH(3 + jx);
          const float cur = c3[0] + c3[1] + c3[2];
          float dtq = ((post ? CH(11) : CH(10)) - cur) * CH(9);
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
    long long* cy = a.cycles + (size_t)t * 8;
    cy[0] = c1 - c0;                    // prologue
    cy[1] = clock64() - c1;             // the sweeps
    cy[2] = n_steps;                    // steps a sweep
    cy[3] = nact;                       // active slots
    cy[4] = cj;                         // the sweeps' jacobi groups
    cy[5] = cj_pro;                     // the prologue's jacobi compaction
    cy[6] = n_units;                    // active jacobi units
    cy[7] = n_kept;                     // kept jacobi phases
  }
}

typedef void (*PgsKernel)(const PgsArgs, const PgsLayout);

// The kernel for this plan (the jacobi instance where it holds a jacobi
// class) and its layout, the attributes set; smem 0 if the kernel cannot
// take it.
static PgsKernel pgs_prepare(const PgsArgs& a, PgsLayout* L) {
  *L = pgs_layout(a);
  // the bulk copies need 16-byte multiples: BP even, W a multiple of 4;
  // a stage's float offset fits 24 bits
  bool ok = a.BP <= 32 && a.BP % 2 == 0 && a.n_lin <= PGS_MAXC
            && a.n_ang <= PGS_MAXC && (long long)a.CS * 14 * a.BP < (1 << 24)
            && L->smem <= 232448;
  bool jac = false;
  for (int k = 0; ok && k < a.n_lin + a.n_ang; ++k) {
    const PgsClass& c = k < a.n_lin ? a.lin[k] : a.ang[k - a.n_lin];
    ok = c.W <= (c.jacobi ? PGS_JMAXW : 32) && c.W % 4 == 0
         && c.n_groups <= PGS_MAXG
         && (long long)c.n_groups * c.U * 23 * c.W < (1 << 24)
         && (!c.jacobi || (k < a.n_lin && c.n_groups == 1
                           && c.U <= PGS_JMAXU));
    jac = jac || c.jacobi;
  }
  const PgsKernel k = jac ? pgs_kernel<true> : pgs_kernel<false>;
  if (!ok
      || cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)L->smem) != cudaSuccess
      || cudaFuncSetAttribute(k,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              100) != cudaSuccess)
    L->smem = 0;
  return k;
}

// Tracks (blocks) an SM holds at once for this plan; 0 if none.
HTS_EXPORT int hts_pgs_occupancy(const void* args) {
  PgsLayout L;
  const PgsKernel k = pgs_prepare(*(const PgsArgs*)args, &L);
  int n = 0;
  if (L.smem) cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, 32, L.smem);
  return n;
}

HTS_EXPORT int hts_pgs_solve(const void* args, void* stream) {
  const PgsArgs a = *(const PgsArgs*)args;
  PgsLayout L;
  const PgsKernel k = pgs_prepare(a, &L);
  if (!L.smem) return (int)cudaErrorInvalidValue;
  for (int c = 0; c < a.n_lin; ++c)
    if (a.lin[c].jacobi && !a.lin[c].jrows) return (int)cudaErrorInvalidValue;
  if (a.T > 0) k<<<a.T, 32, L.smem, (cudaStream_t)stream>>>(a, L);
  return (int)cudaGetLastError();
}
