// The row sweep: every sweep of one sequential-order Gauss-Seidel solve in
// one launch, for all tracks.  No Pallas counterpart: the JAX package runs
// the sequential solve as a lax.scan over rows inside a fori_loop over
// sweeps (hand_tracking_samples_tpu/physics/solver.py:223-297) and the
// colored solve as fori_loops over slots and groups (physics/colored.py:
// 300-455).  The same function as row_sweep_plain in physics/row_sweep.py
// (layouts there).
//
// Per sweep, the linear rows in order, then the angular rows in order:
//   vn      = ((l1.n mi1 + a1.K1) - l0.n mi0) - a0.K0     (b = -1: zeros)
//   impulse = clamp((-ts - vn) dinv, lo - isum, hi - isum)
//             (friction rows: hi = -lo = fcoef x isum of the master row)
//   lin[b0] -= n imp, ang[b0] -= J0 imp, lin[b1] += n imp,
//   ang[b1] += J1 imp, isum += imp
//   angular: dtq = clamp((ts - (a1.K1 - a0.K0)) stt, lo - torq,
//   hi - torq), ang[b0] -= axis dtq, ang[b1] += axis dtq, torq += dtq
// Inactive rows, and angular rows whose target is -FLT_MAX, are skipped
// (their impulse is 0).  A jacobi phase (a run of linear rows linked by
// bit 31 of their meta words: contacts_mode="jacobi" on the colored
// solver, JAX colored.py:339-372) runs at once: every row of it reads the
// momenta of the phase's start, and each body adds its rows' deltas in
// row order and applies the sum once.  `iters` sweeps with ts, then the momenta are
// written (the pose integration reads them), then `iters_post` sweeps with
// the bias-free targets.
//
// Design: one warp a track (a block of 32 threads).  A row reads and
// writes only its own two bodies' momenta and its own accumulated impulse
// (a friction row also reads its master's), so rows on disjoint bodies
// commute exactly.  The prologue levels the track's active rows: a row's
// level is 1 + the largest level of the earlier rows on its bodies (and of
// its master; a master placed after its reader goes one level above it),
// the linear rows and the angular rows each on their own.  A sweep then
// runs the levels in order, the rows of one level on the lanes at once:
// each body sees the same updates in the same order, with each row's
// operations in the kernel's fixed order, so the result is the row order's
// bit for bit.  On the dyn30 sequential rows a track's ~1,930 active rows
// fall into ~626 levels (the palm's ~530 cloud rows are one chain); the
// colored order's groups are body-disjoint, so its levels are its groups.
//
// Three kinds of level.  A single-body level (every row on one body, the
// world its other side, no master: the cloud and chamber rows) runs its
// rows on their bodies' lanes, in body order, each lane's body's momenta
// held in registers from one such level to the next, with no barrier.  A
// mixed level runs row i on lane i against the momenta in shared memory
// (idle lanes and world sides read a zero body and write to a spare one,
// so the step has no branch on the row's shape), then __syncwarp().  A
// jacobi level holds the active rows of one jacobi phase and nothing else
// (one level above every earlier row's; every later row goes above it);
// it runs as mixed steps of 32 rows that leave the momenta as they are and
// write each row's two sides' deltas (6 floats each) to shared memory, at
// the slots the prologue gave them: body by body, each body's in row
// order.  After its last step lane b adds its body's slots in order (the
// level's per-body offsets, built once a solve) and applies the sum.
//
// The prologue (all lanes: the levels walk every row in order, a shuffle
// a body; the counting and placement in parallel) writes the track's
// active rows once, in level order, as 24-float records into a scratch
// stream in device memory, the friction masters remapped to their new
// positions (an inactive master to a slot whose impulse stays 0), and the
// steps (at most 32 rows of one level) into a second scratch array; a
// jacobi level's records carry their two delta slots in their padding
// floats (a stable counting pass by body over the level's rows: a ballot
// a body), and its per-body offsets stay in shared memory.  Every
// sweep streams the records through a ring of RS_NST stages of RS_SR
// records in shared memory: lane 0 fills a stage with one bulk copy (TMA)
// completing on that stage's mbarrier, RS_NST - 1 stages ahead, across the
// phase and sweep boundaries; a step's entry says how many stages to wait
// for before it and how many it frees.  The accumulated impulses (isum,
// torq) live in shared memory, so a friction master and an accumulator
// write never leave the SM.
//
// Bound on the H100: bytes.  Each byte of the rows is needed once (PERF.md
// counts that bound); this design streams every active row's 96-byte record
// every sweep (its own floor, ~0.57 ms at T=512 x 20 sweeps), and the time
// goes to the chain of ~626 level steps a sweep, a few hundred cycles each
// (PERF.md).
#include <float.h>

#include "common.cuh"

#define RS_MAXB 32
#define RS_NLF 21         // linear fields; the meta word follows
#define RS_NAF 14         // angular fields; the meta word follows
#define RS_LW 24          // a linear input row: fields, meta, 2 pad
#define RS_AW 16          // an angular input row: fields, meta, 1 pad
#define RS_REC 24         // floats a staged record (96 bytes)
#define RS_SR 64          // records a stage
#define RS_NST 4          // stages in the ring (RS_SR x RS_NST = 256)
#define RS_MAXR 13000     // rows of one solve, linear and angular together
#define RS_MIXED 0x80000000u   // a level's body mask: not single-body
#define RS_JAC 0x40000000u     // a level's body mask: a jacobi phase
#define RS_MAXJ 256            // rows of a jacobi phase, at most

struct RowSweepArgs {
  const float* mom0;     // (T, B, 6)
  const float* massinv;  // (B,)
  const float* lf;       // (T, Rl, 24)
  const float* af;       // (T, Ra, 16)
  float* stream;         // (T, Rl + Ra, 24) scratch: rows in level order
  int2* steps;           // (T, Rl + Ra) scratch: a sweep's steps
  float* out;            // (T, 2, B, 6)
  long long* cycles;     // (T, 8) clock64 counters, or null
  int T, B, n_lin, n_ang, iters, iters_post;
  int jmax;              // rows of the largest jacobi phase (0: none)
  int jlev;              // jacobi phases (a track's jacobi levels, at most)
};

// Shared memory, in bytes, in this order (16-byte aligned pieces):
//   bars   RS_NST mbarriers (64)
//   ring   RS_NST x RS_SR records; in the prologue the meta words (int; the
//          levels' ends once they are levelled), each row's level and
//          position (short) and each linear level's body mask (int), 12
//          bytes a row
//   mom    (RS_MAXB + 2) x 6 floats, mi RS_MAXB + 2 floats (1024 with a
//          pad): body B is the world (zeros), body B + 1 takes the writes
//          of the lanes and sides that write nothing
//   acc    Rl + Ra + 2 floats: isum by position, a zero slot, torq, and a
//          slot for the writes of the idle lanes
//   jd     (2 jmax + 1) x 6 floats: a jacobi level's deltas by slot, the
//          last slot the world sides'
//   joff   jlev x (B + 1) shorts: each jacobi level's per-body first slots
__host__ __device__ __forceinline__ size_t rs_al16(size_t n) {
  return (n + 15) & ~(size_t)15;
}
__host__ __device__ __forceinline__ size_t rs_ring_bytes(int R) {
  const size_t ring = (size_t)RS_NST * RS_SR * RS_REC * 4;
  const size_t pro = (size_t)R * 12;
  return rs_al16(ring > pro ? ring : pro);
}
__host__ __device__ __forceinline__ size_t rs_jd_floats(int jmax) {
  return jmax ? rs_al16((size_t)(2 * jmax + 1) * 6 * 4) / 4 : 0;
}
__host__ __device__ __forceinline__ size_t rs_smem_bytes(int R, int jmax,
                                                         int jlev, int B) {
  return 64 + rs_ring_bytes(R) + 1024 + rs_al16((size_t)(R + 2) * 4)
         + rs_jd_floats(jmax) * 4
         + (jmax ? rs_al16((size_t)jlev * (B + 1) * 2) : 0);
}

// torch.minimum / torch.maximum: NaN propagates from either side
__device__ __forceinline__ float rs_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float rs_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// The master row position of meta word m, -1 none (bit 31, a jacobi link,
// is masked off where rows may carry it).
template <bool JAC>
__device__ __forceinline__ int rs_master(int m) {
  return (JAC ? (m >> 17) & 0x3FFF : m >> 17) - 1;
}

// All lanes, the same walk: the level of each of n rows (0: inactive) from
// their meta words; returns the number of levels.  Lane b holds the level
// of the last row on body b.  lvl is zero on entry and holds the floor an
// earlier reader sets on a later master; a row's meta word and floor are
// read one row ahead.  The active rows of a jacobi phase (a row whose
// meta word's bit 31 is set continues the phase of the row before it)
// take one level, nlev + 1, and every later row goes above it (floor);
// JAC false compiles that out, for rows with no jacobi phase.  Every lane
// writes the same values (the warp converges at each row's shuffles), so
// no barrier is needed.
template <bool JAC>
__device__ int rs_levels(const int* meta, short* lvl, int n, bool friction,
                         int lane) {
  if (n == 0) return 0;
  int last = 0, nlev = 0, prev = 0;     // prev: the level of row r - 1
  int floor_l = 0, phase = 0;           // phase: the open phase's level
  int mine = lane < n ? meta[lane] : 0;
  int m = __shfl_sync(0xffffffffu, mine, 0), fl = lvl[0];
  for (int r = 0; r < n; ++r) {
    const int r1 = r + 1;
    if (!(r1 & 31)) mine = r1 + lane < n ? meta[r1 + lane] : 0;
    const int mn = __shfl_sync(0xffffffffu, mine, r1 & 31);
    int fln = r1 < n ? lvl[r1] : 0;
    const int b0 = (m & 0xFF) - 1, b1 = ((m >> 8) & 0xFF) - 1;
    const int v0 = __shfl_sync(0xffffffffu, last, b0 & 31);
    const int v1 = __shfl_sync(0xffffffffu, last, b1 & 31);
    int l = 0;
    if (JAC && m >= 0) phase = 0;       // not linked: a new phase or none
    if ((m >> 16) & 1) {
      l = JAC ? max(fl, floor_l) : fl;
      if (b0 >= 0) l = max(l, v0);
      if (b1 >= 0) l = max(l, v1);
      const int mp = friction ? rs_master<JAC>(m) : -1;
      if (mp >= 0 && mp < r) l = max(l, mp == r - 1 ? prev : (int)lvl[mp]);
      ++l;
      if (JAC && (m < 0 || mn < 0)) {   // a jacobi row
        l = phase > 0 ? phase : nlev + 1;
        phase = floor_l = l;
      }
      if (mp > r) {
        lvl[mp] = (short)max((int)lvl[mp], l);
        if (mp == r1) fln = max(fln, l);
      }
      if (lane == b0 || lane == b1) last = l;
      nlev = max(nlev, l);
    }
    lvl[r] = (short)l;
    prev = l;
    m = mn;
    fl = fln;
  }
  return nlev;
}

// All lanes: each active row's position in level order (rows of a level
// keep their row order); ends[l] becomes the end position of level l + 1.
// Returns the number of active rows.
__device__ int rs_place(const short* lvl, short* pos, int* ends, int n,
                        int nlev, int lane) {
  for (int l = lane; l < nlev; l += 32) ends[l] = 0;
  __syncwarp();
  for (int r = lane; r < n; r += 32)
    if (lvl[r] > 0) atomicAdd(&ends[lvl[r] - 1], 1);
  __syncwarp();
  int carry = 0;                       // exclusive scan: level starts
  for (int l0 = 0; l0 < nlev; l0 += 32) {
    const int l = l0 + lane;
    const int v = l < nlev ? ends[l] : 0;
    const int inc = hts_warp_incl_scan(v);
    if (l < nlev) ends[l] = carry + inc - v;
    carry += __shfl_sync(0xffffffffu, inc, 31);
  }
  __syncwarp();
  for (int r0 = 0; r0 < n; r0 += 32) {
    const int r = r0 + lane;
    const int L = r < n ? lvl[r] : 0;
    const unsigned peers = __match_any_sync(0xffffffffu, L);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    const int p = L > 0 ? ends[L - 1] + rank : -1;
    __syncwarp();
    if (L > 0 && rank == __popc(peers) - 1) ends[L - 1] = p + 1;
    __syncwarp();
    if (r < n) pos[r] = (short)p;
  }
  __syncwarp();
  return carry;
}

// All lanes: the steps of nlev levels (ends as rs_place leaves them; mask
// the linear levels' body masks, or null), positions offset by `off`,
// written from steps[0]: (start | rows << 16 | stages to wait for before
// it << 22 | stages done after it << 24 | a jacobi level's step << 26 |
// its last step << 27, the body mask of a single-body level, else 0).
// A sweep's ntot records sit in RS_SR-record stages;
// returns the number of steps.
__device__ int rs_steps(const int* ends, const unsigned* mask, int2* steps,
                        int nlev, int off, int ntot, int lane) {
  const int spp = (ntot + RS_SR - 1) / RS_SR;
  int base = 0;
  for (int l0 = 0; l0 < nlev; l0 += 32) {
    const int l = l0 + lane;
    const int st = l < nlev && l > 0 ? ends[l - 1] : 0;
    const int en = l < nlev ? ends[l] : 0;
    const unsigned mk = mask && l < nlev ? mask[l] : RS_MIXED;
    const int c = (en - st + 31) / 32;
    const int inc = hts_warp_incl_scan(c);
    for (int i = 0; i < c; ++i) {
      const int s0 = off + st + 32 * i, n = min(32, en - st - 32 * i);
      const int nwait = ((s0 + n - 1) >> 6) - ((s0 - 1) >> 6);
      const int nfree =
          (s0 + n == ntot ? spp : (s0 + n) / RS_SR) - s0 / RS_SR;
      const int jac = mk & RS_JAC ? 1 << 26 | (i + 1 == c) << 27 : 0;
      steps[base + inc - c + i] = make_int2(
          s0 | (n << 16) | (nwait << 22) | (nfree << 24) | jac,
          mk & RS_MIXED ? 0 : mk);
    }
    base += __shfl_sync(0xffffffffu, inc, 31);
  }
  return base;
}

// JAC: the rows may hold jacobi phases (a.jmax > 0); without, the kernel
// compiles as it did before the jacobi level existed.
template <bool JAC>
__global__ void __launch_bounds__(32) row_sweep_kernel(RowSweepArgs a) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int lane = threadIdx.x, t = blockIdx.x;
  const unsigned lt = (1u << lane) - 1u;
  const int B = a.B, nl = a.n_lin, na = a.n_ang, R = nl + na;
  uint64_t* bars = (uint64_t*)sm;
  float* ring = (float*)(sm + 64);
  float* mom = (float*)(sm + 64 + rs_ring_bytes(R));   // [body * 6 + c]
  float* mi = mom + (RS_MAXB + 2) * 6 + 4;
  float* acc = mom + 256;
  float* jd = acc + ((R + 2 + 3) & ~3);     // a jacobi level's deltas
  short* joff = (short*)(jd + rs_jd_floats(a.jmax));  // its body offsets
  int* meta = (int*)ring;                   // the prologue's
  int* ends = meta;                         //   (after the levelling)
  short* lvl = (short*)(meta + R);
  short* pos = lvl + R;
  unsigned* lmask = (unsigned*)(pos + R);
  const long long c0 = clock64();

  // ---- prologue: level, place and stream out the track's rows ----------
  const float* L = a.lf + (size_t)t * nl * RS_LW;
  const float* A = a.af + (size_t)t * na * RS_AW;
#pragma unroll 8
  for (int r = lane; r < R; r += 32) {
    meta[r] = __float_as_int(r < nl ? L[(size_t)r * RS_LW + RS_NLF]
                                    : A[(size_t)(r - nl) * RS_AW + RS_NAF]);
    lvl[r] = 0;
  }
  for (int i = lane; i < (B + 2) * 6; i += 32)
    mom[i] = i < B * 6 ? a.mom0[(size_t)t * B * 6 + i] : 0.0f;
  for (int b = lane; b < B + 2; b += 32) mi[b] = b < B ? a.massinv[b] : 0.0f;
  __syncwarp();
  const int nlev_l = rs_levels<JAC>(meta, lvl, nl, true, lane);
  const int nlev_a = rs_levels<JAC>(meta + nl, lvl + nl, na, false, lane);
  const long long c_lev = clock64();
  // a linear level is single-body when each of its rows is on one body
  // (b0 the world, b1 < 31) with no master: its rows then run on their
  // bodies' lanes, the momenta in registers
  for (int l = lane; l < nlev_l; l += 32) lmask[l] = 0;
  __syncwarp();
  for (int r = lane; r < nl; r += 32) {
    const int m = meta[r];
    if (lvl[r] == 0) continue;
    const int b0 = (m & 0xFF) - 1, b1 = ((m >> 8) & 0xFF) - 1;
    const bool jac = JAC && (m < 0 || (r + 1 < nl && meta[r + 1] < 0));
    const bool single = b0 < 0 && b1 >= 0 && b1 < 31 && (m >> 17) == 0;
    atomicOr(&lmask[lvl[r] - 1],
             jac ? RS_MIXED | RS_JAC : single ? 1u << b1 : RS_MIXED);
  }
  __syncwarp();
  const int nla = rs_place(lvl, pos, ends, nl, nlev_l, lane);
  const int naa = rs_place(lvl + nl, pos + nl, ends + nl, na, nlev_a, lane);
  const int ntot = nla + naa;
  // the rows of a single-body level in body order
  for (int r = lane; r < nl; r += 32) {
    const int l = lvl[r];
    if (l == 0 || (lmask[l - 1] & RS_MIXED)) continue;
    const int b1 =
        ((__float_as_int(L[(size_t)r * RS_LW + RS_NLF]) >> 8) & 0xFF) - 1;
    pos[r] = (short)((l > 1 ? ends[l - 2] : 0)
                     + __popc(lmask[l - 1] & ((1u << b1) - 1u)));
  }
  int2* SP = a.steps + (size_t)t * R;
  const int nsl = rs_steps(ends, lmask, SP, nlev_l, 0, ntot, lane);
  const int nsteps =
      nsl + rs_steps(ends + nl, nullptr, SP + nsl, nlev_a, nla, ntot, lane);
  __syncwarp();
  float* S = a.stream + (size_t)t * R * RS_REC;
#pragma unroll 2
  for (int r = lane; r < nl; r += 32) {
    const int p = pos[r];
    if (p < 0) continue;
    const float4* src = (const float4*)(L + (size_t)r * RS_LW);
    float4 v[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) v[i] = src[i];
    int m = __float_as_int(v[5].y);    // field 21: the master's position
    const int mp = rs_master<JAC>(m);
    if (mp >= 0) {
      const int q = pos[mp] >= 0 ? pos[mp] : nla;    // nla: always 0
      m = (m & (JAC ? (int)0x8001FFFFu : 0x1FFFF)) | ((q + 1) << 17);
      v[5].y = __int_as_float(m);
    }
    float4* dst = (float4*)(S + (size_t)p * RS_REC);
#pragma unroll
    for (int i = 0; i < 6; ++i) dst[i] = v[i];
  }
#pragma unroll 2
  for (int r = lane; r < na; r += 32) {
    const int p = pos[nl + r];
    if (p < 0) continue;
    const float4* src = (const float4*)(A + (size_t)r * RS_AW);
    float4* dst = (float4*)(S + (size_t)(nla + p) * RS_REC);
    float4 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = src[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[i] = v[i];
  }
  // a jacobi level's delta slots: each row's two sides' entries, body by
  // body and each body's in row order (a ballot a body over 32 rows at a
  // time: a count, then the slots), into the record's padding floats
  // [side 1, side 0]; the world's sides take the last slot
  int nj = 0;
  if constexpr (JAC) {
    const int jidle = 2 * a.jmax;
    __syncwarp();                       // the records written
    for (int l = 0; l < nlev_l; ++l) {
      if (!(lmask[l] & RS_JAC)) continue;
      const int st = l ? ends[l - 1] : 0, en = ends[l];
      int cnt = 0;                      // lane b: body b's entries
      for (int q0 = st; q0 < en; q0 += 32) {
        const int p = q0 + lane;
        const int m = p < en ? __float_as_int(S[(size_t)p * RS_REC + RS_NLF])
                             : 0;
        const int b0 = (m & 0xFF) - 1, b1 = ((m >> 8) & 0xFF) - 1;
        for (int b = 0; b < B; ++b) {
          const unsigned mb = __ballot_sync(0xffffffffu, b0 == b || b1 == b);
          if (lane == b) cnt += __popc(mb);
        }
      }
      const int inc = hts_warp_incl_scan(lane < B ? cnt : 0);
      const int all = __shfl_sync(0xffffffffu, inc, 31);
      short* jo = joff + nj * (B + 1);
      int run = inc - (lane < B ? cnt : 0);    // lane b: body b's next slot
      if (lane < B) jo[lane] = (short)run;
      if (lane == 0) jo[B] = (short)all;
      for (int q0 = st; q0 < en; q0 += 32) {
        const int p = q0 + lane;
        const int m = p < en ? __float_as_int(S[(size_t)p * RS_REC + RS_NLF])
                             : 0;
        const int b0 = (m & 0xFF) - 1, b1 = ((m >> 8) & 0xFF) - 1;
        int s0 = jidle, s1 = jidle;
        for (int b = 0; b < B; ++b) {
          const unsigned mb = __ballot_sync(0xffffffffu, b0 == b || b1 == b);
          const int s = __shfl_sync(0xffffffffu, run, b) + __popc(mb & lt);
          if (b0 == b) s0 = s;
          if (b1 == b) s1 = s;
          if (lane == b) run += __popc(mb);
        }
        if (p < en) {
          S[(size_t)p * RS_REC + 22] = __int_as_float(s1);
          S[(size_t)p * RS_REC + 23] = __int_as_float(s0);
        }
      }
      ++nj;
    }
  }
  for (int i = lane; i < ntot + 2; i += 32) acc[i] = 0.0f;
  float* isum = acc;                    // by linear position; [nla] = 0
  float* torq = acc + nla + 1;          // by angular position
  const int idle = ntot + 1;            // acc's slot for idle writes
  const int world = B, idle_b = B + 1;  // the world's body, the idle one
  // the stream's and the prologue's generic accesses before the copies
  hts_fence_proxy_async();
  __syncwarp();

  // ---- the sweeps ---------------------------------------------------------
  // Every sweep streams the same ntot records through the ring: stage g
  // (global: sweep x spp + the sweep's stage) holds the sweep's records
  // [l RS_SR, (l + 1) RS_SR), l = g mod spp, in ring slot g mod RS_NST.  A
  // step's entry says how many stages to wait for before it and how many
  // it frees; each freed stage's slot takes the stage RS_NST ahead.
  const int total = a.iters + a.iters_post;
  const int spp = (ntot + RS_SR - 1) / RS_SR;         // stages a sweep
  const int total_st = total * spp;
  auto fill = [&](int g) {              // lane 0
    const int r0 = (g % spp) * RS_SR, n = min(RS_SR, ntot - r0);
    const int slot = g % RS_NST;
    hts_bulk_load(ring + (size_t)slot * RS_SR * RS_REC,
                  S + (size_t)r0 * RS_REC, (unsigned)n * RS_REC * 4,
                  &bars[slot]);
  };
  if (lane == 0) {
    for (int i = 0; i < RS_NST; ++i) hts_mbar_init(&bars[i]);
    hts_fence_mbar_init();
    for (int g = 0; g < RS_NST && g < total_st; ++g) fill(g);
  }
  __syncwarp();
  const long long c1 = clock64();
  auto write_out = [&](int which) {
    __syncwarp();
    for (int i = lane; i < B * 6; i += 32)
      a.out[((size_t)t * 2 + which) * B * 6 + i] = mom[i];
  };
#define MOM(b, c) mom[(b) * 6 + (c)]
  // a lane's own body's momenta in the single-body steps
  const int own_b = lane < B ? lane : world;
  const float mym = mi[own_b];
  bool regs = false;
  float rlx = 0.f, rly = 0.f, rlz = 0.f, rax = 0.f, ray = 0.f, raz = 0.f;
  auto to_regs = [&]() {
    rlx = MOM(own_b, 0); rly = MOM(own_b, 1); rlz = MOM(own_b, 2);
    rax = MOM(own_b, 3); ray = MOM(own_b, 4); raz = MOM(own_b, 5);
    regs = true;
  };
  auto from_regs = [&]() {
    if (lane < B) {
      MOM(lane, 0) = rlx; MOM(lane, 1) = rly; MOM(lane, 2) = rlz;
      MOM(lane, 3) = rax; MOM(lane, 4) = ray; MOM(lane, 5) = raz;
    }
    regs = false;
    __syncwarp();
  };
  // the steps' entries, 32 a chunk, one a lane; the first two chunks kept
  const int2 ck0 = nsteps ? SP[lane % nsteps] : make_int2(0, 0);
  const int2 ck1 = nsteps ? SP[(32 + lane) % nsteps] : make_int2(0, 0);
  int rdy = 0, fr = 0;                  // stages waited for, freed
  long long jcyc = 0, jt0 = 0;          // cycles in jacobi levels
  bool jopen = false;                   // a jacobi level is open
  for (int s = 0; s < total && nsteps > 0; ++s) {
    int jl = 0;                         // the sweep's jacobi level
    if (s == a.iters) {
      if (regs) from_regs();
      write_out(0);
    }
    const bool post = s >= a.iters;
    const int gst = s * spp, gbase = gst * RS_SR;
    int2 ch = ck0, chn = ck1;
    int2 en = make_int2(__shfl_sync(0xffffffffu, ch.x, 0),
                        __shfl_sync(0xffffffffu, ch.y, 0));
    int k = 0;                          // the step
    // step k's entry out of the chunks (the next chunk read at the end of
    // this one)
    auto entry_after = [&]() {
      const int k1 = (k + 1) & 31;
      en = make_int2(__shfl_sync(0xffffffffu, k1 ? ch.x : chn.x, k1),
                     __shfl_sync(0xffffffffu, k1 ? ch.y : chn.y, k1));
    };
    auto next_chunk = [&]() {
      if ((k & 31) == 31) {
        ch = chn;
        chn = SP[(k + 33 + lane) % nsteps];
      }
    };
    auto wait_for = [&](int x) {        // the stages step x reads first
      for (int nw = (x >> 22) & 3; nw > 0; --nw, ++rdy)
        hts_mbar_wait(&bars[rdy % RS_NST], (rdy / RS_NST) & 1);
    };
    auto free_after = [&](int x) {      // the stages step x finished: their
      if (const int nf = (x >> 24) & 3) {  // slots take the stages RS_NST on
        __syncwarp();
        if (lane == 0)
          for (int i = 0; i < nf; ++i)
            if (fr + i + RS_NST < total_st) fill(fr + i + RS_NST);
        fr += nf;
      }
    };
    // record q's place in the ring (stage gst + q / RS_SR, slot that mod
    // RS_NST)
#define RING(q) (ring + (size_t)((gbase + (q)) & (RS_SR * RS_NST - 1)) * RS_REC)
    for (; k < nsteps; ++k) {
      int2 e = en;                       // and the next step's, a step ahead
      entry_after();
      if (e.y) {
        // ---- a run of single-body levels: lane b solves body b's rows,
        // level by level, on the momenta in its registers ----
        if (!regs) to_regs();
        for (;;) {
          wait_for(e.x);
          const unsigned msk = e.y;
          const bool on = (msk >> lane) & 1;
          const int q = (e.x & 0xFFFF) + (on ? __popc(msk & lt) : 0);
          const float4* r4 = (const float4*)RING(q);
          const float4 v0 = r4[0], v1 = r4[1], v2 = r4[2], v3 = r4[3],
                       v4 = r4[4];
          const int qs = on ? q : idle;
          const float own = isum[qs];
          // [n(3) J0(3) J1(3) K0(3) K1(3) dinv ts tspost lo hi ...]
          const float nx = v0.x, ny = v0.y, nz = v0.z;
          const float z = 0.0f;                    // the world side
          const float d1 = (rlx * nx + rly * ny) + rlz * nz;
          const float e1 = (rax * v3.x + ray * v3.y) + raz * v3.z;
          const float d0 = (z * nx + z * ny) + z * nz;
          const float e0 = (z * v2.y + z * v2.z) + z * v2.w;
          const float vn = ((d1 * mym + e1) - d0 * z) - e0;
          const float ts = post ? v4.y : v4.x;
          float imp = (-ts - vn) * v3.w;
          imp = rs_min(imp, v4.w - own);
          imp = rs_max(imp, v4.z - own);
          isum[qs] = own + imp;
          if (on) {
            rlx = rlx + imp * nx;
            rly = rly + imp * ny;
            rlz = rlz + imp * nz;
            rax = rax + imp * v1.z;
            ray = ray + imp * v1.w;
            raz = raz + imp * v2.x;
          }
          free_after(e.x);
          next_chunk();
          if (k + 1 == nsteps || !en.y) break;
          ++k;
          e = en;
          entry_after();
        }
        continue;
      }
      wait_for(e.x);
      const int q0 = e.x & 0xFFFF, cnt = (e.x >> 16) & 63;
      {
        if (regs) from_regs();
        // ---- a mixed level: lane i takes row q0 + i; idle lanes and world
        // sides read the world's zeros and write to the idle slots ----
        const bool on = lane < cnt;
        const int q = q0 + (on ? lane : 0);
        float f[RS_REC];
        {
          const float4* r4 = (const float4*)RING(q);
#pragma unroll
          for (int i = 0; i < RS_REC / 4; ++i) {
            const float4 v = r4[i];
            f[4 * i] = v.x; f[4 * i + 1] = v.y;
            f[4 * i + 2] = v.z; f[4 * i + 3] = v.w;
          }
        }
        if (q0 < nla) {
          // ---- linear rows ----
          const int m = on ? __float_as_int(f[RS_NLF]) : 0;
          const int b0 = (m & 0xFF) - 1, b1 = ((m >> 8) & 0xFF) - 1;
          const int r0 = b0 >= 0 ? b0 : world, r1 = b1 >= 0 ? b1 : world;
          const int w0 = b0 >= 0 ? b0 : idle_b, w1 = b1 >= 0 ? b1 : idle_b;
          const float nx = f[0], ny = f[1], nz = f[2];
          const float l0x = MOM(r0, 0), l0y = MOM(r0, 1), l0z = MOM(r0, 2);
          const float a0x = MOM(r0, 3), a0y = MOM(r0, 4), a0z = MOM(r0, 5);
          const float l1x = MOM(r1, 0), l1y = MOM(r1, 1), l1z = MOM(r1, 2);
          const float a1x = MOM(r1, 3), a1y = MOM(r1, 4), a1z = MOM(r1, 5);
          const float mi0 = mi[r0], mi1 = mi[r1];
          const int mp = rs_master<JAC>(m);        // master, -1 none
          const float own = isum[on ? q : idle];
          const float mst = isum[mp >= 0 ? mp : idle];
          const float d1 = (l1x * nx + l1y * ny) + l1z * nz;
          const float e1 = (a1x * f[12] + a1y * f[13]) + a1z * f[14];
          const float d0 = (l0x * nx + l0y * ny) + l0z * nz;
          const float e0 = (a0x * f[9] + a0y * f[10]) + a0z * f[11];
          const float vn = ((d1 * mi1 + e1) - d0 * mi0) - e0;
          const float ts = post ? f[17] : f[16];
          float imp = (-ts - vn) * f[15];
          const float hm = f[20] * mst;
          const float hi = mp >= 0 ? hm : f[19];
          const float lo = mp >= 0 ? -hm : f[18];
          imp = rs_min(imp, hi - own);
          imp = rs_max(imp, lo - own);
          if (JAC && (e.x & (1 << 26))) {
            // a jacobi level: the row's deltas to its two slots (side 1,
            // side 0); the momenta are left as they are
            if (!jopen) {
              jt0 = clock64();
              jopen = true;
            }
            if (on) {
              float2* d1 = (float2*)(jd + __float_as_int(f[22]) * 6);
              float2* d0 = (float2*)(jd + __float_as_int(f[23]) * 6);
              d1[0] = make_float2(imp * nx, imp * ny);
              d1[1] = make_float2(imp * nz, imp * f[6]);
              d1[2] = make_float2(imp * f[7], imp * f[8]);
              d0[0] = make_float2(imp * -nx, imp * -ny);
              d0[1] = make_float2(imp * -nz, imp * -f[3]);
              d0[2] = make_float2(imp * -f[4], imp * -f[5]);
            }
            isum[on ? q : idle] = own + imp;
            if (e.x & (1 << 27)) {
              // the level's last step: lane b adds its body's slots in
              // order (its rows' in row order) and applies the sum once
              __syncwarp();
              if (lane < B) {
                const short* jo = joff + jl * (B + 1);
                const int o0 = jo[lane], o1 = jo[lane + 1];
                if (o1 > o0) {
                  const float2* d = (const float2*)(jd + o0 * 6);
                  float2 x0 = d[0], x1 = d[1], x2 = d[2];
                  for (int i = 1; i < o1 - o0; ++i) {
                    const float2 y0 = d[3 * i], y1 = d[3 * i + 1],
                                 y2 = d[3 * i + 2];
                    x0.x = x0.x + y0.x; x0.y = x0.y + y0.y;
                    x1.x = x1.x + y1.x; x1.y = x1.y + y1.y;
                    x2.x = x2.x + y2.x; x2.y = x2.y + y2.y;
                  }
                  MOM(lane, 0) = MOM(lane, 0) + x0.x;
                  MOM(lane, 1) = MOM(lane, 1) + x0.y;
                  MOM(lane, 2) = MOM(lane, 2) + x1.x;
                  MOM(lane, 3) = MOM(lane, 3) + x1.y;
                  MOM(lane, 4) = MOM(lane, 4) + x2.x;
                  MOM(lane, 5) = MOM(lane, 5) + x2.y;
                }
              }
              ++jl;
              jcyc += clock64() - jt0;
              jopen = false;
            }
            __syncwarp();
            free_after(e.x);
            next_chunk();
            continue;
          }
          MOM(w1, 0) = l1x + imp * nx;
          MOM(w1, 1) = l1y + imp * ny;
          MOM(w1, 2) = l1z + imp * nz;
          MOM(w1, 3) = a1x + imp * f[6];
          MOM(w1, 4) = a1y + imp * f[7];
          MOM(w1, 5) = a1z + imp * f[8];
          MOM(w0, 0) = l0x + imp * -nx;
          MOM(w0, 1) = l0y + imp * -ny;
          MOM(w0, 2) = l0z + imp * -nz;
          MOM(w0, 3) = a0x + imp * -f[3];
          MOM(w0, 4) = a0y + imp * -f[4];
          MOM(w0, 5) = a0z + imp * -f[5];
          isum[on ? q : idle] = own + imp;
        } else {
          // ---- angular rows (a -FLT_MAX target: no torque) ----
          const float ts = post ? f[11] : f[10];
          const bool act = on && ts != -FLT_MAX;
          const int m = act ? __float_as_int(f[RS_NAF]) : 0;
          const int b0 = (m & 0xFF) - 1, b1 = ((m >> 8) & 0xFF) - 1;
          const int r0 = b0 >= 0 ? b0 : world, r1 = b1 >= 0 ? b1 : world;
          const int w0 = b0 >= 0 ? b0 : idle_b, w1 = b1 >= 0 ? b1 : idle_b;
          const float a0x = MOM(r0, 3), a0y = MOM(r0, 4), a0z = MOM(r0, 5);
          const float a1x = MOM(r1, 3), a1y = MOM(r1, 4), a1z = MOM(r1, 5);
          const int qa = act ? q - nla : idle - nla - 1;
          const float own = torq[qa];
          const float e1 = (a1x * f[6] + a1y * f[7]) + a1z * f[8];
          const float e0 = (a0x * f[3] + a0y * f[4]) + a0z * f[5];
          const float cur_spin = e1 - e0;
          float dtq = (ts - cur_spin) * f[9];
          dtq = rs_min(dtq, f[13] - own);
          dtq = rs_max(dtq, f[12] - own);
          const float ax = f[0], ay = f[1], az = f[2];
          MOM(w1, 3) = a1x + dtq * ax;
          MOM(w1, 4) = a1y + dtq * ay;
          MOM(w1, 5) = a1z + dtq * az;
          MOM(w0, 3) = a0x + dtq * -ax;
          MOM(w0, 4) = a0y + dtq * -ay;
          MOM(w0, 5) = a0z + dtq * -az;
          torq[qa] = own + dtq;
        }
        __syncwarp();
      }
      free_after(e.x);
      next_chunk();
    }
#undef RING
  }
  if (regs) from_regs();
  if (a.iters == total || nsteps == 0) write_out(0);
  write_out(1);
#undef MOM
  if (a.cycles && lane == 0) {
    long long* c = a.cycles + (size_t)t * 8;
    c[0] = c1 - c0;                     // prologue
    c[1] = clock64() - c1;              // the sweeps
    c[2] = nsteps;                      // steps a sweep
    c[3] = ntot;                        // active rows
    c[4] = c_lev - c0;                  // the prologue's levelling
    c[5] = c1 - c_lev;                  // its placement and copies
    c[6] = jcyc;                        // the sweeps' jacobi levels
    c[7] = nj;                          // jacobi levels
  }
}

typedef void (*RowSweepKernel)(RowSweepArgs);

// The kernel for these rows (with the jacobi level where they hold a
// jacobi phase), its shared memory and attributes set; smem 0 if it
// cannot hold them.
static RowSweepKernel rs_prepare(const RowSweepArgs& a, size_t* smem) {
  const RowSweepKernel k =
      a.jmax > 0 ? row_sweep_kernel<true> : row_sweep_kernel<false>;
  *smem = 0;
  if (a.B > RS_MAXB || a.n_lin + a.n_ang > RS_MAXR || a.jmax < 0
      || a.jmax > RS_MAXJ || a.jlev < 0 || (a.jmax > 0 && a.jlev < 1))
    return k;
  const size_t n = rs_smem_bytes(a.n_lin + a.n_ang, a.jmax, a.jlev, a.B);
  if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)n) == cudaSuccess
      && cudaFuncSetAttribute(k,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              100) == cudaSuccess)
    *smem = n;
  return k;
}

// Tracks (blocks) an SM holds at once for these rows; 0 if none.
HTS_EXPORT int hts_row_sweep_occupancy(const void* args) {
  size_t smem;
  const RowSweepKernel k = rs_prepare(*(const RowSweepArgs*)args, &smem);
  int n = 0;
  if (smem) cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, 32, smem);
  return n;
}

HTS_EXPORT int hts_row_sweep(const void* args, void* stream) {
  const RowSweepArgs a = *(const RowSweepArgs*)args;
  size_t smem;
  const RowSweepKernel k = rs_prepare(a, &smem);
  if (!smem) return (int)cudaErrorInvalidValue;
  if (a.T > 0) k<<<a.T, 32, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
