// The kernels of the profiling tools: the staged point-cloud kernel cut
// after each of its passes, and the sum-only kernel at several tracks a
// block.
//
// cloud_stage_kernel<STAGE> replaces the Pallas kernel
// tools/prof_cloud_kernel.py:38 (make_stage_kernel, launched at :172).  The
// TPU tool cuts its cloud kernel after each stage and writes a value that
// depends on everything before the cut, so that nothing is dropped as dead
// code.  This kernel writes the value the TPU stage writes; its stages cut
// this file's own design (below), a cluster of CTAs a track, after each
// pass, so its stage times attribute that design: stage 0 the copy of the
// raster into shared memory and one reduction, stage 1 + the valid masks,
// the row scan and the cluster's exchange of valid totals, stage 2 + a
// pass over the kept pixels, stage 3 + the slot-major pick with its row
// search, stage 4 the slot-major output.  The tool's stage 5 is the real
// path, kernel 1 (cloud_kernel.cu), which keeps its own one-block design.
// Input: a track's depth raster as f32 (R, 128) (R = H*W/128 rows of 128
// pixels, each pixel a u16 depth as an integer-valued float) and the
// scalars lo, hi, scale; output (S, 8) f32:
//   stage 0: the load and one reduction: sum of draw*scale everywhere
//   stage 1: + the valid count and ranks: total + sum(kept) + sum(k_in),
//            k_in the kept count of a pixel's 128-pixel row up to it
//   stage 2: + the compaction: total + sum(cz) + sum(cl) over the kept
//            pixels (cz the raw depth, cl the lane = pixel % 128)
//   stage 3: + the slot pick: the sum over slots of the high depth byte of
//            the first kept pixel of the row the slot picks (the TPU's
//            one-hot row pick: the largest row whose kept base <= t_s,
//            t_s = s*K/S when K > S, else s)
//   stage 4: the full output, (px, py, z*scale, ok, 0, 0, 0, 0) a slot
// Stages 0-3 write their value into every element.  The kept rule is the
// TPU's float rule floor(r*inv)*frac == r on the valid rank r, and a row's
// kept base its floor((base + frac - 1)*inv); for frac <= 16 and ranks
// below 2^20 both equal the integer forms r % frac == 0 and
// ceil(base/frac) (checked over every rank by tests/test_torch_tools.py),
// which the kernel uses.  Stages 1-3 sum integers exactly and round once
// to float32; stage 0 sums the float32 products in float64 in one fixed
// order.  Stage 4 is bit for bit the TPU stage's output.
//
// Bound on the H100: bytes.  A track's f32 raster is 307.2 KB (240 x 320);
// the stages write 64 KB a track (S = 2048): 0.0570 ms at T = 512 and
// 3.35 TB/s.
//
// Design (tests/test_torch_prof_cloud_order.py states it in PyTorch and
// holds it bit for bit to the plain version):
//   * A cluster of C CTAs a track (cudaLaunchKernelEx with the cluster
//     attribute; C = PS_CLUSTER = 8, chosen by measurement over 1-8 on
//     the H100, unless the caller names one).  CTA c owns the rows
//     [c*R/C, (c+1)*R/C) and runs every pass on its slice, so a track's
//     chain of passes is C times shorter and C times as many CTAs are in
//     flight to cover each other's scans.
//   * The slice is copied into shared memory once, by 1-D bulk copies
//     (TMA) of PS_CHUNK rows, each completing on its own mbarrier: pass 1
//     starts on the first chunk while the rest arrive, and every later
//     pass reads shared memory, so the raster crosses HBM once.  A slice
//     fits up to 435 rows (227 KB a CTA): at C = 8 a raster of up to
//     3,480 rows (445,440 pixels; 640 x 480 is 2,400).  Past that, or
//     when the caller asks for it (`staged` 0), the CTAs read their slices
//     from device memory instead.
//   * Pass 1 leaves a valid mask byte a unit of 8 pixels; the row pass
//     counts each row's 16 bytes and scans the rows in one warp.  The
//     first exchange: each CTA's valid total is pushed into every CTA's
//     shared memory (distributed shared memory, after a start barrier
//     that every CTA has reached) and, after a cluster barrier, added in
//     rank order: integers, so the order is free.  The second exchange:
//     each CTA's integer sum (stage 0: its float64 partial) is pushed into
//     the last CTA, with a remote arrival on its mbarrier; the last CTA
//     alone waits, adds them in rank order (one fixed order) and fills the
//     track, while the others are done and free their SMs.
//   * Ranks in 32 bits, no integer division in a per-pixel or per-slot
//     loop: floor(n/frac) for n < 2^21 is a shift (a power-of-two frac)
//     or the multiply-high by the wrapper's reciprocal and a shift
//     (tools/prof_cloud_kernel.frac_divisor, exact over that range,
//     checked exhaustively).  The thinning map floor(s*K/S) runs in 32
//     bits where ceil(H*W/frac)*(S+1) <= 2^32 (`thin32`, decided once a
//     launch); otherwise a float64 estimate with the launcher's 1/S,
//     corrected to the exact floor by 64-bit products.  The SASS calls no
//     subroutine (chip_ab.py --kernel prof_cloud).
//   * Stage 2 visits a unit's kept ranks [ceil(r0/frac), ceil((r0 +
//     its valid count)/frac)), kept rank i at the unit's valid pixel
//     i*frac - r0, not every valid pixel.
//   * Slot-major gather (stages 3, 4).  CTA c owns the slots whose kept
//     rank t_s falls in its kept-rank range [ceil(base_c/frac),
//     ceil(base_{c+1}/frac)): slots [kb_c, kb_{c+1}) when K <= S, else
//     [ceil(kb_c*S/K), ceil(kb_{c+1}*S/K)) (outside 32 bits the smallest s
//     with s*K >= kb*S, by a search of 64-bit products); neighbouring
//     threads take neighbouring slots.  A slot's kept pixel has valid rank
//     t_s*frac: a binary search of the row ranks finds its row, a select
//     over the row's 128 mask bits its pixel, and shared memory its depth.
//     Stage 4 writes the slot's two float4s; stage 3 adds the row's value
//     (its first kept pixel's high byte).  The last CTA writes the empty
//     slots s >= min(K, S) (stage 4: pixel (R-1)*128, z = 0, ok = 0) or
//     adds them once each with the last row's value (stage 3).
// Measured on an H100 at T = 512 (PERF.md §6, chip_ab.py --kernel
// prof_cloud): every stage faster than the one-block-a-track design it
// replaced but stage 0, and within half its bound.  What holds it, from
// the clock64 counters: a CTA spends about as long waiting at the cluster
// barrier for the cluster's slowest copy as in its own pass after it;
// 77 clusters (616 CTAs of 40 KB) fit the card at once.
// `cycles`, when not null, takes thread 0's clock64 counters of each CTA
// (T*C, 8): pass 1 with its copies, the row scan, the first exchange, the
// stage's own pass, the second exchange with the fill (or the empty
// slots), the whole CTA, its SM and its rows.
//
// group_sum_kernel replaces the Pallas kernels tools/prof_cloud_mt.py:35
// (launched at :41) and tools/prof_cloud_pre.py:29 (launched at :34): the
// sum of draw*scale over a group of trk tracks' rasters, broadcast to
// (8, 128).  One block a group; each thread sums its float4 loads in
// float64, then a warp-shuffle tree and the warps' totals in order: one
// fixed order.  Bound: bytes, 4 KB written a group.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define PS_THREADS 256    // threads a CTA of the stage kernel
#define PS_CHUNK 16       // rows a bulk copy (8 KB)
#define PS_CLUSTER 8      // CTAs a track unless the caller names C
#define PS_MAXC 8         // the largest portable cluster
#define PS_SMEM_MAX (227 * 1024)
#define GS_THREADS 1024   // threads a block of the group sum (a group)
#define GS_UNROLL 4       // float4 loads in flight a thread

// Pixel k (0..7) of a unit of 8 pixels (two float4 loads).
__device__ __forceinline__ float ps_px(const float4& a, const float4& b,
                                       int k) {
  const float4& v = k < 4 ? a : b;
  const int j = k & 3;
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// Block sums in one fixed order: each warp's shuffle tree, then warp 0
// adds the warps' totals in warp order.  sh: 32 entries.  Every thread of
// the block calls it; every thread gets the total.
template <typename V>
__device__ __forceinline__ V ps_block_sum(V v, V* sh) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();
  if (lane == 0) sh[wid] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    V s = sh[0];
    for (int w = 1; w < nw; ++w) s += sh[w];
    sh[0] = s;
  }
  __syncthreads();
  return sh[0];
}

// The launch's scalars.  floor(n / frac) for 0 <= n < 2^21 is
// n >> fshift when fmul == 0, else umulhi(n, fmul) >> fshift.
struct PsArgs {
  const float* draw;     // (T, R, 128)
  float* out;            // (T, S, 8)
  long long* cycles;     // (T*C, 8) or null
  double rS;             // 1.0 / S (the float64 thinning estimate)
  int R, W, S, frac, fshift, C, nrmax, staged, thin32;
  unsigned fmul;
  float lo, hi, scale;
};

// Shared memory of a CTA: the slice's raster (staged only), a mask byte a
// unit, the rows' exclusive valid ranks (+ the total), the two exchanges'
// arrays (C ints; C int64 / float64), the block sum's 32 int64, the
// gather's mbarrier, an mbarrier a chunk (staged only).
struct PsLayout {
  size_t msk, rrank, exv, exs, red, gbar, bars, total;
};
__host__ __device__ __forceinline__ PsLayout ps_layout(int nrmax,
                                                       int staged) {
  PsLayout L;
  size_t o = staged ? (size_t)nrmax * 128 * sizeof(float) : 0;
  L.msk = o;
  o += (size_t)nrmax * 16;
  L.rrank = o;
  o += ((size_t)nrmax + 1) * sizeof(int);
  o = (o + 7) & ~(size_t)7;
  L.exv = o;
  o += PS_MAXC * sizeof(int);
  L.exs = o;
  o += PS_MAXC * sizeof(long long);
  L.red = o;
  o += 32 * sizeof(long long);
  L.gbar = o;
  o += 8;
  L.bars = o;
  o += staged ? (size_t)((nrmax + PS_CHUNK - 1) / PS_CHUNK) * 8 : 0;
  L.total = o;
  return L;
}

__device__ __forceinline__ unsigned ps_div(unsigned n, const PsArgs& a) {
  return a.fmul ? __umulhi(n, a.fmul) >> a.fshift : n >> a.fshift;
}

// The cluster barrier in two halves (every thread of every CTA): arrive
// (releasing this thread's writes), then wait (acquiring the others').
__device__ __forceinline__ void ps_cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void ps_cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void ps_cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void ps_cluster_sync() {
  ps_cluster_arrive();
  ps_cluster_wait();
}

// Thread 0 writes v into slot `rank` of arr in every CTA of the cluster.
template <typename V>
__device__ __forceinline__ void ps_push(V* arr, int rank, int C, V v) {
  cg::cluster_group cl = cg::this_cluster();
  for (int c = 0; c < C; ++c) *cl.map_shared_rank(arr + rank, c) = v;
}

// The gather into the cluster's last CTA: thread 0 writes v into slot
// `rank` of arr there and arrives on its mbarrier bar (C arrivals, one a
// CTA), releasing the write at cluster scope.  Only the last CTA waits.
template <typename V>
__device__ __forceinline__ void ps_gather(V* arr, uint64_t* bar, int rank,
                                          int C, V v) {
  cg::cluster_group cl = cg::this_cluster();
  *cl.map_shared_rank(arr + rank, C - 1) = v;
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(hts_smem_addr(bar)), "r"(C - 1));
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          remote)
      : "memory");
}
__device__ __forceinline__ void ps_mbar_init(uint64_t* bar, unsigned n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   hts_smem_addr(bar)),
               "r"(n)
               : "memory");
}
// waits for the gather's C arrivals, acquiring the writes at cluster scope
__device__ __forceinline__ void ps_gather_wait(uint64_t* bar) {
  const unsigned b = hts_smem_addr(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b)
        : "memory");
  } while (!done);
}

// The set bits of a row's 16 mask bytes before unit u, and unit u's byte.
__device__ __forceinline__ unsigned ps_word(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}
__device__ __forceinline__ unsigned ps_prefix(const uint4& w, int u) {
  const int i = u >> 2;
  unsigned p = __popc(ps_word(w, i) & ((1u << (8 * (u & 3))) - 1u));
  if (i > 0) p += __popc(w.x);
  if (i > 1) p += __popc(w.y);
  if (i > 2) p += __popc(w.z);
  return p;
}
__device__ __forceinline__ unsigned ps_byte(const uint4& w, int u) {
  return (ps_word(w, u >> 2) >> (8 * (u & 3))) & 0xFFu;
}

// The position (0..31) of the j-th set bit (from 0) of x; j < its count.
__device__ __forceinline__ int ps_select32(unsigned x, unsigned j) {
  int b = 0;
#pragma unroll
  for (int h = 16; h > 0; h >>= 1) {
    const unsigned c = __popc(x & ((1u << h) - 1u));
    if (j >= c) {
      j -= c;
      x >>= h;
      b += h;
    }
  }
  return b;
}

// The position (0..127) of the j-th set bit (from 0) of a row's 128 mask
// bits; j < their count.
__device__ __forceinline__ int ps_select(const uint4& w, unsigned j) {
  unsigned x = w.x, c = __popc(x);
  int b = 0;
  if (j >= c) {
    j -= c;
    x = w.y;
    b = 32;
    c = __popc(x);
    if (j >= c) {
      j -= c;
      x = w.z;
      b = 64;
      c = __popc(x);
      if (j >= c) {
        j -= c;
        x = w.w;
        b = 96;
      }
    }
  }
  return b + ps_select32(x, j);
}

// t_s = floor(s*K/S), K > S.
__device__ __forceinline__ unsigned ps_fwd(unsigned s, unsigned K,
                                           const PsArgs& a) {
  const unsigned S = (unsigned)a.S;
  if (a.thin32) return s * K / S;
  const unsigned long long n = (unsigned long long)s * K;
  unsigned q = (unsigned)((double)n * a.rS);     // floor, or one off
  if ((unsigned long long)q * S > n)
    --q;
  else if ((unsigned long long)(q + 1) * S <= n)
    ++q;
  return q;
}

// ceil(kb*S/K), K > S: the first slot whose t_s >= kb.
__device__ __forceinline__ unsigned ps_inv(unsigned kb, unsigned K,
                                           const PsArgs& a) {
  const unsigned S = (unsigned)a.S;
  if (a.thin32) return (kb * S + K - 1) / K;
  const unsigned long long n = (unsigned long long)kb * S;
  unsigned lo = 0, hi = S;          // the smallest s with s*K >= n
  while (lo < hi) {
    const unsigned m = (lo + hi) >> 1;
    if ((unsigned long long)m * K >= n)
      hi = m;
    else
      lo = m + 1;
  }
  return lo;
}

// v into every element of the track's (S, 8) output.
__device__ __forceinline__ void ps_fill(float4* o4, unsigned S, float v) {
  const float4 q = make_float4(v, v, v, v);
  for (unsigned i = threadIdx.x; i < 2u * S; i += PS_THREADS) o4[i] = q;
}

template <int STAGE>
__global__ void __launch_bounds__(PS_THREADS)
cloud_stage_kernel(const PsArgs a) {
  extern __shared__ __align__(16) unsigned char ps_sh[];
  const long long c_start = clock64();
  const int C = a.C, tid = threadIdx.x;
  const int cr = (int)(blockIdx.x % C), t = (int)(blockIdx.x / C);
  const int r0 = cr * a.R / C, nr = (cr + 1) * a.R / C - r0;
  const int nu = nr * 16;
  const unsigned f = (unsigned)a.frac, S = (unsigned)a.S;
  const PsLayout L = ps_layout(a.nrmax, a.staged);
  float* ras = reinterpret_cast<float*>(ps_sh);
  unsigned char* msk = ps_sh + L.msk;
  int* rrank = reinterpret_cast<int*>(ps_sh + L.rrank);
  int* exv = reinterpret_cast<int*>(ps_sh + L.exv);
  long long* exs = reinterpret_cast<long long*>(ps_sh + L.exs);
  long long* red = reinterpret_cast<long long*>(ps_sh + L.red);
  uint64_t* gbar = reinterpret_cast<uint64_t*>(ps_sh + L.gbar);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ps_sh + L.bars);
  const float* g = a.draw + ((size_t)t * a.R + r0) * 128;
  const float4* g4 = reinterpret_cast<const float4*>(g);
  const float4* s4 = reinterpret_cast<const float4*>(ras);
  float4* o4 = reinterpret_cast<float4*>(a.out + (size_t)t * S * 8);
  long long cyc[5] = {0, 0, 0, 0, 0};
  long long c_prev = c_start;
  auto stamp = [&](int i) {
    if (a.cycles && tid == 0) {
      const long long c = clock64();
      cyc[i] = c - c_prev;
      c_prev = c;
    }
  };

  const int nch = a.staged ? (nr + PS_CHUNK - 1) / PS_CHUNK : 0;
  if (tid == 0) {
    ps_mbar_init(gbar, (unsigned)C);
    for (int i = 0; i < nch; ++i) hts_mbar_init(bars + i);
    hts_fence_mbar_init();
    for (int i = 0; i < nch; ++i)
      hts_bulk_load(ras + (size_t)i * PS_CHUNK * 128,
                    g + (size_t)i * PS_CHUNK * 128,
                    (unsigned)min(PS_CHUNK, nr - i * PS_CHUNK) * 512u,
                    bars + i);
  }
  // the start barrier's arrival (after the inits): every CTA of the
  // cluster has started, its gather barrier set, before any thread writes
  // another's shared memory
  ps_cluster_arrive_relaxed();
  __syncthreads();
  // unit l's 8 pixels, from shared memory or (not staged) device memory
  auto unit = [&](int l, float4& x, float4& y) {
    if (a.staged) {
      x = s4[2 * l];
      y = s4[2 * l + 1];
    } else {
      x = __ldg(g4 + 2 * l);
      y = __ldg(g4 + 2 * l + 1);
    }
  };
  auto pixel = [&](int q) { return a.staged ? ras[q] : __ldg(g + q); };

  // pass 1, a chunk at a time as its copy lands: stage 0's sum, or the
  // valid mask byte of each unit
  double dacc = 0.0;
  for (int ch = 0, u0 = 0; u0 < nu; ++ch, u0 += PS_CHUNK * 16) {
    if (a.staged) hts_mbar_wait(bars + ch, 0);
    const int u1 = min(nu, u0 + PS_CHUNK * 16);
    for (int l = u0 + tid; l < u1; l += PS_THREADS) {
      float4 x, y;
      unit(l, x, y);
      if (STAGE == 0) {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          dacc += (double)__fmul_rn(ps_px(x, y, k), a.scale);
      } else {
        unsigned m = 0u;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float d = __fmul_rn(ps_px(x, y, k), a.scale);
          m |= (d >= a.lo && d < a.hi) ? 1u << k : 0u;
        }
        msk[l] = (unsigned char)m;
      }
    }
  }
  stamp(0);

  if (STAGE == 0) {
    const double s = ps_block_sum(dacc, reinterpret_cast<double*>(red));
    ps_cluster_wait();                          // the start barrier
    if (tid == 0)
      ps_gather(reinterpret_cast<double*>(exs), gbar, cr, C, s);
    stamp(2);
    if (cr == C - 1) {     // the last CTA adds in rank order and fills
      ps_gather_wait(gbar);
      double tot = 0.0;
      for (int c = 0; c < C; ++c) tot += reinterpret_cast<double*>(exs)[c];
      ps_fill(o4, S, (float)tot);
    }
    stamp(4);
  } else {
    // the row pass: each row's valid count, scanned in row order by warp
    // 0, each lane a contiguous run of rows
    __syncthreads();
    if (tid < 32) {
      const int run = (nr + 31) >> 5;
      const int i0 = min(tid * run, nr), i1 = min(i0 + run, nr);
      int sum = 0;
      for (int i = i0; i < i1; ++i) {
        const uint4 w = *reinterpret_cast<const uint4*>(msk + i * 16);
        const int c = __popc(w.x) + __popc(w.y) + __popc(w.z) + __popc(w.w);
        rrank[i] = c;
        sum += c;
      }
      const int inc = hts_warp_incl_scan(sum);
      int r = inc - sum;
      for (int i = i0; i < i1; ++i) {
        const int c = rrank[i];
        rrank[i] = r;
        r += c;
      }
      if (tid == 31) rrank[nr] = inc;
    }
    __syncthreads();
    const int carry = rrank[nr];
    stamp(1);
    // the first exchange: the CTAs' valid totals, added in rank order
    ps_cluster_wait();                          // the start barrier
    if (tid == 0) ps_push(exv, cr, C, carry);
    ps_cluster_sync();
    stamp(2);
    unsigned base = 0, V = 0;
    for (int c = 0; c < C; ++c) {
      const unsigned v = (unsigned)exv[c];
      base += c < cr ? v : 0u;
      V += v;
    }
    const unsigned K = ps_div(V + f - 1, a);          // the kept count
    long long acc = 0;

    if (STAGE == 1) {
      for (int l = tid; l < nu; l += PS_THREADS) {
        const int rho = l >> 4, u = l & 15;
        const uint4 w = *reinterpret_cast<const uint4*>(msk + rho * 16);
        const unsigned rb = base + (unsigned)rrank[rho];
        const unsigned r0u = rb + ps_prefix(w, u);
        const unsigned m = ps_byte(w, u);
        const unsigned kb = ps_div(rb + f - 1, a);
        unsigned s = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          s += ps_div(r0u + __popc(m & ((2u << k) - 1u)) + f - 1, a) - kb;
        acc += s;
      }
    } else if (STAGE == 2) {
      // a unit's kept pixels: kept ranks [ceil(r0/frac),
      // ceil((r0 + its valid count)/frac)), kept rank i its valid pixel
      // i*frac - r0 of the unit
      for (int l = tid; l < nu; l += PS_THREADS) {
        const int rho = l >> 4, u = l & 15;
        const uint4 w = *reinterpret_cast<const uint4*>(msk + rho * 16);
        const unsigned m = ps_byte(w, u);
        if (m == 0u) continue;
        const unsigned r0u = base + (unsigned)rrank[rho] + ps_prefix(w, u);
        const unsigned i1 = ps_div(r0u + __popc(m) + f - 1, a);
        for (unsigned i = ps_div(r0u + f - 1, a); i < i1; ++i) {
          const int k = ps_select32(m, i * f - r0u);
          acc += (long long)pixel(8 * l + k) + (u * 8 + k);
        }
      }
    } else {
      // the slot-major gather over this CTA's slots
      const bool thin = K > S;
      const unsigned kb0 = ps_div(base + f - 1, a);
      const unsigned kb1 = ps_div(base + (unsigned)carry + f - 1, a);
      const unsigned s0 = thin ? ps_inv(kb0, K, a) : kb0;
      const unsigned s1 = thin ? ps_inv(kb1, K, a) : kb1;
      for (unsigned s = s0 + tid; s < s1; s += PS_THREADS) {
        const unsigned ts = thin ? ps_fwd(s, K, a) : s;
        const int v = (int)(ts * f - base);     // its valid rank, local
        int lo = 0, hi = nr - 1;                // its row
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (rrank[mid] <= v)
            lo = mid;
          else
            hi = mid - 1;
        }
        const uint4 w = *reinterpret_cast<const uint4*>(msk + lo * 16);
        if (STAGE == 3) {       // the row's first kept pixel
          const unsigned rb = base + (unsigned)rrank[lo];
          const unsigned j = ps_div(rb + f - 1, a) * f - rb;
          acc += (long long)pixel(lo * 128 + ps_select(w, j)) >> 8;
        } else {
          const int q = ps_select(w, (unsigned)(v - rrank[lo]));
          const unsigned p = (unsigned)(r0 + lo) * 128u + (unsigned)q;
          o4[2 * s] = make_float4((float)(p % (unsigned)a.W),
                                  (float)(p / (unsigned)a.W),
                                  __fmul_rn(pixel(lo * 128 + q), a.scale),
                                  1.0f);
          o4[2 * s + 1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      }
      if (cr == C - 1 && K < S) {     // the empty slots: the last row
        if (STAGE == 3) {
          if (tid == 0) {
            const unsigned rb = base + (unsigned)rrank[nr - 1];
            const unsigned kr = ps_div(rb + f - 1, a);
            if (kr < K) {
              const uint4 w =
                  *reinterpret_cast<const uint4*>(msk + (nr - 1) * 16);
              acc += (long long)(S - K) *
                     ((long long)pixel((nr - 1) * 128 +
                                       ps_select(w, kr * f - rb)) >> 8);
            }
          }
        } else {
          const unsigned pl = (unsigned)(a.R - 1) * 128u;
          const float4 e = make_float4((float)(pl % (unsigned)a.W),
                                       (float)(pl / (unsigned)a.W), 0.0f,
                                       0.0f);
          for (unsigned s = K + tid; s < S; s += PS_THREADS) {
            o4[2 * s] = e;
            o4[2 * s + 1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          }
        }
      }
    }
    stamp(3);

    if (STAGE <= 3) {
      // the second exchange: the CTAs' integer sums gathered in the last
      // CTA, which fills the track; the others are done
      const long long s = ps_block_sum(acc, red);
      if (tid == 0) ps_gather(exs, gbar, cr, C, s);
      if (cr == C - 1) {
        ps_gather_wait(gbar);
        long long tot = 0;
        for (int c = 0; c < C; ++c) tot += exs[c];
        ps_fill(o4, S,
                (float)(STAGE == 1   ? 2 * (long long)K + tot
                        : STAGE == 2 ? (long long)K + tot
                                     : tot));
      }
    }
    stamp(4);
  }
  if (a.cycles && tid == 0) {
    long long* cy = a.cycles + (size_t)blockIdx.x * 8;
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
#pragma unroll
    for (int i = 0; i < 5; ++i) cy[i] = cyc[i];
    cy[5] = clock64() - c_start;
    cy[6] = sm;
    cy[7] = nr;
  }
}

__global__ void __launch_bounds__(GS_THREADS)
group_sum_kernel(const float4* __restrict__ draw, float* __restrict__ out,
                 long long n4, float scale) {
  __shared__ double sh[32];
  const float4* d = draw + (size_t)blockIdx.x * n4;
  double acc = 0.0;
  for (long long i0 = threadIdx.x; i0 < n4;
       i0 += (long long)GS_UNROLL * GS_THREADS) {
    float4 v[GS_UNROLL];
#pragma unroll
    for (int u = 0; u < GS_UNROLL; ++u) {
      const long long i = i0 + (long long)u * GS_THREADS;
      v[u] = i < n4 ? __ldg(d + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < GS_UNROLL; ++u) {
      acc += (double)__fmul_rn(v[u].x, scale);
      acc += (double)__fmul_rn(v[u].y, scale);
      acc += (double)__fmul_rn(v[u].z, scale);
      acc += (double)__fmul_rn(v[u].w, scale);
    }
  }
  const float s = (float)ps_block_sum(acc, sh);
  float4* o = reinterpret_cast<float4*>(out + (size_t)blockIdx.x * 1024);
  if (threadIdx.x < 256) o[threadIdx.x] = make_float4(s, s, s, s);
}

// The launch a stage takes at these shapes: C (cluster 0: PS_CLUSTER),
// staged (-1: where the slice fits, 0: never, 1: required), the CTA's
// shared memory and thin32.  Returns cudaErrorInvalidValue where the
// shapes are refused.
static int ps_config(int HW, int frac, int S, int cluster, int staged,
                     PsArgs* a, size_t* smem) {
  if (HW < 128 || HW % 128 != 0 || HW > (1 << 20) || frac < 1 ||
      frac > 16 || S < 1 || cluster < 0 || cluster > PS_MAXC ||
      staged < -1 || staged > 1)
    return (int)cudaErrorInvalidValue;
  const int R = HW / 128;
  const int C = cluster ? cluster : PS_CLUSTER;
  auto fits = [&](int c) {
    return ps_layout((R + c - 1) / c, 1).total <= PS_SMEM_MAX;
  };
  const int st = staged == -1 ? (int)fits(C) : staged;
  if (st && !fits(C)) return (int)cudaErrorInvalidValue;
  const int nrmax = (R + C - 1) / C;
  const unsigned long long kmax = (unsigned long long)(HW + frac - 1) / frac;
  a->R = R;
  a->S = S;
  a->frac = frac;
  a->C = C;
  a->nrmax = nrmax;
  a->staged = st;
  a->thin32 = kmax * ((unsigned long long)S + 1) <= (1ull << 32);
  a->rS = 1.0 / S;
  *smem = ps_layout(nrmax, st).total;
  return 0;
}

template <int N>
static int ps_launch(const PsArgs& a, int T, size_t smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cloud_stage_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(T * a.C));
  cfg.blockDim = dim3(PS_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, cloud_stage_kernel<N>, a);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// draw: (T, H*W) f32 (each track's raster as rows of 128), 16-byte
// aligned; out: (T, S, 8) f32.  Requires HW a positive multiple of 128 and
// at most 2^20, 1 <= frac <= 16 with (fmul, fshift) its divisor
// (tools/prof_cloud_kernel.frac_divisor), S >= 1, 0 <= stage <= 4;
// cluster 0 (the launcher's C) or 1-8, staged -1 (where it fits), 0 or 1;
// cycles null or (T*C, 8) int64.  A refused cluster launch returns its
// error: there is no other route.
HTS_EXPORT int hts_cloud_stage(const void* draw, void* out, int T, int HW,
                               int W, int frac, unsigned fmul, int fshift,
                               int S, int stage, float lo, float hi,
                               float scale, int cluster, int staged,
                               void* cycles, void* stream) {
  PsArgs a = {};
  size_t smem;
  const int e = ps_config(HW, frac, S, cluster, staged, &a, &smem);
  if (e) return e;
  // the divisor must be the exact one: a shift for a power of two, else
  // ceil(2^(32+s)/frac) with s = floor(log2 frac)
  const int s = 31 - __builtin_clz((unsigned)frac);
  const unsigned want =
      (frac & (frac - 1)) == 0
          ? 0u
          : (unsigned)(((1ull << (32 + s)) + frac - 1) / frac);
  if (W < 1 || stage < 0 || stage > 4 || fmul != want || fshift != s ||
      (uintptr_t)draw % 16 != 0 || (uintptr_t)out % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (T <= 0) return (int)cudaGetLastError();
  a.draw = (const float*)draw;
  a.out = (float*)out;
  a.cycles = (long long*)cycles;
  a.W = W;
  a.fmul = fmul;
  a.fshift = fshift;
  a.lo = lo;
  a.hi = hi;
  a.scale = scale;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (stage) {
    case 0: return ps_launch<0>(a, T, smem, st);
    case 1: return ps_launch<1>(a, T, smem, st);
    case 2: return ps_launch<2>(a, T, smem, st);
    case 3: return ps_launch<3>(a, T, smem, st);
    default: return ps_launch<4>(a, T, smem, st);
  }
}

// The launch hts_cloud_stage makes for these shapes, into res[0..4]: C,
// staged, the CTA's shared memory in bytes, the clusters the card holds
// at once (cudaOccupancyMaxActiveClusters) and thin32.
HTS_EXPORT int hts_cloud_stage_config(int HW, int frac, int S, int stage,
                                      int cluster, int staged, int* res) {
  PsArgs a = {};
  size_t smem;
  const int e = ps_config(HW, frac, S, cluster, staged, &a, &smem);
  if (e || stage < 0 || stage > 4) return e ? e : (int)cudaErrorInvalidValue;
  const void* fns[5] = {(const void*)cloud_stage_kernel<0>,
                        (const void*)cloud_stage_kernel<1>,
                        (const void*)cloud_stage_kernel<2>,
                        (const void*)cloud_stage_kernel<3>,
                        (const void*)cloud_stage_kernel<4>};
  if (smem > 48 * 1024) {
    const cudaError_t x = cudaFuncSetAttribute(
        fns[stage], cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (x != cudaSuccess) return (int)x;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)a.C * 128u);
  cfg.blockDim = dim3(PS_THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  const cudaError_t x = cudaOccupancyMaxActiveClusters(&n, fns[stage], &cfg);
  if (x != cudaSuccess) return (int)x;
  res[0] = a.C;
  res[1] = a.staged;
  res[2] = (int)smem;
  res[3] = n;
  res[4] = a.thin32;
  return 0;
}

// draw: (G, n) f32 with n a positive multiple of 4 (a group's rasters);
// out: (G, 8, 128) f32, each group's sum of draw*scale.
HTS_EXPORT int hts_group_sum(const void* draw, void* out, int G,
                             long long n, float scale, void* stream) {
  if (n < 4 || n % 4 != 0) return (int)cudaErrorInvalidValue;
  if (G <= 0) return (int)cudaGetLastError();
  group_sum_kernel<<<G, GS_THREADS, 0, (cudaStream_t)stream>>>(
      (const float4*)draw, (float*)out, n / 4, scale);
  return (int)cudaGetLastError();
}
