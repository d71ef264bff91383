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
// (their impulse is 0).  `iters` sweeps with ts, then the momenta are
// written (the pose integration reads them), then `iters_post` sweeps with
// the bias-free targets.
//
// Design: one thread a track, one warp a block (grid ceil(T / 32)).  The
// track's momenta sit in shared memory, one column per lane
// ([body * 6 + c][lane], conflict-free); the rows are laid out tracks-last
// (row, field, track), so a warp's loads of one row coalesce into 128-byte
// lines; the accumulated impulses live in global memory (row, track).  The
// loop over rows is sequential by nature (each row reads the momenta the
// previous one wrote); the parallelism is across tracks only, so at T=512
// the solve runs on 16 warps and is latency-bound.  A row's data does not
// depend on the momenta, so it is staged ahead: chunks of RS_K rows (the
// fields, the meta word and the row's accumulated impulse) are copied into
// shared memory with cp.async, RS_NST - 1 chunks ahead of the rows being
// solved, and a row then costs its chain of shared-memory reads, ~20 float
// operations and the writes, not a trip to device memory (the meta word
// also carries the row's master position).  Every lane stages and reads
// only its own column, so no barrier is needed.  Only a friction row's
// master impulse (written earlier in the same sweep) is read from device
// memory at the row.
//
// Bound on the H100: bytes.  Each sweep reads every active row once
// (22 x 4 B linear, 15 x 4 B angular, per track) and reads and writes its
// accumulated impulse.
#include <float.h>

#include "common.cuh"

#define RS_MAXB 32
#define RS_NLF 21
#define RS_NAF 14
#define RS_K 8           // rows a staged chunk
#define RS_NST 4         // chunks in flight (stages of the ring)
#define RS_MAXR 32766    // linear rows: a master position fits 15 bits

struct RowSweepArgs {
  const float* mom0;     // (T, B, 6)
  const float* massinv;  // (B,)
  const float* lf;       // (Rl, 21, T)
  const int* lm;         // (Rl, T), the master position in bits 17-31
  const float* af;       // (Ra, 14, T)
  const int* am;         // (Ra, T)
  float* isum;           // (Rl, T), zeroed
  float* torq;           // (Ra, T), zeroed
  float* out;            // (T, 2, B, 6)
  int T, B, n_lin, n_ang, iters, iters_post;
};

// torch.minimum / torch.maximum: NaN propagates from either side
__device__ __forceinline__ float rs_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float rs_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Asynchronous 4-byte copies global -> shared (cp.async, Ampere and
// later): each lane stages its own track's column, so the wait is per
// thread and no barrier is needed.
__device__ __forceinline__ void rs_cp4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void rs_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most RS_NST - 1 staged chunks are still in flight
__device__ __forceinline__ void rs_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(RS_NST - 1) : "memory");
}

// Stage rows [r0, r0 + RS_K) of a row list: nf fields, then the meta word
// and the accumulated impulse (its value from the previous sweep: a row's
// accumulator is written only when the row is processed, after this copy
// lands).  st: [k][field][lane].
__device__ __forceinline__ void rs_stage(float* st, const float* f,
                                         const int* meta, const float* acc,
                                         int nf, int r0, int n, int T,
                                         int t, int lane) {
  for (int k = 0; k < RS_K && r0 + k < n; ++k) {
    const int r = r0 + k;
    float* d = st + k * (nf + 2) * 32 + lane;
    for (int q = 0; q < nf; ++q)
      rs_cp4(d + q * 32, f + ((size_t)r * nf + q) * T + t);
    rs_cp4(d + nf * 32, meta + (size_t)r * T + t);
    rs_cp4(d + (nf + 1) * 32, acc + (size_t)r * T + t);
  }
  rs_commit();
}

__global__ void __launch_bounds__(32) row_sweep_kernel(RowSweepArgs a) {
  extern __shared__ float sh[];
  __shared__ float mi[RS_MAXB];
  float* mom = sh;                                 // [body * 6 + c][lane]
  float* stage = sh + RS_MAXB * 6 * 32;    // RS_NST x [k][field][lane]
  const int lane = threadIdx.x;
  const int t = blockIdx.x * 32 + lane;
  const int T = a.T, B = a.B;
  for (int b = lane; b < B; b += 32) mi[b] = a.massinv[b];
  __syncwarp();
  if (t >= T) return;
  for (int i = 0; i < B * 6; ++i)
    mom[i * 32 + lane] = a.mom0[(size_t)t * B * 6 + i];
#define MOM(b, c) mom[((b) * 6 + (c)) * 32 + lane]
  const int LS = (RS_NLF + 2) * 32, AS = (RS_NAF + 2) * 32;
  const int total = a.iters + a.iters_post;
  for (int s = 0; s <= total; ++s) {
    if (s == a.iters)
      for (int i = 0; i < B * 6; ++i)
        a.out[((size_t)t * 2 + 0) * B * 6 + i] = mom[i * 32 + lane];
    if (s == total) break;
    const int post = s >= a.iters;
    // ---- linear rows, staged RS_K at a time, RS_NST - 1 chunks ahead ----
    const int nlc = (a.n_lin + RS_K - 1) / RS_K;
    for (int c = 0; c < RS_NST - 1; ++c) {
      if (c < nlc)
        rs_stage(stage + c * RS_K * LS, a.lf, a.lm, a.isum, RS_NLF,
                 c * RS_K, a.n_lin, T, t, lane);
      else
        rs_commit();
    }
    for (int c = 0; c < nlc; ++c) {
      float* cur = stage + (c % RS_NST) * RS_K * LS;
      const int nx_c = c + RS_NST - 1;
      if (nx_c < nlc)
        rs_stage(stage + (nx_c % RS_NST) * RS_K * LS, a.lf, a.lm, a.isum,
                 RS_NLF, nx_c * RS_K, a.n_lin, T, t, lane);
      else
        rs_commit();
      rs_wait();
      for (int k = 0; k < RS_K && c * RS_K + k < a.n_lin; ++k) {
        const int r = c * RS_K + k;
        const float* f = cur + k * LS + lane;      // field q at f[q * 32]
        const int meta = __float_as_int(f[RS_NLF * 32]);
        if (!((meta >> 16) & 1)) continue;
        const int b0 = (meta & 0xFF) - 1, b1 = ((meta >> 8) & 0xFF) - 1;
        const float nx = f[0], ny = f[32], nz = f[64];
        float l0x = 0.f, l0y = 0.f, l0z = 0.f, a0x = 0.f, a0y = 0.f,
              a0z = 0.f, mi0 = 0.f;
        float l1x = 0.f, l1y = 0.f, l1z = 0.f, a1x = 0.f, a1y = 0.f,
              a1z = 0.f, mi1 = 0.f;
        if (b0 >= 0) {
          l0x = MOM(b0, 0); l0y = MOM(b0, 1); l0z = MOM(b0, 2);
          a0x = MOM(b0, 3); a0y = MOM(b0, 4); a0z = MOM(b0, 5);
          mi0 = mi[b0];
        }
        if (b1 >= 0) {
          l1x = MOM(b1, 0); l1y = MOM(b1, 1); l1z = MOM(b1, 2);
          a1x = MOM(b1, 3); a1y = MOM(b1, 4); a1z = MOM(b1, 5);
          mi1 = mi[b1];
        }
        const float d1 = (l1x * nx + l1y * ny) + l1z * nz;
        const float e1 = (a1x * f[12 * 32] + a1y * f[13 * 32])
                         + a1z * f[14 * 32];
        const float d0 = (l0x * nx + l0y * ny) + l0z * nz;
        const float e0 = (a0x * f[9 * 32] + a0y * f[10 * 32])
                         + a0z * f[11 * 32];
        const float vn = ((d1 * mi1 + e1) - d0 * mi0) - e0;
        const float ts = post ? f[17 * 32] : f[16 * 32];
        float imp = (-ts - vn) * f[15 * 32];
        const float own = f[(RS_NLF + 1) * 32];
        const int mp = (meta >> 17) - 1;          // master row, -1 none
        float lo, hi;
        if (mp >= 0) {
          hi = f[20 * 32] * a.isum[(size_t)mp * T + t];
          lo = -hi;
        } else {
          lo = f[18 * 32];
          hi = f[19 * 32];
        }
        imp = rs_min(imp, hi - own);
        imp = rs_max(imp, lo - own);
        if (b1 >= 0) {
          MOM(b1, 0) = l1x + imp * nx;
          MOM(b1, 1) = l1y + imp * ny;
          MOM(b1, 2) = l1z + imp * nz;
          MOM(b1, 3) = a1x + imp * f[6 * 32];
          MOM(b1, 4) = a1y + imp * f[7 * 32];
          MOM(b1, 5) = a1z + imp * f[8 * 32];
        }
        if (b0 >= 0) {
          MOM(b0, 0) = l0x + imp * -nx;
          MOM(b0, 1) = l0y + imp * -ny;
          MOM(b0, 2) = l0z + imp * -nz;
          MOM(b0, 3) = a0x + imp * -f[3 * 32];
          MOM(b0, 4) = a0y + imp * -f[4 * 32];
          MOM(b0, 5) = a0z + imp * -f[5 * 32];
        }
        a.isum[(size_t)r * T + t] = own + imp;
      }
    }
    // ---- angular rows, staged the same way ----
    const int nac = (a.n_ang + RS_K - 1) / RS_K;
    for (int c = 0; c < RS_NST - 1; ++c) {
      if (c < nac)
        rs_stage(stage + c * RS_K * AS, a.af, a.am, a.torq, RS_NAF,
                 c * RS_K, a.n_ang, T, t, lane);
      else
        rs_commit();
    }
    for (int c = 0; c < nac; ++c) {
      float* cur = stage + (c % RS_NST) * RS_K * AS;
      const int nx_c = c + RS_NST - 1;
      if (nx_c < nac)
        rs_stage(stage + (nx_c % RS_NST) * RS_K * AS, a.af, a.am, a.torq,
                 RS_NAF, nx_c * RS_K, a.n_ang, T, t, lane);
      else
        rs_commit();
      rs_wait();
      for (int k = 0; k < RS_K && c * RS_K + k < a.n_ang; ++k) {
        const int r = c * RS_K + k;
        const float* f = cur + k * AS + lane;
        const int meta = __float_as_int(f[RS_NAF * 32]);
        if (!((meta >> 16) & 1)) continue;
        const float ts = post ? f[11 * 32] : f[10 * 32];
        if (ts == -FLT_MAX) continue;
        const int b0 = (meta & 0xFF) - 1, b1 = ((meta >> 8) & 0xFF) - 1;
        float a0x = 0.f, a0y = 0.f, a0z = 0.f, a1x = 0.f, a1y = 0.f,
              a1z = 0.f;
        if (b0 >= 0) {
          a0x = MOM(b0, 3); a0y = MOM(b0, 4); a0z = MOM(b0, 5);
        }
        if (b1 >= 0) {
          a1x = MOM(b1, 3); a1y = MOM(b1, 4); a1z = MOM(b1, 5);
        }
        const float e1 = (a1x * f[6 * 32] + a1y * f[7 * 32])
                         + a1z * f[8 * 32];
        const float e0 = (a0x * f[3 * 32] + a0y * f[4 * 32])
                         + a0z * f[5 * 32];
        const float cur_spin = e1 - e0;
        float dtq = (ts - cur_spin) * f[9 * 32];
        const float own = f[(RS_NAF + 1) * 32];
        dtq = rs_min(dtq, f[13 * 32] - own);
        dtq = rs_max(dtq, f[12 * 32] - own);
        const float ax = f[0], ay = f[32], az = f[64];
        if (b1 >= 0) {
          MOM(b1, 3) = a1x + dtq * ax;
          MOM(b1, 4) = a1y + dtq * ay;
          MOM(b1, 5) = a1z + dtq * az;
        }
        if (b0 >= 0) {
          MOM(b0, 3) = a0x + dtq * -ax;
          MOM(b0, 4) = a0y + dtq * -ay;
          MOM(b0, 5) = a0z + dtq * -az;
        }
        a.torq[(size_t)r * T + t] = own + dtq;
      }
    }
  }
  for (int i = 0; i < B * 6; ++i)
    a.out[((size_t)t * 2 + 1) * B * 6 + i] = mom[i * 32 + lane];
#undef MOM
}

HTS_EXPORT int hts_row_sweep(const void* args, void* stream) {
  const RowSweepArgs a = *(const RowSweepArgs*)args;
  if (a.B > RS_MAXB || a.n_lin > RS_MAXR) return (int)cudaErrorInvalidValue;
  const int nf = RS_NLF > RS_NAF ? RS_NLF : RS_NAF;
  const size_t smem =
      ((size_t)RS_MAXB * 6 * 32 + (size_t)RS_NST * RS_K * (nf + 2) * 32) *
      sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      row_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (a.T > 0)
    row_sweep_kernel<<<(a.T + 31) / 32, 32, smem, (cudaStream_t)stream>>>(
        a);
  return (int)cudaGetLastError();
}
