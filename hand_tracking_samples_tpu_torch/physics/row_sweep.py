"""The row sweep: every Gauss-Seidel sweep of one solve, rows strictly in
order, in one kernel launch (csrc/row_sweep.cu) for all tracks.

The JAX package runs its reference-shaped solves as device loops: the
sequential solve is a `lax.scan` over rows inside a `fori_loop` over sweeps
(hand_tracking_samples_tpu/physics/solver.py:223-297), the colored solve
`fori_loop`s over slots and groups (physics/colored.py:300-455); XLA
compiles each into one loop on the device.  This kernel is the port's form
of those loops (it has no Pallas counterpart).  Both solvers feed it:
`physics.solver.physics_update` its rows in emission order, and
`physics.colored.physics_update_colored` its rows in colored order
(single-body blocks slot-major then body, pair blocks group by group: the
rows of one group touch disjoint bodies, so applying them one after
another equals the JAX package's one-hot group update).

A sweep runs the linear rows in order, then the angular rows in order
(solver.py:232-284 lin_step / ang_step): world rows (b = -1) read zero
momenta and take no impulse; a friction row's bounds are coef x the
accumulated impulse of its master row (whose position the meta word
carries); an
angular row whose target spin is -FLT_MAX takes no torque; the accumulated
impulses (isum, torq) carry over from the main sweeps into the post sweeps.
`iterations` sweeps with the main targets, then `iterations_post` with the
bias-free ones.  Inactive rows take no impulse: `sweep_rows` drops the
rows inactive on every track, and the sweeps skip a track's inactive
rows.

`row_sweep` is the wrapper: CUDA tensors launch the kernel, CPU tensors
run `row_sweep_plain`, the same operations in the same order (the kernel
is built with -fmad=false, so the two agree bit for bit).  Layouts:
  mom0   (T, B, 6)      momenta after rbinitvelocity [lin xyz, ang xyz]
  massinv (B,)
  lf     (Rl, 21, T)    linear rows [n(3) J0(3) J1(3) K0(3) K1(3) dinv
                        ts tspost lo hi fcoef]; lo/hi the force bounds x dt
  lm     (Rl, T) int32  (b0 + 1) | (b1 + 1) << 8 | active << 16
                        | (master row position + 1) << 17 (0: none)
  af     (Ra, 14, T)    angular rows [axis(3) K0(3) K1(3) stt ts tspost
                        lo hi]
  am     (Ra, T) int32  as lm
  out    (T, 2, B, 6)   momenta after the main and after the post sweeps
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels

NLF, NAF = 21, 14
MAX_B = 32
MAX_LIN = 32766          # a master position fits bits 17-31 of the meta
FLT_MAX = float(np.float32(3.4028235e38))


class SweepRows(NamedTuple):
    lf: torch.Tensor
    lm: torch.Tensor
    af: torch.Tensor
    am: torch.Tensor


def _meta(b0, b1, active, T, R, dev):
    """(T, R) int32 meta of rows: b0/b1 (R,) arrays or (T, R) tensors."""
    def t(b):
        if torch.is_tensor(b):
            return b.to(device=dev, dtype=torch.int32).expand(T, R)
        return torch.as_tensor(np.asarray(b, np.int32),
                               device=dev).expand(T, R)
    return ((t(b0) + 1) | ((t(b1) + 1) << 8)
            | (active.to(torch.int32).expand(T, R) << 16))


def _fields(parts, T, R):
    """List of (T, R) / (T, R, 3) tensors -> (R, F, T)."""
    cols = []
    for x in parts:
        x = x.expand((T, R) + tuple(x.shape[2:]))
        cols.append(x if x.dim() == 3 else x[..., None])
    return torch.cat(cols, dim=-1).permute(1, 2, 0).contiguous()


def linear_block(b0, b1, n, J0, J1, K0, K1, dinv, ts, tspost, lo, hi,
                 fcoef, active, mpos):
    """One block of linear rows in sweep order: fields (T, R[, 3]),
    b0/b1 (R,) or (T, R), mpos (R,) master positions within the block
    (-1 none).  Returns (lf, lm, mpos) pieces for `sweep_rows`."""
    T, R = dinv.shape
    dev = dinv.device
    lf = _fields([n, J0, J1, K0, K1, dinv, ts, tspost, lo, hi, fcoef], T, R)
    return lf, _meta(b0, b1, active, T, R, dev).T.contiguous(), \
        np.asarray(mpos, np.int64)


def angular_block(b0, b1, axis, K0, K1, stt, ts, tspost, lo, hi, active):
    T, R = stt.shape
    dev = stt.device
    af = _fields([axis, K0, K1, stt, ts, tspost, lo, hi], T, R)
    return af, _meta(b0, b1, active, T, R, dev).T.contiguous()


def _live(meta):
    """Host mask of rows active on some track (one device read)."""
    return (((meta >> 16) & 1).amax(dim=1) > 0).cpu().numpy()


def sweep_rows(lin_blocks, ang_blocks, T, device) -> SweepRows:
    """Concatenate blocks (in sweep order) into the kernel's layout.  Rows
    inactive on every track are dropped (they take no impulse), unless a
    kept friction row reads their accumulated impulse."""
    lfs, lms, pos = [], [], []
    off = 0
    for lf, lm, mp in lin_blocks:
        lfs.append(lf)
        lms.append(lm)
        pos.append(np.where(mp >= 0, mp + off, -1))
        off += lf.shape[0]
    lf = torch.cat(lfs) if lfs else torch.zeros((0, NLF, T), device=device)
    lm = torch.cat(lms) if lms else torch.zeros((0, T), dtype=torch.int32,
                                                device=device)
    mp = np.concatenate(pos) if pos else np.zeros(0, np.int64)
    keep = _live(lm)
    keep[mp[keep & (mp >= 0)]] = True
    new = np.cumsum(keep) - 1                  # old position -> new one
    mp = np.where(mp >= 0, new[np.maximum(mp, 0)], -1)[keep]
    idx = torch.as_tensor(np.nonzero(keep)[0], device=device)
    lf, lm = lf[idx], lm[idx]
    if lf.shape[0] > MAX_LIN:
        raise ValueError(f"row sweep: at most {MAX_LIN} linear rows")
    lm = lm | (torch.as_tensor(mp, dtype=torch.int32,
                               device=device)[:, None] + 1) << 17
    af = torch.cat([a for a, _ in ang_blocks]) if ang_blocks else \
        torch.zeros((0, NAF, T), device=device)
    am = torch.cat([m for _, m in ang_blocks]) if ang_blocks else \
        torch.zeros((0, T), dtype=torch.int32, device=device)
    aidx = torch.as_tensor(np.nonzero(_live(am))[0], device=device)
    return SweepRows(lf.contiguous(), lm.contiguous(),
                     af[aidx].contiguous(), am[aidx].contiguous())


def _unpack(meta, B):
    b0 = (meta & 0xFF) - 1
    b1 = ((meta >> 8) & 0xFF) - 1
    act = ((meta >> 16) & 1) == 1
    w = torch.full_like(b0, B)
    return torch.where(b0 < 0, w, b0), torch.where(b1 < 0, w, b1), act


def _dots4(g, C):
    """[l1.n, a1.K1, l0.n, a0.K0] as ((p0 + p1) + p2) per dot: g (T, 12)
    the momenta [b1 lin, b1 ang, b0 lin, b0 ang], C (T, 12) -> (T, 4)."""
    p = (g * C).view(-1, 4, 3)
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def _row_tables(meta, B, T, base, mi, C, D):
    """Per row (a list over rows): the momentum-table indices [b1, b0] of
    every track (2T,), the dot coefficients C and the impulse directions D
    (T, 12) with the world's half zeroed, the inverse masses [mi1, 1, mi0,
    1] (T, 4), the active mask and whether every track is active.  Rows
    active on no track are None."""
    i0, i1, act = _unpack(meta, B)                           # (R, T)
    idx = torch.stack([i1.T + base, i0.T + base], dim=1)      # (T, 2, R)
    idx = idx.permute(2, 0, 1).reshape(meta.shape[0], 2 * T)
    keep = torch.stack([i1 < B, i0 < B], dim=-1).to(torch.float32)
    D = (D * keep.repeat_interleave(6, dim=-1)).contiguous()   # (R, T, 12)
    C = C.contiguous()
    one = torch.ones_like(mi[i1])
    MI = torch.stack([mi[i1], one, mi[i0], one], dim=-1)     # (R, T, 4)
    any_act = act.any(1).tolist()
    all_act = act.all(1).tolist()
    return [(idx[r], C[r], D[r], MI[r], act[r], all_act[r])
            if any_act[r] else None for r in range(meta.shape[0])]


@torch.inference_mode()
def row_sweep_plain(mom0, massinv, rows: SweepRows, iterations: int,
                    iterations_post: int):
    """Plain PyTorch version of the kernel (same operations, same order).
    Momenta live in a (T * (B + 1), 6) table whose slot B of each track is
    the world (always zero); a world row's impulse on it is zeroed."""
    T, B = mom0.shape[0], mom0.shape[1]
    dev = mom0.device
    mom = torch.zeros((T, B + 1, 6), device=dev)
    mom[:, :B] = mom0
    mom = mom.view(T * (B + 1), 6)
    mi = torch.zeros(B + 1, device=dev)
    mi[:B] = massinv
    base = (torch.arange(T, device=dev) * (B + 1))[:, None]
    zero = torch.zeros((), device=dev)
    lf, af = rows.lf, rows.af
    n, J0, J1 = lf[:, 0:3], lf[:, 3:6], lf[:, 6:9]
    K0, K1 = lf[:, 9:12], lf[:, 12:15]
    tl = lambda *xs: torch.cat(xs, dim=1).permute(0, 2, 1)  # (R, T, 12)
    lin = _row_tables(rows.lm, B, T, base, mi, tl(n, K1, n, K0),
                      tl(n, J1, -n, -J0))
    z3 = torch.zeros_like(af[:, 0:3])
    ax, aK0, aK1 = af[:, 0:3], af[:, 3:6], af[:, 6:9]
    ang = _row_tables(rows.am, B, T, base, mi, tl(z3, aK1, z3, aK0),
                      tl(z3, ax, z3, -ax))
    lmpos = ((rows.lm[:, 0] >> 17) - 1).tolist() if T else []
    lfr = [lf[r] for r in range(lf.shape[0])]
    afr = [af[r] for r in range(af.shape[0])]
    isum = [torch.zeros(T, device=dev) for _ in range(lf.shape[0])]
    torq = [torch.zeros(T, device=dev) for _ in range(af.shape[0])]
    # an angular row whose target is -FLT_MAX takes no torque
    amask = [[None if a is None else a[4] & (afr[r][k] != -FLT_MAX)
              for r, a in enumerate(ang)] for k in (10, 11)]
    out = torch.empty((T, 2, B, 6), device=dev)
    total = iterations + iterations_post
    for s in range(total + 1):
        if s == iterations:
            out[:, 0] = mom.view(T, B + 1, 6)[:, :B]
        if s == total:
            break
        post = s >= iterations
        tsk = 17 if post else 16
        for r, row in enumerate(lin):
            if row is None:
                continue
            idx, C, D, MI, act, all_act = row
            f = lfr[r]
            d = _dots4(mom[idx].view(T, 12), C) * MI
            vn = ((d[:, 0] + d[:, 1]) - d[:, 2]) - d[:, 3]
            imp = (-f[tsk] - vn) * f[15]
            own = isum[r]
            if lmpos[r] >= 0:
                hi = f[20] * isum[lmpos[r]]
                lo = -hi
            else:
                hi, lo = f[19], f[18]
            imp = torch.maximum(torch.minimum(imp, hi - own), lo - own)
            if not all_act:
                imp = torch.where(act, imp, zero)
            mom.index_add_(0, idx, (imp[:, None] * D).view(2 * T, 6))
            isum[r] = own + imp
        k = 1 if post else 0
        tsk = 11 if post else 10
        for r, row in enumerate(ang):
            if row is None:
                continue
            idx, C, D = row[0], row[1], row[2]
            f = afr[r]
            d = _dots4(mom[idx].view(T, 12), C)
            ts = f[tsk]
            dtq = (ts - (d[:, 1] - d[:, 3])) * f[9]
            own = torq[r]
            dtq = torch.maximum(torch.minimum(dtq, f[13] - own),
                                f[12] - own)
            dtq = torch.where(amask[k][r], dtq, zero)
            mom.index_add_(0, idx, (dtq[:, None] * D).view(2 * T, 6))
            torq[r] = own + dtq
    out[:, 1] = mom.view(T, B + 1, 6)[:, :B]
    return out


class _Args(ctypes.Structure):
    _fields_ = [("mom0", ctypes.c_void_p), ("massinv", ctypes.c_void_p),
                ("lf", ctypes.c_void_p), ("lm", ctypes.c_void_p),
                ("af", ctypes.c_void_p),
                ("am", ctypes.c_void_p), ("isum", ctypes.c_void_p),
                ("torq", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("T", ctypes.c_int), ("B", ctypes.c_int),
                ("n_lin", ctypes.c_int), ("n_ang", ctypes.c_int),
                ("iters", ctypes.c_int), ("iters_post", ctypes.c_int)]


@kernels.wrapper("row_sweep")
def row_sweep(mom0, massinv, rows: SweepRows, iterations: int,
              iterations_post: int):
    """Kernel wrapper: see the module docstring for the layouts."""
    if mom0.device.type == "cpu":
        return row_sweep_plain(mom0, massinv, rows, iterations,
                               iterations_post)
    T, B = mom0.shape[0], mom0.shape[1]
    if B > MAX_B:
        raise ValueError(f"row sweep: at most {MAX_B} bodies, got {B}")
    args = [x.contiguous() for x in (mom0, massinv, *rows)]
    dev = kernels.require_cuda(*args)
    mom0, massinv, lf, lm, af, am = args
    isum = torch.zeros((lf.shape[0], T), device=dev)
    torq = torch.zeros((af.shape[0], T), device=dev)
    out = torch.empty((T, 2, B, 6), device=dev)
    a = _Args(mom0.data_ptr(), massinv.data_ptr(), lf.data_ptr(),
              lm.data_ptr(), af.data_ptr(), am.data_ptr(),
              isum.data_ptr(), torq.data_ptr(), out.data_ptr(), T, B,
              lf.shape[0], af.shape[0], iterations, iterations_post)
    err = kernels.library().hts_row_sweep(ctypes.byref(a),
                                          kernels.stream_ptr(dev))
    kernels.check(err, "row_sweep")
    row_sweep.launches += 1
    return out
