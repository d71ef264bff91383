"""The row sweep: every Gauss-Seidel sweep of one solve in one kernel
launch (csrc/row_sweep.cu) for all tracks, the result of the rows strictly
in order.

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
another equals the JAX package's one-hot group update).  A jacobi phase
(contacts_mode="jacobi": the colored schedule's contact phases, JAX
colored.py:339-372) is a run of linear rows whose impulses apply at once:
every row of it reads the momenta as they stood at the phase's start, and
each body then adds its rows' deltas in row order and applies the sum
once (the JAX package's one-hot product `O0 @ dl`, summed in a fixed
order).  A jacobi row's friction master lies in an earlier phase.

A sweep runs the linear rows in order, then the angular rows in order
(solver.py:232-284 lin_step / ang_step): world rows (b = -1) read zero
momenta and take no impulse; a friction row's bounds are coef x the
accumulated impulse of its master row (whose position the meta word
carries); an angular row whose target spin is -FLT_MAX takes no torque; the
accumulated impulses (isum, torq) carry over from the main sweeps into the
post sweeps.  `iterations` sweeps with the main targets, then
`iterations_post` with the bias-free ones.  Inactive rows take no impulse:
`sweep_rows` drops the rows inactive on every track, and the sweeps skip a
track's inactive rows.

The kernel runs each track's rows as a wavefront (`wave_schedule` states
its schedule): rows on disjoint bodies commute exactly, so a row runs as
soon as the last earlier row on its bodies (and its friction master) has,
and each body sees the same updates in the same order.  A jacobi phase's
active rows make one level of their own, above every earlier row's, and
every later row goes above it.

`row_sweep` is the wrapper: CUDA tensors launch the kernel, CPU tensors
run `row_sweep_waves`, the plain version in the kernel's wavefront order
(one step a level), equal to `row_sweep_plain`, the same operations in
row order, which the kernel is held to (it is built with -fmad=false, so
the two agree bit for bit).  Layouts, tracks
leading, a row's fields and its meta word (int32 bits) contiguous:
  mom0   (T, B, 6)      momenta after rbinitvelocity [lin xyz, ang xyz]
  massinv (B,)
  lf     (T, Rl, 24)    linear rows [n(3) J0(3) J1(3) K0(3) K1(3) dinv ts
                        tspost lo hi fcoef meta 0 0]; lo/hi the force
                        bounds x dt
  meta   int32          (b0 + 1) | (b1 + 1) << 8 | active << 16
                        | (master row position + 1) << 17 (0: none)
                        | link << 31 (the row continues the previous
                        row's jacobi phase)
  af     (T, Ra, 16)    angular rows [axis(3) K0(3) K1(3) stt ts tspost lo
                        hi meta 0]
  out    (T, 2, B, 6)   momenta after the main and after the post sweeps
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels

NLF, NAF = 21, 14        # fields of a linear / angular row; the meta follows
LW, AW = 24, 16          # a row's floats: fields, meta, zero padding
MAX_B = 32
MAX_LIN = 16382          # a master position + 1 fits bits 17-30 of the meta
MAX_ROWS = 13000         # rows (linear + angular) the kernel holds a track
MAX_JACOBI_ROWS = 256    # rows of a jacobi phase the kernel holds
FLT_MAX = float(np.float32(3.4028235e38))
LINK = -2 ** 31          # the meta word's bit 31 (int32)
MASTER = 0x3FFF          # the master position + 1, bits 17-30


class SweepRows(NamedTuple):
    lf: torch.Tensor      # (T, Rl, LW)
    af: torch.Tensor      # (T, Ra, AW)
    jmax: int = 0         # rows of the largest jacobi phase (0: none)

    @property
    def lm(self):
        """(T, Rl) int32 meta words of the linear rows (a view)."""
        return self.lf[..., NLF].view(torch.int32)

    @property
    def am(self):
        return self.af[..., NAF].view(torch.int32)


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
    """List of (T, R) / (T, R, 3) tensors -> (T, R, F)."""
    cols = []
    for x in parts:
        x = x.expand((T, R) + tuple(x.shape[2:]))
        cols.append(x if x.dim() == 3 else x[..., None])
    return torch.cat(cols, dim=-1)


def linear_block(b0, b1, n, J0, J1, K0, K1, dinv, ts, tspost, lo, hi,
                 fcoef, active, mpos, phase=None):
    """One block of linear rows in sweep order: fields (T, R[, 3]),
    b0/b1 (R,) or (T, R), mpos (R,) master positions within the block
    (-1 none), phase (R,) the jacobi phase of each row (-1: none; a
    phase's rows consecutive).  Returns (fields, meta, mpos, phase)
    pieces for `sweep_rows`."""
    T, R = dinv.shape
    lf = _fields([n, J0, J1, K0, K1, dinv, ts, tspost, lo, hi, fcoef], T, R)
    ph = np.full(R, -1, np.int64) if phase is None else \
        np.asarray(phase, np.int64)
    return lf, _meta(b0, b1, active, T, R, dinv.device), \
        np.asarray(mpos, np.int64), ph


def angular_block(b0, b1, axis, K0, K1, stt, ts, tspost, lo, hi, active):
    T, R = stt.shape
    af = _fields([axis, K0, K1, stt, ts, tspost, lo, hi], T, R)
    return af, _meta(b0, b1, active, T, R, stt.device)


def _live(meta):
    """Host mask of rows (T, R) active on some track (one device read)."""
    return (((meta >> 16) & 1).amax(dim=0) > 0).cpu().numpy()


def _with_meta(fields, meta, width):
    """(T, R, F) fields and (T, R) int32 meta -> (T, R, width) rows: the
    fields, the meta word's bits, zero padding (16-byte rows)."""
    pad = fields.new_zeros(fields.shape[:2] + (width - fields.shape[2] - 1,))
    return torch.cat([fields, meta.view(torch.float32)[..., None], pad],
                     dim=-1).contiguous()


def sweep_rows(lin_blocks, ang_blocks, T, device) -> SweepRows:
    """Concatenate blocks (in sweep order) into the kernel's layout.  Rows
    inactive on every track are dropped (they take no impulse), unless a
    kept friction row reads their accumulated impulse.  A kept jacobi row
    links to the kept row before it when both are of one phase."""
    lfs, lms, pos, phs = [], [], [], []
    off = 0
    for k, (lf, lm, mp, ph) in enumerate(lin_blocks):
        lfs.append(lf)
        lms.append(lm)
        pos.append(np.where(mp >= 0, mp + off, -1))
        phs.append(np.where(ph >= 0, ph * len(lin_blocks) + k, -1))
        off += lf.shape[1]
    lf = torch.cat(lfs, dim=1) if lfs else \
        torch.zeros((T, 0, NLF), device=device)
    lm = torch.cat(lms, dim=1) if lms else \
        torch.zeros((T, 0), dtype=torch.int32, device=device)
    mp = np.concatenate(pos) if pos else np.zeros(0, np.int64)
    ph = np.concatenate(phs) if phs else np.zeros(0, np.int64)
    keep = _live(lm)
    keep[mp[keep & (mp >= 0)]] = True
    new = np.cumsum(keep) - 1                  # old position -> new one
    bad = (ph >= 0) & (mp >= 0) & (ph == ph[np.maximum(mp, 0)])
    if bad.any():
        raise ValueError("row sweep: a jacobi row's friction master lies "
                         "in its own phase")
    mp = np.where(mp >= 0, new[np.maximum(mp, 0)], -1)[keep]
    ph = ph[keep]
    link = np.zeros(len(ph), bool)
    link[1:] = (ph[1:] >= 0) & (ph[1:] == ph[:-1])
    idx = torch.as_tensor(np.nonzero(keep)[0], device=device)
    lf, lm = lf[:, idx], lm[:, idx]
    if lf.shape[1] > MAX_LIN:
        raise ValueError(f"row sweep: at most {MAX_LIN} linear rows")
    lm = lm | (torch.as_tensor(mp, dtype=torch.int32, device=device)
               + 1) << 17
    lm = lm | torch.where(torch.as_tensor(link, device=device),
                          LINK, 0).to(torch.int32)
    _, sizes = np.unique(ph[ph >= 0], return_counts=True)
    af = torch.cat([a for a, _ in ang_blocks], dim=1) if ang_blocks else \
        torch.zeros((T, 0, NAF), device=device)
    am = torch.cat([m for _, m in ang_blocks], dim=1) if ang_blocks else \
        torch.zeros((T, 0), dtype=torch.int32, device=device)
    aidx = torch.as_tensor(np.nonzero(_live(am))[0], device=device)
    return SweepRows(_with_meta(lf, lm, LW),
                     _with_meta(af[:, aidx], am[:, aidx], AW),
                     int(sizes.max()) if len(sizes) else 0)


def jacobi_phases(lm):
    """(T, R) int64: each linear row's jacobi phase (numbered from 0 in
    row order; -1 for a row of no phase), from the meta words' links."""
    link = ((lm.to(torch.int64) >> 31) & 1) == 1
    nxt = torch.zeros_like(link)
    nxt[:, :-1] = link[:, 1:]
    jac = link | nxt
    start = jac & ~link
    num = torch.cumsum(start.to(torch.int64), dim=1) - 1
    return torch.where(jac, num, torch.full_like(num, -1))


def _master(meta):
    """The master position of each row, -1 none (int64)."""
    return ((meta.to(torch.int64) >> 17) & MASTER) - 1


# ---------------------------------------------------------------------------
# the kernel's schedule, stated in PyTorch, and rows that test it (the
# tests and chip_smoke.py)
# ---------------------------------------------------------------------------

class WaveSchedule(NamedTuple):
    lin_level: torch.Tensor   # (T, Rl) int64 level of each row, 0 inactive
    ang_level: torch.Tensor   # (T, Ra)
    lin_perm: torch.Tensor    # (T, Rl) rows in level order, then the
    ang_perm: torch.Tensor    #   inactive rows in row order
    lm: torch.Tensor          # (T, Rl) int32 lm[t, lin_perm[t]], master
                              #   positions remapped to that order
    lin_jac: torch.Tensor     # (T, Rl) bool: a jacobi row, in that order


def _levels(meta, friction):
    """(T, R) levels of the rows of meta (T, R), as the kernel's prologue
    computes them: 1 + the largest level of the earlier active rows on the
    row's bodies and of its master; a master after its reader is placed
    above the reader.  The active rows of a jacobi phase share one level,
    one above every earlier row's, and every later row goes above it."""
    T, R = meta.shape
    dev = meta.device
    jac = jacobi_phases(meta) >= 0
    link = ((meta.to(torch.int64) >> 31) & 1) == 1
    meta = meta.to(torch.int64)
    act = ((meta >> 16) & 1) == 1
    b0 = (meta & 0xFF) - 1
    b1 = ((meta >> 8) & 0xFF) - 1
    mp = _master(meta) if friction else torch.full_like(meta, -1)
    c0 = torch.where(b0 >= 0, b0, MAX_B)      # column MAX_B: the world
    c1 = torch.where(b1 >= 0, b1, MAX_B)
    last = torch.zeros((T, MAX_B + 1), dtype=torch.int64, device=dev)
    lvl = torch.zeros((T, R), dtype=torch.int64, device=dev)
    tt = torch.arange(T, device=dev)
    zero = torch.zeros(T, dtype=torch.int64, device=dev)
    floor, nlev, phase = zero, zero, zero    # phase: the open phase's level
    for r in range(R):
        a, m = act[:, r], mp[:, r]
        phase = torch.where(link[:, r], phase, zero)
        l = torch.maximum(torch.maximum(lvl[:, r], floor),
                          torch.maximum(last[tt, c0[:, r]],
                                        last[tt, c1[:, r]]))
        mc = m.clamp(0, max(R - 1, 0))
        l = torch.where((m >= 0) & (m < r),
                        torch.maximum(l, lvl[tt, mc]), l) + 1
        j = jac[:, r]
        l = torch.where(j, torch.where(phase > 0, phase, nlev + 1), l)
        phase = torch.where(j & a, l, phase)
        floor = torch.where(j & a, l, floor)
        cur = lvl[tt, mc]
        lvl[tt, mc] = torch.where(a & (m > r), torch.maximum(cur, l), cur)
        l = torch.where(a, l, 0)
        last[tt, c0[:, r]] = torch.where(a, l, last[tt, c0[:, r]])
        last[tt, c1[:, r]] = torch.where(a, l, last[tt, c1[:, r]])
        last[:, MAX_B] = 0
        nlev = torch.maximum(nlev, l)
        lvl[:, r] = l
    return lvl


def _single_levels(meta, lvl):
    """(T, R) bool: the row's level is single-body (every row of it has the
    world as b0, a body b1 < 31, no master and no jacobi phase): the
    kernel runs such a level's rows on their bodies' lanes, in body
    order."""
    jac = jacobi_phases(meta) >= 0
    meta = meta.to(torch.int64)
    T, R = lvl.shape
    b0 = (meta & 0xFF) - 1
    b1 = ((meta >> 8) & 0xFF) - 1
    single = (b0 < 0) & (b1 >= 0) & (b1 < 31) & (_master(meta) < 0) & ~jac
    ok = torch.ones((T, R + 1), dtype=torch.int64, device=lvl.device)
    ok.scatter_reduce_(1, lvl, single.to(torch.int64), "amin")
    return (torch.gather(ok, 1, lvl) == 1) & (lvl > 0)


def _level_order(lvl, single=None, b1=None):
    """(T, R) permutation: active rows by level, then by body in a
    single-body level and by row in any other; inactive rows last."""
    T, R = lvl.shape
    r = torch.arange(R, device=lvl.device).expand(T, R)
    big = R + 1
    within = r if single is None else torch.where(single, b1, r)
    key = torch.where(lvl > 0, lvl, big) * max(R, 1) + within
    return torch.argsort(key, dim=1)


def wave_schedule(lm, am) -> WaveSchedule:
    """The row sweep kernel's schedule of each track's rows: the linear and
    the angular rows levelled separately (`_levels`), the level-order
    permutation (`_level_order`) and the linear meta words in that order
    with their master positions remapped.  Vectorised over tracks, a loop
    over rows."""
    lvl_l, lvl_a = _levels(lm, True), _levels(am, False)
    b1 = ((lm.to(torch.int64) >> 8) & 0xFF) - 1
    perm_l = _level_order(lvl_l, _single_levels(lm, lvl_l), b1)
    perm_a = _level_order(lvl_a)
    T, R = lm.shape
    inv = torch.empty_like(perm_l)
    inv.scatter_(1, perm_l, torch.arange(R, device=lm.device).expand(T, R))
    meta = torch.gather(lm, 1, perm_l)
    m = _master(meta)
    nm = torch.where(m >= 0, torch.gather(inv, 1, m.clamp(min=0)), -1)
    meta = (meta & 0x1FFFF) | ((nm + 1) << 17).to(torch.int32)
    jac = torch.gather(jacobi_phases(lm) >= 0, 1, perm_l)
    return WaveSchedule(lvl_l, lvl_a, perm_l, perm_a, meta, jac)


def synthetic_rows(T: int, Rl: int, Ra: int, B: int, seed: int,
                   device="cpu", jacobi: int = 0):
    """(mom0, massinv, rows): seeded rows with the schedule's hard cases.
    B bodies with ~27% of the rows on body 1 (as a hand's palm has), half
    the rows on one body, 3% on no body; friction rows whose master is one
    or two rows before them, 15% of those a later row; 15% of the rows
    inactive on each track; 10% of the angular targets -FLT_MAX.  jacobi:
    that many units of 3 rows (normal, then two friction rows whose master
    is the normal row) behind the others, on random body pairs that share
    bodies (a fifth with the world as b0), in 3 jacobi phases (the units'
    normal rows, then their first and second friction rows)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32))
    u = lambda lo, hi, *s: torch.tensor(rng.uniform(lo, hi, s)
                                        .astype(np.float32))

    def bodies(R):
        b1 = np.where(rng.random(R) < 0.27, 1, rng.integers(0, B, R))
        b0 = np.where(rng.random(R) < 0.5, -1, rng.integers(0, B, R))
        b0 = np.where(b0 == b1, -1, b0)
        world = rng.random(R) < 0.03                    # on no body
        b0[world], b1[world] = -1, -1
        return b0, b1
    b0, b1 = bodies(Rl)
    mpos = np.full(Rl, -1)
    fr = np.nonzero(rng.random(Rl) < 0.2)[0]
    mpos[fr] = np.maximum(fr - rng.integers(1, 3, len(fr)), 0)
    late = fr[rng.random(len(fr)) < 0.15]
    mpos[late] = np.minimum(late + rng.integers(1, 9, len(late)), Rl - 1)
    phase = np.full(Rl, -1)
    if jacobi:
        n = jacobi
        jb1 = rng.integers(1, B, n)
        jb0 = np.where(rng.random(n) < 0.2, -1, rng.integers(0, B, n))
        jb0 = np.where(jb0 == jb1, 0, jb0)
        b0 = np.concatenate([b0, np.tile(jb0, 3)])
        b1 = np.concatenate([b1, np.tile(jb1, 3)])
        jm = np.concatenate([np.full(n, -1), Rl + np.arange(n),
                             Rl + np.arange(n)])
        mpos = np.concatenate([mpos, jm])
        phase = np.concatenate([phase, np.repeat(np.arange(3), n)])
        Rl += 3 * n
    lo, hi = -u(0.1, 1.0, T, Rl), u(0.1, 1.0, T, Rl)
    lin = linear_block(
        b0, b1, f(T, Rl, 3), f(T, Rl, 3) * 0.1, f(T, Rl, 3) * 0.1,
        f(T, Rl, 3) * 0.1, f(T, Rl, 3) * 0.1, u(0.2, 1.0, T, Rl),
        f(T, Rl), f(T, Rl), lo, hi, u(0.1, 1.0, T, Rl),
        torch.tensor(rng.random((T, Rl)) < 0.85), mpos, phase)
    ab0, ab1 = bodies(Ra)
    ts = f(T, Ra)
    ts[torch.tensor(rng.random((T, Ra)) < 0.1)] = -FLT_MAX
    tsp = torch.where(torch.tensor(rng.random((T, Ra)) < 0.1),
                      torch.full_like(ts, -FLT_MAX), f(T, Ra))
    ang = angular_block(ab0, ab1, f(T, Ra, 3), f(T, Ra, 3) * 0.1,
                        f(T, Ra, 3) * 0.1, u(0.2, 1.0, T, Ra), ts, tsp,
                        -u(0.1, 1.0, T, Ra), u(0.1, 1.0, T, Ra),
                        torch.tensor(rng.random((T, Ra)) < 0.85))
    rows = sweep_rows([lin], [ang], T, "cpu")
    return ((f(T, B, 6) * 0.1).to(device), u(0.5, 2.0, B).to(device),
            rows._replace(lf=rows.lf.to(device), af=rows.af.to(device)))


# ---------------------------------------------------------------------------
# the sweeps: plain PyTorch version
# ---------------------------------------------------------------------------

def _ordered_add(mom, slots, deltas, ok, B):
    """Add each body's deltas in entry order and apply the sum once (a
    jacobi phase, as the kernel adds them): mom (T * (B + 1), 6) the
    momentum table, slots (T, E) its indices, deltas (T, E, 6), ok (T, E)
    the entries that count (active rows, real bodies)."""
    T, E = slots.shape
    dev = slots.device
    local = slots - (torch.arange(T, device=dev) * (B + 1))[:, None]
    oh = (local[..., None] == torch.arange(B + 1, device=dev)) \
        & ok[..., None]                                     # (T, E, B+1)
    cnt = oh.sum(1)                                         # (T, B+1)
    K = int(cnt.max()) if cnt.numel() else 0
    if K == 0:
        return
    rank = torch.cumsum(oh.to(torch.int64), dim=1) - 1
    t_i, e_i, b_i = torch.nonzero(oh, as_tuple=True)
    ent = torch.full((T, B + 1, K), E, dtype=torch.int64, device=dev)
    ent[t_i, b_i, rank[t_i, e_i, b_i]] = e_i
    dpad = torch.cat([deltas, deltas.new_zeros((T, 1, 6))], dim=1)
    for k in range(K):
        dk = torch.gather(dpad, 1, ent[:, :, k, None].expand(T, B + 1, 6))
        acc = dk if k == 0 else torch.where((k < cnt)[..., None], acc + dk,
                                            acc)
    m = mom.view(T, B + 1, 6)
    m.copy_(torch.where((cnt > 0)[..., None], m + acc, m))


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
    active on no track are None.  meta (R, T)."""
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
    """Plain PyTorch version of the kernel (same operations, row order).
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
    lm, am = rows.lm.T, rows.am.T                            # (R, T)
    n, J0, J1 = lf[..., 0:3], lf[..., 3:6], lf[..., 6:9]      # (T, R, 3)
    K0, K1 = lf[..., 9:12], lf[..., 12:15]
    tl = lambda *xs: torch.cat(xs, dim=-1).transpose(0, 1)  # (R, T, 12)
    lin = _row_tables(lm, B, T, base, mi, tl(n, K1, n, K0),
                      tl(n, J1, -n, -J0))
    z3 = torch.zeros_like(af[..., 0:3])
    ax, aK0, aK1 = af[..., 0:3], af[..., 3:6], af[..., 6:9]
    ang = _row_tables(am, B, T, base, mi, tl(z3, aK1, z3, aK0),
                      tl(z3, ax, z3, -ax))
    lmpos = _master(lm[:, 0]).tolist() if T else []
    ph = jacobi_phases(rows.lm[:1])[0].tolist() if T else []
    jac_end = [p >= 0 and (r + 1 == len(ph) or ph[r + 1] != p)
               for r, p in enumerate(ph)]
    lft, aft = lf.permute(1, 2, 0), af.permute(1, 2, 0)      # (R, F, T)
    # each row's fields as (T,) tensors, taken once: the linear rows'
    # [-ts, -ts post], dinv, lo, hi, the friction coefficient; the
    # angular rows' [ts, ts post], spin-to-torque, lo, hi and the masks of
    # the rows that take torque (a target of -FLT_MAX takes none)
    lrows = []
    for r, row in enumerate(lin):
        if row is None:
            lrows.append(None)
            continue
        idx, C, D, MI, act, all_act = row
        f = lft[r]
        lrows.append((idx, C, D, MI, None if all_act else act,
                      (-f[16], -f[17]), f[15], f[18], f[19], f[20],
                      lmpos[r]))
    arows = []
    for r, row in enumerate(ang):
        if row is None:
            arows.append(None)
            continue
        f = aft[r]
        arows.append((row[0], row[1], row[2], (f[10], f[11]), f[9], f[12],
                      f[13], tuple(row[4] & (f[k] != -FLT_MAX)
                                   for k in (10, 11))))
    isum = [torch.zeros(T, device=dev) for _ in range(len(lrows))]
    torq = [torch.zeros(T, device=dev) for _ in range(len(arows))]
    out = torch.empty((T, 2, B, 6), device=dev)
    total = iterations + iterations_post
    for s in range(total + 1):
        if s == iterations:
            out[:, 0] = mom.view(T, B + 1, 6)[:, :B]
        if s == total:
            break
        k = 1 if s >= iterations else 0
        pend = []                       # the open jacobi phase's rows
        for r, row in enumerate(lrows):
            if row is None:
                if jac_end and jac_end[r] and pend:
                    _jacobi_apply(mom, pend, T, B)
                    pend = []
                continue
            idx, C, D, MI, act, nts, dinv, lo, hi, fcoef, mpos = row
            x, y, z = (mom[idx].view(T, 12) * C).view(T, 4, 3).unbind(-1)
            d0, d1, d2, d3 = (((x + y) + z) * MI).unbind(-1)
            vn = ((d0 + d1) - d2) - d3
            imp = (nts[k] - vn) * dinv
            own = isum[r]
            if mpos >= 0:
                hi = fcoef * isum[mpos]
                lo = -hi
            imp = torch.maximum(torch.minimum(imp, hi - own), lo - own)
            if act is not None:
                imp = torch.where(act, imp, zero)
            isum[r] = own + imp
            if ph[r] >= 0:
                pend.append((idx, (imp[:, None] * D).view(T, 2, 6), act))
                if jac_end[r]:
                    _jacobi_apply(mom, pend, T, B)
                    pend = []
                continue
            mom.index_add_(0, idx, (imp[:, None] * D).view(2 * T, 6))
        for r, row in enumerate(arows):
            if row is None:
                continue
            idx, C, D, ts, stt, lo, hi, amask = row
            _, d1, _, d3 = _dots4(mom[idx].view(T, 12), C).unbind(-1)
            dtq = (ts[k] - (d1 - d3)) * stt
            own = torq[r]
            dtq = torch.maximum(torch.minimum(dtq, hi - own), lo - own)
            dtq = torch.where(amask[k], dtq, zero)
            mom.index_add_(0, idx, (dtq[:, None] * D).view(2 * T, 6))
            torq[r] = own + dtq
    out[:, 1] = mom.view(T, B + 1, 6)[:, :B]
    return out


def _jacobi_apply(mom, pend, T, B):
    """A jacobi phase's rows (idx (2T,), deltas (T, 2, 6), act (T,) or
    None each, in row order) applied: _ordered_add over their real
    bodies' sides."""
    slots = torch.stack([i.view(T, 2) for i, _, _ in pend], dim=1)
    deltas = torch.stack([d for _, d, _ in pend], dim=1)   # (T, W, 2, 6)
    ok = torch.stack([torch.ones(T, dtype=torch.bool, device=mom.device)
                      if a is None else a for _, _, a in pend], dim=1)
    base = (torch.arange(T, device=mom.device) * (B + 1))[:, None, None]
    ok = ok[..., None] & (slots - base != B)
    W = len(pend)
    _ordered_add(mom, slots.reshape(T, 2 * W), deltas.reshape(T, 2 * W, 6),
                 ok.reshape(T, 2 * W), B)


def _level_steps(level, perm, R):
    """The level steps of one kind of rows: per level l = 1..L the (T, W_l)
    positions, in the schedule's order perm, of each track's rows at level
    l, padded with R (a row that does nothing)."""
    T = level.shape[0]
    L = int(level.amax()) if level.numel() else 0
    if L == 0:
        return []
    cnt = torch.zeros((T, L + 1), dtype=torch.int64, device=level.device)
    cnt.scatter_add_(1, level, torch.ones_like(level))
    cnt = cnt[:, 1:]                                   # inactive rows last
    start = torch.cumsum(cnt, 1) - cnt
    widths = cnt.amax(0).tolist()
    steps = []
    for lv, w in enumerate(widths):
        j = torch.arange(w, device=level.device)
        steps.append(torch.where(j < cnt[:, lv:lv + 1], start[:, lv:lv + 1] + j,
                                 torch.full_like(j, R)))
    return steps


def _wave_tables(fields, meta, B, T, base, mi, Cs, Ds):
    """The rows' tables in the schedule's order, a padding row appended:
    momentum-table indices (T, R+1, 2) [b1, b0], the dot coefficients and
    impulse directions (T, R+1, 12) (the world's half zeroed), the inverse
    masses (T, R+1, 4) [mi1, 1, mi0, 1], the active mask and the fields.
    Cs/Ds: the coefficient and direction blocks of fields (T, R, 3)."""
    pad = lambda x: torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
    i0, i1, act = _unpack(pad(meta), B)                    # padding: world
    C = pad(torch.cat(Cs, dim=-1))
    keep = torch.stack([i1 < B, i0 < B], dim=-1).to(torch.float32)
    D = pad(torch.cat(Ds, dim=-1)) * keep.repeat_interleave(6, dim=-1)
    one = torch.ones_like(mi[i1])
    return dict(idx=torch.stack([i1 + base, i0 + base], dim=-1), C=C, D=D,
                MI=torch.stack([mi[i1], one, mi[i0], one], dim=-1), act=act,
                f=pad(fields))


def _at(tables, P):
    """The tables' rows at the level step's positions P (T, W)."""
    return {k: torch.gather(v, 1, P.reshape(P.shape + (1,) * (v.dim() - 2))
                            .expand(P.shape + v.shape[2:]))
            for k, v in tables.items()}


@torch.inference_mode()
def row_sweep_waves(mom0, massinv, rows: SweepRows, iterations: int,
                    iterations_post: int):
    """row_sweep_plain in the kernel's wavefront order (wave_schedule): each
    sweep runs a track's linear rows level by level, then its angular rows,
    a level's rows (body-disjoint, so they commute exactly) at once; a
    friction row's master is in an earlier level, or a later one where
    the row order has it later.  The same operations on every row, so the
    momenta equal row_sweep_plain's (tests/test_torch_row_waves.py), with
    one step a level instead of one a row."""
    T, B = mom0.shape[0], mom0.shape[1]
    dev = mom0.device
    mom = torch.zeros((T, B + 1, 6), device=dev)
    mom[:, :B] = mom0
    mom = mom.view(T * (B + 1), 6)
    mi = torch.zeros(B + 1, device=dev)
    mi[:B] = massinv
    base = (torch.arange(T, device=dev) * (B + 1))[:, None]
    zero = torch.zeros((), device=dev)
    ws = wave_schedule(rows.lm, rows.am)
    Rl, Ra = rows.lf.shape[1], rows.af.shape[1]
    lf = torch.gather(rows.lf, 1, ws.lin_perm[..., None].expand(-1, -1, LW))
    af = torch.gather(rows.af, 1, ws.ang_perm[..., None].expand(-1, -1, AW))
    n, J0, J1 = lf[..., 0:3], lf[..., 3:6], lf[..., 6:9]
    K0, K1 = lf[..., 9:12], lf[..., 12:15]
    lt = _wave_tables(lf[..., :NLF], ws.lm.to(torch.int64), B, T, base, mi,
                      (n, K1, n, K0), (n, J1, -n, -J0))
    lt["mpos"] = torch.cat([_master(ws.lm),
                            torch.full((T, 1), -1, device=dev,
                                       dtype=torch.int64)], dim=1)
    lt["jac"] = torch.cat([ws.lin_jac, torch.zeros((T, 1), device=dev,
                                                   dtype=torch.bool)], dim=1)
    ax, aK0, aK1 = af[..., 0:3], af[..., 3:6], af[..., 6:9]
    z3 = torch.zeros_like(ax)
    at = _wave_tables(af[..., :NAF], torch.gather(rows.am, 1, ws.ang_perm)
                      .to(torch.int64), B, T, base, mi, (z3, aK1, z3, aK0),
                      (z3, ax, z3, -ax))
    lin = []
    for P in _level_steps(ws.lin_level, ws.lin_perm, Rl):
        x = _at(lt, P)
        f = x["f"].permute(2, 0, 1)                        # (F, T, W)
        fr = x["mpos"] >= 0
        act = x["act"]
        jac = bool(x["jac"].any())
        real = (x["idx"] - base[..., None] != B) & act[..., None]
        lin.append((P, x["idx"].reshape(-1), x["C"], x["D"], x["MI"],
                    None if bool(act.all()) else act, (-f[16], -f[17]),
                    f[15], f[18], f[19], f[20],
                    fr if bool(fr.any()) else None, x["mpos"].clamp(min=0),
                    real.reshape(T, -1) if jac else None))
    ang = []
    for P in _level_steps(ws.ang_level, ws.ang_perm, Ra):
        x = _at(at, P)
        f = x["f"].permute(2, 0, 1)
        masks = [x["act"] & (f[k] != -FLT_MAX) for k in (10, 11)]
        ang.append((P, x["idx"].reshape(-1), x["C"], x["D"], (f[10], f[11]),
                    f[9], f[12], f[13],
                    tuple(None if bool(m.all()) else m for m in masks)))
    isum = torch.zeros((T, Rl + 1), device=dev)
    torq = torch.zeros((T, Ra + 1), device=dev)
    out = torch.empty((T, 2, B, 6), device=dev)
    total = iterations + iterations_post
    for s in range(total + 1):
        if s == iterations:
            out[:, 0] = mom.view(T, B + 1, 6)[:, :B]
        if s == total:
            break
        k = 1 if s >= iterations else 0
        for (P, idx, C, D, MI, act, nts, dinv, lo, hi, fcoef, fr,
             mpos, jac) in lin:
            W = P.shape[1]
            x, y, z = (mom[idx].view(T, W, 12) * C).view(T, W, 4, 3) \
                .unbind(-1)
            d0, d1, d2, d3 = (((x + y) + z) * MI).unbind(-1)
            vn = ((d0 + d1) - d2) - d3
            imp = (nts[k] - vn) * dinv
            own = torch.gather(isum, 1, P)
            if fr is not None:
                hf = fcoef * torch.gather(isum, 1, mpos)
                hi, lo = torch.where(fr, hf, hi), torch.where(fr, -hf, lo)
            imp = torch.maximum(torch.minimum(imp, hi - own), lo - own)
            if act is not None:
                imp = torch.where(act, imp, zero)
            isum.scatter_(1, P, own + imp)
            if jac is not None:         # a jacobi phase's level
                _ordered_add(mom, idx.view(T, 2 * W),
                             (imp[..., None] * D).view(T, 2 * W, 6), jac, B)
                continue
            mom.index_add_(0, idx, (imp[..., None] * D).view(-1, 6))
        for P, idx, C, D, ts, stt, lo, hi, amask in ang:
            W = P.shape[1]
            p = (mom[idx].view(T, W, 12) * C).view(T, W, 4, 3)
            _, d1, _, d3 = ((p[..., 0] + p[..., 1]) + p[..., 2]).unbind(-1)
            dtq = (ts[k] - (d1 - d3)) * stt
            own = torch.gather(torq, 1, P)
            dtq = torch.maximum(torch.minimum(dtq, hi - own), lo - own)
            if amask[k] is not None:
                dtq = torch.where(amask[k], dtq, zero)
            mom.index_add_(0, idx, (dtq[..., None] * D).view(-1, 6))
            torq.scatter_(1, P, own + dtq)
    out[:, 1] = mom.view(T, B + 1, 6)[:, :B]
    return out


# ---------------------------------------------------------------------------
# the sweeps: kernel wrapper
# ---------------------------------------------------------------------------

class _Args(ctypes.Structure):
    _fields_ = [("mom0", ctypes.c_void_p), ("massinv", ctypes.c_void_p),
                ("lf", ctypes.c_void_p), ("af", ctypes.c_void_p),
                ("stream", ctypes.c_void_p), ("steps", ctypes.c_void_p),
                ("out", ctypes.c_void_p),
                ("cycles", ctypes.c_void_p),
                ("T", ctypes.c_int), ("B", ctypes.c_int),
                ("n_lin", ctypes.c_int), ("n_ang", ctypes.c_int),
                ("iters", ctypes.c_int), ("iters_post", ctypes.c_int),
                ("jmax", ctypes.c_int)]


REC = 24                 # floats of a row's record in the kernel's stream


@kernels.wrapper("row_sweep")
def row_sweep(mom0, massinv, rows: SweepRows, iterations: int,
              iterations_post: int, cycles=None):
    """Kernel wrapper: see the module docstring for the layouts.  cycles:
    an optional (T, 4) int64 CUDA tensor that receives each track's
    clock64 counts [prologue, sweeps, level steps a sweep, active rows]."""
    if mom0.device.type == "cpu":
        return row_sweep_waves(mom0, massinv, rows, iterations,
                               iterations_post)
    T, B = mom0.shape[0], mom0.shape[1]
    Rl, Ra = rows.lf.shape[1], rows.af.shape[1]
    if B > MAX_B:
        raise ValueError(f"row sweep: at most {MAX_B} bodies, got {B}")
    if Rl + Ra > MAX_ROWS:
        raise ValueError(f"row sweep kernel: at most {MAX_ROWS} rows "
                         f"(linear and angular), got {Rl + Ra}")
    if rows.jmax > MAX_JACOBI_ROWS:
        raise ValueError(f"row sweep kernel: at most {MAX_JACOBI_ROWS} "
                         f"rows a jacobi phase, got {rows.jmax}")
    args = [x.contiguous() for x in (mom0, massinv)] + [
        r if r.data_ptr() % 16 == 0 else r.clone()     # 16-byte rows
        for r in (x.contiguous() for x in (rows.lf, rows.af))]
    dev = kernels.require_cuda(*args)
    mom0, massinv, lf, af = args
    stream = torch.empty((T, Rl + Ra, REC), device=dev)
    steps = torch.empty((T, Rl + Ra, 2), dtype=torch.int32, device=dev)
    out = torch.empty((T, 2, B, 6), device=dev)
    cyc = 0
    if cycles is not None:
        kernels.require_cuda(cycles)
        if cycles.shape != (T, 4) or cycles.dtype != torch.int64:
            raise ValueError("cycles: a (T, 4) int64 tensor")
        cyc = cycles.data_ptr()
    a = _Args(mom0.data_ptr(), massinv.data_ptr(), lf.data_ptr(),
              af.data_ptr(), stream.data_ptr(), steps.data_ptr(),
              out.data_ptr(), cyc, T, B,
              Rl, Ra, iterations, iterations_post, rows.jmax)
    err = kernels.library().hts_row_sweep(ctypes.byref(a),
                                          kernels.stream_ptr(dev))
    kernels.check(err, "row_sweep")
    row_sweep.launches += 1
    if rows.jmax:
        row_sweep.kinds["jacobi"] = row_sweep.kinds.get("jacobi", 0) + 1
    return out


def occupancy(rows: SweepRows, B: int) -> int:
    """Tracks (blocks) an SM holds at once for these rows (a measurement;
    0 if the kernel cannot hold them)."""
    a = _Args(B=B, n_lin=rows.lf.shape[1], n_ang=rows.af.shape[1],
              jmax=rows.jmax)
    return kernels.library().hts_row_sweep_occupancy(ctypes.byref(a))
