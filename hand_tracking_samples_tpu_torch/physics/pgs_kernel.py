"""The whole 16+4-sweep PGS solve: kernel 4 of the kernel path, with its
host-side plan (reference semantics: third_party/physics.h:543-587).

The solve is the colored solver's schedule (physics/colored.py) run inside
one kernel:
  * single-body rows (cloud, chamber; b0 = world) in CS slots of (14, BP)
    channels [n(3) J1(3) K1(3) dinv tsmain tspost fmin*dt fmax*dt]: slot c
    of every body solves at once (same-body rows keep their slot order,
    cross-body rows commute);
  * pair rows (joints, contacts) in units of U consecutive rows on one
    static body pair, precedence-colored into groups of body-disjoint units;
    friction rows read the accumulated impulse of their contact's normal
    row;
  * with contacts_mode="jacobi" the contact class is one group of every
    collide pair (JAX pgs_kernel.py:109): each unit runs its U rows on the
    momenta of the group's start (its own impulses carried from row to
    row), and each body then adds its units' deltas in unit order
    (`body_off` / `body_ent`, the plan's per-body lists) and applies the
    sum once: the Pallas kernel's scatter matmul (:126), summed in a
    fixed order;
  * the last iterations_post sweeps use the bias-free target speeds.

`pgs_solve` is the wrapper: on CUDA tensors it launches csrc/pgs_kernel.cu
(which replaces the Pallas kernel hand_tracking_samples_tpu/physics/
pgs_kernel.py:185, launched by _pallas_solve at :479), on CPU tensors it runs
`pgs_solve_plain`, the same sweeps in plain PyTorch.  Layouts, tracks
leading (the port has no lane blocks, so no track padding):
  mom0     (T, 6, BP)           momenta, rows [lin xyz, ang xyz] x bodies
  mi       (BP,)                inverse masses (0 on padded bodies)
  singles  (T, CS, 14, BP)
  lin rows (T, n_phases, 23, W) per class, phase p = group*U + u
  ang rows (T, n_phases, 14, W)
  out      (T, 2, 6, BP)        momenta after the main and the post sweeps
Both versions stop the slot loop at the last slot with an active row.  That
is exact only if every single-body row class has fmin <= 0 <= fmax (an
inactive slot then clamps to a zero impulse); `check_slot_bound` asserts it
on the host before a solve.
"""
from __future__ import annotations

import ctypes
import hashlib
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..maths import fma as fq
from ..maths.quat import cross
from .colored import precedence_coloring

BP = 24          # body slots (17 padded; at most 32, one warp)
MAX_CLASSES = 4
MAX_GROUPS = 256
MAX_JACOBI_W = 96    # a jacobi class's units: three a lane of one warp


def _batched_world_iinv(q, tinv, massinv):
    """_world_iinv (physics.h:518) elementwise over (..., B): R tinv R^T
    massinv with the JAX package's term order, contracted as its CPU build
    runs it (maths.fma).  q (..., B, 4), tinv (B, 3, 3), massinv (B,) ->
    (..., B, 3, 3)."""
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    R = torch.stack([fq.qrot(q, eye[i].expand(q.shape[:-1] + (3,)))
                     for i in range(3)], dim=-1)
    A = torch.stack([torch.stack(
        [fq.dot3(R[..., i, 0], R[..., i, 1], R[..., i, 2], tinv[..., 0, j],
                 tinv[..., 1, j], tinv[..., 2, j])
         for j in range(3)], dim=-1) for i in range(3)], dim=-2)
    W = torch.stack([torch.stack(
        [fq.dot3(A[..., i, 0], A[..., i, 1], A[..., i, 2], R[..., j, 0],
                 R[..., j, 1], R[..., j, 2])
         for j in range(3)], dim=-1) for i in range(3)], dim=-2)
    return W * massinv[..., None, None]


def _mv33(M, v):
    """(..., 3, 3) @ (..., 3) as explicit products, in the JAX order."""
    return torch.stack(
        [M[..., i, 0] * v[..., 0] + M[..., i, 1] * v[..., 1]
         + M[..., i, 2] * v[..., 2] for i in range(3)], dim=-1)


# ---------------------------------------------------------------------------
# host plan
# ---------------------------------------------------------------------------

class PairClassPlan(NamedTuple):
    """Static schedule of one pair-row class."""
    kind: str              # "lin" | "ang"
    U: int                 # rows per unit (consecutive, same body pair)
    W: int                 # units per group, padded
    n_groups: int
    n_phases: int          # n_groups * U
    row_index: np.ndarray  # (n_phases * W,) into the class's rows, -1 pad
    unit_b0: np.ndarray    # (n_groups, W) int32 body ids, -1 world / pad
    unit_b1: np.ndarray
    friction: bool
    b0: np.ndarray         # (R,) static per-row body ids (prep gathers)
    b1: np.ndarray
    jacobi: bool = False   # one group whose units share bodies
    body_off: np.ndarray = None   # jacobi: (BP + 1,) int32 offsets into
    body_ent: np.ndarray = None   # (entries,) int32 unit << 1 | side, each
    # body's (unit, side) in unit order (side 0: b0, 1: b1)


class SolvePlan(NamedTuple):
    key: str
    CS: int
    lin_classes: tuple
    ang_classes: tuple
    massinv: np.ndarray    # (B,) host copy
    bp: int = BP


def build_pair_class(kind: str, unit_b0, unit_b1, U: int,
                     friction: bool = False,
                     mode: str = "exact") -> PairClassPlan:
    """Schedule a class of n_units*U rows (row i*U+u belongs to unit i).

    mode="exact": precedence coloring over units; the concatenated phases
    are an exact reordering of the sequential sweep (conflicting units keep
    order) and every group's units touch disjoint bodies.  mode="jacobi"
    (linear classes): all units in one group, their impulses applied at
    once through the per-body lists (JAX pgs_kernel.py:109)."""
    if mode not in ("exact", "jacobi") or (mode == "jacobi"
                                           and kind != "lin"):
        raise ValueError(f"pair class mode {mode!r} for kind {kind!r}")
    unit_b0 = np.asarray(unit_b0, np.int32)
    unit_b1 = np.asarray(unit_b1, np.int32)
    n_units = len(unit_b0)
    if mode == "jacobi":
        groups = [list(range(n_units))]
    else:
        groups = precedence_coloring(list(zip(unit_b0, unit_b1)))
    G = len(groups)
    W = max(8, -(-max(len(g) for g in groups) // 8) * 8)
    row_index = np.full((G, U, W), -1, np.int32)
    ub0 = np.full((G, W), -1, np.int32)
    ub1 = np.full((G, W), -1, np.int32)
    for g, us in enumerate(groups):
        for w, u in enumerate(us):
            ub0[g, w] = unit_b0[u]
            ub1[g, w] = unit_b1[u]
            for uu in range(U):
                row_index[g, uu, w] = u * U + uu
    off = ent = None
    if mode == "jacobi":
        lists = [[(w << 1) | side for w in range(W)
                  for side, ub in ((0, ub0), (1, ub1)) if ub[0, w] == b]
                 for b in range(BP)]
        off = np.cumsum([0] + [len(x) for x in lists]).astype(np.int32)
        ent = np.asarray(sum(lists, []), np.int32)
    return PairClassPlan(kind=kind, U=U, W=W, n_groups=G, n_phases=G * U,
                         row_index=row_index.reshape(-1), unit_b0=ub0,
                         unit_b1=ub1, friction=friction,
                         b0=np.repeat(unit_b0, U), b1=np.repeat(unit_b1, U),
                         jacobi=mode == "jacobi", body_off=off,
                         body_ent=ent)


_PLANS: dict = {}


def _model_digest(model_np) -> str:
    h = hashlib.sha1()
    for k in ("massinv", "collide_pairs", "joint_rbi0", "joint_rbi1"):
        h.update(np.asarray(model_np[k]).tobytes())
    return h.hexdigest()[:12]


def build_dynamics_plan(model_np: dict, CS: int, contacts_mode: str = "exact",
                        use_contacts: bool = True) -> SolvePlan:
    """Solve plan of the main-fit FitPointCloud row structure:
    [CS single-body slots][joint nailed U=3][contacts U=3*CONTACT_POINTS,
    friction]; angular: [joint ranges U=6] (physmodel.h:321-334,
    physics.h:451-489)."""
    from .contacts import CONTACT_POINTS
    key = f"dyn:{_model_digest(model_np)}:{CS}:{contacts_mode}:{use_contacts}"
    if key in _PLANS:
        return _PLANS[key]
    j0 = np.asarray(model_np["joint_rbi0"])
    j1 = np.asarray(model_np["joint_rbi1"])
    lin = [build_pair_class("lin", j0, j1, 3)]
    if use_contacts:
        pairs = np.asarray(model_np["collide_pairs"])
        lin.append(build_pair_class("lin", pairs[:, 0], pairs[:, 1],
                                    3 * CONTACT_POINTS, friction=True,
                                    mode=contacts_mode))
    ang = [build_pair_class("ang", j0, j1, 6)]
    plan = SolvePlan(key=key, CS=CS, lin_classes=tuple(lin),
                     ang_classes=tuple(ang),
                     massinv=np.asarray(model_np["massinv"], np.float32))
    _PLANS[key] = plan
    return plan


def build_multistep_plan(model_np: dict, CS: int, has_angles: bool,
                         contacts_mode: str = "exact",
                         use_contacts: bool = True) -> SolvePlan:
    """Solve plan of one MultiStepSim step (handtrack.h:658-688): the
    dynamics plan's linear classes; angular classes [ApplyAngles palm
    drive (world, 1) U=3][the 9 finger cones U=1] when has_angles, then
    [the arm cone (world, 0) U=1][joint ranges U=6]: with angles, exactly
    MAX_CLASSES angular classes."""
    from .contacts import CONTACT_POINTS
    key = (f"ms:{_model_digest(model_np)}:{CS}:{int(has_angles)}:"
           f"{contacts_mode}:{use_contacts}")
    if key in _PLANS:
        return _PLANS[key]
    j0 = np.asarray(model_np["joint_rbi0"])
    j1 = np.asarray(model_np["joint_rbi1"])
    lin = [build_pair_class("lin", j0, j1, 3)]
    if use_contacts:
        pairs = np.asarray(model_np["collide_pairs"])
        lin.append(build_pair_class("lin", pairs[:, 0], pairs[:, 1],
                                    3 * CONTACT_POINTS, friction=True,
                                    mode=contacts_mode))
    ang = []
    if has_angles:
        # tracker.runtime.apply_angles emission: drive, then the cones
        cone_b1 = [4]
        for finger in (1, 2, 3, 4):
            cone_b1 += [3 + finger * 3, 2 + finger * 3]
        ang.append(build_pair_class("ang", [-1], [1], 3))
        ang.append(build_pair_class("ang", [1] * 9, cone_b1, 1))
    ang.append(build_pair_class("ang", [-1], [0], 1))
    ang.append(build_pair_class("ang", j0, j1, 6))
    plan = SolvePlan(key=key, CS=CS, lin_classes=tuple(lin),
                     ang_classes=tuple(ang),
                     massinv=np.asarray(model_np["massinv"], np.float32))
    _PLANS[key] = plan
    return plan


def build_unibody_plan(CS: int) -> SolvePlan:
    """Solve plan of UnibodyFit (handtrack.h:444-470): one free body, CS
    cloud rows solved in their sequential order, no pair classes, 8 body
    slots (body 0 real)."""
    key = f"uni:{CS}"
    if key in _PLANS:
        return _PLANS[key]
    plan = SolvePlan(key=key, CS=CS, lin_classes=(), ang_classes=(),
                     massinv=np.ones(1, np.float32), bp=8)
    _PLANS[key] = plan
    return plan


def check_slot_bound(*limits):
    """The last-active-slot bound is exact only when every single-body row
    class keeps fmin <= 0 <= fmax.  limits: (fmin, fmax) pairs of the
    classes' static force limits (scalars or arrays)."""
    for fmin, fmax in limits:
        fmin = np.asarray(fmin, np.float64)
        fmax = np.asarray(fmax, np.float64)
        if not ((fmin <= 0).all() and (fmax >= 0).all()):
            raise ValueError(
                "the slot bound needs fmin <= 0 <= fmax for every "
                f"single-body row class: got fmin {fmin.max()} fmax "
                f"{fmax.min()}")


# ---------------------------------------------------------------------------
# prep (batched over tracks, T-leading)
# ---------------------------------------------------------------------------

def _to_planes(channels, bp: int = BP):
    """channels: list of (T, C, B) tensors -> (T, C, nch, bp)."""
    x = torch.stack(channels, dim=2)                    # (T, C, nch, B)
    B = x.shape[-1]
    if B < bp:
        x = torch.nn.functional.pad(x, (0, bp - B))
    return x.contiguous()


def _prep_singles(sb, iinv, massinv, dt, bp: int = BP):
    """sb: SingleBodyLinear with (T, C, B, ...) fields -> (T, C, 14, bp)."""
    act = sb.active.to(torch.float32)
    n = sb.normal * act[..., None]
    r1 = sb.r1
    J1 = cross(r1, n)
    K1 = _mv33(iinv[:, None], J1)
    cc = cross(K1, r1)
    denom = massinv + (cc[..., 0] * n[..., 0] + cc[..., 1] * n[..., 1]
                       + cc[..., 2] * n[..., 2])
    ok = sb.active & (denom != 0)
    dinv = torch.where(ok, 1.0 / torch.where(ok, denom,
                                             torch.ones_like(denom)),
                       torch.zeros_like(denom))
    tsm = sb.targetdist / dt * act
    tsp = torch.minimum(tsm, sb.targetspeednobias * act)
    chans = [n[..., 0], n[..., 1], n[..., 2],
             J1[..., 0], J1[..., 1], J1[..., 2],
             K1[..., 0], K1[..., 1], K1[..., 2],
             dinv, tsm, tsp, sb.fmin * dt * act, sb.fmax * dt * act]
    return _to_planes(chans, bp)


# ---------------------------------------------------------------------------
# the solve: plain PyTorch version
# ---------------------------------------------------------------------------

def _slot_count(singles) -> int:
    """Last slot (over all tracks) with an active row, plus one."""
    if singles is None or singles.shape[1] == 0:
        return 0
    act = (singles[:, :, 9].abs().sum(dim=(0, 2)) > 0).cpu().numpy()
    nz = np.nonzero(act)[0]
    return int(nz[-1]) + 1 if len(nz) else 0


def pgs_solve_plain(plan: SolvePlan, iterations: int, iterations_post: int,
                    mom0, mi, singles, lin_rows, ang_rows):
    """The kernel's sweeps in plain PyTorch, same operation order."""
    T, _, bp = mom0.shape
    dev = mom0.device
    mom = mom0.clone()
    lin_isum = [[torch.zeros((T, c.W), device=dev)] * c.n_phases
                for c in plan.lin_classes]
    ang_torq = [[torch.zeros((T, c.W), device=dev)] * c.n_phases
                for c in plan.ang_classes]
    # each phase's columns, sliced once (the ts columns negated where the
    # sweep negates them)
    lin_cols = [[(b[:, 0:3], b[:, 3:6], b[:, 6:9], b[:, 9:12], b[:, 12:15],
                  -b[:, 16], -b[:, 17], b[:, 15], b[:, 18], b[:, 19],
                  b[:, 20], b[:, 21:22], b[:, 22:23])
                 for b in rows.unbind(1)] for rows in lin_rows]
    ang_cols = [[(b[:, 0:3], b[:, 3:6], b[:, 6:9], b[:, 9], b[:, 10],
                  b[:, 11], b[:, 12], b[:, 13])
                 for b in rows.unbind(1)] for rows in ang_rows]
    nact = _slot_count(singles)
    # each active slot's columns, sliced once: n, K, J, -ts, -ts (post),
    # the inverse diagonal, lo, hi; and its impulse sum
    slot_cols = [(b[:, 0:3], b[:, 6:9], b[:, 3:6], -b[:, 10], -b[:, 11],
                  b[:, 9], b[:, 12], b[:, 13])
                 for b in singles[:, :nact].unbind(1)] if nact else []
    isum_s = [torch.zeros((T, bp), device=dev) for _ in range(nact)]
    gact = []
    for cls, rows in zip(plan.lin_classes, lin_rows):
        if cls.friction:
            a = rows[:, :, 15].abs().sum(dim=(0, 2)).reshape(
                cls.n_groups, cls.U).sum(1) > 0
            gact.append(a.cpu().numpy())
        else:
            gact.append(None)
    units = []
    for cls in plan.lin_classes + plan.ang_classes:
        per = []
        for g in range(cls.n_groups):
            b0 = cls.unit_b0[g]
            b1 = cls.unit_b1[g]
            w0 = np.nonzero(b0 >= 0)[0]
            w1 = np.nonzero(b1 >= 0)[0]
            per.append(tuple(torch.as_tensor(x, dtype=torch.int64, device=dev)
                             for x in (w0, b0[w0], w1, b1[w1])))
        units.append(per)
    mi0_full = mi                                           # (bp,)
    jacobi_tables = {}
    for cls in plan.lin_classes:
        if not cls.jacobi:
            continue
        off, ent = cls.body_off, cls.body_ent
        cnt = np.diff(off)[:bp]
        K = int(cnt.max()) if len(cnt) else 0
        if K == 0:
            jacobi_tables[id(cls)] = None
            continue
        ju = np.zeros((bp, K), np.int64)
        side1 = np.zeros((bp, K), bool)
        for b in range(bp):
            e = ent[off[b]:off[b + 1]]
            ju[b, :len(e)] = e >> 1
            side1[b, :len(e)] = (e & 1) == 1
        valid = np.arange(K)[None] < cnt[:, None]
        jacobi_tables[id(cls)] = tuple(
            torch.as_tensor(x, device=dev) for x in (ju, side1, valid,
                                                     cnt > 0))

    def gather(cols, w_idx, b_idx, W, scale):
        out = torch.zeros((T, 3, W), device=dev)
        if len(w_idx):
            v = mom[:, cols][:, :, b_idx]
            out[:, :, w_idx] = v * mi0_full[b_idx] if scale else v
        return out

    def single_slots(post):
        """The single-body slots in order, every body at once."""
        lin, ang = mom[:, 0:3], mom[:, 3:6]
        for c, (n, K, J, nts, nts_post, d, lo, hi) in enumerate(slot_cols):
            ln0, ln1, ln2 = (lin * n).unbind(1)
            ak0, ak1, ak2 = (ang * K).unbind(1)
            vn = (ln0 + ln1 + ln2) * mi + ak0 + ak1 + ak2
            imp = ((nts_post if post else nts) - vn) * d
            isc = isum_s[c]
            imp = torch.minimum(imp, hi - isc)
            imp = torch.maximum(imp, lo - isc)
            isum_s[c] = isc + imp
            imp = imp[:, None]
            lin = lin + n * imp
            ang = ang + J * imp
        mom[:, 0:3] = lin
        mom[:, 3:6] = ang

    def lin_group(cls, cols, isum, unit, g, post):
        U, W = cls.U, cls.W
        w0, b0, w1, b1 = unit
        l0m = gather(slice(0, 3), w0, b0, W, True)
        a0 = gather(slice(3, 6), w0, b0, W, False)
        l1m = gather(slice(0, 3), w1, b1, W, True)
        a1 = gather(slice(3, 6), w1, b1, W, False)
        sv = None
        for u in range(U):
            p = g * U + u
            (n, J0, J1, K0, K1, nts, nts_post, d, lo0, hi0, fc, c0,
             c1) = cols[p]
            v0, v1, v2 = ((l1m - l0m) * n + a1 * K1 - a0 * K0).unbind(1)
            vn = v0 + v1 + v2
            imp = ((nts_post if post else nts) - vn) * d
            isc = isum[p]
            if cls.friction and u % 3 != 0:
                mst = isum[g * U + (u // 3) * 3]
            else:
                mst = isc
            hi = hi0 + fc * mst
            lo = lo0 - fc * mst
            imp = torch.minimum(imp, hi - isc)
            imp = torch.maximum(imp, lo - isc)
            isum[p] = isc + imp
            imp3 = imp[:, None]
            dl = n * imp3
            da0 = J0 * imp3
            da1 = J1 * imp3
            svu = torch.cat([dl, da0, da1], dim=1)
            sv = svu if sv is None else sv + svu
            if u + 1 < U:
                l0m = l0m - c0 * dl
                l1m = l1m + c1 * dl
                a0 = a0 - da0
                a1 = a1 + da1
        if cls.jacobi:
            jacobi_scatter(cls, sv)
            return
        if len(w0):
            mom[:, 0:3, b0] = mom[:, 0:3, b0] - sv[:, 0:3][:, :, w0]
            mom[:, 3:6, b0] = mom[:, 3:6, b0] - sv[:, 3:6][:, :, w0]
        if len(w1):
            mom[:, 0:3, b1] = mom[:, 0:3, b1] + sv[:, 0:3][:, :, w1]
            mom[:, 3:6, b1] = mom[:, 3:6, b1] + sv[:, 6:9][:, :, w1]

    def jacobi_scatter(cls, sv):
        """Each body's deltas (side 0: -dl, -da0; side 1: dl, da1) added
        in unit order, then applied once: the kernel's order."""
        tab = jacobi_tables[id(cls)]
        if tab is None:
            return
        units, side1, valid, has = tab
        dl_all, da0_all, da1_all = sv[:, 0:3], sv[:, 3:6], sv[:, 6:9]
        for k in range(units.shape[1]):
            u, s1 = units[:, k], side1[:, k]
            dl = torch.where(s1, dl_all[:, :, u], -dl_all[:, :, u])
            da = torch.where(s1, da1_all[:, :, u], -da0_all[:, :, u])
            if k == 0:
                Dl, Da = dl, da
            else:
                Dl = torch.where(valid[:, k], Dl + dl, Dl)
                Da = torch.where(valid[:, k], Da + da, Da)
        mom[:, 0:3, :] = torch.where(has, mom[:, 0:3, :] + Dl,
                                     mom[:, 0:3, :])
        mom[:, 3:6, :] = torch.where(has, mom[:, 3:6, :] + Da,
                                     mom[:, 3:6, :])

    def ang_group(cls, cols, torq, unit, g, post):
        U, W = cls.U, cls.W
        w0, b0, w1, b1 = unit
        a0 = gather(slice(3, 6), w0, b0, W, False)
        a1 = gather(slice(3, 6), w1, b1, W, False)
        sv = None
        for u in range(U):
            p = g * U + u
            axis, K0, K1, d, ts, ts_post, lo, hi = cols[p]
            c0, c1, c2 = (a1 * K1 - a0 * K0).unbind(1)
            cur = c0 + c1 + c2
            dtq = ((ts_post if post else ts) - cur) * d
            tq = torq[p]
            dtq = torch.minimum(dtq, hi - tq)
            dtq = torch.maximum(dtq, lo - tq)
            torq[p] = tq + dtq
            da = axis * dtq[:, None]
            sv = da if sv is None else sv + da
            if u + 1 < U:
                a0 = a0 - da
                a1 = a1 + da
        if len(w0):
            mom[:, 3:6, b0] = mom[:, 3:6, b0] - sv[:, :, w0]
        if len(w1):
            mom[:, 3:6, b1] = mom[:, 3:6, b1] + sv[:, :, w1]

    nl = len(plan.lin_classes)
    out0 = mom.clone()
    for sweep in range(iterations + iterations_post):
        post = sweep >= iterations
        if sweep == iterations:
            out0 = mom.clone()
        single_slots(post)
        for k, (cls, cols, isum) in enumerate(zip(plan.lin_classes,
                                                  lin_cols, lin_isum)):
            for g in range(cls.n_groups):
                if gact[k] is not None and not gact[k][g]:
                    continue
                lin_group(cls, cols, isum, units[k][g], g, post)
        for k, (cls, cols, torq) in enumerate(zip(plan.ang_classes,
                                                  ang_cols, ang_torq)):
            for g in range(cls.n_groups):
                ang_group(cls, cols, torq, units[nl + k][g], g, post)
    if iterations_post == 0:
        out0 = mom.clone()
    return torch.stack([out0, mom], dim=1)


# ---------------------------------------------------------------------------
# the solve: kernel wrapper
# ---------------------------------------------------------------------------

class _Class(ctypes.Structure):
    _fields_ = [("rows", ctypes.c_void_p), ("ub0", ctypes.c_void_p),
                ("ub1", ctypes.c_void_p), ("boff", ctypes.c_void_p),
                ("bent", ctypes.c_void_p), ("U", ctypes.c_int),
                ("W", ctypes.c_int), ("n_groups", ctypes.c_int),
                ("friction", ctypes.c_int), ("jacobi", ctypes.c_int),
                ("n_ent", ctypes.c_int)]


def _class(c, rows=None, ids=(None, None, None, None)):
    return _Class(rows, *ids, c.U, c.W, c.n_groups, int(c.friction),
                  int(c.jacobi), len(c.body_ent) if c.jacobi else 0)


class _Args(ctypes.Structure):
    _fields_ = [("mom0", ctypes.c_void_p), ("mi", ctypes.c_void_p),
                ("singles", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("cycles", ctypes.c_void_p), ("T", ctypes.c_int),
                ("CS", ctypes.c_int), ("BP", ctypes.c_int),
                ("iters", ctypes.c_int), ("iters_post", ctypes.c_int),
                ("n_lin", ctypes.c_int), ("n_ang", ctypes.c_int),
                ("lin", _Class * MAX_CLASSES), ("ang", _Class * MAX_CLASSES)]


_UNIT_IDS: dict = {}


def _unit_ids(plan, device):
    """Per class the device copies of the unit body ids and, for a jacobi
    class, its per-body lists; their pointers (4 a class)."""
    key = (plan.key, str(device))
    if key not in _UNIT_IDS:
        out = []
        for c in plan.lin_classes + plan.ang_classes:
            xs = (c.unit_b0, c.unit_b1) + ((c.body_off, c.body_ent)
                                           if c.jacobi else ())
            ts = [torch.as_tensor(np.ascontiguousarray(x),
                                  dtype=torch.int32, device=device)
                  for x in xs]
            ptrs = [t.data_ptr() for t in ts]
            out.append((ts, ptrs + [None] * (4 - len(ptrs))))
        _UNIT_IDS[key] = out
    return [ptrs for _, ptrs in _UNIT_IDS[key]]


def _aligned(x):
    """x, or a copy of it whose data starts on 16 bytes (the bulk copies'
    alignment)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


@kernels.wrapper("pgs_solve")
def pgs_solve(plan: SolvePlan, iterations: int, iterations_post: int, mom0,
              mi, singles, lin_rows, ang_rows, cycles=None):
    """Kernel wrapper: see the module docstring for the layouts.  cycles:
    an optional (T, 4) int64 CUDA tensor that receives each track's
    clock64 counts [prologue, sweeps, steps a sweep, active slots]."""
    if mom0.device.type == "cpu":
        return pgs_solve_plain(plan, iterations, iterations_post, mom0, mi,
                               singles, lin_rows, ang_rows)
    T, _, bp = mom0.shape
    if bp > 32 or bp % 2 or len(plan.lin_classes) > MAX_CLASSES \
            or len(plan.ang_classes) > MAX_CLASSES:
        raise ValueError("pgs kernel: at most 32 body slots (an even "
                         "count) and 4 classes of each kind")
    for c in plan.lin_classes + plan.ang_classes:
        wmax = MAX_JACOBI_W if c.jacobi else 32
        if c.W > wmax or c.W % 4 or c.n_groups > MAX_GROUPS \
                or (c.jacobi and c.n_groups != 1):
            raise ValueError(f"pgs kernel: class W={c.W} > {wmax} or not "
                             f"a multiple of 4, or {c.n_groups} groups "
                             f"(at most {MAX_GROUPS}; a jacobi class one)")
    mom0, mi = mom0.contiguous(), mi.contiguous()
    lin_rows = [_aligned(r.contiguous()) for r in lin_rows]
    ang_rows = [_aligned(r.contiguous()) for r in ang_rows]
    singles = _aligned(singles.contiguous()) if plan.CS else None
    dev = kernels.require_cuda(mom0, mi, *lin_rows, *ang_rows,
                               *([singles] if plan.CS else []))
    out = torch.empty((T, 2, 6, bp), device=dev)
    ids = _unit_ids(plan, dev)
    a = _Args()
    a.mom0, a.mi, a.out = mom0.data_ptr(), mi.data_ptr(), out.data_ptr()
    a.singles = singles.data_ptr() if plan.CS else None
    if cycles is not None:
        kernels.require_cuda(cycles)
        if cycles.shape != (T, 4) or cycles.dtype != torch.int64:
            raise ValueError("cycles: a (T, 4) int64 tensor")
        a.cycles = cycles.data_ptr()
    a.T, a.CS, a.BP = T, plan.CS, bp
    a.iters, a.iters_post = iterations, iterations_post
    a.n_lin, a.n_ang = len(plan.lin_classes), len(plan.ang_classes)
    nl = len(plan.lin_classes)
    for k, (c, r) in enumerate(zip(plan.lin_classes, lin_rows)):
        a.lin[k] = _class(c, r.data_ptr(), ids[k])
    for k, (c, r) in enumerate(zip(plan.ang_classes, ang_rows)):
        a.ang[k] = _class(c, r.data_ptr(), ids[nl + k])
    kernels.launch("pgs_solve", kernels.library().hts_pgs_solve, dev,
                   ctypes.byref(a))
    pgs_solve.launches += 1
    kind = plan.key.split(":")[0]              # dyn, ms or uni
    if any(c.jacobi for c in plan.lin_classes):
        kind += "_jacobi"
    pgs_solve.kinds[kind] = pgs_solve.kinds.get(kind, 0) + 1
    return out


def occupancy(plan: SolvePlan, bp: int, device) -> int:
    """Tracks (blocks) an SM of card `device` holds at once for this plan's
    layout with bp body slots (a measurement; 0 if the kernel cannot hold
    it)."""
    a = _Args(CS=plan.CS, BP=bp, n_lin=len(plan.lin_classes),
              n_ang=len(plan.ang_classes))
    for k, c in enumerate(plan.lin_classes):
        a.lin[k] = _class(c)
    for k, c in enumerate(plan.ang_classes):
        a.ang[k] = _class(c)
    return kernels.on_device(kernels.library().hts_pgs_occupancy, device,
                             ctypes.byref(a))
