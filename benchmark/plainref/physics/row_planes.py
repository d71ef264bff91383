"""Tracks-last constraint-row factories and class prep (the PGS-kernel feed).

The port's counterpart of hand_tracking_samples_tpu.physics.row_planes: the
same algebra, term for term, on (rows, T) planes with every body reference
static (joint topology, collide pairs), so every gather is a constant index.
Produces, per PairClassPlan (physics/pgs_kernel.py), the kernel's phase
planes (T, n_phases, nch, W).

Reference semantics per factory:
  * joint nailed rows      physics.h:342-346 via physmodel.h:328-334
  * joint angular ranges   physics.h:351-399 via physmodel.h:321-327
  * HandModelEnhancements  handtrack.h:402-441 (range mutation)
  * contact rows           physics.h:451-489 (fields from the contact kernel)
  * ApplyAngles drive and finger cones   handtrack.h:203-216
  * the enhancement arm cone             handtrack.h:430
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .contacts import _rot_planes
from .solver import FLT_MAX

DEG = 3.14 / 180.0


# ---------------------------------------------------------------------------
# plane algebra helpers (vectors = lists of 3 planes, quats = lists of 4)
# ---------------------------------------------------------------------------

def p_cross(a, b):
    return [a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def p_dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def p_qconj(q):
    return [-q[0], -q[1], -q[2], q[3]]


def p_qmul(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return [aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz]


def p_qrot(q, v):
    """qrot as maths.quat.qrot: v + w*t + cross(qv, t), t = 2*cross(qv, v)."""
    qv = q[0:3]
    w = q[3]
    t = [2.0 * c for c in p_cross(qv, v)]
    ct = p_cross(qv, t)
    return [v[c] + w * t[c] + ct[c] for c in range(3)]


def p_norm(v):
    return torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])


def p_safenormalize(v):
    """maths.quat.safenormalize: +z for the zero vector."""
    n = p_norm(v)
    zero = n == 0.0
    inv = 1.0 / torch.where(zero, torch.ones_like(n), n)
    z0 = torch.zeros((), device=n.device)
    return [torch.where(zero, z0, v[0] * inv),
            torch.where(zero, z0, v[1] * inv),
            torch.where(zero, torch.ones((), device=n.device), v[2] * inv)]


def p_orth(v):
    """maths.quat.orth: first-max argmax over |components|, zeroed,
    crossed."""
    ax, ay, az = v[0].abs(), v[1].abs(), v[2].abs()
    i0 = (ax >= ay) & (ax >= az)
    i1 = (~i0) & (ay >= az)
    i2 = ~(i0 | i1)
    one = torch.ones((), device=ax.device)
    z0 = torch.zeros((), device=ax.device)
    u = [torch.where(i0, z0, one), torch.where(i1, z0, one),
         torch.where(i2, z0, one)]
    c = p_cross(u, v)
    inv = 1.0 / p_norm(c)
    return [cc * inv for cc in c]


def p_qzdir(q):
    x, y, z, w = q
    return [(z * x + y * w) * 2, (y * z - x * w) * 2,
            w * w - x * x - y * y + z * z]


def p_qydir(q):
    x, y, z, w = q
    return [(x * y - z * w) * 2, w * w - x * x + y * y - z * z,
            (y * z + x * w) * 2]


def p_qxdir(q):
    x, y, z, w = q
    return [w * w + x * x - y * y - z * z, (x * y + z * w) * 2,
            (z * x - y * w) * 2]


# ---------------------------------------------------------------------------
# pose planes
# ---------------------------------------------------------------------------

class PosePlanes(NamedTuple):
    """Tracks-last view of a (T, B, 7) pose batch + derived quantities."""
    tr: list      # 3 x (B, T)
    q: list       # 4 x (B, T)
    iinv: list    # iinv[i][j] 3x3 of (B, T): world inertia^-1 * massinv
    T: int
    B: int


def pose_planes(pose_b, tinv_massless, massinv, iinv_tb=None) -> PosePlanes:
    """pose_b (T, B, 7) -> planes; iinv from pgs_kernel._batched_world_iinv
    (or the caller's copy of it)."""
    from .pgs_kernel import _batched_world_iinv
    T, B = pose_b.shape[0], pose_b.shape[1]
    pt = pose_b.permute(1, 2, 0)                        # (B, 7, T)
    tr = [pt[:, c] for c in range(3)]
    q = [pt[:, 3 + c] for c in range(4)]
    if iinv_tb is None:
        iinv_tb = _batched_world_iinv(pose_b[..., 3:7], tinv_massless,
                                      massinv)          # (T, B, 3, 3)
    it = iinv_tb.permute(2, 3, 1, 0)                    # (3, 3, B, T)
    iinv = [[it[i, j] for j in range(3)] for i in range(3)]
    return PosePlanes(tr=tr, q=q, iinv=iinv, T=T, B=B)


def _idx(idx, device):
    return torch.as_tensor(np.asarray(idx), dtype=torch.int64, device=device)


def take(x, idx):
    """Static-index row gather: x (B, T), idx host ints."""
    return x[_idx(idx, x.device)]


# ---------------------------------------------------------------------------
# class prep: geometry channels -> the kernel's 23/14-channel phase planes
# ---------------------------------------------------------------------------

def _gather_static(x, b):
    """x (B, T) -> (R, T) rows at host indices b, zeroed where b < 0."""
    b = np.asarray(b)
    out = x[_idx(np.maximum(b, 0), x.device)]
    if (b < 0).any():
        out = out * torch.as_tensor((b >= 0).astype(np.float32),
                                    device=x.device)[:, None]
    return out


def _where_ok(ok, denom):
    one = torch.ones((), device=denom.device)
    zero = torch.zeros((), device=denom.device)
    return torch.where(ok, 1.0 / torch.where(ok, denom, one), zero)


def prep_lin_channels(P: PosePlanes, b0, b1, massinv, dt, n, r0, r1, td,
                      tsnb, fminF, fmaxF, fcoef, act):
    """The 23 linear-row channels [n, J0, J1, K0, K1, dinv, tsm, tsp,
    fmin*dt, fmax*dt, fcoef, mi0, mi1], tracks-last.  b0/b1 host (R,)
    ints; n/r0/r1 3-lists of (R, T); act a float 0/1 plane."""
    mi = np.asarray(massinv, np.float32)
    b0 = np.asarray(b0)
    b1 = np.asarray(b1)
    dev = act.device
    mi0 = torch.as_tensor(np.where(b0 >= 0, mi[np.maximum(b0, 0)], 0.0)
                          .astype(np.float32), device=dev)[:, None]
    mi1 = torch.as_tensor(np.where(b1 >= 0, mi[np.maximum(b1, 0)], 0.0)
                          .astype(np.float32), device=dev)[:, None]
    I0 = [[_gather_static(P.iinv[i][j], b0) for j in range(3)]
          for i in range(3)]
    I1 = [[_gather_static(P.iinv[i][j], b1) for j in range(3)]
          for i in range(3)]
    na = [n[c] * act for c in range(3)]
    J0 = p_cross(r0, na)
    J1 = p_cross(r1, na)
    K0 = [sum(I0[i][j] * J0[j] for j in range(3)) for i in range(3)]
    K1 = [sum(I1[i][j] * J1[j] for j in range(3)) for i in range(3)]
    denom = (mi0 + p_dot(p_cross(K0, r0), na)
             + mi1 + p_dot(p_cross(K1, r1), na))
    dinv = _where_ok((act > 0) & (denom != 0), denom)
    tsm = td / dt * act
    tsp = torch.minimum(tsm, tsnb * act)
    R, T = act.shape
    return (na + J0 + J1 + K0 + K1
            + [dinv, tsm, tsp, fminF * dt * act, fmaxF * dt * act,
               fcoef * act, mi0.expand(R, T), mi1.expand(R, T)])


def prep_ang_channels(P: PosePlanes, b0, b1, dt, axis, targetspin, mint,
                      maxt, act_b):
    """The 14 angular-row channels [axis, K0, K1, stt, tsm, tsp, mint*dt,
    maxt*dt], tracks-last.  act_b is a bool plane; targetspin == -FLT_MAX
    rows are skipped."""
    b0 = np.asarray(b0)
    b1 = np.asarray(b1)
    I0 = [[_gather_static(P.iinv[i][j], b0) for j in range(3)]
          for i in range(3)]
    I1 = [[_gather_static(P.iinv[i][j], b1) for j in range(3)]
          for i in range(3)]
    K0 = [sum(I0[i][j] * axis[j] for j in range(3)) for i in range(3)]
    K1 = [sum(I1[i][j] * axis[j] for j in range(3)) for i in range(3)]
    denom = p_dot(axis, K0) + p_dot(axis, K1)
    skip = targetspin == -FLT_MAX
    stt = _where_ok(act_b & ~skip & (denom != 0), denom)
    act = (act_b & ~skip).to(torch.float32)
    tsm = targetspin * act
    zero = torch.zeros((), device=act.device)
    tsp = torch.where(mint < 0, zero,
                      torch.clamp(targetspin, max=0.0)) * act
    mintD = torch.clamp(mint * dt, min=-FLT_MAX)
    maxtD = torch.clamp(maxt * dt, max=FLT_MAX)
    return ([axis[c] * act for c in range(3)] + K0 + K1
            + [stt, tsm, tsp, mintD * act, maxtD * act + (1.0 - act)])


def phase_planes_t(chans, cls):
    """channels: list of (R, T) -> (T, n_phases, nch, W): rows gathered by
    the class's row_index (-1 -> zeros), the kernel's input layout."""
    T = chans[0].shape[-1]
    nch = len(chans)
    x = torch.stack(chans, dim=1)                       # (R, nch, T)
    ridx = np.asarray(cls.row_index)
    g = x[_idx(np.maximum(ridx, 0), x.device)]          # (P*W, nch, T)
    if (ridx < 0).any():
        g = g * torch.as_tensor((ridx >= 0).astype(np.float32),
                                device=x.device)[:, None, None]
    g = g.reshape(cls.n_phases, cls.W, nch, T)
    return g.permute(3, 0, 2, 1).contiguous()


# ---------------------------------------------------------------------------
# joint factories (physmodel.h:321-334)
# ---------------------------------------------------------------------------

def joint_lin_geometry(P: PosePlanes, model_np):
    """Nailed joint rows (3 per joint, physics.h:342-346): returns
    (b0, b1, n, r0, r1, td, tsnb, fmin, fmax, fcoef, act) with (3J, T)
    planes; row j*3+k is joint j's world-axis-k row."""
    j0 = np.asarray(model_np["joint_rbi0"])
    j1 = np.asarray(model_np["joint_rbi1"])
    p0 = np.asarray(model_np["joint_p0"], np.float32)   # (J, 3)
    p1 = np.asarray(model_np["joint_p1"], np.float32)
    J = j0.shape[0]
    T = P.T
    dev = P.q[0].device

    q0 = [take(P.q[c], j0) for c in range(4)]           # (J, T)
    q1 = [take(P.q[c], j1) for c in range(4)]
    tr0 = [take(P.tr[c], j0) for c in range(3)]
    tr1 = [take(P.tr[c], j1) for c in range(3)]
    p0c = [torch.as_tensor(p0[:, c], device=dev)[:, None] for c in range(3)]
    p1c = [torch.as_tensor(p1[:, c], device=dev)[:, None] for c in range(3)]
    r0 = p_qrot(q0, p0c)
    r1 = p_qrot(q1, p1c)
    w0 = [tr0[c] + r0[c] for c in range(3)]
    w1 = [tr1[c] + r1[c] for c in range(3)]
    d = [w1[c] - w0[c] for c in range(3)]

    def inter3(xs):
        """3 x (J, T) -> (3J, T) rows j*3+k."""
        return torch.stack([x.expand(J, T) for x in xs],
                           dim=1).reshape(3 * J, T)

    eye = np.eye(3, dtype=np.float32)
    n = [inter3([torch.full((J, T), float(eye[k][c]), device=dev)
                 for k in range(3)]) for c in range(3)]
    r0_r = [inter3([r0[c]] * 3) for c in range(3)]
    r1_r = [inter3([r1[c]] * 3) for c in range(3)]
    td = inter3(d)
    z = torch.zeros((3 * J, T), device=dev)
    act = torch.ones((3 * J, T), device=dev)
    return (np.repeat(j0, 3), np.repeat(j1, 3), n, r0_r, r1_r, td, z,
            torch.full((3 * J, T), -FLT_MAX, device=dev),
            torch.full((3 * J, T), FLT_MAX, device=dev), z, act)


def _setrows(plane, rows, val):
    """plane (J, T) with rows `rows` replaced by val (k, T), as the JAX
    package's one-hot form plane*keep + onehot@val computes it."""
    out = plane.clone()
    idx = _idx(rows, plane.device)
    out[idx] = plane[idx] * 0.0 + val
    return out


def enhancement_ranges(P: PosePlanes, model_np):
    """HandModelEnhancements' per-frame joint-range mutation
    (handtrack.h:417-440), tracks-last.  Returns (rmin, rmax) as 3-lists of
    (J, T) degree planes."""
    rmin0 = np.asarray(model_np["joint_rangemin"], np.float32)   # (J, 3)
    rmax0 = np.asarray(model_np["joint_rangemax"], np.float32)
    J = rmin0.shape[0]
    T = P.T
    dev = P.q[0].device
    rmin = [torch.as_tensor(rmin0[:, c], device=dev)[:, None].expand(J, T)
            for c in range(3)]
    rmax = [torch.as_tensor(rmax0[:, c], device=dev)[:, None].expand(J, T)
            for c in range(3)]

    # distal x-range pinned to half the upper knuckle angle
    db = np.asarray([7, 10, 13, 16])
    z2 = p_qzdir([take(P.q[c], db - 2) for c in range(4)])   # (4, T)
    z1 = p_qzdir([take(P.q[c], db - 1) for c in range(4)])
    ang = (torch.arccos(torch.clamp(p_dot(z2, z1), 0.0, 1.0))
           * 180.0 / 3.14159 / 2.0)
    rmin[0] = _setrows(rmin[0], db - 1, ang)
    rmax[0] = _setrows(rmax[0], db - 1, ang)

    # abduction gating on curl
    kb = np.asarray([14, 11, 8, 5])
    klo = torch.as_tensor(np.asarray([-30.0, -10.0, -10.0, -10.0],
                                     np.float32), device=dev)[:, None]
    khi = torch.as_tensor(np.asarray([10.0, 10.0, 10.0, 20.0], np.float32),
                          device=dev)[:, None]
    cos40 = float(np.float32(np.cos(40.0 * 3.14 / 180.0)))
    y1 = p_qydir([P.q[c][1:2] for c in range(4)])            # (1, T)
    yk = p_qydir([take(P.q[c], kb) for c in range(4)])       # (4, T)
    up = p_dot(y1, yk) > cos40
    lo = torch.where(up, klo, torch.full((), -0.0, device=dev))
    hi = torch.where(up, khi, torch.zeros((), device=dev))
    rmin[1] = _setrows(rmin[1], kb - 1, lo)
    rmax[1] = _setrows(rmax[1], kb - 1, hi)
    return rmin, rmax


def joint_ang_geometry(P: PosePlanes, model_np, params, rmin, rmax):
    """ConstrainAngularRange (physics.h:351-399) for all joints,
    tracks-last.  rmin/rmax: 3-lists of (J, T) degree planes.  Returns
    (b0, b1, axis, targetspin, mintorque, maxtorque, act) with (6J, T)
    planes, rows j*6+a."""
    j0 = np.asarray(model_np["joint_rbi0"])
    j1 = np.asarray(model_np["joint_rbi1"])
    jf = np.asarray(model_np["joint_frame"], np.float32)     # (J, 4)
    J = j0.shape[0]
    T = P.T
    dev = P.q[0].device
    q0 = [take(P.q[c], j0) for c in range(4)]
    q1 = [take(P.q[c], j1) for c in range(4)]
    jfc = [torch.as_tensor(jf[:, c], device=dev)[:, None] for c in range(4)]
    axes, spins6, mints6, act6 = angular_range_rows(
        p_qmul(q0, jfc), q1, [x.expand(J, T) for x in rmin],
        [x.expand(J, T) for x in rmax], params)

    def inter6(xs):
        return torch.stack(xs, dim=1).reshape(6 * J, T)

    axis = [inter6([a[c] for a in axes]) for c in range(3)]
    return (np.repeat(j0, 6), np.repeat(j1, 6), axis, inter6(spins6),
            inter6(mints6), torch.full((6 * J, T), FLT_MAX, device=dev),
            inter6(act6))


def angular_range_rows(jb0, jf1, rmin, rmax, params):
    """ConstrainAngularRange's row math (physics.h:351-399) on planes of
    one shape: jb0 = q0 * jointframe and jf1 = q1 (4-lists), rmin/rmax
    degree 3-lists.  Returns the 6 slots' (axes, targetspins, mintorques,
    active) as 6-lists, slots [x+, x-, y+, y-, z+, z-]."""
    dt = params.deltaT
    bias = params.biasfactorjoint
    dev = jb0[0].device
    shape = rmin[0].shape
    jmin0 = [rmin[c] * DEG for c in range(3)]
    jmax0 = [rmax[c] * DEG for c in range(3)]
    swap = (jmin0[0] == 0) & (jmax0[0] == 0) & (jmin0[2] < jmax0[2])
    cbv = np.asarray([0.0, -1.0, 0.0, 1.0], np.float32) / np.sqrt(2.0)
    cb = [torch.full(shape, float(cbv[c]), device=dev) for c in range(4)]
    jb0s = p_qmul(jb0, cb)
    jf1s = p_qmul(jf1, cb)
    jb0 = [torch.where(swap, jb0s[c], jb0[c]) for c in range(4)]
    jf1 = [torch.where(swap, jf1s[c], jf1[c]) for c in range(4)]
    zero = torch.zeros(shape, device=dev)
    jmin = [torch.where(swap, jmin0[2], jmin0[0]), jmin0[1],
            torch.where(swap, zero, jmin0[2])]
    jmax = [torch.where(swap, jmax0[2], jmax0[0]), jmax0[1],
            torch.where(swap, zero, jmax0[2])]

    r = p_qmul(p_qconj(jb0), jf1)
    zr = p_qzdir(r)
    nrm = p_norm(zr)
    v1 = [zr[c] / nrm for c in range(3)]
    d = v1[2]
    s2 = torch.sqrt(torch.clamp((1.0 + d) * 2.0, min=1e-30))
    s_main = [-v1[1] / s2, v1[0] / s2, torch.zeros_like(d), s2 * 0.5]
    r2c = float(np.float32(1.0) / np.sqrt(np.float32(2.0)))
    deg180 = d <= -1.0
    s = [torch.where(deg180, torch.full_like(d, r2c), s_main[0]),
         torch.where(deg180, torch.full_like(d, -r2c), s_main[1]),
         torch.where(deg180, zero, s_main[2]),
         torch.where(deg180, zero, s_main[3])]
    t = p_qmul(p_qconj(s), r)

    xd = p_qxdir(jf1)
    yd = p_qydir(jf1)
    zd = p_qzdir(jf1)

    negmax = torch.full(shape, -FLT_MAX, device=dev)
    x_eq = jmax[0] == jmin[0]
    x_on = x_eq | (jmax[0] - jmin[0] < 360.0 * DEG)
    xa_spin = 2.0 * (-s[0] + torch.sin(jmin[0] / 2.0)) / dt
    xb_spin = 2.0 * (s[0] - torch.sin(jmax[0] / 2.0)) / dt
    xa_min = torch.where(x_eq, negmax, zero)

    y_eq = jmax[1] == jmin[1]
    ya_spin = torch.where(y_eq, bias * 2.0 * (-s[1] + jmin[1]) / dt,
                          2.0 * (-s[1] + torch.sin(jmin[1] / 2.0)) / dt)
    yb_spin = 2.0 * (s[1] - torch.sin(jmax[1] / 2.0)) / dt
    ya_min = torch.where(y_eq, negmax, zero)

    z_eq = jmin[2] == jmax[2]
    za_spin = torch.where(z_eq, bias * 2.0 * (-t[2]) / dt,
                          2.0 * (-t[2] + torch.sin(jmin[2] / 2.0)) / dt)
    zb_spin = 2.0 * (t[2] - torch.sin(jmax[2] / 2.0)) / dt
    za_min = torch.where(z_eq, negmax, zero)

    tru = torch.ones(shape, dtype=torch.bool, device=dev)
    axes = [xd, [-c for c in xd], yd, [-c for c in yd], zd, [-c for c in zd]]
    return (axes, [xa_spin, xb_spin, ya_spin, yb_spin, za_spin, zb_spin],
            [xa_min, zero, ya_min, zero, za_min, zero],
            [x_on, x_on & ~x_eq, tru, ~y_eq, tru, ~z_eq])


# ---------------------------------------------------------------------------
# ApplyAngles (handtrack.h:203-216) + enhancement arm cone (handtrack.h:430)
# ---------------------------------------------------------------------------

def _cone_rows(a0, a1, limit_deg, params):
    """constrain_cone_angle's row math on planes of any shape: (axis,
    targetspin).  limit_deg a float > 0 (bias 1), or a tensor of per-row
    limits broadcasting with the planes, converted to radians in double
    (as a Python float limit is) and taking the joint bias where 0."""
    axis = p_safenormalize(p_cross(a1, a0))
    rbangle = torch.arccos(torch.clamp(p_dot(a0, a1), 0.0, 1.0))
    if not torch.is_tensor(limit_deg):
        dangle = rbangle - limit_deg * 3.14 / 180.0
        return axis, dangle / params.deltaT      # bias = 1 (limit > 0)
    rad = (limit_deg.double() * 3.14 / 180.0).float()
    bias = torch.where(limit_deg == 0.0,
                       torch.full((), params.biasfactorjoint,
                                  device=rad.device),
                       torch.ones((), device=rad.device))
    return axis, bias * (rbangle - rad) / params.deltaT


def drive_rows(q1, target):
    """constrain_angular_drive's row math on planes of any shape: the
    driven body's orientation q1 toward the world target (q0 * target_q),
    4-lists.  Returns the three row axes [axis, binormal, normal] (3-lists)
    and the first row's spin before its bias and time step."""
    dq = p_qmul(q1, p_qconj(target))
    neg = dq[3] < 0
    dq = [torch.where(neg, -dq[c], dq[c]) for c in range(4)]
    axis = p_safenormalize(dq[0:3])
    binormal = p_orth(axis)
    normal = p_cross(axis, binormal)
    return [axis, binormal, normal], \
        torch.arccos(torch.clamp(dq[3], -1.0, 1.0)) * 2.0


def apply_angles_drive(P: PosePlanes, palmq, camq, drive_force, params):
    """The palm angular drive (3 rows, pair (-1, 1)).  palmq/camq: 4-lists
    of (1, T) planes; drive_force a Python float."""
    axes, ang = drive_rows([P.q[c][1:2] for c in range(4)],
                           p_qmul(camq, palmq))
    spin0 = -params.biasfactorjoint * ang / params.deltaT
    T = P.T
    dev = spin0.device
    zero = torch.zeros((1, T), device=dev)
    ax = [torch.cat([a[c] for a in axes], dim=0) for c in range(3)]
    spins = torch.cat([spin0, zero, zero], dim=0)
    mint = torch.full((3, T), -float(drive_force), device=dev)
    maxt = torch.full((3, T), float(drive_force), device=dev)
    act = torch.ones((3, T), dtype=torch.bool, device=dev)
    return ax, spins, mint, maxt, act


def finger_cone_axes(clenched, model_np, sin=torch.sin, cos=torch.cos):
    """ApplyAngles' nine finger cones' first axes (body 1's frame) from the
    net's clench angles clenched (5, ...): (n0, a 3-list of (9, ...)
    planes, and the cones' second bodies b1s) in emission order, the thumb
    first, then per finger its knuckle and mid cones.  sin/cos: the
    float32 sine and cosine to use (maths.libm's for the JAX CPU build's
    bits)."""
    jf = np.asarray(model_np["joint_frame"], np.float32)
    zero = torch.zeros_like(clenched[0:1])
    a0 = clenched[0:1]
    n0s = [[cos(a0), zero, sin(a0)]]
    b1s = [4]
    for finger in (1, 2, 3, 4):
        a = clenched[finger:finger + 1]
        n0s.append([zero, -sin(a), cos(a)])
        b1s.append(3 + finger * 3)
        jfq = [torch.full_like(zero, float(jf[1 + finger * 3, c]))
               for c in range(4)]
        inner = [zero, -sin(a / 2.0), cos(a / 2.0)]
        n0s.append(p_qrot(jfq, p_qrot(jfq, inner)))
        b1s.append(2 + finger * 3)
    return [torch.cat([n[c] for n in n0s], dim=0) for c in range(3)], b1s


def apply_angles_cones(P: PosePlanes, clenched, model_np, params,
                       coneangle=10.0):
    """The 9 finger cones (pair (1, b1) each, U=1).  clenched: (5, T)."""
    T = P.T
    dev = clenched.device
    n0, b1s = finger_cone_axes(clenched, model_np)
    K = len(b1s)
    q1 = [P.q[c][1:2].expand(K, T) for c in range(4)]
    a0w = p_qrot(q1, n0)
    qb = [take(P.q[c], np.asarray(b1s)) for c in range(4)]
    # a1 = qrot(q, (0,0,1)): the factory's qrot expansion, not qzdir
    zk = torch.zeros((K, T), device=dev)
    a1w = p_qrot(qb, [zk, zk, torch.ones((K, T), device=dev)])
    axis, spins = _cone_rows(a0w, a1w, coneangle, params)
    return (np.full(K, 1), np.asarray(b1s), axis, spins, zk,
            torch.full((K, T), FLT_MAX, device=dev),
            torch.ones((K, T), dtype=torch.bool, device=dev))


def armdir_cone(P: PosePlanes, camq, params):
    """hand_model_enhancements' arm cone: pair (-1, 0), limit 70 degrees,
    armdir = qrot(camq, (0, -1, 0))."""
    T = P.T
    dev = camq[0].device
    zero = torch.zeros((1, T), device=dev)
    one = torch.ones((1, T), device=dev)
    armdir = p_qrot(camq, [zero, -one, zero])
    a1 = p_qrot([P.q[c][0:1] for c in range(4)], [zero, zero, one])
    axis, spins = _cone_rows(armdir, a1, 70.0, params)
    return (np.asarray([-1]), np.asarray([0]), axis, spins, zero,
            torch.full((1, T), FLT_MAX, device=dev),
            torch.ones((1, T), dtype=torch.bool, device=dev))


# ---------------------------------------------------------------------------
# contact rows from kernel fields (physics.h:451-489 epilogue, tracks-last)
# ---------------------------------------------------------------------------

def contact_geometry(fields, pairs, params, friction, n_points):
    """The contact rows' geometry from the contact kernel's fields, as
    (NP*3Pt, T) planes: per contact point [normal, binormal-friction,
    tangent-friction] rows."""
    n, seps, vdotn, r0, r1, pt_active = fields
    NP = pairs.shape[0]
    Pt = n_points
    T = seps.shape[-1]
    dev = seps.device
    minsep = params.driftmax * 0.25
    gterm = float(np.linalg.norm(np.asarray(params.gravity, np.float32))
                  ) * params.falltime_to_ballistic
    bouncevel = torch.clamp((-vdotn - gterm) * params.restitution, min=0.0)
    targetdist = torch.minimum((seps - minsep) * params.biasfactorpositive,
                               seps)
    cn = [-n[c] for c in range(3)]
    cnorm = torch.sqrt(cn[0] * cn[0] + cn[1] * cn[1] + cn[2] * cn[2])
    ncn = [cn[c] / torch.clamp(cnorm, min=1e-30) for c in range(3)]
    s2 = torch.sqrt(torch.clamp((1.0 + ncn[2]) * 2.0, min=1e-30))
    deg180 = ncn[2] <= -1.0
    r2 = float(np.float32(1.0) / np.sqrt(np.float32(2.0)))
    qqx = torch.where(deg180, torch.full_like(s2, r2), -ncn[1] / s2)
    qqy = torch.where(deg180, torch.full_like(s2, -r2), ncn[0] / s2)
    qqz = torch.zeros_like(qqx)
    qqw = torch.where(deg180, torch.zeros_like(s2), s2 * 0.5)
    Rq = _rot_planes(qqx, qqy, qqz, qqw)
    tangent = [Rq[c][0] for c in range(3)]
    binormal = [Rq[c][1] for c in range(3)]

    U = 3 * Pt
    zero = torch.zeros((NP, Pt, T), device=dev)

    def inter(x0, x1, x2):
        """(NP, Pt, T) triples -> (NP*3Pt, T) rows i*3Pt + pt*3 + u."""
        return torch.stack([x0, x1, x2], dim=2).reshape(NP * U, T)

    def bc(x):
        return x[:, None, :].expand(NP, Pt, T)

    n_r = [inter(bc(n[c]), bc(binormal[c]), bc(tangent[c])) for c in range(3)]
    r0_r = [inter(r0[c], r0[c], r0[c]) for c in range(3)]
    r1_r = [inter(r1[c], r1[c], r1[c]) for c in range(3)]
    td = inter(targetdist, zero, zero)
    tsnb = inter(-bouncevel, zero, zero)
    actf = pt_active.to(torch.float32)
    act = inter(actf, actf, actf)
    fmin = torch.zeros((NP * U, T), device=dev)
    fmax = torch.as_tensor(np.tile(np.asarray([FLT_MAX, 0.0, 0.0],
                                              np.float32), NP * Pt),
                           device=dev)[:, None].expand(NP * U, T)
    fcoef = torch.as_tensor(np.tile(np.asarray([0.0, friction, friction],
                                               np.float32), NP * Pt),
                            device=dev)[:, None].expand(NP * U, T)
    b0 = np.repeat(pairs[:, 0], U)
    b1 = np.repeat(pairs[:, 1], U)
    return b0, b1, n_r, r0_r, r1_r, td, tsnb, fmin, fmax, fcoef, act


# ---------------------------------------------------------------------------
# pose integration (physics.h:522-531), tracks-last
# ---------------------------------------------------------------------------

def _diffq_planes(q, tinv, ang):
    """solver._diffq on planes: q 4 x (B,T), tinv (B,3,3), ang 3x(B,T)."""
    nrm = torch.sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3])
    qn = [q[c] / nrm for c in range(4)]
    R = _rot_planes(qn[0], qn[1], qn[2], qn[3])
    A = [[sum(R[i][k] * tinv[:, k, j][:, None] for k in range(3))
          for j in range(3)] for i in range(3)]
    iinv = [[sum(A[i][k] * R[j][k] for k in range(3)) for j in range(3)]
            for i in range(3)]
    half = [sum(iinv[i][j] * ang[j] for j in range(3)) * 0.5
            for i in range(3)]
    hx, hy, hz = half
    bx, by, bz, bw = qn
    return [bw * hx + hy * bz - hz * by,
            bw * hy - hx * bz + hz * bx,
            bw * hz + hx * by - hy * bx,
            -hx * bx - hy * by - hz * bz]


def rkupdateq_planes(q, tinv, ang, dt):
    """solver.rkupdateq on planes (RK4 + normalize)."""
    d1 = _diffq_planes(q, tinv, ang)
    q2 = [q[c] + d1[c] * (dt / 2) for c in range(4)]
    d2 = _diffq_planes(q2, tinv, ang)
    q3 = [q[c] + d2[c] * (dt / 2) for c in range(4)]
    d3 = _diffq_planes(q3, tinv, ang)
    q4 = [q[c] + d3[c] * dt for c in range(4)]
    d4 = _diffq_planes(q4, tinv, ang)
    out = [q[c] + d1[c] * (dt / 6) + d2[c] * (dt / 3) + d3[c] * (dt / 3)
           + d4[c] * (dt / 6) for c in range(4)]
    nrm = torch.sqrt(out[0] * out[0] + out[1] * out[1] + out[2] * out[2]
                     + out[3] * out[3])
    return [out[c] / nrm for c in range(4)]
