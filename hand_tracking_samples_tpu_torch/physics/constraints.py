"""Constraint-row factories on batched tensors (third_party/physics.h:
313-414): the port's counterpart of hand_tracking_samples_tpu.physics.
constraints, cut to the rows of the tracking frames: the single-body rows
(the boundary-plane chamber, the CNN keypoint dead zones), the joints'
nailed and angular-range rows, and the angular drive and cone rows of
ApplyAngles and HandModelEnhancements, in the reference layout (T, rows).
The pair factories of the kernel path live in physics/row_planes.py and
share the angular-range, drive and cone math (`row_planes.
angular_range_rows`, `drive_rows`, `_cone_rows`).  Every argument
broadcasts over leading batch dims.
"""
from __future__ import annotations

import torch

from ..maths.pose import pose_apply, pose_quat
from ..maths.quat import qconj, qrot
import numpy as np

from .solver import FLT_MAX, AngularRows, LinearRows


def constrain_along_direction_world(p0_world, pose1, p1, axisw, minforce,
                                    maxforce, active):
    """physics.h:328 with b0 = world: 1 row per batch element.  p0_world is
    the world anchor, p1 the body-local anchor on the body at pose1."""
    w1 = pose_apply(pose1, p1)
    targetdist = ((w1 - p0_world) * axisw).sum(-1)
    r1 = qrot(pose_quat(pose1), p1)
    z = torch.zeros_like(targetdist)
    shape = targetdist.shape
    lo, hi = min(minforce, maxforce), max(minforce, maxforce)
    return LinearRows(
        b0=torch.full(shape, -1, dtype=torch.int64, device=z.device),
        b1=torch.zeros(shape, dtype=torch.int64, device=z.device),
        normal=axisw, r0=p0_world, r1=r1, targetdist=targetdist,
        targetspeednobias=z, fmin=torch.full_like(z, lo),
        fmax=torch.full_like(z, hi),
        friction_master=torch.zeros(shape, dtype=torch.int64,
                                    device=z.device),
        friction_coef=z,
        active=torch.as_tensor(active, device=z.device).expand(shape))


def constrain_under_plane(pose_b, verts, vert_mask, plane, maxforce,
                          active=True):
    """physics.h:347-350: keep the body's support point under `plane`.
    pose_b (..., 7); verts (..., V, 3) local (COM-frame) collision verts;
    vert_mask (..., V); plane (..., 4).  b1 of the rows is left 0: the
    caller knows the body of each row."""
    q = pose_quat(pose_b)
    dloc = qrot(qconj(q), plane[..., :3])
    dots = (verts * dloc[..., None, :]).sum(-1)        # (..., V)
    dots = torch.where(vert_mask, dots, torch.full_like(dots, -torch.inf))
    idx = torch.argmax(dots, dim=-1)                   # first maximum
    p1 = torch.gather(verts, -2, idx[..., None, None].expand(
        idx.shape + (1, 3)))[..., 0, :]
    return constrain_along_direction_world(
        plane[..., :3] * -plane[..., 3:4], pose_b, p1, -plane[..., :3],
        0.0, maxforce, active)


def constrain_along_direction_deadzone(p0_world, pose1, p1, axisw, radius,
                                       fmin, fmax, active):
    """physics.h:332-340 with b0 = world: 2 rows forming a dead zone of the
    given radius along axisw, [push, pull].  p0_world (..., 3) the world
    anchor, pose1 (..., 7) the body's pose, p1 (..., 3) its local anchor.
    Returns LinearRows with (..., 2) rows (b1 left 0 for the caller)."""
    w1 = pose_apply(pose1, p1)
    d = ((w1 - p0_world) * axisw).sum(-1)
    r1 = qrot(pose_quat(pose1), p1)
    shape = d.shape + (2,)
    dev = d.device
    two = lambda x: torch.stack([x, x], dim=-2)
    z = torch.zeros(shape, device=dev)
    lim = lambda a, b: torch.tensor([a, b], dtype=torch.float32,
                                    device=dev).expand(shape)
    return LinearRows(
        b0=torch.full(shape, -1, dtype=torch.int64, device=dev),
        b1=torch.zeros(shape, dtype=torch.int64, device=dev),
        normal=two(axisw), r0=two(p0_world), r1=two(r1),
        targetdist=torch.stack([d + radius, d - radius], dim=-1),
        targetspeednobias=z, fmin=lim(0.0, fmin), fmax=lim(fmax, 0.0),
        friction_master=torch.zeros(shape, dtype=torch.int64, device=dev),
        friction_coef=z,
        active=torch.as_tensor(active, device=dev)[..., None].expand(shape))


def _frames(pose, b):
    """Orientation and position 4-/3-lists (T, K) of bodies b (K,) host
    ints, the identity pose where b < 0 (the world)."""
    bb = torch.as_tensor(np.maximum(b, 0), device=pose.device)
    w = torch.as_tensor(np.asarray(b) >= 0, device=pose.device)
    q, tr = pose[:, bb, 3:7], pose[:, bb, 0:3]
    one = torch.ones((), device=pose.device)
    zero = torch.zeros((), device=pose.device)
    qs = [torch.where(w, q[..., c], one if c == 3 else zero)
          for c in range(4)]
    return qs, [torch.where(w, tr[..., c], zero) for c in range(3)], w


def _anchor(p, dev):
    """A nail's anchor as float32 on dev: host (K, 3), or a tensor (K, 3)
    or per track (T, K, 3)."""
    if torch.is_tensor(p):
        return p.to(device=dev, dtype=torch.float32)
    return torch.as_tensor(np.asarray(p, np.float32), device=dev)


def constrain_position_nailed(pose, b0, p0, b1, p1, active=True):
    """physics.h:342-346 for K nails at once: 3 rows along world x/y/z per
    nail.  pose (T, B, 7); b0/b1 (K,) host ints (-1 = world); p0/p1 the
    anchors in b0's / b1's frame (the world's where -1): (K, 3) shared by
    the tracks (the joints), or per track (T, K, 3) tensors (slowfit's
    dragged-bone nail).  Returns LinearRows (T, 3K), row k*3 + axis."""
    from .row_planes import p_qrot
    b0, b1 = np.asarray(b0), np.asarray(b1)
    T, K = pose.shape[0], b0.shape[0]
    dev = pose.device
    p0, p1 = _anchor(p0, dev), _anchor(p1, dev)
    q0, tr0, w0 = _frames(pose, b0)
    q1, tr1, w1 = _frames(pose, b1)
    p0c = [p0[..., c].expand(T, K) for c in range(3)]
    p1c = [p1[..., c].expand(T, K) for c in range(3)]
    r0 = p_qrot(q0, p0c)
    r1 = p_qrot(q1, p1c)
    d = [(tr1[c] + r1[c]) - (tr0[c] + r0[c]) for c in range(3)]
    r0 = torch.stack([torch.where(w0, r0[c], p0c[c]) for c in range(3)], -1)
    r1 = torch.stack([torch.where(w1, r1[c], p1c[c]) for c in range(3)], -1)

    def rep(x):                      # (T, K, ...) -> (T, 3K, ...)
        return x.repeat_interleave(3, dim=1)
    eye = torch.eye(3, device=dev).repeat(K, 1).expand(T, 3 * K, 3)
    z = torch.zeros((T, 3 * K), device=dev)
    i = lambda b: torch.as_tensor(np.repeat(b, 3), device=dev).expand(
        T, 3 * K)
    return LinearRows(
        b0=i(b0), b1=i(b1), normal=eye, r0=rep(r0), r1=rep(r1),
        targetdist=torch.stack(d, dim=-1).reshape(T, 3 * K),
        targetspeednobias=z, fmin=torch.full_like(z, -FLT_MAX),
        fmax=torch.full_like(z, FLT_MAX),
        friction_master=torch.zeros((T, 3 * K), dtype=torch.int64,
                                    device=dev),
        friction_coef=z,
        active=torch.as_tensor(active, device=dev).expand(T, 3 * K))


def constrain_angular_range(pose, b0, b1, jointframe, limitmin_deg,
                            limitmax_deg, params):
    """physics.h:351-399 ConstrainAngularRange(W) for K joints at once: 6
    masked row slots per joint [x+, x-, y+, y-, z+, z-].  pose (T, B, 7);
    b0/b1 (K,) host ints; jointframe (K, 4); limits (K, 3) or (T, K, 3)
    degrees.  Returns AngularRows (T, 6K), row k*6 + slot."""
    from .row_planes import angular_range_rows, p_qmul
    b0, b1 = np.asarray(b0), np.asarray(b1)
    T, K = pose.shape[0], b0.shape[0]
    dev = pose.device
    jf = torch.as_tensor(np.asarray(jointframe, np.float32), device=dev)
    jfc = [jf[:, c].expand(T, K) for c in range(4)]
    q0, _, w0 = _frames(pose, b0)
    q1, _, _ = _frames(pose, b1)
    jb0 = p_qmul(q0, jfc)
    jb0 = [torch.where(w0, jb0[c], jfc[c]) for c in range(4)]
    lim = lambda x: torch.as_tensor(x, dtype=torch.float32,
                                    device=dev).expand(T, K, 3)
    rmin, rmax = lim(limitmin_deg), lim(limitmax_deg)
    axes, spins, mints, act = angular_range_rows(
        jb0, q1, [rmin[..., c] for c in range(3)],
        [rmax[..., c] for c in range(3)], params)

    def inter6(xs):                  # 6 x (T, K) -> (T, 6K)
        return torch.stack(xs, dim=-1).reshape(T, 6 * K)
    axis = torch.stack([inter6([a[c] for a in axes]) for c in range(3)],
                       dim=-1)
    i = lambda b: torch.as_tensor(np.repeat(b, 6), device=dev).expand(
        T, 6 * K)
    return AngularRows(b0=i(b0), b1=i(b1), axis=axis,
                       targetspin=inter6(spins), mintorque=inter6(mints),
                       maxtorque=torch.full((T, 6 * K), FLT_MAX, device=dev),
                       active=inter6(act))


def constrain_angular_drive(pose, b0: int, b1: int, target_q, maxtorque,
                            params, active=True) -> AngularRows:
    """physics.h:313-326: 3 rows driving body b1's orientation relative to
    body b0 (-1 = world) toward target_q (T, 4), [axis, binormal, normal],
    torque limits +-maxtorque (a Python float).  pose (T, B, 7).  Returns
    AngularRows (T, 3)."""
    from .row_planes import drive_rows, p_qmul
    T = pose.shape[0]
    dev = pose.device
    q0, _, _ = _frames(pose, [b0])
    q1, _, _ = _frames(pose, [b1])
    tq = [target_q[:, None, c] for c in range(4)]            # (T, 1)
    target = p_qmul(q0, tq) if b0 >= 0 else tq
    axes, ang = drive_rows(q1, target)
    spin0 = -params.biasfactorjoint * ang / params.deltaT       # (T, 1)
    axis = torch.stack([torch.cat([a[c] for a in axes], dim=1)
                        for c in range(3)], dim=-1)           # (T, 3, 3)
    full = lambda v: torch.full((T, 3), float(v), device=dev)
    return AngularRows(
        b0=torch.full((T, 3), b0, dtype=torch.int64, device=dev),
        b1=torch.full((T, 3), b1, dtype=torch.int64, device=dev),
        axis=axis, targetspin=torch.cat([spin0, torch.zeros(
            (T, 2), device=dev)], dim=1),
        mintorque=full(-maxtorque), maxtorque=full(maxtorque),
        active=torch.as_tensor(active, device=dev).expand(T, 3))


def constrain_cone_angle_batch(pose, b0, n0, b1, n1, limitangle_degrees,
                               params, active=True) -> AngularRows:
    """physics.h:402-414 for K rows at once: each limits the angle between
    body b0's axis n0 (world axis where b0 = -1) and body b1's axis n1.
    pose (T, B, 7); b0/b1 (K,) host ints; n0/n1 (K, 3) or per track
    (T, K, 3); limitangle_degrees (K,) host floats (0 = equality, with
    the joint bias).  Returns AngularRows (T, K)."""
    from ..maths import fma as fq
    from .row_planes import _cone_rows
    b0, b1 = np.asarray(b0), np.asarray(b1)
    T, K = pose.shape[0], b0.shape[0]
    dev = pose.device
    q0, _, w0 = _frames(pose, b0)
    q1, _, _ = _frames(pose, b1)
    n0c = torch.as_tensor(n0, dtype=torch.float32, device=dev).expand(
        T, K, 3)
    n1c = torch.as_tensor(n1, dtype=torch.float32, device=dev).expand(
        T, K, 3)
    a0 = torch.where(w0[..., None], fq.qrot(torch.stack(q0, -1), n0c), n0c)
    a1 = fq.qrot(torch.stack(q1, -1), n1c)
    a0, a1 = [a0[..., c] for c in range(3)], [a1[..., c] for c in range(3)]
    lim = np.asarray(limitangle_degrees, np.float64)
    if (lim > 0).all() and (lim == lim[0]).all():
        limit = float(lim[0])              # the fused path's form
    else:
        limit = torch.as_tensor(lim, device=dev).expand(T, K)
    axis, spin = _cone_rows(a0, a1, limit, params)
    mint = torch.as_tensor(np.where(lim > 0, 0.0, -FLT_MAX)
                           .astype(np.float32), device=dev).expand(T, K)
    i = lambda b: torch.as_tensor(b, device=dev).expand(T, K)
    return AngularRows(
        b0=i(b0), b1=i(b1), axis=torch.stack(axis, dim=-1),
        targetspin=spin, mintorque=mint,
        maxtorque=torch.full((T, K), FLT_MAX, device=dev),
        active=torch.as_tensor(active, device=dev).expand(T, K))


def constrain_cone_angle(pose, b0: int, n0, b1: int, n1,
                         limitangle_degrees: float, params,
                         active=True) -> AngularRows:
    """physics.h:402-414: one row limiting the angle between body b0's
    axis n0 (a world axis where b0 = -1; (3,) or per track (T, 3)) and
    body b1's axis n1.  Returns AngularRows (T, 1)."""
    n0 = torch.as_tensor(n0, dtype=torch.float32, device=pose.device)
    n1 = torch.as_tensor(n1, dtype=torch.float32, device=pose.device)
    return constrain_cone_angle_batch(pose, [b0], n0[..., None, :], [b1],
                                      n1[..., None, :],
                                      [limitangle_degrees], params, active)


def relative_angular_rows(pose, refpose, b0: int, b1: int, params,
                          active=True) -> AngularRows:
    """physmodel.h:410-432 RelativeAngularConstraints for one (parent,
    child) pair, every track: 3 rows along the rows of the parent's
    rotation matrix (qxdir, qydir, qzdir of its orientation) driving the
    relative orientation toward refpose's.  pose, refpose (T, B, 7); b0/b1
    host ints.  Only the quaternion of JAX's pose products reaches the
    rows: dq = conj(conj(r0) r1) (conj(q0) q1), spins -dq_xyz * 2 *
    fl(1/dt); the products and the axes contracted as the JAX CPU build
    runs them (maths.fma).  Returns AngularRows (T, 3)."""
    from ..maths import fma as fq
    from .solver import _recip
    T, dev = pose.shape[0], pose.device
    q0, q1 = pose[:, b0, 3:7], pose[:, b1, 3:7]
    ref_rel = fq.qmul(qconj(refpose[:, b0, 3:7]), refpose[:, b1, 3:7])
    dq = fq.qmul(qconj(ref_rel), fq.qmul(qconj(q0), q1))
    full = lambda v: torch.full((T, 3), v, device=dev)
    return AngularRows(
        b0=torch.full((T, 3), b0, dtype=torch.int64, device=dev),
        b1=torch.full((T, 3), b1, dtype=torch.int64, device=dev),
        axis=fq.qdirs(q0),
        targetspin=-dq[:, :3] * 2.0 * _recip(params.deltaT),
        mintorque=full(-FLT_MAX), maxtorque=full(FLT_MAX),
        active=torch.as_tensor(active, device=dev).expand(T, 3))
