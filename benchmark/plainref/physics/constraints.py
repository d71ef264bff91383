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

from .solver import LinearRows


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


