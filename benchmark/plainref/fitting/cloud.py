"""Point-cloud <-> articulated-model correspondence and fitting rows
(include/physmodel.h:127-193, 486-496), batched over tracks.

The port's counterpart of hand_tracking_samples_tpu.fitting.cloud: the
reference-shaped correspondence of the sequential and colored solvers
(`closest_planes`, `cloud_constraint_rows`, on the correspondence kernel
with use_kernel, on the (T, B, N, P) plane dots without; the kernel solver
packs the same rows with ops/cloud_rows.py), the boundary-plane chamber
(`containing_plane`, `cloud_chamber_rows`, `rows_to_single_block`) and
FitError (on the vals kernel with use_kernel, on `closest_vals`' plane dots
without).  Points are fixed-budget (T, N, 3) tensors with a validity mask
(T, N).
"""
from __future__ import annotations

import torch

from ..maths.pose import pose_apply, pose_inverse
from ..maths.quat import cross
from ..physics.constraints import constrain_under_plane
from ..physics.solver import LinearRows


def containing_plane(points, point_mask, outdir, origin, viewdir):
    """physmodel.h:183-193, per track: the plane through the origin that
    contains the cloud on the `outdir` side.  The reference's order-dependent
    scan is an angular extreme search, computed as an argmax of the angle
    around the tangent axis.  points (T, N, 3) -> planes (T, 4)."""
    dev = points.device
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    outdir, origin, viewdir = f(outdir), f(origin), f(viewdir)
    best0 = viewdir - outdir + origin
    tangent = cross(best0, outdir)
    b0 = best0 - origin
    th = tangent / torch.clamp(torch.linalg.vector_norm(tangent), min=1e-20)
    u = b0 - th * (b0 * th).sum()
    u = u / torch.clamp(torch.linalg.vector_norm(u), min=1e-20)
    wv = cross(th, u)
    dp = points - origin
    ang = torch.atan2((dp * wv).sum(-1), (dp * u).sum(-1))  # (T, N)
    ang = torch.where(point_mask, ang, torch.full((), -torch.inf,
                                                   device=dev))
    take_pt = (point_mask & (ang > 0)).any(-1)              # (T,)
    i = torch.argmax(ang, dim=-1)
    pick = torch.gather(points, 1, i[:, None, None].expand(-1, 1, 3))[:, 0]
    best = torch.where(take_pt[:, None], pick, best0)
    n = cross(tangent.expand_as(best), best)
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True),
                        min=1e-20)
    return torch.cat([n, -(n * origin).sum(-1, keepdim=True)], dim=-1)


def cloud_chamber_rows(pose, model, points, point_mask, outdirs, origin,
                       viewdir, maxforce: float, active) -> LinearRows:
    """physmodel.h:486-496: for each outdir a containing plane and one
    under-plane row per body.  pose (T, B, 7); active (T,) bool.  Returns
    rows with (T, D*B) fields, direction-major, body-minor."""
    T, B = pose.shape[0], pose.shape[1]
    D = len(outdirs)
    planes = torch.stack([containing_plane(points, point_mask, od, origin,
                                           viewdir) for od in outdirs],
                         dim=1)                            # (T, D, 4)
    V = model.verts.shape[1]
    rows = constrain_under_plane(
        pose[:, None].expand(T, D, B, 7),
        model.verts.expand(T, D, B, V, 3),
        model.vert_mask.expand(T, D, B, V),
        planes[:, :, None].expand(T, D, B, 4), maxforce,
        active=active[:, None, None].expand(T, D, B))
    body = torch.arange(B, device=pose.device).expand(T, D, B)
    rows = rows._replace(b1=body)
    return LinearRows(*[x.reshape((T, D * B) + x.shape[3:]) for x in rows])


def rows_to_single_block(rows: LinearRows, layout):
    """Reshape structurally single-body rows (b0 = world) whose emission
    order is slot-major / body-minor into a SingleBodyLinear (T, C, B)
    block.  layout = (C, B)."""
    from ..physics.colored import SingleBodyLinear
    C, B = layout

    def rs(x):
        return x.reshape((x.shape[0], C, B) + x.shape[2:])
    return SingleBodyLinear(
        normal=rs(rows.normal), r1=rs(rows.r1),
        targetdist=rs(rows.targetdist),
        targetspeednobias=rs(rows.targetspeednobias),
        fmin=rs(rows.fmin), fmax=rs(rows.fmax), active=rs(rows.active))


def fit_error(pose, model, points_ph, depth, depth_cam,
              bone_sum_error_scale: float = 4.0, use_kernel: bool = True):
    """FitError (handtrack.h:369-399) for every track: the correspondence
    of the cloud (planes carrier points_ph (T, 8, N), mask in row 4), the
    per-body maximum point error, and the bones seen in front of the depth
    image (depth (T, H, W) int16 holding u16 bits; depth_cam the camera).
    pose (T, B, 7).  use_kernel: the correspondence by the vals kernel
    (ops.cloud_rows.cloud_vals_ph); an (N, 3) cloud (the voxel and mirror
    clouds, the reference solvers' cloud) enters as ops.cloud_rows.
    points_planes(points, mask), as the JAX package's cloud_vals feeds it
    to the same kernel.  Without it, closest_vals on the plane dots (JAX
    fitting/cloud.py:229).  Returns (T,) float32."""
    from ..imaging.image_ops import depth_u16
    from ..ops.cloud_rows import cloud_vals_ph
    T, B = pose.shape[0], pose.shape[1]
    dev = pose.device
    body, val = cloud_vals_ph(pose, model, points_ph)
    mask = points_ph[:, 4] > 0.5
    ninf = torch.full((), -torch.inf, device=dev)
    contrib = torch.where(mask, val, ninf)                  # (T, N)
    oh = torch.arange(B, device=dev)[None, :, None] == body[:, None, :]
    pointerror = torch.where(oh, contrib[:, None, :], ninf).amax(dim=2)
    point_error_sum = torch.clamp(pointerror, min=0.0).sum(dim=1)

    cam_pose = torch.tensor(depth_cam.pose, device=dev)
    local = pose_apply(pose_inverse(cam_pose), pose[..., :3])  # (T, B, 3)
    px = depth_cam.projectz(local)
    pi = px.to(torch.int32)
    H, W = depth.shape[1], depth.shape[2]
    inside = ((pi[..., 0] >= 0) & (pi[..., 0] <= W - 1)
              & (pi[..., 1] >= 0) & (pi[..., 1] <= H - 1))
    cx = torch.clamp(pi[..., 0], 0, W - 1).long()
    cy = torch.clamp(pi[..., 1], 0, H - 1).long()
    flat = depth_u16(depth).reshape(T, H * W)
    dvals = torch.gather(flat, 1, cy * W + cx).to(torch.float32) \
        * depth_cam.depth_scale
    bone_error = torch.clamp(dvals - local[..., 2], 0.0, 0.01)
    bone_error_sum = torch.where(inside, bone_error,
                                 torch.zeros((), device=dev)).sum(dim=1)
    return point_error_sum + bone_error_sum * bone_sum_error_scale
