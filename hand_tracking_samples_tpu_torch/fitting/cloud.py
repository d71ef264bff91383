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

from ..maths import fma as fq
from ..maths.pose import pose_apply, pose_inverse
from ..maths.quat import cross, qconj, qrot, safenormalize
from ..physics.constraints import constrain_under_plane
from ..physics.solver import LinearRows


def _hull_dots(pose, model, points):
    """dot(plane, (local point, 1)) for all (track, body, point, plane):
    (T, B, N, P), with the JAX CPU build's contracted rotation and dot."""
    pos = pose[..., :3]                                    # (T, B, 3)
    q = pose[..., 3:7]
    local = fq.qrot(qconj(q)[:, :, None, :],
                    points[:, None, :, :] - pos[:, :, None, :])  # (T,B,N,3)
    pl = model.planes[None, :, None]                       # (1, B, 1, P, 4)
    x, y, z = (local[..., k, None] for k in range(3))
    return fq.fma(z, pl[..., 2], fq.fma(y, pl[..., 1], x * pl[..., 0])) \
        + pl[..., 3]


def _hull_best(pose, model, points, origin, use_kernel, dots):
    """Per (track, body, point) the most-above plane's value and index
    (T, B, N), plus, with use_kernel, the ray-clip reductions (t_enter,
    t_exit, miss) and the world plane sets (T, B, P, 8) from the
    correspondence kernel (ops/correspondence.py); without it, from the
    caller's _hull_dots `dots`.  Returns (hull_vals, pidx, slab or None,
    planes_w or None)."""
    if use_kernel:
        from ..ops.correspondence import hull_reductions, world_planes
        planes_w = world_planes(pose, model)
        hv, pidx, te, tx, miss = hull_reductions(pose, model, points, origin,
                                                 planes_w=planes_w)
        return hv, pidx.long(), (te, tx, miss), planes_w
    P = dots.shape[-1]
    hv = dots.amax(dim=-1)
    iota = torch.arange(P, device=dots.device)
    pidx = torch.where(dots >= hv[..., None], iota, P).amin(dim=-1)
    return hv, pidx, None, None


def _sphere_candidates(pose, model, points):
    """The bounding spheres' candidate planes (T, N, B, 4) and values
    (T, N, B) (physmodel.h:141-150)."""
    pos = pose[..., :3]
    d = points[:, :, None, :] - pos[:, None, :, :]         # (T, N, B, 3)
    n = safenormalize(d)
    w = -fq.rsum3(pos[:, None], n) - model.radius_inner
    return (torch.cat([n, w[..., None]], dim=-1),
            fq.rsum3(n, points[:, :, None, :]) + w)


def _first_min(vals):
    """The index of the first minimum over the last axis."""
    best = vals.amin(dim=-1, keepdim=True)
    iota = torch.arange(vals.shape[-1], device=vals.device)
    return torch.where(vals <= best, iota, vals.shape[-1]).amin(dim=-1)


def closest_vals(pose, model, points):
    """FitError's correspondence (JAX fitting/cloud.py:59): the winning
    body (T, N) and value (T, N) of each point, closest_planes without the
    plane gather, from the (T, B, N, P) plane dots."""
    B = model.planes.shape[0]
    _, sphere_vals = _sphere_candidates(pose, model, points)
    hull_vals = _hull_dots(pose, model, points).amax(dim=-1)
    vals = torch.cat([sphere_vals, hull_vals.transpose(1, 2)], dim=2)
    k = _first_min(vals)
    return (torch.where(k >= B, k - B, k),
            torch.gather(vals, 2, k[..., None])[..., 0])


def closest_planes(pose, model, points, hull_best):
    """For each point: (winning body (T, N), winning world plane (T, N, 4),
    value (T, N)); sphere candidates first, then hull most-above planes
    (hull_best, _hull_best's result), the first minimum wins
    (physmodel.h:127-150)."""
    B = model.planes.shape[0]
    pos = pose[..., :3]
    q = pose[..., 3:7]
    sphere_planes, sphere_vals = _sphere_candidates(pose, model, points)
    hull_vals, pidx, _, planes_w = hull_best
    if planes_w is not None:
        # the world plane sets are computed once: gather the winners
        hull_planes = torch.gather(
            planes_w[..., :4], 2,
            pidx[..., None].expand(pidx.shape + (4,)))     # (T, B, N, 4)
    else:
        best_local = model.planes[torch.arange(B, device=pose.device)[:, None],
                                  pidx]                    # (T, B, N, 4)
        wn = fq.qrot(q[:, :, None, :], best_local[..., :3])
        ww = best_local[..., 3] - fq.rsum3(pos[:, :, None, :], wn)
        hull_planes = torch.cat([wn, ww[..., None]], -1)
    hull_planes = hull_planes.transpose(1, 2)              # (T, N, B, 4)
    vals = torch.cat([sphere_vals, hull_vals.transpose(1, 2)], dim=2)
    planes = torch.cat([sphere_planes, hull_planes], dim=2)  # (T, N, 2B, 4)
    k = _first_min(vals)
    body = torch.where(k >= B, k - B, k)
    plane = torch.gather(planes, 2, k[..., None, None].expand(
        k.shape + (1, 4)))[:, :, 0]
    val = torch.gather(vals, 2, k[..., None])[..., 0]
    return body, plane, val


def _slab(d0, d1, plane_mask):
    """ConvexHitCheck's slab reductions (geometric.h:275-302) over the last
    (plane) axis, masked planes at -1: (miss, t_enter, t_exit)."""
    neg = torch.full((), -1.0, device=d0.device)
    one = torch.ones((), device=d0.device)
    zero = torch.zeros((), device=d0.device)
    d0 = torch.where(plane_mask, d0, neg)
    d1 = torch.where(plane_mask, d1, neg)
    miss = ((d0 >= 0) & (d1 >= 0)).any(-1)
    denom = d0 - d1
    t = torch.where(denom != 0, d0 / torch.where(denom == 0, one, denom),
                    zero)
    t_enter = torch.where((d0 >= 0) & (d1 < 0), t, zero).amax(-1)
    t_exit = torch.where((d0 <= 0) & (d1 > 0), t, one).amin(-1)
    return miss, t_enter, t_exit


def cloud_constraint_rows(pose, model, points, point_mask,
                          origin=(0.0, 0.0, 0.0),
                          use_kernel: bool = False) -> LinearRows:
    """CloudConstraints (physmodel.h:163-181), directed: one row per point
    slot, (T, N) fields.  Force limits are the caller's.  A point in front
    of its winning plane whose camera ray enters the winner's hull attaches
    at the ray's entry point, along the ray.  use_kernel: the
    correspondence and the ray clip come from the correspondence kernel
    (N a multiple of 512); otherwise from the (T, B, N, P) plane dots.
    origin: the rays' origin, (3,) or per track (T, 3)."""
    T, N = points.shape[0], points.shape[1]
    dev = points.device
    o = torch.as_tensor(origin, dtype=torch.float32,
                        device=dev).expand(T, 3)[:, None]   # (T, 1, 3)
    dots = None if use_kernel else _hull_dots(pose, model, points)
    hull_best = _hull_best(pose, model, points, o[:, 0], use_kernel, dots)
    body, plane, val = closest_planes(pose, model, points, hull_best)
    tt = torch.arange(T, device=dev)[:, None]
    bpose = pose[tt, body]                                 # (T, N, 7)
    attach_w = points - plane[..., :3] * val[..., None]
    n_default = plane[..., :3]
    dp = points - o
    dirn = dp / fq.norm3(dp)[..., None]
    front = fq.rsum3(dp, n_default) > 0
    if hull_best[2] is not None:
        t_enter, t_exit, miss = hull_best[2]
        hit_all = (miss == 0) & (t_enter <= t_exit)        # (T, B, N)
    else:
        # the slab clip of origin -> point over the point's plane dots
        olocal = pose_apply(pose_inverse(pose),
                            o.expand(pose.shape[:2] + (3,)))  # (T, B, 3)
        pl = model.planes
        d0 = fq.rsum3(pl[None, :, :, :3], olocal[:, :, None, :]) \
            + pl[None, :, :, 3]                             # (T, B, P)
        miss, t_enter, t_exit = _slab(
            d0[:, :, None, :].expand_as(dots), dots,
            model.plane_mask[None, :, None, :])
        hit_all = (~miss) & (t_enter <= t_exit)
    nidx = torch.arange(N, device=dev)[None, :]
    hit = hit_all[tt, body, nidx]
    te = t_enter[tt, body, nidx]
    impact = o + dp * te[..., None]
    use_ray = front & hit
    w1 = torch.where(use_ray[..., None], impact, attach_w)
    n = torch.where(use_ray[..., None], dirn, n_default)
    targetdist = fq.rsum3(w1 - points, n)
    r1 = w1 - bpose[..., :3]
    z = torch.zeros((T, N), device=dev)
    return LinearRows(
        b0=torch.full((T, N), -1, dtype=torch.int64, device=dev), b1=body,
        normal=n, r0=points, r1=r1, targetdist=targetdist,
        targetspeednobias=z, fmin=torch.full_like(z, -1.0),
        fmax=torch.full_like(z, 1.0),
        friction_master=torch.zeros((T, N), dtype=torch.int64, device=dev),
        friction_coef=z, active=point_mask)


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


def scale_cloud_forces(rows: LinearRows, per_row_scale) -> LinearRows:
    """Per-row force-limit scaling (physmodel.h:347 and the other call
    sites multiply the +-1 base limits by their factors)."""
    return rows._replace(fmin=rows.fmin * per_row_scale,
                         fmax=rows.fmax * per_row_scale)


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
    from ..ops.cloud_kernel import planes_points
    from ..ops.cloud_rows import cloud_vals_ph
    T, B = pose.shape[0], pose.shape[1]
    dev = pose.device
    if use_kernel:
        body, val = cloud_vals_ph(pose, model, points_ph)
    else:
        body, val = closest_vals(pose, model, planes_points(points_ph)[0])
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
