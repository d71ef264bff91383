"""Synthetic depth rendering: ray-cast the hand model into depth images
(the port's counterpart of hand_tracking_samples_tpu.data.synth;
synthetic-tracker.cpp:69-76 + PhysModel::HitCheck, physmodel.h:287-294).

For every pixel a ray from the camera origin to deproject(p, 4 m) takes the
nearest convex-hull entry over the 17 bones.  Batched over tracks; the
bodies run as a loop, each clipping only the rays that pass within its
bounding sphere, so that one (rays, planes) slab is live at a time, and the
tracks go in chunks of `chunk` to bound that slab."""
from __future__ import annotations

import torch

from ..imaging.camera import DCamera
from ..maths.pose import pose_apply, pose_inverse
from ..maths.quat import qrot

SYNTH_CAM = dict(dim=(320, 240), focal=(305.0, 305.0),
                 principal=(160.0, 120.0), depth_scale=0.001)


def _render(poses, model, cam, ends):
    T, B = poses.shape[0], poses.shape[1]
    N = ends.shape[0]
    dev = poses.device
    one = torch.ones((), device=dev)
    zero = torch.zeros((), device=dev)
    neg = torch.full((), -1.0, device=dev)
    tmin = torch.ones((T * N,), device=dev)
    # a ray whose line passes farther from a bone's origin than its hull's
    # bounding radius (model.radius, plus a margin far above float32
    # rounding) misses that hull: only the other rays are clipped
    reach = model.radius * 1.01 + 2e-3
    for b in range(B):
        inv = pose_inverse(poses[:, b])                   # (T, 7)
        l0 = pose_apply(inv, torch.zeros((T, 3), device=dev))
        dirl = qrot(inv[:, None, 3:7], ends[None])        # (T, N, 3)
        c = torch.cross(l0[:, None].expand_as(dirl), dirl, dim=-1)
        near = (c * c).sum(-1) <= reach[b] ** 2 * (dirl * dirl).sum(-1)
        tt, nn = torch.nonzero(near, as_tuple=True)
        l1 = dirl[tt, nn] + inv[tt, :3]                   # (K, 3)
        planes = model.planes[b]                          # (P, 4)
        pmask = model.plane_mask[b]
        d0 = (l0[:, None, :] * planes[None, :, :3]).sum(-1) + planes[:, 3]
        d1 = (l1[..., None, 0] * planes[:, 0] + l1[..., None, 1]
              * planes[:, 1] + l1[..., None, 2] * planes[:, 2]
              + planes[:, 3])                             # (K, P)
        d0 = torch.where(pmask, d0, neg)[tt]
        d1 = torch.where(pmask, d1, neg)
        miss = ((d0 >= 0) & (d1 >= 0)).any(-1)
        denom = d0 - d1
        t = torch.where(denom != 0,
                        d0 / torch.where(denom == 0, one, denom), zero)
        t_enter = torch.where((d0 >= 0) & (d1 < 0), t, zero).amax(-1)
        t_exit = torch.where((d0 <= 0) & (d1 > 0), t, one).amin(-1)
        hit = (~miss) & (t_enter <= t_exit)
        k = tt * N + nn
        tmin[k] = torch.minimum(tmin[k], torch.where(hit, t_enter, one))
    return tmin.reshape(T, N)


def fake_depth(poses, model, cam: DCamera, chunk: int = 16):
    """poses (T, B, 7) bone poses (physics frame) -> (T, H, W) int16 depth
    holding u16 millimetre-scale units bit for bit."""
    W, H = cam.dim
    dev = poses.device
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    ends = cam.deprojectz(torch.stack([xs, ys], -1),
                          torch.full((H, W), 4.0, device=dev)).reshape(-1, 3)
    out = []
    for i in range(0, poses.shape[0], chunk):
        tmin = _render(poses[i:i + chunk], model, cam, ends)
        depth_m = tmin * 4.0
        u = (depth_m / cam.depth_scale).to(torch.int32)   # truncation
        out.append(u.to(torch.int16).reshape(-1, H, W))
    return torch.cat(out)
