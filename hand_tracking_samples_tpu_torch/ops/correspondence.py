"""Point -> hull correspondence and ray-clip reductions (kernel 8 of the
port): the counterpart of hand_tracking_samples_tpu.ops.correspondence,
whose Pallas kernel (`_kernel`, hand_tracking_samples_tpu/ops/
correspondence.py:32, launched by `correspondence_reductions` at :76) it
replaces with csrc/correspondence.cu.

For every (track, body, point) the reductions of the dots of the track's
world hull planes with the homogeneous point [p; 1]: their maximum, the
index of the first maximum, and the slab clip of the segment from the ray
origin to the point (entry and exit parameters, and whether the segment
starts and ends outside one plane).  Hulls are taken in world space (the
planes move once per solve, not the points per body), so one point tile
serves every body.

`correspondence_reductions` is the wrapper: CUDA tensors launch the kernel,
CPU tensors run `correspondence_reductions_plain`, the same operations in
the same order.  Tracks lead every tensor:
  pts_h   (T, 8, N)     rows [x, y, z, 1, ...]; only rows 0-2 are read
  planes  (T, B, P, 8)  world planes [n, w, 0, 0, 0, 0] (world_planes)
  d0      (T, B, P)     plane dots of the ray origin
Returns hull_val f32, pidx i32, t_enter f32, t_exit f32, miss i32, each
(T, B, N).  The plane dot is fma(nz, z, fma(ny, y, nx*x)) + w, the JAX CPU
build's contraction of its K=8 dot (0 differences from JAX's interpret-mode
kernel); the planes' lanes 4-7 are zero and add nothing there.
"""
from __future__ import annotations

import torch

from .. import kernels
from ..maths.fma import fma, sub_prod

N_BLK = 512
CHUNK_BYTES = 1 << 28     # the plain version's (t, B, P, N) dots per chunk


def world_planes(pose, model):
    """Per-body hull planes in world space (Pose::TransformPlane), padded
    to 8 lanes; masked planes get n = 0 and w = -1e9 so they never win or
    clip.  pose (T, B, 7) -> (T, B, P, 8).  The rotation and the offset
    are the JAX CPU build's contracted expressions."""
    pl = model.planes                                       # (B, P, 4)
    q = pose[:, :, None, 3:7]                               # (T, B, 1, 4)
    qx, qy, qz, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    nlx, nly, nlz = pl[..., 0], pl[..., 1], pl[..., 2]
    tx = 2.0 * sub_prod(qy, nlz, qz, nly)
    ty = 2.0 * sub_prod(qz, nlx, qx, nlz)
    tz = 2.0 * sub_prod(qx, nly, qy, nlx)
    wnx = fma(qw, tx, nlx) + sub_prod(qy, tz, qz, ty)
    wny = fma(qw, ty, nly) + sub_prod(qz, tx, qx, tz)
    wnz = fma(qw, tz, nlz) + sub_prod(qx, ty, qy, tx)
    px, py, pz = (pose[:, :, None, k] for k in range(3))
    ww = pl[..., 3] - fma(pz, wnz, fma(py, wny, px * wnx))
    mask = model.plane_mask
    ww = torch.where(mask, ww, torch.full((), -1e9, device=pose.device))
    m = mask.to(torch.float32)
    out = torch.zeros(ww.shape + (8,), device=pose.device)
    out[..., 0] = wnx * m
    out[..., 1] = wny * m
    out[..., 2] = wnz * m
    out[..., 3] = ww
    return out


def points_h(points):
    """(T, N, 3) points -> the (T, 8, N) homogeneous tile [p; 1; 0...]."""
    T, N = points.shape[0], points.shape[1]
    out = torch.zeros((T, 8, N), device=points.device)
    out[:, 0:3] = points.transpose(1, 2)
    out[:, 3] = 1.0
    return out


def origin_dots(planes_w, model, origin):
    """d0 (T, B, P): the ray origin's plane dots, -1 on masked planes.
    origin (3,) floats or a (T, 3) tensor."""
    o = torch.as_tensor(origin, dtype=torch.float32,
                        device=planes_w.device)
    o = o.expand(planes_w.shape[0], 3)[:, None, None, :]
    d0 = fma(planes_w[..., 2], o[..., 2],
             fma(planes_w[..., 1], o[..., 1],
                 planes_w[..., 0] * o[..., 0])) + planes_w[..., 3]
    return torch.where(model.plane_mask, d0,
                       torch.full((), -1.0, device=planes_w.device))


def _reduce_chunk(pts_h, planes, d0):
    px, py, pz = (pts_h[:, None, None, k] for k in range(3))  # (T,1,1,N)
    nx, ny, nz, w = (planes[..., k, None] for k in range(4))  # (T,B,P,1)
    d1 = fma(nz, pz, fma(ny, py, nx * px)) + w               # (T,B,P,N)
    hull_val = d1.amax(dim=2)
    P = d1.shape[2]
    iota = torch.arange(P, device=d1.device)[:, None]
    pidx = torch.where(d1 >= hull_val[:, :, None], iota,
                       torch.full_like(iota, P)).amin(dim=2)
    a = d0[..., None]                                        # (T,B,P,1)
    zero = torch.zeros((), device=d1.device)
    one = torch.ones((), device=d1.device)
    miss = ((a >= 0) & (d1 >= 0)).any(dim=2)
    denom = a - d1
    t = torch.where(denom != 0, a / torch.where(denom == 0, one, denom),
                    zero)
    t_enter = torch.where((a >= 0) & (d1 < 0), t, zero).amax(dim=2)
    t_exit = torch.where((a <= 0) & (d1 > 0), t, one).amin(dim=2)
    return (hull_val, pidx.to(torch.int32), t_enter, t_exit,
            miss.to(torch.int32))


def correspondence_reductions_plain(pts_h, planes, d0):
    """Plain PyTorch version of the kernel (same operations, same order),
    over chunks of tracks that keep the (t, B, P, N) dots under
    CHUNK_BYTES."""
    T, B, P = d0.shape
    N = pts_h.shape[2]
    step = max(1, CHUNK_BYTES // (B * P * N * 4))
    parts = [_reduce_chunk(pts_h[i:i + step], planes[i:i + step],
                           d0[i:i + step]) for i in range(0, T, step)]
    return tuple(torch.cat(xs, dim=0) for xs in zip(*parts))


@kernels.wrapper("correspondence")
def correspondence_reductions(pts_h, planes, d0):
    """Kernel wrapper: see the module docstring for the layouts."""
    T, _, N = pts_h.shape
    B, P = planes.shape[1], planes.shape[2]
    assert N % N_BLK == 0, (
        f"point budget {N} must be a multiple of {N_BLK} when "
        f"use_pallas=True (TrackerConfig.point_budget)")
    if pts_h.device.type == "cpu":
        return correspondence_reductions_plain(pts_h, planes, d0)
    args = [x.contiguous() for x in (pts_h, planes, d0)]
    dev = kernels.require_cuda(*args)
    if B * P * 5 * 4 > 48 * 1024:
        raise ValueError(f"correspondence kernel: B={B} P={P} planes do "
                         f"not fit in shared memory")
    f32 = dict(device=dev, dtype=torch.float32)
    i32 = dict(device=dev, dtype=torch.int32)
    out = (torch.empty((T, B, N), **f32), torch.empty((T, B, N), **i32),
           torch.empty((T, B, N), **f32), torch.empty((T, B, N), **f32),
           torch.empty((T, B, N), **i32))
    err = kernels.library().hts_correspondence(
        *[x.data_ptr() for x in args], *[o.data_ptr() for o in out],
        T, B, P, N, kernels.stream_ptr(dev))
    kernels.check(err, "correspondence")
    correspondence_reductions.launches += 1
    return out


def hull_reductions(pose, model, points, origin, planes_w=None):
    """World-plane transform + shared homogeneous point tile + the
    reductions.  points (T, N, 3), N a multiple of 512; origin (3,) floats
    or (T, 3).  Returns the five (T, B, N) reductions."""
    if planes_w is None:
        planes_w = world_planes(pose, model)
    d0 = origin_dots(planes_w, model, origin)
    return correspondence_reductions(points_h(points), planes_w, d0)
