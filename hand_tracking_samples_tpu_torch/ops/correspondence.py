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

import numpy as np
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
    if N % N_BLK:
        raise ValueError(f"point budget {N} must be a multiple of {N_BLK} "
                         f"when use_pallas=True (TrackerConfig.point_budget)")
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
    kernels.launch(
        "correspondence", kernels.library().hts_correspondence, dev,
        *[x.data_ptr() for x in args], *[o.data_ptr() for o in out],
        T, B, P, N)
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


def synthetic_clip_inputs(T: int, B: int, P: int, N: int, seed: int,
                          device="cpu"):
    """Seeded kernel inputs (pts_h, planes, d0) for the correspondence kernel's
    checks, built so that clip quotients tie and lie within an ulp of each
    other.  Three planes in five are axis planes n = (1, 0, 0) whose offset
    w, origin dot a and the points' x are multiples of 1/8 (the plane value
    x + w and a - d1 exact, so quotients such as 1/3 and 2/6 tie and planes
    of equal w tie for the max); one in twenty has a = +0 (both sides of the
    clip); about a third of the axis planes are twins of the plane before
    them with a moved an ulp up or down (quotients an ulp or less apart; the
    twins of a = 0 have the subnormal a = +-2^-149); and planes 0-1 (a = 64)
    and 2-3 (a = -1/4096) are such twins whose quotients bound every point's
    enter and exit clip.  The rest are random unit normals with random
    offsets and origin dots, and each body's last 4 planes are masked as
    world_planes masks them (n = 0, w = -1e9, a = -1)."""
    rng = np.random.default_rng(seed)
    eighths = lambda *shape: rng.integers(-8, 9, shape) / 8.0
    pts = np.zeros((T, 8, N), np.float32)
    pts[:, 0] = eighths(T, N)
    pts[:, 1:3] = rng.uniform(-0.1, 0.1, (T, 2, N))
    pts[:, 3] = 1.0
    n = rng.standard_normal((T, B, P, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    w = rng.uniform(-0.1, 0.1, (T, B, P))
    a = (rng.uniform(0.01, 0.1, (T, B, P))
         * rng.choice([-1.0, 1.0], (T, B, P))).astype(np.float32)
    axis = rng.random((T, B, P)) < 0.6
    n[axis] = (1.0, 0.0, 0.0)
    w[axis] = eighths(int(axis.sum()))
    a[axis] = eighths(int(axis.sum()))
    a[rng.random((T, B, P)) < 0.05] = 0.0
    # twins: an axis plane followed by a copy with a an ulp up or down
    twin = axis[..., :-1] & (rng.random((T, B, P - 1)) < 0.5)
    twin[..., 1:] &= ~twin[..., :-1]
    tt, bb, pp = np.nonzero(twin)
    n[tt, bb, pp + 1], w[tt, bb, pp + 1] = n[tt, bb, pp], w[tt, bb, pp]
    step = np.where(rng.random(pp.shape) < 0.5, np.inf, -np.inf)
    a[tt, bb, pp + 1] = np.nextafter(a[tt, bb, pp], step.astype(np.float32))
    # planes 0-1 and 2-3: twins whose quotients bound every point's clip
    # (a = 64: enter quotients above 0.96; a = -1/4096: exit ones below
    # 0.002), so the ulp between them decides the bounds' bits
    n[:, :, :4], w[:, :, 2] = (1.0, 0.0, 0.0), w[:, :, 0]
    w[:, :, 1], w[:, :, 3] = w[:, :, 0], w[:, :, 2]
    a[:, :, 0], a[:, :, 2] = 64.0, -1.0 / 4096
    for k in (1, 3):
        step = np.where(rng.random((T, B)) < 0.5, np.inf, -np.inf)
        a[:, :, k] = np.nextafter(a[:, :, k - 1], step.astype(np.float32))
    planes = np.zeros((T, B, P, 8), np.float32)
    planes[..., :3] = n
    planes[..., 3] = w
    planes[:, :, -4:, :3] = 0.0
    planes[:, :, -4:, 3] = -1e9
    a[:, :, -4:] = -1.0
    return (torch.tensor(pts, device=device),
            torch.tensor(planes, device=device),
            torch.tensor(a, device=device))
