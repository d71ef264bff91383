"""Depth raster -> budgeted point cloud: kernel 1 of the kernel path.

`cloud_from_depth_planes` is the wrapper: on a CUDA tensor it launches the
CUDA kernel (csrc/cloud_kernel.cu, which replaces the Pallas kernel
hand_tracking_samples_tpu/ops/cloud_kernel.py:26), on a CPU tensor it runs
`cloud_from_depth_planes_plain`, the same function in plain PyTorch.  The
two are bit-identical: same float32 operations, same order, no FMA
contraction.

Depth reaches both as int16 holding the u16 raster bit for bit (torch.uint16
supports few operations); `depth_tensor` makes that view from a NumPy u16
image.  Output: the planes carrier ph (T, 8, budget) with rows
[x, y, z, 1, mask, 0, 0, 0].

The kernel tests the range in integers: `valid_range` finds the u16
depths whose float32 product with the depth scale passes the plain
version's float test, over all 65,536 values (one interval).

Off the main path: `synthetic_depths` makes the seeded rasters (no valid
pixel, every pixel valid, exactly `budget` pixels kept, hand-like blobs
that keep fewer and more than `budget`) that the tests and chip_smoke.py
hold the kernel to.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels


def depth_tensor(depth_u16, device=None) -> torch.Tensor:
    """NumPy u16 depth (..., H, W) -> int16 tensor with the same bits, on
    the card unless the caller asks for "cpu"."""
    from ..device import resolve_device
    a = np.ascontiguousarray(np.asarray(depth_u16, np.uint16))
    return torch.from_numpy(a.view(np.int16)).to(resolve_device(device))


def _scalars(cam, range_lo, range_hi, frac):
    f = lambda x: float(np.float32(x))
    # the JAX package's compiled deprojection (x - c) / f multiplies by the
    # float32 reciprocal of the constant focal length; so does the port
    rcp = lambda x: float(np.float32(1.0) / np.float32(x))
    return dict(lo=f(range_lo), hi=f(range_hi), scale=f(cam.depth_scale),
                inv_frac=f(1.0 / frac), cx=cam.principal[0],
                cy=cam.principal[1], rfx=rcp(cam.focal[0]),
                rfy=rcp(cam.focal[1]))


@functools.lru_cache(maxsize=16)
def valid_range(scale: float, lo: float, hi: float):
    """[ulo, uhi): the u16 depths u whose float32 product u * scale lies in
    [lo, hi) (the float32 values of _scalars), found over all 65,536 values.
    The rounded product is monotone in u, so they form one interval; the
    kernel tests the range in integers."""
    d = np.arange(65536, dtype=np.float32) * np.float32(scale)
    idx = np.flatnonzero((d >= np.float32(lo)) & (d < np.float32(hi)))
    if idx.size == 0:
        return 0, 0
    ulo, uhi = int(idx[0]), int(idx[-1]) + 1
    if uhi - ulo != idx.size:
        raise ValueError(f"the valid depths are not one interval (scale "
                         f"{scale})")
    return ulo, uhi


def cloud_from_depth_planes_plain(depth, cam, range_lo, range_hi,
                                  frac: int, budget: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel.  depth (T, H, W) int16."""
    T, H, W = depth.shape
    HW = H * W
    k = _scalars(cam, range_lo, range_hi, frac)
    dev = depth.device
    raw = (depth.reshape(T, HW).to(torch.int32) & 0xFFFF).to(torch.float32)
    d = raw * k["scale"]
    v = (d >= k["lo"]) & (d < k["hi"])
    vi = v.to(torch.int32)
    rank = (torch.cumsum(vi, dim=1) - vi).to(torch.float32)
    kept = v & (torch.floor(rank * k["inv_frac"]) * float(frac) == rank)
    ki = kept.to(torch.int64)
    K = ki.sum(1)                                          # (T,)
    maxkept = -(-HW // frac)
    kpos = torch.where(kept, torch.cumsum(ki, dim=1) - 1,
                       torch.full_like(ki, maxkept))
    kidx = torch.zeros((T, maxkept + 1), dtype=torch.int64, device=dev)
    kidx.scatter_(1, kpos, torch.arange(HW, device=dev).expand(T, HW))
    s = torch.arange(budget, device=dev, dtype=torch.int64)[None, :]
    ti = torch.where(K[:, None] > budget, (s * K[:, None]) // budget,
                     s.expand(T, budget))
    ok = ti < K[:, None]
    flat = torch.where(ok, torch.gather(kidx, 1, torch.clamp(ti, max=maxkept)),
                       torch.full_like(ti, HW - 1))
    z = torch.gather(raw, 1, flat) * k["scale"]
    px = (flat % W).to(torch.float32)
    py = (flat // W).to(torch.float32)
    x = (px - k["cx"]) * k["rfx"] * z
    y = (py - k["cy"]) * k["rfy"] * z
    one = torch.ones_like(z)
    zero = torch.zeros_like(z)
    return torch.stack([x, y, z, one, ok.to(torch.float32), zero, zero,
                        zero], dim=1)


@kernels.wrapper("cloud_from_depth")
def cloud_from_depth_planes(depth, cam, range_lo, range_hi, frac: int,
                            budget: int) -> torch.Tensor:
    """The planes route of cloud_from_depth (JAX ops/cloud_kernel.py:273)
    and the kernel's wrapper: (T, H, W) int16 depth -> (T, 8, budget).
    On the card one launch a call, one block a track; the output is the
    only allocation (each kept pixel writes its own slot, so no scratch)."""
    if depth.device.type == "cpu":
        return cloud_from_depth_planes_plain(depth, cam, range_lo, range_hi,
                                             frac, budget)
    if depth.dtype != torch.int16 or depth.dim() != 3:
        raise ValueError("depth must be a (T, H, W) int16 tensor")
    depth = depth.contiguous()
    if depth.data_ptr() % 16 != 0:      # a view: its 16-byte loads need a copy
        depth = depth.clone()
    dev = kernels.require_cuda(depth)
    T, H, W = depth.shape
    if (H * W) % 8 != 0:
        raise ValueError(f"the kernel reads 8 pixels a load: H*W = {H * W}")
    k = _scalars(cam, range_lo, range_hi, frac)
    ulo, uhi = valid_range(k["scale"], k["lo"], k["hi"])
    out = torch.empty((T, 8, budget), dtype=torch.float32, device=dev)
    kernels.launch(
        "cloud_from_depth", kernels.library().hts_cloud_from_depth, dev,
        depth.data_ptr(), out.data_ptr(), T, H, W, frac, budget, ulo, uhi,
        k["scale"], k["inv_frac"], k["cx"], k["cy"], k["rfx"], k["rfy"])
    cloud_from_depth_planes.launches += 1
    return out


def synthetic_depths(T: int, H: int, W: int, seed: int, frac: int = 4,
                     budget: int = 2048, depth_scale: float = 0.001,
                     range_lo: float = 0.1, range_hi: float = 0.7):
    """Seeded u16 rasters (T, H, W) for the kernel's checks, one kind a
    track by t % 5: 0 no valid pixel (zeros, and depths just outside the
    range); 1 every pixel valid; 2 exactly `budget` kept pixels (the valid
    ones scattered); 3 and 4 hand-like: an elliptic blob of depths around
    0.35-0.5 m with holes, out-of-range specks and the range's two edge
    values, sized to keep about half of and three times `budget` (as far as
    the raster holds).  A NumPy array; `depth_tensor` uploads it."""
    rng = np.random.default_rng(seed)
    HW = H * W
    u_lo = int(np.ceil(range_lo / depth_scale))
    u_hi = int(np.floor(range_hi / depth_scale))
    lo_edge, hi_edge = range_lo / depth_scale, range_hi / depth_scale
    out = np.zeros((T, HW), np.uint16)
    yy, xx = np.divmod(np.arange(HW), W)
    for t in range(T):
        kind = t % 5
        d = np.zeros(HW, np.int64)
        if kind == 0:
            n = HW // 3
            d[rng.choice(HW, n, replace=False)] = rng.choice(
                [max(int(lo_edge) - 1, 0), int(hi_edge) + 1, 65535], n)
        elif kind == 1:
            d[:] = rng.integers(u_lo + 1, u_hi - 1, HW)
        elif kind == 2:
            n = min(HW, (budget - 1) * frac + 1)    # kept: ceil(n / frac)
            d[rng.choice(HW, n, replace=False)] = rng.integers(
                u_lo + 1, u_hi - 1, n)
        else:
            want = min(HW, (budget // 2 if kind == 3 else 3 * budget) * frac)
            ry = np.sqrt(want / np.pi * rng.uniform(0.6, 0.9))
            rx = want / np.pi / ry
            cy = rng.uniform(0.3, 0.7) * H
            cx = rng.uniform(0.3, 0.7) * W
            inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
            d[inside] = (rng.uniform(350, 500) + 40 * np.sin(
                xx[inside] / 7.0) + rng.normal(0, 2, inside.sum())).astype(
                    np.int64)
            specks = rng.random(HW) < 0.02
            d[specks] = rng.choice([0, int(hi_edge) + 5, 65535, u_lo - 1,
                                    int(lo_edge), int(hi_edge)],
                                   int(specks.sum()))
        out[t] = np.clip(d, 0, 65535)
    return out.reshape(T, H, W)


def planes_points(ph):
    """ph (T, 8, N) -> (points (T, N, 3), mask (T, N))."""
    return ph[:, 0:3].transpose(1, 2), ph[:, 4] > 0.5
