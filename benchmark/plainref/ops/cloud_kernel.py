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


import numpy as np
import torch



def _scalars(cam, range_lo, range_hi, frac):
    f = lambda x: float(np.float32(x))
    # the JAX package's compiled deprojection (x - c) / f multiplies by the
    # float32 reciprocal of the constant focal length; so does the port
    rcp = lambda x: float(np.float32(1.0) / np.float32(x))
    return dict(lo=f(range_lo), hi=f(range_hi), scale=f(cam.depth_scale),
                inv_frac=f(1.0 / frac), cx=cam.principal[0],
                cy=cam.principal[1], rfx=rcp(cam.focal[0]),
                rfy=rcp(cam.focal[1]))


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


def cloud_from_depth_planes(depth, cam, range_lo, range_hi, frac: int,
                            budget: int) -> torch.Tensor:
    """The planes route of cloud_from_depth (JAX ops/cloud_kernel.py:273)
    and the kernel's wrapper: (T, H, W) int16 depth -> (T, 8, budget).
    On the card one launch a call, one block a track; the output is the
    only allocation (each kept pixel writes its own slot, so no scratch)."""
    return cloud_from_depth_planes_plain(depth, cam, range_lo, range_hi,
                                         frac, budget)


def planes_points(ph):
    """ph (T, 8, N) -> (points (T, N, 3), mask (T, N))."""
    return ph[:, 0:3].transpose(1, 2), ph[:, 4] > 0.5
