"""Depth-camera intrinsics (include/misc_image.h:30-62), the port's
counterpart of hand_tracking_samples_tpu.imaging.camera.

Intrinsics are Python floats holding float32 values exactly, so an operation
with a float32 tensor rounds as the JAX package's float32 arrays do."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _f32(x) -> float:
    return float(np.float32(x))


class DCamera(NamedTuple):
    dim: tuple            # (W, H) ints
    focal: tuple          # (fx, fy)
    principal: tuple      # (cx, cy)
    depth_scale: float
    pose: tuple           # (7,) camera pose

    @staticmethod
    def make(dim, focal=None, principal=None, depth_scale=0.001, pose=None):
        dim = (int(dim[0]), int(dim[1]))
        if focal is None:                       # DCamera(int2 dim) ctor
            focal = dim
        if principal is None:
            principal = (dim[0] / 2.0, dim[1] / 2.0)
        if pose is None:
            pose = (0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0)
        return DCamera(dim, (_f32(focal[0]), _f32(focal[1])),
                       (_f32(principal[0]), _f32(principal[1])),
                       _f32(depth_scale), tuple(_f32(p) for p in pose))

    @staticmethod
    def default_320x240():
        """The reference's default intrinsics (misc_image.h:32-34)."""
        return DCamera.make((320, 240), (241.811768, 241.811768),
                            (162.830505, 118.740089), 0.001)

    def deprojectz(self, p, d):
        """p (..., 2) pixel, d (...) depth -> (..., 3) camera-space point,
        in DCamera.deprojectz's operation order."""
        x = (p[..., 0] - self.principal[0]) / self.focal[0]
        y = (p[..., 1] - self.principal[1]) / self.focal[1]
        return torch.stack([x, y, torch.ones_like(x)], dim=-1) * d[..., None]

    def projectz(self, v):
        f = torch.tensor(self.focal, dtype=v.dtype, device=v.device)
        c = torch.tensor(self.principal, dtype=v.dtype, device=v.device)
        return v[..., :2] / v[..., 2:3] * f + c
