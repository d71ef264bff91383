"""Depth-camera intrinsics (include/misc_image.h:30-62), the port's
counterpart of hand_tracking_samples_tpu.imaging.camera.

Intrinsics are Python floats holding float32 values exactly, so an operation
with a float32 tensor rounds as the JAX package's float32 arrays do."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..maths.fma import fma


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


    def deprojectz(self, p, d):
        """p (..., 2) pixel, d (...) depth -> (..., 3) camera-space point,
        in DCamera.deprojectz's operation order."""
        x = (p[..., 0] - self.principal[0]) / self.focal[0]
        y = (p[..., 1] - self.principal[1]) / self.focal[1]
        return torch.stack([x, y, torch.ones_like(x)], dim=-1) * d[..., None]

    def deprojectz_folded(self, p, d):
        """deprojectz as the JAX CPU build runs it inside a jitted function
        that holds this camera as a constant: XLA folds `/ focal` into
        `* (1/focal)` (float32 reciprocal)."""
        rx = float(np.float32(1.0) / np.float32(self.focal[0]))
        ry = float(np.float32(1.0) / np.float32(self.focal[1]))
        x = (p[..., 0] - self.principal[0]) * rx
        y = (p[..., 1] - self.principal[1]) * ry
        return torch.stack([x, y, torch.ones_like(x)], dim=-1) * d[..., None]

    def projectz(self, v):
        """v (..., 3) -> (..., 2) pixel coordinates; (v/z)*f + c runs
        contracted, as the JAX CPU build runs it (maths.fma)."""
        f = torch.tensor(self.focal, dtype=v.dtype, device=v.device)
        c = torch.tensor(self.principal, dtype=v.dtype, device=v.device)
        return fma(v[..., :2] / v[..., 2:3], f, c)


    def sub(self, s: int):
        """camsub (misc_image.h:60): dims, focal and principal over s."""
        f = np.float32
        return self._replace(
            dim=(self.dim[0] // s, self.dim[1] // s),
            focal=tuple(_f32(f(x) / f(s)) for x in self.focal),
            principal=tuple(_f32(f(x) / f(s)) for x in self.principal))


class TrackCamera(NamedTuple):
    """One camera per track, tracks leading: the virtual cameras that the
    segmentation makes (focal (T, 2), principal (T, 2), pose (T, 7)
    tensors), with DCamera's deprojectz/projectz."""
    dim: tuple
    focal: torch.Tensor
    principal: torch.Tensor
    depth_scale: float
    pose: torch.Tensor

    def _bc(self, x, nd):
        return x.reshape(x.shape[:1] + (1,) * (nd - 2) + x.shape[1:])

    def deprojectz(self, p, d):
        """p (T, ..., 2), d (T, ...) -> (T, ..., 3)."""
        c = self._bc(self.principal, p.dim())
        f = self._bc(self.focal, p.dim())
        x = (p[..., 0] - c[..., 0]) / f[..., 0]
        y = (p[..., 1] - c[..., 1]) / f[..., 1]
        return torch.stack([x, y, torch.ones_like(x)], dim=-1) * d[..., None]


    def sub(self, s: int):
        return self._replace(dim=(self.dim[0] // s, self.dim[1] // s),
                             focal=self.focal / s,
                             principal=self.principal / s)
