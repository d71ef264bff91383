"""Quaternion math on tensors (x, y, z, w), broadcasting over leading dims.

Same conventions and operation order as hand_tracking_samples_tpu.maths.quat
(`qrot(q, v) = q * (v,0) * conj(q)`, `qmat` columns qxdir/qydir/qzdir), so
the two packages agree to rounding on the same inputs.
"""
from __future__ import annotations

import torch

__all__ = ["cross", "qconj", "qmul", "qrot", "qxdir", "qydir",
           "quat_from_axis_angle", "quat_from_to", "qnormalize", "orth"]


def cross(a, b):
    """a x b over the last axis, as jnp.cross computes it."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def qconj(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def qmul(a, b):
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-1)


def qxdir(q):
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([w * w + x * x - y * y - z * z, (x * y + z * w) * 2,
                        (z * x - y * w) * 2], dim=-1)


def qydir(q):
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([(x * y - z * w) * 2, w * w - x * x + y * y - z * z,
                        (y * z + x * w) * 2], dim=-1)


def qrot(q, v):
    qv = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * cross(qv, v)
    return v + w * t + cross(qv, t)


def qnormalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_from_axis_angle(axis, angle):
    half = torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)
    half = half[..., None] * 0.5
    return torch.cat([axis * torch.sin(half), torch.cos(half)], dim=-1)


def orth(v):
    """geometric.h:312 Orth: unit vector orthogonal to v."""
    imax = torch.argmax(v.abs(), dim=-1, keepdim=True)
    u = torch.ones_like(v).scatter(-1, imax, 0.0)
    c = cross(u, v)
    return c / torch.linalg.vector_norm(c, dim=-1, keepdim=True)


def quat_from_to(v0, v1):
    """Shortest-arc quaternion taking v0 to v1 (geometric.h:319)."""
    v0 = v0 / torch.linalg.vector_norm(v0, dim=-1, keepdim=True)
    v1 = v1 / torch.linalg.vector_norm(v1, dim=-1, keepdim=True)
    c = cross(v0, v1)
    d = (v0 * v1).sum(-1, keepdim=True)
    s = torch.sqrt(torch.clamp((1.0 + d) * 2.0, min=1e-30))
    q = torch.cat([c / s, s * 0.5], dim=-1)
    q180 = torch.cat([orth(v0), torch.zeros_like(d)], dim=-1)
    return torch.where(d <= -1.0, q180, q)


