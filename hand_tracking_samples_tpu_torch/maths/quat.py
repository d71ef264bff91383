"""Quaternion math on tensors (x, y, z, w), broadcasting over leading dims.

Same conventions and operation order as hand_tracking_samples_tpu.maths.quat
(`qrot(q, v) = q * (v,0) * conj(q)`, `qmat` columns qxdir/qydir/qzdir), so
the two packages agree to rounding on the same inputs.
"""
from __future__ import annotations

import torch

__all__ = [
    "cross", "dot", "qconj", "qmul", "qrot", "qxdir", "qydir", "qzdir",
    "qmat", "quat_from_axis_angle", "quat_from_to", "qnormalize", "orth",
    "safenormalize", "quat_from_mat",
]


def cross(a, b):
    """a x b over the last axis, as jnp.cross computes it."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def dot(a, b):
    """Sum over the last axis of length 3, left to right."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


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


def qzdir(q):
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([(z * x + y * w) * 2, (y * z - x * w) * 2,
                        w * w - x * x - y * y + z * z], dim=-1)


def qmat(q):
    """(..., 3, 3) with qmat(q) @ v == qrot(q, v)."""
    return torch.stack([qxdir(q), qydir(q), qzdir(q)], dim=-1)


def qrot(q, v):
    qv = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * cross(qv, v)
    return v + w * t + cross(qv, t)


def qnormalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def safenormalize(v):
    """normalize, +z for the zero vector (geometric.h:58)."""
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    z = torch.zeros_like(v)
    z[..., 2] = 1.0
    zero = n == 0.0
    return torch.where(zero, z, v / torch.where(zero, torch.ones_like(n), n))


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


def quat_from_mat(m):
    """geometric.h:67 quatfrommat.  m (..., 3, 3) row-major (matvec
    convention): m[..., :, j] is column j (linalg's m[j])."""
    def e(i, j):
        return m[..., j, i]

    def vec(*v):
        return torch.tensor(v, dtype=m.dtype, device=m.device)
    magw = e(0, 0) + e(1, 1) + e(2, 2)
    wvsz = (magw > e(2, 2))[..., None]
    magzw = torch.where(wvsz[..., 0], magw, e(2, 2))
    prezw = torch.where(wvsz, vec(1.0, 1.0, 1.0), vec(-1.0, -1.0, 1.0))
    postzw = torch.where(wvsz, vec(0.0, 0, 0, 1), vec(0.0, 0, 1, 0))
    xvsy = (e(0, 0) > e(1, 1))[..., None]
    magxy = torch.where(xvsy[..., 0], e(0, 0), e(1, 1))
    prexy = torch.where(xvsy, vec(1.0, -1.0, -1.0), vec(-1.0, 1.0, -1.0))
    postxy = torch.where(xvsy, vec(1.0, 0, 0, 0), vec(0.0, 1, 0, 0))
    zwvsxy = (magzw > magxy)[..., None]
    pre = torch.where(zwvsxy, prezw, prexy)
    post = torch.where(zwvsxy, postzw, postxy)
    t = (pre[..., 0] * e(0, 0) + pre[..., 1] * e(1, 1)
         + pre[..., 2] * e(2, 2) + 1.0)
    s = 1.0 / torch.sqrt(t) / 2.0
    qp = torch.stack([
        (pre[..., 1] * e(1, 2) - pre[..., 2] * e(2, 1)) * s,
        (pre[..., 2] * e(2, 0) - pre[..., 0] * e(0, 2)) * s,
        (pre[..., 0] * e(0, 1) - pre[..., 1] * e(1, 0)) * s,
        t * s,
    ], dim=-1)
    return qmul(qp, post)
