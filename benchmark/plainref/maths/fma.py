"""The JAX CPU build's contracted arithmetic, reproduced.

XLA's CPU backend lets LLVM contract a float32 multiply feeding an add into
one fused multiply-add.  The pattern it produces is fixed by the expression's
shape: a*x + b*y runs as fma(a, x, b*y), s + c*z as fma(c, z, s),
a*x - b*y as fma(a, x, -(b*y)) and s - b*y as fma(-b, y, s).  Where such a
result decides an outcome (which hull plane is highest, which planes tie for
a blended normal) or is amplified downstream (K1 = Iinv_w J1), the port
computes the same contracted expressions.

`fma(a, b, c)` is a correctly rounded float32 fused multiply-add (one
rounding, as fmaf and the CPU's vfmadd compute it).  On the card it is
PyTorch's addcmul, whose CUDA kernel compiles `c + 1*a*b` to one FFMA
(chip_smoke.py phase 6 holds it to the exact form below, bit for bit).  On
the CPU it is addcmul too where this PyTorch build's CPU kernel fuses it
(checked once a process against the exact form, `_cpu_addcmul_fused`),
and otherwise `fma_exact`, computed exactly in PyTorch operations: the
product a*b is
exact in float64 (two float32 significands have at most 48 bits), the
float64 sum is rounded to odd (Boldo and Melquiond: the sum and its exact
error by TwoSum, the last bit set where the sum was inexact), and the
float64 value rounds to float32 once more; rounding to odd in a format of
at least 2p+2 bits makes that second rounding exact, so no
double-rounding midpoint remains.  The CUDA kernels call fmaf for the same
expressions (csrc/common.cuh), so a kernel and its plain version stay
bit-identical.
"""
from __future__ import annotations

import torch


def _d(x):
    return x.double() if torch.is_tensor(x) else float(x)


def _device(*xs):
    return next(x.device for x in xs if torch.is_tensor(x))


def fma(a, b, c):
    """float32(a*b + c) rounded once (see the module note)."""
    dev = _device(a, b, c)
    if dev.type == "cuda" or _cpu_addcmul_fused():
        a, b, c = (x if torch.is_tensor(x) else  # a fill, not a copy
                   torch.full((), x, dtype=torch.float32, device=dev)
                   for x in (a, b, c))
        return torch.addcmul(c, a, b)
    return fma_exact(a, b, c)


_FUSED: list = []


def _cpu_addcmul_fused() -> bool:
    """Whether the CPU addcmul rounds a*b + c once: it equals fma_exact on
    inputs where rounding a*b first changes the result (c = -fl(a*b), and
    a double-rounding case), contiguous with a scalar tail, broadcast,
    transposed and with a 0-d operand.  Checked once a process."""
    if not _FUSED:
        g = torch.Generator().manual_seed(0)
        a = torch.randn(1031, generator=g)
        b = torch.randn(1031, generator=g)
        c = -(a * b)
        x = torch.tensor(1 + 2 ** -12)
        a, b = torch.cat([a, x[None]]), torch.cat([b, x[None]])
        c = torch.cat([c, torch.tensor([2.0 ** -70])])
        m = torch.randn(33, 1, generator=g)
        n = torch.randn(1, 9, generator=g)
        cases = [(a, b, c), (m, n, -(m * n)), (m.expand(33, 9).t(),
                                               n.expand(33, 9).t(),
                                               -(m * n).t()),
                 (a, torch.tensor(0.3), -(a * 0.3))]
        _FUSED.append(all(torch.equal(torch.addcmul(r, p, q),
                                      fma_exact(p, q, r))
                          for p, q, r in cases))
    return _FUSED[0]


def fma_exact(a, b, c):
    """float32(a*b + c) rounded once, computed exactly on the CPU (see the
    module note)."""
    p = _d(a) * _d(b)
    cd = _d(c)
    if not torch.is_tensor(p):
        p = torch.tensor(p, dtype=torch.float64)
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)           # TwoSum: s + err is exact
    bits = s.view(torch.int64)
    inexact_even = (err != 0) & ((bits & 1) == 0)
    toward = torch.where((err > 0) == (s > 0), bits + 1, bits - 1)
    return torch.where(inexact_even, toward, bits).view(torch.float64) \
        .float()


def dot3(a0, a1, a2, b0, b1, b2):
    """a0*b0 + a1*b1 + a2*b2 as XLA CPU contracts it:
    fma(a2, b2, fma(a0, b0, a1*b1))."""
    return fma(a2, b2, fma(a0, b0, a1 * b1))


def sub_prod(a, b, c, d):
    """a*b - c*d as fma(a, b, -(c*d))."""
    return fma(a, b, -(c * d))


def cross(a, b):
    """jnp.cross over the last axis, contracted."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([sub_prod(ay, bz, az, by), sub_prod(az, bx, ax, bz),
                        sub_prod(ax, by, ay, bx)], dim=-1)


def qrot(q, v):
    """maths.quat.qrot, contracted: v + w*t + qv x t, t = 2 qv x v, runs as
    fma(w, t, v) + cross(qv, t)."""
    qv = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * cross(qv, v)
    return fma(w, t, v) + cross(qv, t)


def qrot_z1(q, x, y):
    """qrot(q, (x, y, 1)) as the JAX CPU build runs it when the 1 is a
    constant: XLA folds the multiplies by it, so the first cross product's
    x and y terms contract as fma(-qz, y, qy) and fma(qz, x, -qx)."""
    qx, qy, qz, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3:4]
    c = torch.stack([fma(-qz, y, qy), fma(qz, x, -qx),
                     sub_prod(qx, y, qy, x)], dim=-1)
    t = 2.0 * c
    v = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    return fma(w, t, v) + cross(q[..., :3], t)


def sqrt(x):
    """Correctly rounded float32 square root: PyTorch's vectorised CPU
    sqrt is off by an ulp for a few inputs in 10^4; the float64 root rounded
    to float32 is the correctly rounded float32 root.  On the card PyTorch's
    sqrt is already correctly rounded (IEEE sqrtf; chip_smoke.py phase 6
    holds the two forms to each other)."""
    if x.device.type == "cuda":
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def rsum3(a, b):
    """sum(a*b) over a last axis of length 3 as XLA CPU reduces it:
    fma(a2, b2, fma(a1, b1, a0*b0))."""
    return fma(a[..., 2], b[..., 2], fma(a[..., 1], b[..., 1],
                                         a[..., 0] * b[..., 0]))


def norm3(v):
    """jnp.linalg.norm over a last axis of length 3, contracted."""
    return sqrt(rsum3(v, v))


def quat_from_to(v0, v1):
    """maths.quat.quat_from_to with the contracted norms, cross and dot."""
    from .quat import orth
    v0 = v0 / norm3(v0)[..., None]
    v1 = v1 / norm3(v1)[..., None]
    c = cross(v0, v1)
    d = rsum3(v0, v1)[..., None]
    s = sqrt(torch.clamp((1.0 + d) * 2.0, min=1e-30))
    q = torch.cat([c / s, s * 0.5], dim=-1)
    q180 = torch.cat([orth(v0), torch.zeros_like(d)], dim=-1)
    return torch.where(d <= -1.0, q180, q)


def qmul(a, b):
    """maths.quat.qmul, contracted term by term from the left."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        fma(-az, by, fma(ay, bz, fma(aw, bx, ax * bw))),
        fma(az, bx, fma(ay, bw, fma(aw, by, -(ax * bz)))),
        fma(az, bw, fma(-ay, bx, fma(aw, bz, ax * by))),
        fma(-az, bz, fma(-ay, by, fma(aw, bw, -(ax * bx)))),
    ], dim=-1)


