"""The JAX CPU build's float32 sin, cos, atan2, exp, arccos and arcsin,
reproduced.

XLA's CPU backend computes float32 sin, cos and atan2 with the C library's
sinf, cosf and atan2f (glibc 2.36 on x86-64; 0 differences in 2^20 random
inputs each).  Those are not correctly rounded: about 1.3% of sinf/cosf
results and 16% of atan2f results differ by an ulp from the float32
rounding of the exact value, and PyTorch's own float32 sin/cos/atan2 differ
from both.  Where such a value decides a result (the segmentation's
in-plane rotation: atan2, then sin/cos of the half angle), the port
computes the C library's algorithms here, in PyTorch operations, so the
same code gives the same bits on the CPU and on the card:

  atan2f  fdlibm's e_atan2f.c and s_atanf.c: argument reduction to one of
          five intervals and an 11-term odd polynomial, all in float32
          arithmetic (no contraction);
  sinf/cosf  the optimized-routines sinf/cosf of glibc: the argument in
          float64, reduced by the nearest multiple of pi/2 (|x| < 120, the
          reduction rounded once as glibc's fused multiply-add rounds it),
          an 8-term float64 polynomial, rounded to float32 once.  glibc's
          x86-64 build evaluates the polynomial with fused multiply-adds
          too; that float64 rounding difference can move the final
          float32 rounding only when the float64 value lies within ~2^-52
          of a float32 rounding boundary (0 of 2^20 inputs measured);
  expf    XLA's own exp (Eigen's pexp), not the C library's;
  acosf/asinf  atan2f forms, as XLA expands arccos and arcsin.
"""
from __future__ import annotations

import numpy as np
import torch


_F = np.float32
_ATANHI = [float(_F(v)) for v in (4.6364760399e-01, 7.8539812565e-01,
                                   9.8279368877e-01, 1.5707962513e+00)]
_ATANLO = [float(_F(v)) for v in (5.0121582440e-09, 3.7748947079e-08,
                                   3.4473217170e-08, 7.5497894159e-08)]
_AT = [float(_F(v)) for v in (
    3.3333334327e-01, -2.0000000298e-01, 1.4285714924e-01,
    -1.1111110449e-01, 9.0908870101e-02, -7.6918758452e-02,
    6.6610731184e-02, -5.8335702866e-02, 4.9768779427e-02,
    -3.6531571299e-02, 1.6285819933e-02)]
_PI = float(_F(3.1415927410e+00))
_PI_O_2 = float(_F(1.5707963705e+00))
_PI_LO = float(_F(-8.7422776573e-08))

_H = float.fromhex
_C0, _C1, _S1, _C2, _S2, _C3, _S3, _C4 = (
    1.0, _H("-0x1.ffffffd0c621cp-2"), _H("-0x1.555545995a603p-3"),
    _H("0x1.55553e1068f19p-5"), _H("0x1.1107605230bc4p-7"),
    _H("-0x1.6c087e89a359dp-10"), _H("-0x1.994eb3774cf24p-13"),
    _H("0x1.99343027bf8c3p-16"))
_HPI_INV = _H("0x1.45F306DC9C883p+23")      # 2/pi * 2^24
_HPI = _H("0x1.921FB54442D18p0")             # pi/2
# pi/2 split so that n * _HPI_HI is exact (n < 2^7 for |x| < 120): the
# reduction x - n pi/2 then rounds once, as glibc's fused multiply-add does
_HPI_HI = float(np.frombuffer((np.frombuffer(np.float64(_HPI).tobytes(),
                                             np.uint64)
                               & np.uint64(0xFFFFFFFFF8000000)).tobytes(),
                              np.float64)[0])
_HPI_LO = _HPI - _HPI_HI


def _bits(x):
    return x.contiguous().view(torch.int32) & 0x7FFFFFFF


def atanf(x):
    """fdlibm's float32 atan (s_atanf.c) for finite x."""
    ix = _bits(x)
    ax = x.abs()
    one = torch.ones_like(x)
    idx = torch.full_like(ix, -1)
    xr = x
    for k, lo, hi, red in (
            (0, 0x3EE00000, 0x3F300000, lambda a: (2.0 * a - one) / (2.0 + a)),
            (1, 0x3F300000, 0x3F980000, lambda a: (a - one) / (a + one)),
            (2, 0x3F980000, 0x401C0000,
             lambda a: (a - 1.5) / (one + 1.5 * a)),
            (3, 0x401C0000, 0x7F800000, lambda a: -one / a)):
        m = (ix >= lo) & (ix < hi)
        xr = torch.where(m, red(ax), xr)
        idx = torch.where(m, torch.full_like(idx, k), idx)
    z = xr * xr
    w = z * z
    a = _AT
    s1 = z * (a[0] + w * (a[2] + w * (a[4] + w * (a[6] + w * (a[8]
                                                             + w * a[10])))))
    s2 = w * (a[1] + w * (a[3] + w * (a[5] + w * (a[7] + w * a[9]))))
    small = xr - xr * (s1 + s2)
    i = torch.clamp(idx, min=0).long()
    hi_t = torch.tensor(_ATANHI, device=x.device)[i]
    lo_t = torch.tensor(_ATANLO, device=x.device)[i]
    zz = hi_t - ((xr * (s1 + s2) - lo_t) - xr)
    zz = torch.where(x < 0, -zz, zz)
    return torch.where(idx < 0, small, zz)


def atan2f(y, x):
    """fdlibm's float32 atan2 (e_atan2f.c) for finite y, x."""
    y, x = torch.broadcast_tensors(y, x)
    iy, ix = _bits(y), _bits(x)
    sy = torch.signbit(y)
    sx = torch.signbit(x)
    k = (iy - ix) >> 23
    z = atanf((y / torch.where(ix == 0, torch.ones_like(x), x)).abs())
    z = torch.where(k > 60, torch.full_like(z, _PI_O_2 + 0.5 * _PI_LO), z)
    z = torch.where(sx & (k < -60), torch.zeros_like(z), z)
    r = torch.where(sx, torch.where(sy, (z - _PI_LO) - _PI,
                                    _PI - (z - _PI_LO)),
                    torch.where(sy, -z, z))
    # the special cases: y = 0, x = 0, x = 1
    r = torch.where(iy == 0, torch.where(sx, torch.where(sy, -_PI + 0 * y,
                                                         _PI + 0 * y), y), r)
    r = torch.where((ix == 0) & (iy != 0),
                    torch.where(sy, torch.full_like(r, -_PI_O_2),
                                torch.full_like(r, _PI_O_2)), r)
    return torch.where(x == 1.0, atanf(y), r)


_EXP_HI = float(_F(88.3762626647950))
_FLT_MIN = float(np.finfo(np.float32).tiny)
_LOG2EF = float(_F(1.44269504088896341))
_EXP_C1 = float(_F(0.693359375))
_EXP_C2 = float(_F(-2.12194440e-4))
_EXP_P = [float(_F(v)) for v in (1.9875691500e-4, 1.3981999507e-3,
                                 8.3334519073e-3, 4.1665795894e-2,
                                 1.6666665459e-1, 5.0000001201e-1)]


def _poly(x, x2, odd):
    """The sin (odd False) or cos (odd True) polynomial, float64."""
    if not odd:
        x3 = x * x2
        s1 = _S2 + x2 * _S3
        x7 = x3 * x2
        s = x + x3 * _S1
        return s + x7 * s1
    x4 = x2 * x2
    c2 = _C3 + x2 * _C4
    c1 = _C0 + x2 * _C1
    x6 = x4 * x2
    c = c1 + x4 * _C2
    return c + x6 * c2


def _sincos(y, cos: bool):
    if y.is_floating_point() and y.dtype != torch.float32:
        raise TypeError("float32 input expected")
    x = y.double()
    ay = y.abs()
    small = ay < float(_F(np.pi / 4))
    # reduce_fast: n = round(x * 2/pi), r = x - n pi/2 (|x| < 120)
    n = ((x * _HPI_INV).to(torch.int32) + 0x800000) >> 24
    nd = n.double()
    r = (x - nd * _HPI_HI) - nd * _HPI_LO
    sign = torch.where((n & 3 == 1) | (n & 3 == 2), -1.0, 1.0).double()
    odd = ((n & 1) == 1) ^ cos
    negc = (n & 2) == 2                     # the table with negated cos
    r2 = r * r
    vs = _poly(r * sign, r2, False)
    vc = _poly(r * sign, r2, True)
    big = torch.where(odd, torch.where(negc, -vc, vc), vs)
    if cos:
        out = torch.where(small, _poly(x, x * x, True), big)
    else:
        out = torch.where(small, _poly(x, x * x, False), big)
        out = torch.where(ay < 2.0 ** -12, x, out)
    if bool((ay >= 120.0).any()):
        raise ValueError("sinf/cosf: |x| >= 120 is not reproduced")
    return out.float()


def sinf(x):
    """glibc's float32 sin for |x| < 120."""
    return _sincos(x, False)


def cosf(x):
    """glibc's float32 cos for |x| < 120."""
    return _sincos(x, True)


def quat_from_axis_angle(axis, angle):
    """maths.quat.quat_from_axis_angle with the JAX CPU build's sin/cos."""
    half = angle[..., None] * 0.5
    return torch.cat([axis * sinf(half), cosf(half)], dim=-1)
