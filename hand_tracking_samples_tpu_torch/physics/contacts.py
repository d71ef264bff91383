"""Contact constants and plane helpers shared by the contact kernel and the
row factories (the port's counterpart of the parts of
hand_tracking_samples_tpu.physics.contacts that the kernel path reads; the
reference-shaped contact_rows is a later slice)."""
from __future__ import annotations

CONTACT_POINTS = 4   # manifold size per pair (reference patch: up to 5)

_ROT_ELEMS = (
    # R[c][j] = world-from-local rotation, columns qxdir/qydir/qzdir
    lambda x, y, z, w: w * w + x * x - y * y - z * z,
    lambda x, y, z, w: 2 * (x * y - z * w),
    lambda x, y, z, w: 2 * (z * x + y * w),
    lambda x, y, z, w: 2 * (x * y + z * w),
    lambda x, y, z, w: w * w - x * x + y * y - z * z,
    lambda x, y, z, w: 2 * (y * z - x * w),
    lambda x, y, z, w: 2 * (z * x - y * w),
    lambda x, y, z, w: 2 * (y * z + x * w),
    lambda x, y, z, w: w * w - x * x - y * y + z * z,
)


def _rot_planes(qx, qy, qz, qw):
    """Rotation matrix as 9 planes R[c][j] of the operands' shape."""
    e = [f(qx, qy, qz, qw) for f in _ROT_ELEMS]
    return [e[0:3], e[3:6], e[6:9]]
