"""Contact rows (the ConstrainContacts analog, physics.h:451-489): the
port's counterpart of hand_tracking_samples_tpu.physics.contacts.  The
contact fields of every collide pair come from the contact kernel
(physics/contact_kernel.py); `contact_rows` turns them into the reference
row layout as the JAX package's batched rule does on the TPU
(contacts.py:464-472: contact_fields, then _rows_from_fields), with the
epilogue shared with the kernel solver (row_planes.contact_geometry)."""
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


