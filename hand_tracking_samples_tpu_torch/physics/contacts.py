"""Contact rows (the ConstrainContacts analog, physics.h:451-489): the
port's counterpart of hand_tracking_samples_tpu.physics.contacts.  The
contact fields of every collide pair come from the contact kernel
(physics/contact_kernel.py); `contact_rows` turns them into the reference
row layout as the JAX package's batched rule does on the TPU
(contacts.py:464-472: contact_fields, then _rows_from_fields), with the
epilogue shared with the kernel solver (row_planes.contact_geometry)."""
from __future__ import annotations

import numpy as np
import torch

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


def contact_rows(state, model, params, friction: float = 0.6,
                 n_points: int = CONTACT_POINTS):
    """n_points x [normal, binormal-friction, tangent-friction] rows per
    collide pair, masked by separation, for every track: LinearRows with
    (T, NP * 3 * n_points) fields (row pair*3Pt + point*3 + kind)."""
    from .contact_kernel import contact_fields
    fields = contact_fields(state.pose, state.linear_momentum,
                            state.angular_momentum, model, params, n_points)
    return contact_rows_from_fields(fields, model, params, friction,
                                    n_points)


def contact_rows_from_fields(fields, model, params, friction: float = 0.6,
                             n_points: int = CONTACT_POINTS):
    """contact_rows' epilogue (_rows_from_fields, contacts.py:363) on the
    contact kernel's fields (contact_kernel.fields_of)."""
    from .row_planes import contact_geometry
    from .solver import LinearRows
    pairs = np.asarray(model.np["collide_pairs"])
    (b0, b1, n, r0, r1, td, tsnb, fmin, fmax, fcoef,
     act) = contact_geometry(fields, pairs, params, friction, n_points)
    T, R = td.shape[1], td.shape[0]
    dev = td.device
    v3 = lambda x: torch.stack(x, dim=-1).transpose(0, 1)   # (T, R, 3)
    i = lambda b: torch.as_tensor(b, device=dev).expand(T, R)
    fm = np.tile(np.asarray([0, -1, -2]), R // 3)
    return LinearRows(b0=i(b0), b1=i(b1), normal=v3(n), r0=v3(r0),
                      r1=v3(r1), targetdist=td.T, targetspeednobias=tsnb.T,
                      fmin=fmin.T, fmax=fmax.T, friction_master=i(fm),
                      friction_coef=fcoef.T, active=act.T > 0.5)
