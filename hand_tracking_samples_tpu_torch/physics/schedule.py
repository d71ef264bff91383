"""Host-computed static row schedules for the hand (the port's counterpart
of hand_tracking_samples_tpu.physics.schedule): precedence-colored groups
per row class, as lists of row-index groups; `pair_linear`/`pair_angular`
attach a class's exact groups, padded by `pad_groups`, to its rows for the
colored solve."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .colored import (StaticPairAngular, StaticPairLinear, pad_groups,
                      precedence_coloring)
from .contacts import CONTACT_POINTS


class HandSchedule(NamedTuple):
    joint_lin: list       # 3*n_joints nailed rows
    joint_ang: list       # 6*n_joints angular-range rows
    contact: list         # 3*CONTACT_POINTS rows per collide pair
    apply_angles: list    # the 12 ApplyAngles rows (tracker.runtime.
    # apply_angles: the palm drive's 3, then the 9 finger cones)
    enh_cone: list        # the enhancement arm cone: one (world, 0) row


def build_hand_schedule(model_np: dict, contacts_mode: str = "exact"):
    """The hand's colored groups, built once per model and contacts mode
    (cached beside the PGS kernel's plans)."""
    from .pgs_kernel import _PLANS, _model_digest
    key = f"sched:{_model_digest(model_np)}:{contacts_mode}"
    if key not in _PLANS:
        _PLANS[key] = _hand_schedule(model_np, contacts_mode)
    return _PLANS[key]


def _hand_schedule(model_np: dict, contacts_mode: str) -> HandSchedule:
    j0 = np.asarray(model_np["joint_rbi0"])
    j1 = np.asarray(model_np["joint_rbi1"])
    joint_lin = precedence_coloring(list(zip(np.repeat(j0, 3),
                                             np.repeat(j1, 3))))
    joint_ang = precedence_coloring(list(zip(np.repeat(j0, 6),
                                             np.repeat(j1, 6))))
    U = 3 * CONTACT_POINTS
    pairs = np.asarray(model_np["collide_pairs"])
    if contacts_mode == "jacobi":
        contact = [list(range(r, U * len(pairs), U)) for r in range(U)]
    else:
        contact = precedence_coloring(list(zip(np.repeat(pairs[:, 0], U),
                                               np.repeat(pairs[:, 1], U))))
    # ApplyAngles' pairs in emission order: the drive (world, 1) x 3, the
    # thumb cone (1, 4), then per finger (1, knuckle) and (1, mid)
    aa0, aa1 = [-1, -1, -1, 1], [1, 1, 1, 4]
    for finger in (1, 2, 3, 4):
        aa0 += [1, 1]
        aa1 += [3 + finger * 3, 2 + finger * 3]
    apply_angles = precedence_coloring(list(zip(aa0, aa1)))
    enh_cone = precedence_coloring([(-1, 0)])
    return HandSchedule(joint_lin, joint_ang, contact, apply_angles,
                        enh_cone)


def pair_linear(rows, groups) -> StaticPairLinear:
    return StaticPairLinear(rows, *pad_groups(groups))


def pair_angular(rows, groups) -> StaticPairAngular:
    return StaticPairAngular(rows, *pad_groups(groups))
