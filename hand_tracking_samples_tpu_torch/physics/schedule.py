"""Host-computed static row schedules for the hand (the port's counterpart
of hand_tracking_samples_tpu.physics.schedule): precedence-colored groups
per row class, as lists of row-index groups."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .colored import precedence_coloring
from .contacts import CONTACT_POINTS


class HandSchedule(NamedTuple):
    joint_lin: list       # 3*n_joints nailed rows
    joint_ang: list       # 6*n_joints angular-range rows
    contact: list         # 3*CONTACT_POINTS rows per collide pair


def build_hand_schedule(model_np: dict, contacts_mode: str = "exact"):
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
    return HandSchedule(joint_lin, joint_ang, contact)
