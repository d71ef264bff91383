"""Rigid transforms as flat (..., 7) tensors: position (3) + quaternion (4,
xyzw), as in hand_tracking_samples_tpu.maths.pose (geometric.h:111-125)."""
from __future__ import annotations

import torch

from .quat import qconj, qmul, qrot

__all__ = ["pose", "pose_pos", "pose_quat", "pose_inverse", "pose_mul",
           "pose_apply"]


def pose(position, orientation):
    return torch.cat([position, orientation], dim=-1)


def pose_pos(p):
    return p[..., :3]


def pose_quat(p):
    return p[..., 3:7]


def pose_inverse(p):
    q = qconj(pose_quat(p))
    return pose(qrot(q, -pose_pos(p)), q)


def pose_mul(a, b):
    return pose(pose_apply(a, pose_pos(b)), qmul(pose_quat(a), pose_quat(b)))


def pose_apply(p, v):
    return pose_pos(p) + qrot(pose_quat(p), v)


