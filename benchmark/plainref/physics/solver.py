"""Sequential-impulse rigid-body solver (third_party/physics.h:543-587
PhysicsUpdate): the port's counterpart of
hand_tracking_samples_tpu.physics.solver.

`physics_update` is the reference solve: damp and integrate forces, 16
Gauss-Seidel sweeps over every row (linears then angulars, in emission
order), RK4 pose integration, bias removal, 4 post sweeps, pose commit.
Body orientations are constant during a solve, so every per-row constant
(lever arms, Jacobians, the Iinv-projected Jacobians, denominators) is
computed once here in PyTorch; the sweeps run in the row-sweep kernel
(physics/row_sweep.py) on the card and in its plain version on the CPU.
State tensors carry the tracks as their leading dimension: pose (T, B, 7);
rows (T, R).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..maths.quat import qmul, qnormalize, qrot

FLT_MAX = float(np.float32(3.4028235e38))


def _f32(x: float) -> float:
    """A Python float holding exactly the float32 value of x."""
    return float(np.float32(x))


class PhysicsParams(NamedTuple):
    """File-scope tunables of physics.h:34-47, as float32-exact floats."""
    deltaT: float = _f32(1.0 / 60.0)
    restitution: float = _f32(0.4)
    gravity: tuple = (0.0, 0.0, 0.0)
    coloumb: float = _f32(0.6)
    biasfactorjoint: float = _f32(0.3)
    biasfactorpositive: float = _f32(0.3)
    biasfactornegative: float = _f32(0.3)
    falltime_to_ballistic: float = _f32(0.2)
    driftmax: float = _f32(0.03 / 8.0)
    damping: float = _f32(0.15)


class BodyState(NamedTuple):
    """Dynamic state of all bodies: pose (..., B, 7) pos + quat."""
    pose: torch.Tensor
    linear_momentum: torch.Tensor   # (..., B, 3)
    angular_momentum: torch.Tensor  # (..., B, 3)

    @property
    def position(self):
        return self.pose[..., :3]

    @property
    def orientation(self):
        return self.pose[..., 3:7]


class BodyParams(NamedTuple):
    """Static inertial properties (from the HandModel)."""
    massinv: torch.Tensor             # (B,)
    tensorinv_massless: torch.Tensor  # (B, 3, 3)
    damping: torch.Tensor             # (B,)
    gravscale: torch.Tensor           # (B,)
    start_pose: torch.Tensor          # (B, 7) for the NaN reset


class LinearRows(NamedTuple):
    """LimitLinear rows (physics.h:270-308), world-space precomputed form.
    Fields carry any leading batch dims before the row axis."""
    b0: torch.Tensor
    b1: torch.Tensor
    normal: torch.Tensor
    r0: torch.Tensor
    r1: torch.Tensor
    targetdist: torch.Tensor
    targetspeednobias: torch.Tensor
    fmin: torch.Tensor
    fmax: torch.Tensor
    friction_master: torch.Tensor
    friction_coef: torch.Tensor
    active: torch.Tensor


def _diffq(q, tinv, angular):
    qn = qnormalize(q)
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    R = torch.stack([qrot(qn, eye[i].expand(qn.shape[:-1] + (3,)))
                     for i in range(3)], dim=-1)
    iinv = R @ tinv @ R.transpose(-1, -2)
    halfspin = (iinv @ angular[..., None])[..., 0] * 0.5
    return qmul(torch.cat([halfspin, torch.zeros_like(halfspin[..., :1])],
                          dim=-1), qn)


def rkupdateq(q, tinv, angular, dt):
    """RK4 quaternion integration (physics.h:202-218), then normalize."""
    d1 = _diffq(q, tinv, angular)
    d2 = _diffq(q + d1 * (dt / 2), tinv, angular)
    d3 = _diffq(q + d2 * (dt / 2), tinv, angular)
    d4 = _diffq(q + d3 * dt, tinv, angular)
    return qnormalize(q + d1 * (dt / 6) + d2 * (dt / 3) + d3 * (dt / 3)
                      + d4 * (dt / 6))


def sanity_check(state: BodyState, bodies: BodyParams) -> BodyState:
    """physmodel.h:437-442: reset any body whose state went NaN."""
    bad = (torch.isnan(state.pose).any(-1)
           | torch.isnan(state.linear_momentum).any(-1)
           | torch.isnan(state.angular_momentum).any(-1))[..., None]
    pose = torch.where(bad, bodies.start_pose, state.pose)
    lm = torch.where(bad, torch.zeros_like(state.linear_momentum),
                     state.linear_momentum)
    am = torch.where(bad, torch.zeros_like(state.angular_momentum),
                     state.angular_momentum)
    return BodyState(pose, lm, am)


# ---------------------------------------------------------------------------
# the solve
# ---------------------------------------------------------------------------


