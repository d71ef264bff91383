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

from ..maths import fma as fq
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


class AngularRows(NamedTuple):
    """LimitAngular rows (physics.h:239-266)."""
    b0: torch.Tensor
    b1: torch.Tensor
    axis: torch.Tensor
    targetspin: torch.Tensor
    mintorque: torch.Tensor
    maxtorque: torch.Tensor
    active: torch.Tensor


def _world_iinv(q, tinv_massless, massinv):
    """Iinv = R * tinv * R^T * massinv (physics.h:518)."""
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    R = torch.stack([qrot(q, eye[i].expand(q.shape[:-1] + (3,)))
                     for i in range(3)], dim=-1)
    return R @ tinv_massless @ R.transpose(-1, -2) * massinv[..., None, None]


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



def empty_angular(T: int, n: int, device) -> AngularRows:
    z = torch.zeros((T, n), device=device)
    i = torch.full((T, n), -1, dtype=torch.int64, device=device)
    return AngularRows(b0=i, b1=i.clone(),
                       axis=torch.zeros((T, n, 3), device=device),
                       targetspin=z, mintorque=torch.full_like(z, -FLT_MAX),
                       maxtorque=torch.full_like(z, FLT_MAX),
                       active=torch.zeros((T, n), dtype=torch.bool,
                                          device=device))


def _cat_rows(rows):
    T = rows[0].b0.shape[0]
    out = []
    for xs in zip(*rows):
        out.append(torch.cat([x.expand((T,) + tuple(x.shape[1:]))
                              for x in xs], dim=1))
    return type(rows[0])(*out)


def concat_linear(*rows: LinearRows) -> LinearRows:
    return _cat_rows(rows)


def concat_angular(*rows: AngularRows) -> AngularRows:
    return _cat_rows(rows)


# ---------------------------------------------------------------------------
# the solve
# ---------------------------------------------------------------------------

def init_momenta(state: BodyState, bodies: BodyParams,
                 params: PhysicsParams):
    """rbinitvelocity (physics.h:500-519): damped momenta plus gravity,
    (T, B, 6) [lin, ang]."""
    dt = params.deltaT
    dampleftover = torch.pow(
        1.0 - torch.clamp(bodies.damping, min=params.damping), dt)
    lin = state.linear_momentum * dampleftover[:, None]
    ang = state.angular_momentum * dampleftover[:, None]
    mass = 1.0 / bodies.massinv
    grav = torch.tensor(params.gravity, dtype=torch.float32,
                        device=lin.device)
    lin = lin + grav * (mass * bodies.gravscale * dt)[:, None]
    return torch.cat([lin, ang], dim=-1)


def matvec(M, v):
    """(..., 3, 3) @ (..., 3) as the JAX CPU build contracts a 3-deep
    dot: row i as fma(M_i2, v2, fma(M_i1, v1, M_i0 v0))."""
    return torch.stack([fq.fma(M[..., i, 2], v[..., 2],
                               fq.fma(M[..., i, 1], v[..., 1],
                                      M[..., i, 0] * v[..., 0]))
                        for i in range(3)], dim=-1)


def _gather_body(x, b):
    """x (T, B, ...) at bodies b (T, R) (-1 = world -> zeros)."""
    T = x.shape[0]
    tt = torch.arange(T, device=x.device)[:, None]
    v = x[tt, torch.clamp(b, min=0)]
    w = (b >= 0).reshape(b.shape + (1,) * (v.dim() - 2))
    return v * w.to(v.dtype)


def _mi(massinv, b):
    return torch.where(b >= 0, massinv[torch.clamp(b, min=0)],
                       torch.zeros((), device=massinv.device))


def linear_consts(iinv, massinv, b0, b1, normal, r0, r1, active):
    """row_consts_linear (solver.py:190-205) of rows (T, R): J0, J1, K0,
    K1 and dinv.  iinv (T, B, 3, 3) world inverse inertia."""
    I0 = _gather_body(iinv, b0)
    I1 = _gather_body(iinv, b1)
    J0 = fq.cross(r0, normal)
    J1 = fq.cross(r1, normal)
    K0 = matvec(I0, J0)
    K1 = matvec(I1, J1)
    denom = (_mi(massinv, b0) + fq.rsum3(fq.cross(K0, r0), normal)
             + _mi(massinv, b1) + fq.rsum3(fq.cross(K1, r1), normal))
    ok = active & (denom != 0)
    dinv = torch.where(ok, 1.0 / torch.where(ok, denom, 1.0),
                       torch.zeros((), device=denom.device))
    return J0, J1, K0, K1, dinv


def angular_consts(iinv, b0, b1, axis, active):
    """row_consts_angular (solver.py:207-214): K0, K1, spintotorque."""
    K0 = matvec(_gather_body(iinv, b0), axis)
    K1 = matvec(_gather_body(iinv, b1), axis)
    denom = fq.rsum3(axis, K0) + fq.rsum3(axis, K1)
    ok = active & (denom != 0)
    stt = torch.where(ok, 1.0 / torch.where(ok, denom, 1.0),
                      torch.zeros((), device=denom.device))
    return K0, K1, stt


def _recip(x: float) -> float:
    return float(np.float32(1.0) / np.float32(x))


def linear_targets(targetdist, targetspeednobias, params: PhysicsParams):
    """(ts, ts post): targetdist / dt (the JAX CPU build multiplies by the
    constant's float32 reciprocal) and min(ts, targetspeednobias)."""
    ts = targetdist * _recip(params.deltaT)
    return ts, torch.minimum(ts, targetspeednobias)


def angular_targets(targetspin, mintorque):
    """(spin, spin post): RemoveBias (physics.h:570-573)."""
    zero = torch.zeros((), device=targetspin.device)
    post = torch.where(mintorque < 0, zero, torch.minimum(targetspin, zero))
    return targetspin, torch.where(targetspin == -FLT_MAX, targetspin, post)


def master_positions(friction_master) -> np.ndarray:
    """Static master positions max(r + fmaster, 0) of rows whose
    friction_master is non-zero (-1 elsewhere).  friction_master (R,) or
    (T, R), the same for every track."""
    fm = friction_master
    if torch.is_tensor(fm):
        fm = fm.reshape(-1, fm.shape[-1])[0].cpu().numpy()
    fm = np.asarray(fm)
    r = np.arange(fm.shape[0])
    return np.where(fm != 0, np.maximum(r + fm, 0), -1)


def solve_and_integrate(state: BodyState, bodies: BodyParams, rows, mom0,
                        params: PhysicsParams, iterations: int,
                        iterations_post: int) -> BodyState:
    """The sweeps (row-sweep kernel or its plain version), then the pose
    from the momenta after the main sweeps (rbcalcnextpose, physics.h:
    522-531) and the momenta after the post sweeps."""
    from .row_sweep import row_sweep
    dt = params.deltaT
    out = row_sweep(mom0, bodies.massinv, rows, iterations, iterations_post)
    lin, ang = out[:, 0, :, 0:3], out[:, 0, :, 3:6]
    pos_next = state.position + lin * (bodies.massinv * dt)[:, None]
    q_next = rkupdateq(state.orientation,
                       bodies.tensorinv_massless
                       * bodies.massinv[:, None, None], ang, dt)
    return BodyState(pose=torch.cat([pos_next, q_next], dim=-1),
                     linear_momentum=out[:, 1, :, 0:3].contiguous(),
                     angular_momentum=out[:, 1, :, 3:6].contiguous())


def sweep_inputs(state: BodyState, bodies: BodyParams, linears: LinearRows,
                 angulars: AngularRows, params: PhysicsParams):
    """What the row sweep reads for one sequential solve: (mom0, rows)."""
    from ..physics.pgs_kernel import _batched_world_iinv
    from .row_sweep import angular_block, linear_block, sweep_rows
    dt = params.deltaT
    T = state.pose.shape[0]
    mom0 = init_momenta(state, bodies, params)
    iinv = _batched_world_iinv(state.orientation, bodies.tensorinv_massless,
                               bodies.massinv)
    r = linears
    J0, J1, K0, K1, dinv = linear_consts(iinv, bodies.massinv, r.b0, r.b1,
                                         r.normal, r.r0, r.r1, r.active)
    ts, tsp = linear_targets(r.targetdist, r.targetspeednobias, params)
    lin = linear_block(r.b0, r.b1, r.normal, J0, J1, K0, K1, dinv, ts, tsp,
                       r.fmin * dt, r.fmax * dt, r.friction_coef, r.active,
                       master_positions(r.friction_master))
    a = angulars
    aK0, aK1, stt = angular_consts(iinv, a.b0, a.b1, a.axis, a.active)
    spin, spinp = angular_targets(a.targetspin, a.mintorque)
    ang = angular_block(a.b0, a.b1, a.axis, aK0, aK1, stt, spin, spinp,
                        a.mintorque * dt, a.maxtorque * dt, a.active)
    return mom0, sweep_rows([lin], [ang], T, state.pose.device)


def physics_update(state: BodyState, bodies: BodyParams,
                   linears: LinearRows, angulars: AngularRows,
                   params: PhysicsParams, iterations: int = 16,
                   iterations_post: int = 4) -> BodyState:
    """One PhysicsUpdate (physics.h:543-587) for every track, rows in
    emission order.  Contact rows, if any, are already in `linears`."""
    mom0, rows = sweep_inputs(state, bodies, linears, angulars, params)
    return solve_and_integrate(state, bodies, rows, mom0, params,
                               iterations, iterations_post)
