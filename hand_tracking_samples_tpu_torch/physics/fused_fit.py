"""Fused PGS fit: tracks-last row factories + prep + the solve kernel + pose
integration (the port's counterpart of the batched rule
hand_tracking_samples_tpu/physics/fused_fit.py:192 `_fused_batched`,
modes "dyn", "ms_angles", "ms_noangles").  The port is batched from the
start: every tensor carries the tracks, so there is no custom_vmap and no
unbatched fallback.

Reference semantics: physmodel.h:345-356 FitPointCloud row order
[caller singles][cloud singles][joint nailed][contacts]; angulars
[ApplyAngles][arm cone][joint ranges] (handtrack.h:658-688) or
[joint ranges] alone for the main-thread fit (handtrack.h:769-783).
"""
from __future__ import annotations

import numpy as np
import torch

from . import row_planes as rp
from .contacts import CONTACT_POINTS
from .pgs_kernel import (BP, _batched_world_iinv, _prep_singles, pgs_solve)
from .solver import BodyState, PhysicsParams


def _cloud_singles_planes(packed, dt):
    """packed (T, 12, BP*C) solve-prep channels from
    ops.cloud_rows.cloud_rows_solve -> (T, C, 14, BP) singles: the tsp and
    force-limit channels derive here (tsnb = 0 for cloud rows)."""
    T = packed.shape[0]
    C = packed.shape[2] // BP
    x = packed.reshape(T, 12, BP, C)
    tsm = x[:, 10]
    tsp = torch.clamp(tsm, max=0.0)
    f = x[:, 11] * dt
    chans = torch.cat([x[:, 0:11], tsp[:, None], (-f)[:, None],
                       f[:, None]], dim=1)                # (T, 14, BP, C)
    return chans.permute(0, 3, 1, 2).contiguous()


def initial_momenta(state: BodyState, bodies, params: PhysicsParams,
                    bp: int = BP):
    """rbinitvelocity (physics.h:500-519): damped momenta plus gravity, as
    the solve's (T, 6, bp) planes, and the (bp,) inverse masses."""
    dt = params.deltaT
    T, B = state.pose.shape[0], state.pose.shape[1]
    dev = state.pose.device
    dampleftover = torch.pow(
        1.0 - torch.clamp(bodies.damping, min=params.damping), dt)
    lin0 = state.linear_momentum * dampleftover[None, :, None]
    ang0 = state.angular_momentum * dampleftover[None, :, None]
    mass = 1.0 / bodies.massinv
    grav = torch.tensor(params.gravity, dtype=torch.float32, device=dev)
    lin0 = lin0 + grav[None, None, :] * (
        mass * bodies.gravscale * dt)[None, :, None]
    mom0 = torch.zeros((T, 6, bp), device=dev)
    mom0[:, 0:3, :B] = lin0.transpose(1, 2)
    mom0[:, 3:6, :B] = ang0.transpose(1, 2)
    mi = torch.zeros(bp, device=dev)
    mi[:B] = bodies.massinv
    return mom0, mi


def solve_inputs(state: BodyState, bodies, single_rows, plan,
                 params: PhysicsParams, model, cloud=None,
                 cloud_slots: int = 0, mode: str = "dyn", aa=None,
                 drive_force: float = 0.0) -> dict:
    """Everything the PGS kernel reads for one FitPointCloud of all tracks,
    plus the pose planes the integration needs: a dict with mom0, mi,
    singles, lin_rows, ang_rows (pgs_kernel's layouts) and P.

    state: (T, B, ...) BodyState.  single_rows: caller SingleBodyLinear
    (T, C_small, B) or None.  cloud: (ph (T, 8, N), origin (3,) floats or
    (T, 3), scale_per_body (B,) or (T, B)), packed by the cloud-rows kernel
    straight into the solve's singles.  Slot order is [single_rows][cloud]
    and the total must equal plan.CS.  mode: "dyn" (angular rows [joint
    ranges]), "ms_angles" ([palm drive][finger cones][arm cone][joint
    ranges]) or "ms_noangles" ([arm cone][joint ranges]), the MultiStepSim
    steps (handtrack.h:658-688); aa = (palmq (T, 4), finger_clenched
    (T, 5), camera quaternion (T, 4)) for the ms modes; drive_force the
    palm drive's torque limit."""
    dt = params.deltaT
    bp = plan.bp
    model_np = model.np
    hmi = np.asarray(model_np["massinv"], np.float32)

    iinv_tb = _batched_world_iinv(state.pose[..., 3:7],
                                  bodies.tensorinv_massless, bodies.massinv)
    P = rp.pose_planes(state.pose, bodies.tensorinv_massless, bodies.massinv,
                       iinv_tb=iinv_tb)

    mom0, mi = initial_momenta(state, bodies, params, bp)

    # ---- singles: [caller blocks][cloud] ----
    s_parts = []
    if single_rows is not None:
        s_parts.append(_prep_singles(single_rows, iinv_tb, bodies.massinv,
                                     dt, bp))
    if cloud is not None:
        from ..ops.cloud_rows import cloud_rows_solve_ph
        ph, origin, scale_b = cloud
        packed, _ = cloud_rows_solve_ph(state.pose, model, ph, origin,
                                        scale_b, cloud_slots, dt)
        s_parts.append(_cloud_singles_planes(packed, dt))
    s_all = torch.cat(s_parts, dim=1) if s_parts else None
    if plan.CS:
        assert s_all is not None and s_all.shape[1] == plan.CS, (
            plan.key, None if s_all is None else s_all.shape)

    # ---- pair-class planes, tracks-last ----
    lin_g, ang_g = pair_factories(state, plan, params, model, P, mode, aa,
                                  drive_force)
    lin_planes, ang_planes = pair_preps(P, lin_g, ang_g, plan, dt, hmi)

    return dict(mom0=mom0, mi=mi, singles=s_all, lin_rows=lin_planes,
                ang_rows=ang_planes, P=P)


def pair_factories(state: BodyState, plan, params: PhysicsParams, model, P,
                   mode: str = "dyn", aa=None, drive_force: float = 0.0):
    """The pair classes' row factories of one solve (the work the JAX
    package's HTS_ZERO_PLANES switch let XLA drop): the joints' nailed
    geometry, the contacts (kernel 3 and their geometry) when the plan has
    them, and the mode's angular rows.  Returns (linear, angular): per
    class the (b0, b1, *fields) tuple its prep takes (pair_preps)."""
    model_np = model.np
    lin = [rp.joint_lin_geometry(P, model_np)]
    if len(plan.lin_classes) > 1:
        from .contact_kernel import contact_fields
        fields = contact_fields(state.pose, state.linear_momentum,
                                state.angular_momentum, model, params,
                                CONTACT_POINTS)
        pairs_np = np.asarray(model_np["collide_pairs"])
        lin.append(rp.contact_geometry(fields, pairs_np, params, 0.6,
                                       CONTACT_POINTS))
    ang = []
    if mode != "dyn":
        palmq_b, clenched_b, camq_b = aa
        palmq = [palmq_b[:, c][None, :] for c in range(4)]
        camq = [camq_b[:, c][None, :] for c in range(4)]
        if mode == "ms_angles":
            ang.append((np.asarray([-1] * 3), np.asarray([1] * 3),
                        *rp.apply_angles_drive(P, palmq, camq, drive_force,
                                               params)))
            ang.append(tuple(rp.apply_angles_cones(P, clenched_b.T,
                                                   model_np, params)))
        ang.append(tuple(rp.armdir_cone(P, camq, params)))
    rmin, rmax = rp.enhancement_ranges(P, model_np)
    ang.append(rp.joint_ang_geometry(P, model_np, params, rmin, rmax))
    assert len(lin) == len(plan.lin_classes), plan.key
    assert len(ang) == len(plan.ang_classes), plan.key
    return lin, ang


def pair_preps(P, lin, ang, plan, dt, hmi):
    """The pair classes' preps: each factory's rows (pair_factories) into
    its solve channels, then into the PGS kernel's phase planes.  Returns
    (linear planes, angular planes)."""
    lin_planes = [rp.phase_planes_t(rp.prep_lin_channels(
        P, g[0], g[1], hmi, dt, *g[2:]), cls)
        for g, cls in zip(lin, plan.lin_classes)]
    ang_planes = [rp.phase_planes_t(rp.prep_ang_channels(
        P, g[0], g[1], dt, *g[2:]), cls)
        for g, cls in zip(ang, plan.ang_classes)]
    return lin_planes, ang_planes


def integrate(out, P, model_np, dt) -> BodyState:
    """Pose integration, tracks-last (physics.h:522-531): the next pose
    from the momenta after the main sweeps, the momenta after the post
    sweeps.  out (T, 2, 6, BP) from the solve."""
    B = P.B
    dev = out.device
    hmi = np.asarray(model_np["massinv"], np.float32)
    htinv = np.asarray(model_np["tensorinv_massless"], np.float32)
    m0 = out[:, 0].permute(1, 2, 0)[:, :B]                  # (6, B, T)
    mf = out[:, 1].permute(1, 2, 0)[:, :B]
    mi_dt = torch.as_tensor(hmi, device=dev)[:, None] * dt
    pos_next = [P.tr[c] + m0[c] * mi_dt for c in range(3)]
    tinv_mi = torch.as_tensor(htinv * hmi[:, None, None], device=dev)
    q_next = rp.rkupdateq_planes(P.q, tinv_mi, [m0[3 + c] for c in range(3)],
                                 dt)
    pose = torch.stack(pos_next + q_next, dim=0).permute(2, 1, 0)
    lin_f = mf[0:3].permute(2, 1, 0)
    ang_f = mf[3:6].permute(2, 1, 0)
    return BodyState(pose=pose.contiguous(),
                     linear_momentum=lin_f.contiguous(),
                     angular_momentum=ang_f.contiguous())


def fused_fit(state: BodyState, bodies, single_rows, plan,
              params: PhysicsParams, iterations: int = 16,
              iterations_post: int = 4, model=None, cloud=None,
              cloud_slots: int = 0, mode: str = "dyn", aa=None,
              drive_force: float = 0.0) -> BodyState:
    """One FitPointCloud solve for all tracks: solve_inputs -> the PGS
    kernel -> integrate."""
    x = solve_inputs(state, bodies, single_rows, plan, params, model, cloud,
                     cloud_slots, mode, aa, drive_force)
    out = pgs_solve(plan, iterations, iterations_post, x["mom0"], x["mi"],
                    x["singles"], x["lin_rows"], x["ang_rows"])
    return integrate(out, x["P"], model.np, params.deltaT)
