"""Articulated hand model runtime ops (include/physmodel.h:321-442): the
port's counterpart of hand_tracking_samples_tpu.model.hand, cut to the
dynamics frame's kernel path.  State tensors carry the tracks first."""
from __future__ import annotations

import torch

from ..maths.quat import qrot
from ..physics.solver import BodyParams, BodyState, PhysicsParams, sanity_check

PHYSICS_WEAK_FORCE = 0.4  # physmodel.h:234


def body_params(model) -> BodyParams:
    return BodyParams(massinv=model.massinv,
                      tensorinv_massless=model.tensorinv_massless,
                      damping=model.damping, gravscale=model.gravscale,
                      start_pose=model.start_pose)


def initial_state(model) -> BodyState:
    B = model.n_bodies
    z = torch.zeros((B, 3), device=model.device)
    return BodyState(pose=model.start_pose.clone(), linear_momentum=z,
                     angular_momentum=z.clone())


def fit_point_cloud(state: BodyState, model, params: PhysicsParams,
                    points_ph, single_blocks=(), single_limits=(),
                    microforce: float = 1.0,
                    origin=(0.0, 0.0, 0.0), iterations: int = 16,
                    iterations_post: int = 4, cloud_slots: int = 128,
                    pgs_plan=None) -> BodyState:
    """FitPointCloud (physmodel.h:345-356) on the kernel path, all tracks
    at once: the cloud (planes carrier points_ph (T, 8, N)) is packed by the
    cloud-rows kernel behind the caller's single-body blocks, the joints and
    contacts are built tracks-last, and the PGS kernel solves them.
    Cloud rows on the wrist, palm and thumb base get the weak force
    (physmodel.h:347).  single_limits: the static (fmin, fmax) force limits
    of each caller block, for the solve's slot-bound check."""
    from ..physics.fused_fit import fused_fit
    from ..physics.pgs_kernel import check_slot_bound
    B = model.n_bodies
    dev = state.pose.device
    scale_b = torch.where(torch.arange(B, device=dev) <= 2,
                          torch.full((), PHYSICS_WEAK_FORCE, device=dev),
                          torch.ones((), device=dev)) * microforce
    check_slot_bound((-PHYSICS_WEAK_FORCE * microforce,
                      PHYSICS_WEAK_FORCE * microforce),
                     (-microforce, microforce), *single_limits)
    sb = None
    if single_blocks:
        sb = type(single_blocks[0])(*[torch.cat(xs, dim=1)
                                      for xs in zip(*single_blocks)])
    new = fused_fit(state, body_params(model), sb, pgs_plan, params,
                    iterations=iterations, iterations_post=iterations_post,
                    model=model, cloud=(points_ph, origin, scale_b),
                    cloud_slots=cloud_slots)
    return sanity_check(new, body_params(model))


def get_pose_user(state: BodyState, model):
    """Rig-space poses: position - qrot(q, com) (physics.h:142-143)."""
    pos = state.position - qrot(state.orientation, model.com)
    return torch.cat([pos, state.orientation], dim=-1)
