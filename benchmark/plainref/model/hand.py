"""Articulated hand model runtime ops (include/physmodel.h:321-442): the
port's counterpart of hand_tracking_samples_tpu.model.hand.  FitPointCloud
runs on the reference-shaped solvers (`fit_point_cloud`: sequential, or
colored with a schedule) or on the kernel solver (`fit_point_cloud_kernel`,
`fit_fused`); the pose API (GetPose(User), SetPose(User), Reset,
DrivePose, DriveBasePose, GenericUpdate, FixOrientations,
SetBonePoseHierarchyW, FixPositions) works on every track at once.  State
tensors carry the tracks first."""
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


def fit_fused(state: BodyState, model, params: PhysicsParams, plan,
              single_blocks=(), single_limits=(), cloud=None,
              cloud_limits=None, cloud_slots: int = 0, mode: str = "dyn",
              aa=None, drive_force: float = 0.0, iterations: int = 16,
              iterations_post: int = 4) -> BodyState:
    """One FitPointCloud solve on the kernel path for all tracks
    (physics.fused_fit): the caller's single-body blocks (concatenated in
    order), then the cloud packed by the cloud-rows kernel, the joints,
    contacts and the mode's angular rows, solved by the PGS kernel.
    single_limits / cloud_limits: the static (fmin, fmax) force limits of
    each block and of the cloud rows, for the solve's slot-bound check."""
    from ..physics.fused_fit import fused_fit
    from ..physics.pgs_kernel import check_slot_bound
    check_slot_bound(*single_limits,
                     *([cloud_limits] if cloud is not None else []))
    sb = None
    if single_blocks:
        sb = type(single_blocks[0])(*[torch.cat(xs, dim=1)
                                      for xs in zip(*single_blocks)])
    new = fused_fit(state, body_params(model), sb, plan, params,
                    iterations=iterations, iterations_post=iterations_post,
                    model=model, cloud=cloud, cloud_slots=cloud_slots,
                    mode=mode, aa=aa, drive_force=drive_force)
    return sanity_check(new, body_params(model))


def fit_point_cloud_kernel(state: BodyState, model, params: PhysicsParams,
                           points_ph, single_blocks=(), single_limits=(),
                           microforce: float = 1.0,
                           origin=(0.0, 0.0, 0.0), iterations: int = 16,
                           iterations_post: int = 4, cloud_slots: int = 128,
                           pgs_plan=None, planes_path: bool = True,
                           use_pallas: bool = True) -> BodyState:
    """FitPointCloud (physmodel.h:345-356) of the main-thread fit, all
    tracks at once, on the kernel solver: the cloud's rows (planes carrier
    points_ph (T, 8, N)) go behind the caller's single-body blocks, and the
    joint ranges are the only angular rows.  Cloud rows on the wrist, palm
    and thumb base get the weak force (physmodel.h:347).

    planes_path: the cloud kernel's own cloud, packed by kernel 2 straight
    into the solve's channels.  Otherwise (an (N, 3) cloud: the voxel and
    mirror clouds; JAX model/hand.py:194-202) kernel 2.5 packs it into one
    more single-body block, prepped with the caller's.  Without use_pallas
    that block holds the reference-shaped rows (the plane dots, the weak
    force, colored.pack_single_body_linear; JAX model/hand.py:203-211)."""
    B = model.n_bodies
    dev = state.pose.device
    scale_b = torch.where(torch.arange(B, device=dev) <= 2,
                          torch.full((), PHYSICS_WEAK_FORCE, device=dev),
                          torch.ones((), device=dev)) * microforce
    cloud_limits = (-microforce, microforce)       # +-scale, scale >= 0
    return fit_fused(state, model, params, pgs_plan, single_blocks,
                     single_limits, cloud=(points_ph, origin, scale_b),
                     cloud_limits=cloud_limits, cloud_slots=cloud_slots,
                     iterations=iterations, iterations_post=iterations_post)


def fix_positions(state: BodyState, model) -> BodyState:
    """physmodel.h:404-408 FixPositions: the top-down snap of the joint
    attachment points, joint by joint (the hand model orders joints parent
    before child).  FixPositions reads joint.p0/p1 in rig coordinates
    (before the COM offset)."""
    pose = state.pose.clone()
    com = model.com
    j0 = model.np["joint_rbi0"]
    j1 = model.np["joint_rbi1"]
    p0_rig = model.joint_p0 + com[model.joint_rbi0]
    p1_rig = model.joint_p1 + com[model.joint_rbi1]
    for j in range(len(j0)):
        b0, b1 = int(j0[j]), int(j1[j])
        q0, q1 = pose[:, b0, 3:7], pose[:, b1, 3:7]
        user0 = pose[:, b0, :3] - qrot(q0, com[b0])
        user1 = pose[:, b1, :3] - qrot(q1, com[b1])
        w0 = user0 + qrot(q0, p0_rig[j])
        w1 = user1 + qrot(q1, p1_rig[j])
        pose[:, b1, :3] = pose[:, b1, :3] + (w0 - w1)
    return state._replace(pose=pose)


def get_pose_user(state: BodyState, model):
    """Rig-space poses: position - qrot(q, com) (physics.h:142-143)."""
    pos = state.position - qrot(state.orientation, model.com)
    return torch.cat([pos, state.orientation], dim=-1)


