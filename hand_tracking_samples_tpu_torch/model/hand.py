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


def joint_linear_rows(state: BodyState, model):
    """GetLinearConstraints (physmodel.h:328-334): 3 nailed rows per joint,
    in joint order; 16 joints -> (T, 48) rows."""
    from ..physics.constraints import constrain_position_nailed
    m = model.np
    return constrain_position_nailed(state.pose, m["joint_rbi0"],
                                     m["joint_p0"], m["joint_rbi1"],
                                     m["joint_p1"])


def joint_angular_rows(state: BodyState, model, params: PhysicsParams,
                       rangemin=None, rangemax=None):
    """GetAngularConstraints (physmodel.h:321-327): 6 masked slots per
    joint, (T, 96) rows.  rangemin/rangemax (T, J, 3) override the baked
    ranges (HandModelEnhancements mutates them per frame)."""
    from ..physics.constraints import constrain_angular_range
    m = model.np
    return constrain_angular_range(
        state.pose, m["joint_rbi0"], m["joint_rbi1"], m["joint_frame"],
        m["joint_rangemin"] if rangemin is None else rangemin,
        m["joint_rangemax"] if rangemax is None else rangemax, params)


def _scaled_cloud(state, model, points, point_mask, microforce, origin,
                  use_kernel):
    """The cloud rows with the weak force on the wrist, palm and thumb
    base (physmodel.h:347)."""
    from ..fitting.cloud import cloud_constraint_rows, scale_cloud_forces
    cloud = cloud_constraint_rows(state.pose, model, points, point_mask,
                                  origin=origin, use_kernel=use_kernel)
    weak = (cloud.b1 <= 2).to(torch.float32)
    return scale_cloud_forces(
        cloud, (weak * PHYSICS_WEAK_FORCE + (1.0 - weak)) * microforce)


def fit_point_cloud(state: BodyState, model, params: PhysicsParams, points,
                    point_mask, linears=None, angulars=None,
                    microforce: float = 1.0, origin=(0.0, 0.0, 0.0),
                    rangemin=None, rangemax=None, iterations: int = 16,
                    iterations_post: int = 4, contacts: bool = False,
                    schedule=None, single_blocks=(), cloud_slots: int = 128,
                    use_kernel: bool = False) -> BodyState:
    """FitPointCloud (physmodel.h:345-356) on the reference-shaped solvers,
    for all tracks: points (T, N, 3), point_mask (T, N).

    Sequential (schedule None): rows [caller linears][cloud][joint nailed]
    [contacts], angulars [caller angulars][joint ranges], solved in that
    order by physics_update.  Colored (schedule a HandSchedule): the
    caller's single-body blocks, the cloud packed into cloud_slots per body,
    the joints and contacts as pair blocks on the schedule's groups, solved
    by physics_update_colored.  use_kernel: the correspondence kernel
    (N a multiple of 512)."""
    from ..physics.colored import physics_update_colored
    from ..physics.solver import physics_update
    lin, ang = fit_rows(state, model, params, points, point_mask, linears,
                        angulars, microforce, origin, rangemin, rangemax,
                        contacts, schedule, single_blocks, cloud_slots,
                        use_kernel)
    bp = body_params(model)
    solve = physics_update if schedule is None else physics_update_colored
    new = solve(state, bp, lin, ang, params, iterations=iterations,
                iterations_post=iterations_post)
    return sanity_check(new, bp)


def fit_rows(state: BodyState, model, params: PhysicsParams, points,
             point_mask, linears=None, angulars=None,
             microforce: float = 1.0, origin=(0.0, 0.0, 0.0), rangemin=None,
             rangemax=None, contacts: bool = False, schedule=None,
             single_blocks=(), cloud_slots: int = 128,
             use_kernel: bool = False, angular_pair_blocks=()):
    """fit_point_cloud's rows: (linear rows, angular rows) for the
    sequential solve, (linear blocks, angular blocks) for the colored
    one, the caller's angular pair blocks before the ranges.  N may be 0:
    MultiStepSim passes its cloud rows as the caller's rows."""
    from ..physics.colored import pack_single_body_linear
    from ..physics.contacts import contact_rows
    from ..physics.schedule import pair_angular, pair_linear
    from ..physics.solver import concat_angular, concat_linear
    cloud = (_scaled_cloud(state, model, points, point_mask, microforce,
                           origin, use_kernel)
             if points.shape[1] > 0 else None)
    nailed = joint_linear_rows(state, model)
    con = contact_rows(state, model, params) if contacts else None
    ranges = joint_angular_rows(state, model, params, rangemin, rangemax)
    if schedule is None:
        lin = [x for x in (linears, cloud, nailed, con) if x is not None]
        ang = [x for x in (angulars, ranges) if x is not None]
        return concat_linear(*lin), concat_angular(*ang)
    lin = list(single_blocks)
    if cloud is not None:
        lin.append(pack_single_body_linear(cloud, model.n_bodies,
                                           cloud_slots))
    lin.append(pair_linear(nailed, schedule.joint_lin))
    if con is not None:
        lin.append(pair_linear(con, schedule.contact))
    return lin, [*angular_pair_blocks,
                 pair_angular(ranges, schedule.joint_ang)]


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
    if not use_pallas:
        from ..ops.cloud_kernel import planes_points
        from ..physics.colored import pack_single_body_linear
        points, mask = planes_points(points_ph)
        rows = _scaled_cloud(state, model, points, mask, microforce,
                             origin, use_kernel=False)
        return fit_fused(state, model, params, pgs_plan,
                         (*single_blocks,
                          pack_single_body_linear(rows, B, cloud_slots)),
                         (*single_limits, cloud_limits),
                         iterations=iterations,
                         iterations_post=iterations_post)
    if not planes_path:
        from ..ops.cloud_rows import cloud_rows_packed_ph
        blk, _ = cloud_rows_packed_ph(state.pose, model, points_ph, origin,
                                      scale_b, cloud_slots)
        return fit_fused(state, model, params, pgs_plan,
                         (*single_blocks, blk),
                         (*single_limits, cloud_limits),
                         iterations=iterations,
                         iterations_post=iterations_post)
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


def set_pose_user(state: BodyState, model, poses_user) -> BodyState:
    """SetPoseUser: rig-space poses (T, 17, 7) -> physics poses (position
    + qrot(q, com))."""
    pos = poses_user[..., :3] + qrot(poses_user[..., 3:7], model.com)
    return state._replace(pose=torch.cat([pos, poses_user[..., 3:7]], -1))


def set_pose(state: BodyState, poses) -> BodyState:
    return state._replace(pose=poses)


def reset_state(model) -> BodyState:
    """Reset: the model's start pose, at rest (one track)."""
    return initial_state(model)


def _joint_drives(state: BodyState, model, targets, params, maxtorque):
    from ..physics.constraints import constrain_angular_drive
    from ..physics.solver import concat_angular
    j0, j1 = model.np["joint_rbi0"], model.np["joint_rbi1"]
    return concat_angular(*[constrain_angular_drive(
        state.pose, int(j0[j]), int(j1[j]), targets(j), maxtorque, params)
        for j in range(len(j0))])


def drive_pose_rows(state: BodyState, model, target_poses, params,
                    maxtorque: float = 1.0):
    """DrivePose (physmodel.h:368-374): angular drives toward the relative
    orientations of target_poses (T, 17, 7), 3 rows a joint in joint
    order, AngularRows (T, 48)."""
    from ..maths.quat import qconj, qmul
    j0, j1 = model.np["joint_rbi0"], model.np["joint_rbi1"]
    return _joint_drives(state, model, lambda j: qmul(
        qconj(target_poses[:, int(j0[j]), 3:7]),
        target_poses[:, int(j1[j]), 3:7]), params, maxtorque)


def drive_base_pose_rows(state: BodyState, model, params,
                         maxtorque: float = 1.0):
    """DriveBasePose (physmodel.h:375-381): the joints driven to their
    frames, AngularRows (T, 48)."""
    T = state.pose.shape[0]
    return _joint_drives(state, model,
                         lambda j: model.joint_frame[j].expand(T, 4),
                         params, maxtorque)


def generic_update(state: BodyState, model, params) -> BodyState:
    """GenericUpdate (physmodel.h:335-341): a step of the joint rows alone
    (the sequential solve, the row-sweep kernel)."""
    from ..physics.solver import physics_update
    bp = body_params(model)
    return sanity_check(physics_update(
        state, bp, joint_linear_rows(state, model),
        joint_angular_rows(state, model, params), params), bp)


def fix_orientations(state: BodyState, model, params) -> BodyState:
    """FixOrientations (physmodel.h:394-403): joint by joint, each violated
    range row's correction applied to the child's orientation directly."""
    from ..maths.quat import qmul, qnormalize, quat_from_axis_angle
    from ..physics.constraints import constrain_angular_range
    m = model.np
    pose = state.pose.clone()
    for j in range(len(m["joint_rbi0"])):
        b1 = int(m["joint_rbi1"][j])
        sl = slice(j, j + 1)
        rows = constrain_angular_range(
            pose, m["joint_rbi0"][sl], m["joint_rbi1"][sl],
            m["joint_frame"][sl], m["joint_rangemin"][sl],
            m["joint_rangemax"][sl], params)
        for a in range(6):
            ts = rows.targetspin[:, a]
            viol = (((ts * rows.maxtorque[:, a] > 0)
                     | (ts * rows.mintorque[:, a] > 0)) & rows.active[:, a])
            dq = quat_from_axis_angle(rows.axis[:, a], ts * params.deltaT)
            newq = qnormalize(qmul(dq, pose[:, b1, 3:7]))
            pose[:, b1, 3:7] = torch.where(viol[:, None], newq,
                                           pose[:, b1, 3:7])
    return state._replace(pose=pose)


def set_bone_pose_hierarchy_w(state: BodyState, model, params, bid: int,
                              qw) -> BodyState:
    """SetBonePoseHierarchyW (physmodel.h:357-367): bone bid's world
    orientation set to qw ((4,) or (T, 4)) and the same turn applied to
    its descendants (the joint tree's, found on the host), then the ranges
    and positions repaired."""
    from ..maths.quat import qconj, qmul
    j0 = [int(x) for x in model.np["joint_rbi0"]]
    j1 = [int(x) for x in model.np["joint_rbi1"]]

    def parent(i):
        p = i
        for a, b in zip(j0, j1):
            if a == i or b == i:
                p = min(p, min(a, b))
        return -1 if p == i else p
    desc, changed = [bid], True
    while changed:
        changed = False
        for c in range(model.n_bodies):
            if c not in desc and parent(c) in desc:
                desc.append(c)
                changed = True
    pose = state.pose.clone()
    qw = torch.as_tensor(qw, dtype=torch.float32,
                         device=pose.device).expand(pose.shape[0], 4)
    dq = qmul(qw, qconj(pose[:, bid, 3:7]))
    for c in desc:
        pose[:, c, 3:7] = qmul(dq, pose[:, c, 3:7])
    out = fix_orientations(state._replace(pose=pose), model, params)
    return fix_positions(out, model)
