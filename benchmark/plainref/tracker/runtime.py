"""HandTracker runtime: the per-frame tracking step (include/handtrack.h:
693-785), the port's counterpart of hand_tracking_samples_tpu.tracker.runtime.

Every function runs all tracks at once (tracks are the leading dimension of
the state, the depth and every intermediate).  On the kernel solver:

  dynamics frame   depth -> cloud kernel -> boundary-plane chamber rows ->
                   cloud-rows kernel -> joint / contact (contact kernel) /
                   angular rows -> PGS kernel -> poses
  CNN frame        segmentation -> CNN -> FitError (vals kernel) -> reset
                   (PoseFromScratch + UnibodyFit: unpacked-rows kernel and
                   the PGS kernel's unibody plan, on the resetting tracks
                   only) -> MultiStepSim (the PGS kernel's multistep plans)
                   -> FitError -> take, then the dynamics frame

On the sequential solver (the JAX package's default) and the colored one:

  dynamics frame   depth -> cloud kernel -> chamber rows -> cloud rows (the
                   correspondence kernel with use_pallas, the plane dots
                   without) -> joints / contacts (contact kernel) / ranges
                   -> the row-sweep kernel -> poses
  CNN frame        segmentation -> CNN -> FitError (the vals kernel with
                   use_pallas, closest_vals without) -> reset
                   (PoseFromScratch + UnibodyFit: with use_pallas the
                   unpacked-rows kernel and the PGS kernel's unibody plan,
                   without it the plane-dot cloud rows and a one-body
                   colored solve on the row-sweep kernel) -> MultiStepSim
                   (keypoint, cloud, ApplyAngles and arm-cone rows solved
                   by the row-sweep kernel) -> FitError -> take, then the
                   dynamics frame

Every one of these frames also runs on the voxel cloud (subsample_voxel:
the full-image point_cloud averaged per voxel and compacted to the point
budget) and through a mirror rig's plane (mirror_plane), alone or together.
Those clouds leave the planes carrier: on the kernel solver the fits pack
their rows with kernel 2.5 (the 16-channel cloud-rows pack) as a
single-body block, in the dynamics pass and in each MultiStepSim step.

slowfit, the annotation-grade fit of the annotate CLI (handtrack.h:
786-821): six sequential solves (the row-sweep kernel) of the cloud's rows
(the correspondence kernel with use_pallas), the joints, the contacts
(contact kernel), and the annotator's extras: CNN landmark rays, a
dragged-bone nail and the hold mode's relative angular rows.

Every setting of TrackerConfig runs.  contacts_mode="jacobi" is read by
the kernel solver's PGS plans (one jacobi contact class) and the colored
solver's schedule (jacobi phases, the row sweep's jacobi levels), as in
JAX runtime.py:771-783; the sequential solver and slowfit never read it.
On the kernel solver without use_pallas the cloud's rows are the
reference-shaped ones (the plane dots) packed into one more single-body
block of the PGS solve, in the dynamics pass, the reset's UnibodyFit and
each MultiStepSim step; FitError takes closest_vals.  angles_only resets
and takes the refit on every track, runs MultiStepSim with its angle rows
on every step and no keypoint or cloud rows, and skips the main-thread
pass.  kickstart_multi runs the reset from palm-flip hypotheses folded
into the track dimension and keeps each track's best.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..cnn.labels import CNNAnalysis, analyze_cnn_output
from ..cnn.model import forward as cnn_forward
from ..fitting.cloud import cloud_chamber_rows, fit_error, rows_to_single_block
from ..imaging.image_ops import compact_planes
from ..maths.pose import pose_inverse, pose_mul, pose_quat
from ..maths.quat import qmul, quat_from_axis_angle, quat_from_to, qxdir, qydir
from ..model.bake import FEATURE_BONES, FEATURE_OFFSETS
from ..model.hand import (body_params, fit_fused, fit_point_cloud_kernel,
                          fix_positions, get_pose_user, initial_state)
from ..ops.cloud_kernel import cloud_from_depth_planes, planes_points
from ..physics.solver import BodyState, PhysicsParams, sanity_check
from ..segment.handsegment import cnn_input_from_segment, hand_segment_vr
from .config import TrackerConfig

BOUNDARY_OUTDIRS = ((-1.0, -0.25, 0.0), (-1.0, -1.0, 0.0), (0.0, -1.0, 0.0),
                    (1.0, -1.0, 0.0), (1.0, -0.25, 0.0))  # handtrack.h:776
CHAMBER_MAXFORCE = 10.0


class TrackerState(NamedTuple):
    body: BodyState
    prev_frame_error: torch.Tensor   # f32, one per track
    initializing: torch.Tensor       # i32, one per track


def make_tracker_state(model) -> TrackerState:
    """One track's state at the model's start pose."""
    dev = model.device
    return TrackerState(body=initial_state(model),
                        prev_frame_error=torch.zeros((), device=dev),
                        initializing=torch.zeros((), dtype=torch.int32,
                                                 device=dev))


def physics_params(config: TrackerConfig) -> PhysicsParams:
    """Physics globals as the HandTracker ctor sets them
    (handtrack.h:837-838): no gravity, driftmax 0.03/8."""
    return PhysicsParams()


def _check_config(config: TrackerConfig):
    """Raise ValueError for a setting this copy does not keep: it keeps
    the kernel solver's plain paths with use_pallas, exact contacts and
    the cloud kernel's cloud (no voxel subsampling, no mirror plane), the
    settings of the benchmark's configurations."""
    if (config.solver != "kernel" or not config.use_pallas
            or config.contacts_mode != "exact" or config.subsample_voxel
            or config.mirror_plane):
        raise ValueError("the plain reference keeps only the kernel solver "
                         "with use_pallas, exact contacts and the cloud "
                         f"kernel's cloud: {config}")


_UNIBODY_TINV = 6.0 / (0.2 * 0.2)   # solid cube of side 0.2, unit mass


class CnnDebug(NamedTuple):
    """Last CNN inputs and outputs (handtrack.h:618-640), tracks leading."""
    cnn_input: torch.Tensor     # (T, 64, 64)
    cnn_output: torch.Tensor    # (T, 2304)
    image_points: torch.Tensor  # (T, 8, 2)
    segment_cam_pose: torch.Tensor  # (T, 7)


# ---------------------------------------------------------------------------
# PoseFromScratch (handtrack.h:473-506)
# ---------------------------------------------------------------------------

def pose_from_scratch(body: BodyState, model, analysis: CNNAnalysis, ph,
                      camera_pose) -> BodyState:
    """The hand placed from the CNN alone: the palm on the weighted cloud
    centre along the palm ray, oriented by the net's palm angles, fingers
    curled by its clench angles.  ph (T, 8, N) planes carrier;
    camera_pose (T, 7)."""
    points, mask = planes_points(ph)
    crays = analysis.crays
    palmray = crays[:, 0, :3] + crays[:, 1, :3] + crays[:, 2, :3]
    palmray = palmray / torch.clamp(
        torch.linalg.vector_norm(palmray, dim=-1, keepdim=True), min=1e-20)
    c = torch.linalg.cross(points, palmray[:, None].expand_as(points))
    w = 1.0 / (1e-6 + (c * c).sum(-1))
    w = torch.where(mask, w, torch.zeros((), device=w.device))
    wsum = 1e-11 + w.sum(1)
    pcom = (points * w[..., None]).sum(1) / wsum[:, None]

    st = model.start_pose
    T = points.shape[0]
    p1 = torch.cat([pcom, qmul(pose_quat(camera_pose), analysis.palmq)], -1)
    dp = pose_mul(p1, pose_inverse(st[1]).expand(T, 7))
    pose = pose_mul(dp[:, None].expand(T, st.shape[0], 7),
                    st[None].expand(T, -1, -1)).contiguous()
    xaxis = torch.tensor([1.0, 0.0, 0.0], device=pose.device).expand(T, 3)
    for finger in (1, 2, 3, 4):
        a = analysis.finger_clenched[:, finger]
        jf = model.joint_frame[1 + finger * 3].expand(T, 4)
        for k, mult in ((2, 0.5), (3, 1.0), (4, 1.25)):
            b = k + finger * 3
            pose[:, b, 3:7] = qmul(jf, qmul(
                pose[:, b, 3:7], quat_from_axis_angle(xaxis, a * mult)))
    z = torch.zeros_like(body.linear_momentum)
    return fix_positions(BodyState(pose=pose, linear_momentum=z,
                                   angular_momentum=z.clone()), model)


# ---------------------------------------------------------------------------
# UnibodyFit (handtrack.h:444-470)
# ---------------------------------------------------------------------------

def _subsample4(ph):
    """takesubsample (handtrack.h:453, :679): the mask (T, N) of every 4th
    valid point of the planes carrier ph, and N."""
    mask = ph[:, 4] > 0.5
    keep = mask & ((torch.cumsum(mask.to(torch.int64), 1) - 1) % 4 == 0)
    return keep, ph.shape[2]


def unibody_inputs(body: BodyState, model, params, ph, camera_position,
                   unibody_force: float = 0.1) -> dict:
    """What UnibodyFit's solve reads: the cloud rows against the
    articulated hand (the unpacked-rows kernel on the stride-4 subsample),
    retargeted to one free body at the palm (a cube of side 0.2 and unit
    mass), prepped for the PGS kernel's unibody plan.  Returns a dict with
    plan, mom0, mi, singles (pgs_kernel's layouts), uni_pose (T, 7) and
    tinv."""
    from ..ops.cloud_rows import cloud_rows_unibody
    from ..physics.fused_fit import initial_momenta
    from ..physics.pgs_kernel import (_batched_world_iinv, _prep_singles,
                                      build_unibody_plan, check_slot_bound)
    from ..physics.solver import BodyParams
    keep, N = _subsample4(ph)
    uph = compact_planes(ph, keep, max(N // 4, 64))
    T = ph.shape[0]
    dev = ph.device
    uni_pose = body.pose[:, 1]                              # (T, 7)
    blk = cloud_rows_unibody(body.pose, model, uph, camera_position,
                             uni_pose[:, :3], unibody_force)
    check_slot_bound((-unibody_force, unibody_force))
    plan = build_unibody_plan(blk.targetdist.shape[1])
    tinv = torch.eye(3, device=dev)[None] * _UNIBODY_TINV
    one = torch.ones(1, device=dev)
    ubody = BodyParams(massinv=one, tensorinv_massless=tinv,
                       damping=torch.zeros(1, device=dev), gravscale=one,
                       start_pose=uni_pose[:1])
    z = torch.zeros((T, 1, 3), device=dev)
    ustate = BodyState(pose=uni_pose[:, None], linear_momentum=z,
                       angular_momentum=z)
    mom0, mi = initial_momenta(ustate, ubody, params, plan.bp)
    iinv = _batched_world_iinv(uni_pose[:, None, 3:7], tinv, one)
    singles = _prep_singles(blk, iinv, one, params.deltaT, plan.bp)
    return dict(plan=plan, mom0=mom0, mi=mi, singles=singles,
                uni_pose=uni_pose, tinv=tinv)


def unibody_pose(x: dict, out, body: BodyState, model, dt) -> BodyState:
    """The free body's motion from the solve's momenta out (T, 2, 6, 8),
    applied to every bone."""
    from ..physics.solver import rkupdateq
    uni_pose, T, B = x["uni_pose"], body.pose.shape[0], body.pose.shape[1]
    pos = uni_pose[:, :3] + out[:, 0, 0:3, 0] * dt       # massinv 1
    qn = rkupdateq(uni_pose[:, 3:7], x["tinv"], out[:, 0, 3:6, 0], dt)
    dp = pose_mul(torch.cat([pos, qn], -1), pose_inverse(uni_pose))
    pose = pose_mul(dp[:, None].expand(T, B, 7), body.pose)
    return sanity_check(body._replace(pose=pose), body_params(model))


def unibody_fit(body: BodyState, model, params, ph, camera_position,
                unibody_force: float = 0.1, iterations: int = 16,
                iterations_post: int = 4,
                use_kernel: bool = True) -> BodyState:
    """Rigid fit of the whole hand as one free body to the cloud, and the
    palm's motion applied to every bone.  ph (T, 8, N); camera_position
    (T, 3).  use_kernel: unibody_inputs (the unpacked-rows kernel) solved
    in the rows' sequential order by the PGS kernel's unibody plan;
    without it (JAX runtime.py:275-291) the plane-dot cloud rows of the
    stride-4 subsample retargeted to the free body, solved as one
    single-body colored block by the row-sweep kernel."""
    from ..physics.pgs_kernel import pgs_solve
    x = unibody_inputs(body, model, params, ph, camera_position,
                       unibody_force)
    out = pgs_solve(x["plan"], iterations, iterations_post, x["mom0"],
                    x["mi"], x["singles"], [], [])
    return unibody_pose(x, out, body, model, params.deltaT)


# ---------------------------------------------------------------------------
# MultiStepSim (handtrack.h:642-690)
# ---------------------------------------------------------------------------

def _ray_rows(body: BodyState, crays, features, origin, gates):
    """CNN landmark-ray dead zones: for each feature i of `features`, two
    rows along each of the normal axes (x then y) of its ray crays[:, i]
    (T, 8, 4), anchored at the world point origin (T, 3), radius 0.01,
    force +-100000, active where gates[k] (a (T,) bool or True).
    LinearRows (T, 4 * len(features)) in the JAX package's order."""
    from ..physics.constraints import constrain_along_direction_deadzone
    from ..physics.solver import LinearRows
    T = body.pose.shape[0]
    dev = body.pose.device
    zaxis = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(T, 3)
    parts = []
    for i, ok in zip(features, gates):
        q = quat_from_to(zaxis, crays[:, i, :3])
        bone = int(FEATURE_BONES[i])
        offset = torch.tensor(FEATURE_OFFSETS[i], dtype=torch.float32,
                              device=dev).expand(T, 3)
        for axis in (qxdir(q), qydir(q)):
            r = constrain_along_direction_deadzone(
                origin, body.pose[:, bone], offset, axis, 0.01, -100000.0,
                100000.0, ok)
            parts.append(r._replace(b1=torch.full_like(r.b1, bone)))
    return LinearRows(*[torch.cat(xs, dim=1) for xs in zip(*parts)])


def _keypoint_rows(body: BodyState, analysis, camera_pose,
                   config: TrackerConfig):
    """The CNN keypoint dead zones of MultiStepSim (handtrack.h:665-676):
    features 3-7 from the camera, each gated by its finger's clench and
    its ray's probability, LinearRows (T, 20)."""
    start = 3 if config.steps_keyangles else 0
    features = range(max(start, 3), 8)
    gates = [(analysis.finger_clenched[:, i - 3] < 3.14 / 2.0)
             & (analysis.crays[:, i, 3] >= config.min_cray_prob)
             for i in features]
    return _ray_rows(body, analysis.crays, features, camera_pose[:, :3],
                     gates)


def _keypoint_block(body: BodyState, model, analysis, camera_pose,
                    config: TrackerConfig):
    """_keypoint_rows packed 4 slots per body (the kernel and colored
    solvers' form)."""
    from ..physics.colored import pack_single_body_linear
    return pack_single_body_linear(
        _keypoint_rows(body, analysis, camera_pose, config),
        body.pose.shape[1], 4)


def _cloudforce(ph, config: TrackerConfig):
    """MultiStepSim's cloud force a track (T,): min(cloudforce_max_point,
    cloudforce_max_sum / the frame cloud's points)."""
    npts = torch.clamp((ph[:, 4] > 0.5).sum(1), min=1).to(torch.float32)
    return torch.clamp(config.cloudforce_max_sum / npts,
                       max=config.cloudforce_max_point)


def multistep_cloud(ph, camera_pose, config: TrackerConfig, B: int):
    """MultiStepSim's cloud (handtrack.h:679): the stride-4 subsample,
    compacted to ceil(budget/4) slots rounded up to 128 (the most it can
    hold), with the cloud force min(cloudforce_max_point,
    cloudforce_max_sum / points), a tenth of it on the wrist.  Returns the
    fused fit's cloud argument (ph (T, 8, M), origin (T, 3), scale
    (T, B))."""
    dev = ph.device
    cloudforce = _cloudforce(ph, config)
    keep, N = _subsample4(ph)
    q4 = -(-N // 4)
    mph = compact_planes(ph, keep, max(-(-q4 // 128) * 128, 128))
    wrist = torch.where(torch.arange(B, device=dev) == 0,
                        torch.full((), 0.1, device=dev),
                        torch.ones((), device=dev))
    return mph, camera_pose[:, :3], cloudforce[:, None] * wrist


def multi_step_sim(body: BodyState, model, analysis: CNNAnalysis, ph,
                   camera_pose, config: TrackerConfig, params,
                   schedule=None) -> BodyState:
    """The staged constraint schedule of the CNN refit: per step, the CNN
    keypoint rows (steps < steps_keypoints), the subsampled cloud
    (steps >= steps_cloudstart), the ApplyAngles drive and cones
    (steps < steps_keyangles; palm drive torque while
    steps < steps_palmangle), the arm cone and the joint ranges; with
    angles_only the angle rows on every step and no keypoint or cloud rows
    (JAX runtime.py:341-377).  ph (T, 8, N); camera_pose (T, 7).  On the
    kernel solver the PGS kernel's multistep plan solves them, the cloud's
    rows packed by kernel 2 straight into the solve, or for the voxel and
    mirror clouds (JAX runtime.py:397-404) by kernel 2.5 into one more
    single-body block each cloud step, or without use_pallas the plane
    dots' rows packed into that block (:422-433).  On the reference
    solvers, multi_step_reference (schedule: the colored solver's
    HandSchedule)."""
    from ..physics.pgs_kernel import build_multistep_plan
    bp = body_params(model)
    body = sanity_check(body, bp)
    cloud_all = multistep_cloud(ph, camera_pose, config, model.n_bodies)
    camq = pose_quat(camera_pose)
    aa = (analysis.palmq, analysis.finger_clenched, camq)
    C = config.cloud_rows_per_body
    for s in range(config.steps):
        has_angles = s < config.steps_keyangles or config.angles_only
        has_cloud = config.steps_cloudstart <= s and not config.angles_only
        blocks, limits = [], []
        if s < config.steps_keypoints and not config.angles_only:
            blocks.append(_keypoint_block(body, model, analysis,
                                          camera_pose, config))
            limits.append(((0.0, -100000.0), (100000.0, 0.0)))
        cloud = cloud_all if has_cloud else None
        cs = sum(int(b.targetdist.shape[1]) for b in blocks)
        if cloud is not None:
            cs += C
        plan = build_multistep_plan(model.np, cs, has_angles,
                                    config.contacts_mode,
                                    bool(config.physics_use_collision))
        body = fit_fused(
            body, model, params, plan, blocks, limits, cloud=cloud,
            cloud_limits=(-1.0, 1.0),        # +-scale, scale >= 0
            cloud_slots=C if cloud is not None else 0,
            mode="ms_angles" if has_angles else "ms_noangles", aa=aa,
            drive_force=10000.0 if s < config.steps_palmangle else 0.0,
            iterations=config.physics_iterations,
            iterations_post=config.physics_iterations_post)
        body = body._replace(
            linear_momentum=torch.zeros_like(body.linear_momentum),
            angular_momentum=torch.zeros_like(body.angular_momentum))
    return sanity_check(body, bp)


# ---------------------------------------------------------------------------
# the reset branch (handtrack.h:712-719), on the resetting tracks only
# ---------------------------------------------------------------------------

def _take(x, idx):
    return type(x)(*[_take(f, idx) for f in x]) if isinstance(x, tuple) \
        else x[idx]


def reset_tracks(do_reset, body: BodyState, model, analysis, ph,
                 camera_pose, config: TrackerConfig, params) -> BodyState:
    """PoseFromScratch and steps_unibody UnibodyFits (with or without the
    kernels, by config.use_pallas) for the tracks whose do_reset (T,) is
    set; the others keep `body`.  The resetting tracks are
    gathered (one host read of the decision), run as one batch and
    scattered back; a frame where no track resets launches nothing here."""
    idx = torch.nonzero(do_reset).flatten()
    if idx.numel() == 0:
        return body
    cam = camera_pose[idx]
    ph_r = ph[idx]
    b = pose_from_scratch(_take(body, idx), model, _take(analysis, idx),
                          ph_r, cam)
    for _ in range(config.steps_unibody):
        b = unibody_fit(b, model, params, ph_r, cam[:, :3],
                        config.unibody_force, config.physics_iterations,
                        config.physics_iterations_post,
                        use_kernel=config.use_pallas)
    out = []
    for full, part in zip(body, b):
        full = full.clone()
        full[idx] = part
        out.append(full)
    return BodyState(*out)


# ---------------------------------------------------------------------------
# update_cnn_model (handtrack.h:693-746)
# ---------------------------------------------------------------------------

def frame_cloud(depth, cam, config: TrackerConfig):
    """The dynamics frame's cloud (JAX runtime.py:785-810) as a planes
    carrier (T, 8, point_budget): the cloud kernel's (every
    subsample_fraction-th valid pixel), or with subsample_voxel the
    full-image point_cloud averaged per voxel of subsample_size (buckets
    holding at least subsample_fraction points: the JAX package passes it
    as min_voxel_num) and compacted; then the mirror split when a plane is
    set."""
    return cloud_from_depth_planes(depth, cam, 0.1, config.drangey,
                                   config.subsample_fraction,
                                   config.point_budget)


def _planes_path(config: TrackerConfig) -> bool:
    """The cloud rides the cloud kernel's planes carrier end to end (JAX
    runtime.py:622-628); the voxel and mirror clouds leave it."""
    return (config.solver == "kernel" and config.use_pallas
            and not config.subsample_voxel and not config.mirror_plane)


def _cnn_frame_inputs(cnn_params, depth, cam, config: TrackerConfig,
                      ph=None):
    """The CNN frame's prologue: segment, net forward, decode, cloud.
    ph: the frame's own cloud when the caller has it (already mirrored);
    else the cloud kernel's, mirrored when a plane is set (JAX
    runtime.py:589-620).  Returns (seg, analysis, cnn_input, cnn_output,
    ph)."""
    drange = (0.1, config.drangey)
    seg = hand_segment_vr(depth, cam, 0xF, drange, config.segment_scale)
    cnn_input = cnn_input_from_segment(seg.depth, cam.depth_scale, drange)
    cnn_output = cnn_forward(cnn_params, cnn_input)
    analysis = analyze_cnn_output(cnn_output, seg.cam.sub(4))
    if ph is None:
        ph = cloud_from_depth_planes(depth, cam, drange[0], drange[1],
                                     config.subsample_fraction,
                                     config.point_budget)
    return seg, analysis, cnn_input, cnn_output, ph


def update_cnn_model(state: TrackerState, model, cnn_params, depth, cam,
                     config: TrackerConfig, params, ph=None, schedule=None):
    """The background-thread body of the reference, for every track:
    FitError of the current pose, a reset where it exceeds
    full_reset_on_error (every track with angles_only), MultiStepSim,
    FitError of the result, and the take decision (always with
    angles_only).  depth (T, H, W) int16 (u16 bits); ph: the frame's cloud
    (planes carrier) when the caller has it; schedule: the colored
    solver's HandSchedule (built here when not given).  Returns (state,
    CnnDebug)."""
    _check_config(config)
    if config.solver == "colored" and schedule is None:
        from ..physics.schedule import build_hand_schedule
        schedule = build_hand_schedule(model.np, config.contacts_mode)
    seg, analysis, cnn_input, cnn_output, ph = _cnn_frame_inputs(
        cnn_params, depth, cam, config, ph)
    olderror = fit_error(state.body.pose, model, ph, depth, cam,
                         config.bone_sum_error_scale, config.use_pallas)
    do_reset = (olderror > config.full_reset_on_error) | config.angles_only
    other = reset_tracks(do_reset, state.body, model, analysis, ph,
                         seg.cam.pose, config, params)
    other = multi_step_sim(other, model, analysis, ph, seg.cam.pose, config,
                           params, schedule)
    newerror = fit_error(other.pose, model, ph, depth, cam,
                         config.bone_sum_error_scale, config.use_pallas)
    zero = torch.zeros((), device=olderror.device)
    prev = torch.where(newerror > olderror, zero,
                       state.prev_frame_error + (olderror - newerror))
    npts = (ph[:, 4] > 0.5).sum(1)
    init_take = (npts > config.min_point_num) & (state.initializing > 0)
    if config.init_take_gated:
        init_take = init_take & (newerror <= olderror)
    take = init_take | bool(config.always_take_cnn) \
        | bool(config.angles_only) | (prev > config.accum_error_threshold)
    prev = torch.where(prev > config.accum_error_threshold, zero, prev)
    initializing = torch.clamp(state.initializing - 1, min=0)
    body = state.body._replace(pose=torch.where(
        take[:, None, None], other.pose, state.body.pose))
    dbg = CnnDebug(cnn_input=cnn_input, cnn_output=cnn_output,
                   image_points=analysis.image_points,
                   segment_cam_pose=seg.cam.pose)
    return TrackerState(body, prev, initializing), dbg


# palm-frame flips spanning the edge-on and clenched view ambiguities the
# net cannot resolve from one crop: identity, and pi about each local axis
_HYP_FLIPS = ((0.0, 0.0, 0.0, 1.0), (1.0, 0.0, 0.0, 0.0),
              (0.0, 1.0, 0.0, 0.0), (0.0, 0.0, 1.0, 0.0))


# ---------------------------------------------------------------------------
# update (handtrack.h:748-785)
# ---------------------------------------------------------------------------

def update(state: TrackerState, model, depth, cam, config: TrackerConfig,
           params: PhysicsParams | None = None, cnn_params=None,
           run_cnn: bool | None = None):
    """Per-frame tracking step for every track.  depth: (T, H, W) int16
    (u16 bits, ops.cloud_kernel.depth_tensor); state: TrackerState with
    leading dimension T.  run_cnn overrides config.cnn_every_frame for this
    call (the cadence hook of parallel.tracks.track_sequences); the CNN
    frame needs cnn_params (cnn.model.load_cnnb).  Returns (state, user
    poses (T, 17, 7), CnnDebug or None)."""
    from ..physics.pgs_kernel import build_dynamics_plan
    _check_config(config)
    if params is None:
        params = physics_params(config)
    cnn = config.cnn_every_frame if run_cnn is None else run_cnn
    if cnn and cnn_params is None:
        raise ValueError("the CNN frame needs cnn_params "
                         "(cnn.model.load_cnnb)")
    nb = len(BOUNDARY_OUTDIRS) if config.boundary_planes else 0
    plan = build_dynamics_plan(model.np, config.cloud_rows_per_body + nb,
                               config.contacts_mode,
                               bool(config.physics_use_collision))
    ph = frame_cloud(depth, cam, config)
    points, mask = planes_points(ph)
    npts = mask.sum(-1)
    dbg = None
    if cnn:
        # the frame's own cloud, unless the voxel subsampler replaced it
        state, dbg = update_cnn_model(
            state, model, cnn_params, depth, cam, config, params,
            None if config.subsample_voxel else ph)
    body = state.body
    B = model.n_bodies
    for _ in range(0 if config.angles_only else config.mainthreadpasses):
        blocks, limits = [], []
        if config.boundary_planes:
            chamber = cloud_chamber_rows(
                body.pose, model, points, mask, BOUNDARY_OUTDIRS,
                (0.0, 0.0, 0.0), (0.0, 0.0, 1.0), CHAMBER_MAXFORCE,
                active=npts > config.min_point_num)
            blocks.append(rows_to_single_block(chamber, (nb, B)))
            limits.append((min(0.0, CHAMBER_MAXFORCE),
                           max(0.0, CHAMBER_MAXFORCE)))
        body = fit_point_cloud_kernel(
            body, model, params, ph, single_blocks=blocks,
            single_limits=limits, microforce=config.microforce,
            iterations=config.physics_iterations,
            iterations_post=config.physics_iterations_post,
            cloud_slots=config.cloud_rows_per_body, pgs_plan=plan,
            planes_path=_planes_path(config),
            use_pallas=config.use_pallas)
    initializing = torch.where(npts < config.min_point_num,
                               torch.full_like(state.initializing, 50),
                               state.initializing)
    state = TrackerState(body, state.prev_frame_error, initializing)
    return state, get_pose_user(body, model), dbg


# ---------------------------------------------------------------------------
# slowfit (handtrack.h:786-821), the annotation-grade fit
# ---------------------------------------------------------------------------


