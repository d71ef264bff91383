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

import numpy as np
import torch

from ..cnn.labels import CNNAnalysis, analyze_cnn_output
from ..cnn.model import forward as cnn_forward
from ..fitting.cloud import (cloud_chamber_rows, cloud_constraint_rows,
                             fit_error, rows_to_single_block,
                             scale_cloud_forces)
from ..imaging.image_ops import (compact_planes, compact_points,
                                 mirror_plane_split, point_cloud,
                                 voxel_subsample)
from ..maths.pose import pose_apply, pose_inverse, pose_mul, pose_quat
from ..maths.quat import (qconj, qmul, qrot, quat_from_axis_angle,
                          quat_from_to, qxdir, qydir)
from ..model.bake import FEATURE_BONES, FEATURE_OFFSETS
from ..model.hand import (body_params, fit_fused, fit_point_cloud_kernel,
                          fix_positions, get_pose_user, initial_state)
from ..ops.cloud_kernel import cloud_from_depth_planes, planes_points
from ..ops.cloud_rows import points_planes
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


def scale_tracker(model, config: TrackerConfig, s: float):
    """HandTracker::scale (handtrack.h:591): the model resized by s
    (model.bake.scale_model, on the model's device) and the segmentation
    diameter with it.  Returns (model, config)."""
    import dataclasses
    from ..model.bake import HandModelArrays, from_numpy_model, scale_model
    scaled = scale_model(HandModelArrays(**model.np), s)
    return (from_numpy_model(scaled, model.device),
            dataclasses.replace(config,
                                segment_scale=config.segment_scale * s))


def state_from_numpy(state, device):
    """The JAX package's TrackerState or BodyState, as NumPy arrays (or any
    NamedTuple with the same field names), -> the port's, on `device`."""
    def t(x):
        return torch.tensor(np.asarray(x)).to(device)
    fields = getattr(state, "_fields", ())
    if "body" in fields:
        return TrackerState(body=state_from_numpy(state.body, device),
                            prev_frame_error=t(state.prev_frame_error)
                            .to(torch.float32),
                            initializing=t(state.initializing)
                            .to(torch.int32))
    return BodyState(pose=t(state.pose).to(torch.float32),
                     linear_momentum=t(state.linear_momentum)
                     .to(torch.float32),
                     angular_momentum=t(state.angular_momentum)
                     .to(torch.float32))


def _check_config(config: TrackerConfig):
    """Raise ValueError for a solver or contacts mode the JAX package does
    not have.  Every other setting of TrackerConfig runs in the port."""
    if config.solver not in ("kernel", "sequential", "colored"):
        raise ValueError(f"TrackerConfig.solver={config.solver!r}")
    if config.contacts_mode not in ("exact", "jacobi"):
        raise ValueError(
            f"TrackerConfig.contacts_mode={config.contacts_mode!r}")


def hand_model_enhancements(body: BodyState, model, params, armdir=None,
                            tiepinkyringmid: bool = False,
                            fingerhold: int = 0):
    """HandModelEnhancements (handtrack.h:402-441) for every track: (angular
    rows (T, K), rangemin, rangemax (T, J, 3)) with the per-frame joint-range
    mutations applied.  The cone rows, in the reference's order: with
    tiepinkyringmid the four ring/pinky/middle ties, with armdir (T, 3) the
    arm cone (world, palm base 0) of 70 degrees, with fingerhold's bits the
    thumb and finger holds; none with the defaults."""
    from ..physics.constraints import constrain_cone_angle_batch
    from ..physics.row_planes import PosePlanes, enhancement_ranges
    from ..physics.solver import empty_angular
    T, B = body.pose.shape[0], body.pose.shape[1]
    dev = body.pose.device
    pt = body.pose.permute(1, 2, 0)                          # (B, 7, T)
    P = PosePlanes(tr=[pt[:, c] for c in range(3)],
                   q=[pt[:, 3 + c] for c in range(4)], iinv=None, T=T, B=B)
    rmin, rmax = enhancement_ranges(P, model.np)             # 3 x (J, T)
    cones = []                     # (b0, n0 (T, 3), b1, n1, degrees)
    vec = lambda *v: torch.tensor(v, device=dev).expand(T, 3)
    if tiepinkyringmid:
        cones += [(b, vec(0.0, 1, 0), b - 3, vec(0.0, 1, 0), 10.0)
                  for b in (15, 14, 12, 11)]
    if armdir is not None:
        cones.append((-1, armdir, 0, vec(0.0, 0, 1), 70.0))
    if fingerhold & 1:
        cones.append((1, vec(-1.0, 0, 0), 4, vec(0.0, 0, 1), 10.0))
    cones += [(1, vec(0.0, 0, -1), 3 + finger * 3, vec(0.0, 0, 1), 10.0)
              for finger in (1, 2, 3, 4) if fingerhold & (1 << finger)]
    rows = (constrain_cone_angle_batch(
        body.pose, [c[0] for c in cones],
        torch.stack([c[1] for c in cones], dim=1), [c[2] for c in cones],
        torch.stack([c[3] for c in cones], dim=1), [c[4] for c in cones],
        params) if cones else empty_angular(T, 0, dev))
    return (rows, torch.stack(rmin, dim=-1).transpose(0, 1),
            torch.stack(rmax, dim=-1).transpose(0, 1))


def apply_angles(body: BodyState, model, analysis: CNNAnalysis, camera_pose,
                 params, drive_force: float, coneangle: float = 10.0):
    """CNNOutputAnalysis::ApplyAngles (handtrack.h:203-216) for every
    track: the palm drive toward the camera-rotated palm angles (3 rows,
    world -> 1, torque +-drive_force), then the nine finger cones from the
    clench angles (body 1 -> each finger bone; their sines and cosines the
    JAX CPU build's, maths.libm), AngularRows (T, 12).  camera_pose
    (T, 7)."""
    from ..maths.libm import cosf, sinf
    from ..physics.constraints import (constrain_angular_drive,
                                       constrain_cone_angle_batch)
    from ..physics.row_planes import finger_cone_axes
    from ..physics.solver import concat_angular
    drive = constrain_angular_drive(
        body.pose, -1, 1, qmul(pose_quat(camera_pose), analysis.palmq),
        drive_force, params)
    n0, b1s = finger_cone_axes(analysis.finger_clenched.transpose(0, 1),
                               model.np, sinf, cosf)         # 3 x (9, T)
    K = len(b1s)
    cones = constrain_cone_angle_batch(
        body.pose, [1] * K, torch.stack(n0, dim=-1).transpose(0, 1), b1s,
        torch.tensor([0.0, 0.0, 1.0], device=body.pose.device).expand(K, 3),
        [coneangle] * K, params)
    return concat_angular(drive, cones)


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
    if not use_kernel:
        return _unibody_fit_rows(body, model, params, ph, camera_position,
                                 unibody_force, iterations, iterations_post)
    from ..physics.pgs_kernel import pgs_solve
    x = unibody_inputs(body, model, params, ph, camera_position,
                       unibody_force)
    out = pgs_solve(x["plan"], iterations, iterations_post, x["mom0"],
                    x["mi"], x["singles"], [], [])
    return unibody_pose(x, out, body, model, params.deltaT)


def unibody_rows(body: BodyState, model, ph, camera_position,
                 unibody_force: float = 0.1):
    """What UnibodyFit's solve reads without the kernels (JAX runtime.py:
    275-288, handtrack.h:453-461): the plane-dot cloud rows of the
    stride-4 subsample against the articulated hand, retargeted to one
    free body at the palm (a cube of side 0.2 and unit mass), packed in
    point order into a single-body block of as many slots as rows (every
    row on the one body keeps its sequential order).  Returns (the free
    body's BodyState, its BodyParams, the block)."""
    from ..physics.colored import pack_single_body_linear
    from ..physics.solver import BodyParams
    keep, N = _subsample4(ph)
    upts, umask = planes_points(compact_planes(ph, keep, max(N // 4, 64)))
    T, dev = ph.shape[0], ph.device
    rows = cloud_constraint_rows(body.pose, model, upts, umask,
                                 origin=camera_position, use_kernel=False)
    uni_pose = body.pose[:, 1]                              # (T, 7)
    bpose = body.pose[torch.arange(T, device=dev)[:, None], rows.b1]
    p1_world = pose_apply(bpose, qrot(qconj(pose_quat(bpose)), rows.r1))
    rows = rows._replace(b0=torch.full_like(rows.b0, -1),
                         b1=torch.zeros_like(rows.b1),
                         r1=p1_world - uni_pose[:, None, :3],
                         fmin=rows.fmin * unibody_force,
                         fmax=rows.fmax * unibody_force)
    one = torch.ones(1, device=dev)
    ubody = BodyParams(massinv=one,
                       tensorinv_massless=torch.eye(3, device=dev)[None]
                       * _UNIBODY_TINV,
                       damping=torch.zeros(1, device=dev), gravscale=one,
                       start_pose=uni_pose[:1])
    z = torch.zeros((T, 1, 3), device=dev)
    return (BodyState(pose=uni_pose[:, None], linear_momentum=z,
                      angular_momentum=z), ubody,
            pack_single_body_linear(rows, 1, rows.b0.shape[1]))


def _unibody_fit_rows(body: BodyState, model, params, ph, camera_position,
                      unibody_force, iterations, iterations_post):
    """unibody_fit without the kernels: unibody_rows solved by the colored
    solve (the row-sweep kernel), the palm's motion applied to every
    bone."""
    from ..physics.colored import physics_update_colored
    ustate, ubody, blk = unibody_rows(body, model, ph, camera_position,
                                      unibody_force)
    out = physics_update_colored(ustate, ubody, [blk], [], params,
                                 iterations=iterations,
                                 iterations_post=iterations_post)
    dp = pose_mul(out.pose[:, 0], pose_inverse(ustate.pose[:, 0]))
    pose = pose_mul(dp[:, None].expand_as(body.pose), body.pose)
    return sanity_check(body._replace(pose=pose), body_params(model))


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
    if config.solver != "kernel":
        return multi_step_reference(body, model, analysis, ph, camera_pose,
                                    config, params, schedule)
    from ..ops.cloud_rows import cloud_rows_packed_ph
    from ..physics.pgs_kernel import build_multistep_plan
    bp = body_params(model)
    body = sanity_check(body, bp)
    cloud_all = multistep_cloud(ph, camera_pose, config, model.n_bodies)
    camq = pose_quat(camera_pose)
    aa = (analysis.palmq, analysis.finger_clenched, camq)
    C = config.cloud_rows_per_body
    planes = _planes_path(config)
    ms = (multistep_reference_cloud(ph, camera_pose, config, model.n_bodies)
          if not config.use_pallas else None)
    for s in range(config.steps):
        has_angles = s < config.steps_keyangles or config.angles_only
        has_cloud = config.steps_cloudstart <= s and not config.angles_only
        blocks, limits = [], []
        if s < config.steps_keypoints and not config.angles_only:
            blocks.append(_keypoint_block(body, model, analysis,
                                          camera_pose, config))
            limits.append(((0.0, -100000.0), (100000.0, 0.0)))
        cloud = None
        if has_cloud and planes:
            cloud = cloud_all
        elif has_cloud and ms is not None:
            # the reference-shaped rows (JAX runtime.py:422-433)
            from ..physics.colored import pack_single_body_linear
            rows = cloud_constraint_rows(body.pose, model, ms.points,
                                         ms.mask, origin=ms.origin,
                                         use_kernel=False)
            rows = scale_cloud_forces(rows, ms.cloudforce * torch.where(
                rows.b1 == 0, 0.1, 1.0))
            blocks.append(pack_single_body_linear(rows, model.n_bodies, C))
            limits.append((-1.0, 1.0))       # +-force x the slot scale
        elif has_cloud:
            blocks.append(cloud_rows_packed_ph(body.pose, model, *cloud_all,
                                               C)[0])
            limits.append((-1.0, 1.0))       # +-scale, scale >= 0
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


class MultistepCloud(NamedTuple):
    """What MultiStepSim's steps share on the reference solvers: the
    compacted stride-4 subsample (points (T, M, 3), mask (T, M)), the ray
    origin (T, 3), the cloud force (T, 1) and the arm direction (T, 3)."""
    points: torch.Tensor
    mask: torch.Tensor
    origin: torch.Tensor
    cloudforce: torch.Tensor
    armdir: torch.Tensor


def multistep_reference_cloud(ph, camera_pose, config: TrackerConfig,
                              B: int) -> MultistepCloud:
    """MultistepCloud of the frame's cloud ph (T, 8, N) (multistep_cloud),
    and the arm direction qrot(camera quat, (0, -1, 0))."""
    mph, origin, _ = multistep_cloud(ph, camera_pose, config, B)
    down = torch.tensor([0.0, -1.0, 0.0], device=ph.device)
    return MultistepCloud(
        *planes_points(mph), origin, _cloudforce(ph, config)[:, None],
        qrot(pose_quat(camera_pose), down.expand(ph.shape[0], 3)))


def multistep_rows(body: BodyState, model, analysis: CNNAnalysis,
                   ms: MultistepCloud, camera_pose, config: TrackerConfig,
                   params, s: int, schedule=None):
    """Step s of MultiStepSim on the reference solvers (JAX runtime.py:
    337-458, non-fused): ApplyAngles (s < steps_keyangles, the palm drive's
    torque while s < steps_palmangle), the keypoint dead zones
    (s < steps_keypoints), the subsampled cloud's rows (s >=
    steps_cloudstart; the correspondence kernel with use_pallas, the plane
    dots without; a tenth of the force on the wrist) and the arm cone (with
    angles_only ApplyAngles on every step, no keypoints, no cloud), with
    the joints, contacts and ranges: model.hand.fit_rows' rows.
    Sequential (schedule None): linears [keypoints][cloud], angulars
    [ApplyAngles][arm cone] before fit_rows' own; colored: the keypoints
    and the cloud as single-body blocks, ApplyAngles and the arm cone as
    pair blocks on the schedule's groups."""
    from ..model.hand import fit_rows
    from ..physics.colored import pack_single_body_linear
    from ..physics.schedule import pair_angular
    from ..physics.solver import concat_angular, concat_linear
    B = model.n_bodies
    colored = schedule is not None
    lin, ang = [], []
    if s < config.steps_keyangles or config.angles_only:
        aa = apply_angles(body, model, analysis, camera_pose, params,
                          10000.0 if s < config.steps_palmangle else 0.0)
        ang.append(pair_angular(aa, schedule.apply_angles) if colored
                   else aa)
    if s < config.steps_keypoints and not config.angles_only:
        kp = _keypoint_rows(body, analysis, camera_pose, config)
        lin.append(pack_single_body_linear(kp, B, 4) if colored else kp)
    if config.steps_cloudstart <= s and not config.angles_only:
        cloud = cloud_constraint_rows(body.pose, model, ms.points, ms.mask,
                                      origin=ms.origin,
                                      use_kernel=config.use_pallas)
        cloud = scale_cloud_forces(cloud, ms.cloudforce * torch.where(
            cloud.b1 == 0, 0.1, 1.0))
        lin.append(pack_single_body_linear(
            cloud, B, config.cloud_rows_per_body) if colored else cloud)
    enh, rmin, rmax = hand_model_enhancements(body, model, params,
                                              ms.armdir)
    ang.append(pair_angular(enh, schedule.enh_cone) if colored else enh)
    empty = torch.zeros((body.pose.shape[0], 0, 3), device=body.pose.device)
    return fit_rows(
        body, model, params, empty, empty[..., 0] > 0,
        linears=None if colored or not lin else concat_linear(*lin),
        angulars=None if colored else concat_angular(*ang),
        microforce=config.microforce, rangemin=rmin, rangemax=rmax,
        contacts=bool(config.physics_use_collision), schedule=schedule,
        single_blocks=lin if colored else (),
        cloud_slots=config.cloud_rows_per_body,
        use_kernel=config.use_pallas,
        angular_pair_blocks=ang if colored else ())


def multi_step_reference(body: BodyState, model, analysis: CNNAnalysis, ph,
                         camera_pose, config: TrackerConfig, params,
                         schedule=None) -> BodyState:
    """MultiStepSim on the sequential solver (schedule None) or the colored
    one (JAX runtime.py:303-470, non-fused), every track at once: per step
    multistep_rows, solved by the row-sweep kernel (physics_update or
    physics_update_colored), momenta zeroed after every step."""
    from ..physics.colored import physics_update_colored
    from ..physics.solver import physics_update
    bp = body_params(model)
    body = sanity_check(body, bp)
    ms = multistep_reference_cloud(ph, camera_pose, config, model.n_bodies)
    solve = physics_update if schedule is None else physics_update_colored
    for s in range(config.steps):
        lin, ang = multistep_rows(body, model, analysis, ms, camera_pose,
                                  config, params, s, schedule)
        body = sanity_check(solve(body, bp, lin, ang, params,
                                  iterations=config.physics_iterations,
                                  iterations_post=config
                                  .physics_iterations_post), bp)
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

def _mirrored(ph, config: TrackerConfig, cam=None):
    """MirrorPlaneSplit of the cloud ph when config.mirror_plane is set
    (cam: the camera whose deprojection the points are, see
    imaging.image_ops.mirror_points)."""
    if not config.mirror_plane:
        return ph
    return points_planes(*mirror_plane_split(
        *planes_points(ph), config.mirror_plane, cam=cam))


def frame_cloud(depth, cam, config: TrackerConfig):
    """The dynamics frame's cloud (JAX runtime.py:785-810) as a planes
    carrier (T, 8, point_budget): the cloud kernel's (every
    subsample_fraction-th valid pixel), or with subsample_voxel the
    full-image point_cloud averaged per voxel of subsample_size (buckets
    holding at least subsample_fraction points: the JAX package passes it
    as min_voxel_num) and compacted; then the mirror split when a plane is
    set."""
    if not config.subsample_voxel:
        return _mirrored(cloud_from_depth_planes(
            depth, cam, 0.1, config.drangey, config.subsample_fraction,
            config.point_budget), config, cam)
    pts, mask = point_cloud(depth, cam, 0.1, config.drangey)
    pts, mask = voxel_subsample(pts, mask, config.subsample_size,
                                config.subsample_fraction)
    return _mirrored(points_planes(*compact_points(pts, mask,
                                                   config.point_budget)),
                     config)


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
        ph = _mirrored(cloud_from_depth_planes(
            depth, cam, drange[0], drange[1], config.subsample_fraction,
            config.point_budget), config, cam)
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


def kickstart(state: TrackerState, model, cnn_params, depth, cam, config,
              params):
    """handtrack.h:743: run the CNN frame synchronously and take its pose
    (the returned state already holds the taken pose)."""
    return update_cnn_model(state, model, cnn_params, depth, cam, config,
                            params)


# palm-frame flips spanning the edge-on and clenched view ambiguities the
# net cannot resolve from one crop: identity, and pi about each local axis
_HYP_FLIPS = ((0.0, 0.0, 0.0, 1.0), (1.0, 0.0, 0.0, 0.0),
              (0.0, 1.0, 0.0, 0.0), (0.0, 0.0, 1.0, 0.0))


def kickstart_hypotheses(state: TrackerState, model, cnn_params, depth,
                         cam, config: TrackerConfig, params,
                         n_hyp: int = 4, lm_weight: float = 0.1):
    """kickstart_multi's hypotheses (JAX runtime.py:698-751): from the
    net's palm orientation turned by each of the first n_hyp flips, the
    full reset (PoseFromScratch, steps_unibody UnibodyFits, MultiStepSim
    on the sequential schedule where the solver is not the kernel one) and
    its score, FitError plus lm_weight x the landmark rays' disagreement
    (the net's feature rays against the fitted features, weighted by the
    rays' probabilities).  The hypotheses fold into the track dimension
    (track t's hypothesis h is batch row t * n_hyp + h), one batch.
    Returns (BodyState (T, n_hyp, 17, ...), scores (T, n_hyp)) and the
    frame's (seg, analysis, cnn_input, cnn_output)."""
    _check_config(config)
    seg, analysis, cnn_input, cnn_output, ph = _cnn_frame_inputs(
        cnn_params, depth, cam, config)
    T, dev = ph.shape[0], ph.device
    idx = torch.arange(T, device=dev).repeat_interleave(n_hyp)
    flips = torch.tensor(_HYP_FLIPS[:n_hyp], device=dev).repeat(T, 1)
    a = _take(analysis, idx)
    a = a._replace(palmq=qmul(a.palmq, flips))
    ph_r, campose = ph[idx], seg.cam.pose[idx]
    b = pose_from_scratch(_take(state.body, idx), model, a, ph_r, campose)
    for _ in range(config.steps_unibody):
        b = unibody_fit(b, model, params, ph_r, campose[:, :3],
                        config.unibody_force, config.physics_iterations,
                        config.physics_iterations_post,
                        use_kernel=config.use_pallas)
    b = multi_step_sim(b, model, a, ph_r, campose, config, params)
    err = fit_error(b.pose, model, ph_r, depth[idx], cam,
                    config.bone_sum_error_scale, config.use_pallas)
    bones = torch.as_tensor(FEATURE_BONES.astype(np.int64), device=dev)
    off = torch.as_tensor(FEATURE_OFFSETS, dtype=torch.float32, device=dev)
    fw = pose_apply(b.pose[:, bones], off)                  # (T*H, 8, 3)
    d = fw - campose[:, None, :3]
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True),
                        min=1e-20)
    agree = (d * a.crays[..., :3]).sum(-1)                  # (T*H, 8)
    err_lm = (torch.clamp(a.crays[..., 3], min=0.0) * (1.0 - agree)).sum(-1)
    score = (err + lm_weight * err_lm).reshape(T, n_hyp)
    bodies = BodyState(*[x.reshape((T, n_hyp) + x.shape[1:]) for x in b])
    return bodies, score, (seg, analysis, cnn_input, cnn_output)


def kickstart_multi(state: TrackerState, model, cnn_params, depth, cam,
                    config: TrackerConfig, params, n_hyp: int = 4,
                    lm_weight: float = 0.1):
    """Multi-hypothesis re-acquisition (the JAX package's addition; the
    reference's kickstart, handtrack.h:743, is the n_hyp=1 column), every
    track at once: kickstart_hypotheses, then per track the hypothesis of
    the lowest score (the lower index on a tie).  Returns (state with the
    chosen bodies, prev_frame_error 0 and initializing unchanged,
    CnnDebug)."""
    bodies, score, (seg, analysis, cnn_input, cnn_output) = \
        kickstart_hypotheses(state, model, cnn_params, depth, cam, config,
                             params, n_hyp, lm_weight)
    k = torch.argmin(score, dim=1)
    tt = torch.arange(score.shape[0], device=score.device)
    body = BodyState(*[x[tt, k] for x in bodies])
    dbg = CnnDebug(cnn_input=cnn_input, cnn_output=cnn_output,
                   image_points=analysis.image_points,
                   segment_cam_pose=seg.cam.pose)
    return TrackerState(body, torch.zeros_like(state.prev_frame_error),
                        state.initializing), dbg


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
    if config.solver != "kernel":
        return _update_reference(state, model, depth, cam, config, params,
                                 cnn_params if cnn else None)
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


def reference_frame_rows(body: BodyState, model, params, points, mask,
                         config: TrackerConfig, schedule=None):
    """One main-thread pass's rows on the reference solvers
    (handtrack.h:770-782): HandModelEnhancements' ranges, the boundary
    chamber (caller linears before the cloud on the sequential solver, a
    single-body block on the colored one, schedule given), the cloud rows
    from the correspondence kernel (use_pallas) or the plane dots, the
    joints and the contacts: model.hand.fit_rows' (linears, angulars) or
    (linear blocks, angular blocks)."""
    from ..model.hand import fit_rows
    enh, rmin, rmax = hand_model_enhancements(body, model, params)
    linears, blocks = None, []
    if config.boundary_planes:
        chamber = cloud_chamber_rows(
            body.pose, model, points, mask, BOUNDARY_OUTDIRS,
            (0.0, 0.0, 0.0), (0.0, 0.0, 1.0), CHAMBER_MAXFORCE,
            active=mask.sum(-1) > config.min_point_num)
        if schedule is not None:
            blocks.append(rows_to_single_block(
                chamber, (len(BOUNDARY_OUTDIRS), model.n_bodies)))
        else:
            linears = chamber
    return fit_rows(body, model, params, points, mask, linears=linears,
                    angulars=None if schedule is not None else enh,
                    microforce=config.microforce, rangemin=rmin,
                    rangemax=rmax,
                    contacts=bool(config.physics_use_collision),
                    schedule=schedule, single_blocks=blocks,
                    cloud_slots=config.cloud_rows_per_body,
                    use_kernel=config.use_pallas)


def _update_reference(state: TrackerState, model, depth, cam,
                      config: TrackerConfig, params: PhysicsParams,
                      cnn_params=None):
    """update's sequential and colored branches (handtrack.h:748-785): the
    frame's cloud (frame_cloud); with cnn_params the CNN frame
    (update_cnn_model) on that cloud, unless the voxel subsampler replaced
    it (JAX runtime.py:818-826); then per main-thread pass
    reference_frame_rows and the solve (the row-sweep kernel).  The
    colored schedule is built once and serves both."""
    from ..physics.colored import physics_update_colored
    from ..physics.schedule import build_hand_schedule
    from ..physics.solver import physics_update
    colored = config.solver == "colored"
    schedule = (build_hand_schedule(model.np, config.contacts_mode)
                if colored else None)
    solve = physics_update_colored if colored else physics_update
    ph = frame_cloud(depth, cam, config)
    points, mask = planes_points(ph)
    npts = mask.sum(-1)
    dbg = None
    if cnn_params is not None:
        state, dbg = update_cnn_model(
            state, model, cnn_params, depth, cam, config, params,
            None if config.subsample_voxel else ph, schedule)
    body = state.body
    bp = body_params(model)
    for _ in range(0 if config.angles_only else config.mainthreadpasses):
        lin, ang = reference_frame_rows(body, model, params, points, mask,
                                        config, schedule)
        body = sanity_check(solve(body, bp, lin, ang, params,
                                  iterations=config.physics_iterations,
                                  iterations_post=config
                                  .physics_iterations_post), bp)
    initializing = torch.where(npts < config.min_point_num,
                               torch.full_like(state.initializing, 50),
                               state.initializing)
    state = TrackerState(body, state.prev_frame_error, initializing)
    return state, get_pose_user(body, model), dbg


# ---------------------------------------------------------------------------
# slowfit (handtrack.h:786-821), the annotation-grade fit
# ---------------------------------------------------------------------------

def _hold_rows(body: BodyState, model, refpose, hold: int, params):
    """The hold mode's relative angular rows (handtrack.h:811-816): joint j
    is held toward refpose (T, B, 7) where (j != 0 and hold == 2) or
    j > 3, 3 rows a joint in joint order."""
    from ..physics.constraints import relative_angular_rows
    from ..physics.solver import concat_angular
    j0, j1 = model.np["joint_rbi0"], model.np["joint_rbi1"]
    rows = [relative_angular_rows(body.pose, refpose, int(j0[j]),
                                  int(j1[j]), params)
            for j in range(len(j0)) if (j != 0 and hold == 2) or j > 3]
    return concat_angular(*rows)


def slowfit_rows(body: BodyState, model, points, mask,
                 config: TrackerConfig, params, st: int, steps: int = 6,
                 hold: int = 0, refpose=None, crays=None,
                 select_bone: int | None = None, spoint=None, rbpoint=None):
    """The rows of slowfit's solve st (JAX runtime.py:880-923), for the
    sequential solve: model.hand.fit_rows' (linear rows, angular rows) with

      linears   [CNN landmark rays (crays (T, 8, 4), st < 5)]
                [the dragged-bone nail: body select_bone's local rbpoint
                 (T, 3) pulled to world spoint (T, 3)]
                [the cloud's rows (points (T, N, 3), mask (T, N); st <
                 steps - 1), force microforce * (steps - st) / steps, a
                 tenth of it on the wrist while st < steps - 2 and none
                 there after]
                then the joints and the exact contacts;
      angulars  [HandModelEnhancements' rows][hold rows toward refpose
                 (T, 17, 7), hold 1 or 2] then the model's own joint
                 ranges: JAX's slowfit computes the enhancement ranges and
                 does not pass them on, and neither does the port.

    The cloud rows come from the correspondence kernel with
    config.use_pallas (N a multiple of 512), else from the plane dots."""
    from ..fitting.cloud import cloud_constraint_rows, scale_cloud_forces
    from ..model.hand import fit_rows
    from ..physics.constraints import constrain_position_nailed
    from ..physics.solver import concat_angular, concat_linear
    T, dev = body.pose.shape[0], body.pose.device
    enh, _, _ = hand_model_enhancements(body, model, params)
    angulars, linears = [enh], []
    if crays is not None and st < 5:       # every feature, from the origin
        linears.append(_ray_rows(body, crays, range(8),
                                 torch.zeros((T, 3), device=dev), [True] * 8))
    if select_bone is not None:
        linears.append(constrain_position_nailed(
            body.pose, [-1], spoint[:, None], [select_bone],
            rbpoint[:, None]))
    if hold and refpose is not None:
        angulars.append(_hold_rows(body, model, refpose, hold, params))
    if st < steps - 1:
        cloud = cloud_constraint_rows(body.pose, model, points, mask,
                                      use_kernel=config.use_pallas)
        decay = config.microforce * (1.0 * (steps - st) / steps)
        scale = decay * torch.where(
            cloud.b1 == 0, torch.full((), 0.1 * float(st < steps - 2),
                                      device=dev),
            torch.ones((), device=dev))
        linears.append(scale_cloud_forces(cloud, scale))
    empty = torch.zeros((T, 0, 3), device=dev)
    return fit_rows(body, model, params, empty, empty[..., 0] > 0,
                    linears=concat_linear(*linears) if linears else None,
                    angulars=concat_angular(*angulars),
                    contacts=bool(config.physics_use_collision))


def slowfit(state: TrackerState, model, points, mask, config: TrackerConfig,
            params, hold: int = 0, refpose=None, steps: int = 6, crays=None,
            select_bone: int | None = None, spoint=None,
            rbpoint=None) -> TrackerState:
    """handtrack.h:786-821 with the annotation fixer's extras, every track
    at once (JAX runtime.py:872-933, step for step): `steps` solves of
    slowfit_rows' rows, the sequential solve (the row-sweep kernel)
    whatever config.solver says.  points (T, N, 3), mask (T, N); the CNN
    landmark rays crays (T, 8, 4); the hold level (0, 1, 2) toward refpose
    (T, 17, 7); the nail on body select_bone, its local rbpoint (T, 3) to
    world spoint (T, 3).  hold and select_bone are host ints shared by the
    tracks (trace-time structure in the JAX package).  Returns the state
    with the fitted bodies."""
    from ..physics.solver import physics_update
    _check_config(config)
    bp = body_params(model)
    body = state.body
    for st in range(steps):
        lin, ang = slowfit_rows(body, model, points, mask, config, params,
                                st, steps, hold, refpose, crays,
                                select_bone, spoint, rbpoint)
        body = sanity_check(physics_update(
            body, bp, lin, ang, params,
            iterations=config.physics_iterations,
            iterations_post=config.physics_iterations_post), bp)
    return state._replace(body=body)
