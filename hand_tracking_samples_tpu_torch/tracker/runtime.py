"""HandTracker runtime: the per-frame tracking step (include/handtrack.h:
748-785), the port's counterpart of hand_tracking_samples_tpu.tracker.runtime.

This slice runs the dynamics-only frame on the kernel path, for every track
at once (tracks are the leading dimension of the state and the depth):

  depth -> cloud kernel -> boundary-plane chamber rows -> cloud-rows kernel
  -> joint / contact (contact kernel) / angular rows -> PGS kernel -> poses

Other settings of TrackerConfig (the CNN frame, the sequential and colored
solvers, the voxel and mirror clouds, angles-only) raise NotImplementedError
naming the slice that will bring them.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..fitting.cloud import cloud_chamber_rows, rows_to_single_block
from ..model.hand import fit_point_cloud, get_pose_user, initial_state
from ..ops.cloud_kernel import cloud_from_depth_planes, planes_points
from ..physics.solver import BodyState, PhysicsParams
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
    later = {
        "cnn_every_frame": (config.cnn_every_frame, "the CNN frame "
                            "(ROADMAP queue 1, items 12-13)"),
        "solver": (config.solver != "kernel", "the sequential and colored "
                   "solvers (ROADMAP queue 1, items 5-6)"),
        "use_pallas": (not config.use_pallas, "the reference-shaped cloud "
                       "path (ROADMAP queue 1, item 8)"),
        "subsample_voxel": (bool(config.subsample_voxel), "the voxel cloud "
                            "(ROADMAP queue 1, item 11)"),
        "mirror_plane": (bool(config.mirror_plane), "the mirror split "
                         "(ROADMAP queue 1, item 11)"),
        "angles_only": (config.angles_only, "the angles-only frame "
                        "(ROADMAP queue 1, item 13)"),
    }
    for name, (bad, where) in later.items():
        if bad:
            raise NotImplementedError(
                f"TrackerConfig.{name}={getattr(config, name)!r}: the port "
                f"runs the dynamics-only kernel-solver frame so far; "
                f"{where} come in a later slice")


def update(state: TrackerState, model, depth, cam, config: TrackerConfig,
           params: PhysicsParams | None = None):
    """Per-frame tracking step for every track.  depth: (T, H, W) int16
    (u16 bits, ops.cloud_kernel.depth_tensor); state: TrackerState with
    leading dimension T.  Returns (state, user poses (T, 17, 7))."""
    from ..physics.pgs_kernel import build_dynamics_plan
    _check_config(config)
    if params is None:
        params = physics_params(config)
    nb = len(BOUNDARY_OUTDIRS) if config.boundary_planes else 0
    plan = build_dynamics_plan(model.np, config.cloud_rows_per_body + nb,
                               config.contacts_mode,
                               bool(config.physics_use_collision))
    ph = cloud_from_depth_planes(depth, cam, 0.1, config.drangey,
                                 config.subsample_fraction,
                                 config.point_budget)
    points, mask = planes_points(ph)
    npts = mask.sum(-1)
    body = state.body
    B = model.n_bodies
    for _ in range(config.mainthreadpasses):
        blocks, limits = [], []
        if config.boundary_planes:
            chamber = cloud_chamber_rows(
                body.pose, model, points, mask, BOUNDARY_OUTDIRS,
                (0.0, 0.0, 0.0), (0.0, 0.0, 1.0), CHAMBER_MAXFORCE,
                active=npts > config.min_point_num)
            blocks.append(rows_to_single_block(chamber, (nb, B)))
            limits.append((min(0.0, CHAMBER_MAXFORCE),
                           max(0.0, CHAMBER_MAXFORCE)))
        body = fit_point_cloud(
            body, model, params, ph, single_blocks=blocks,
            single_limits=limits, microforce=config.microforce,
            iterations=config.physics_iterations,
            iterations_post=config.physics_iterations_post,
            cloud_slots=config.cloud_rows_per_body, pgs_plan=plan)
    initializing = torch.where(npts < config.min_point_num,
                               torch.full_like(state.initializing, 50),
                               state.initializing)
    state = TrackerState(body, state.prev_frame_error, initializing)
    return state, get_pose_user(body, model)
