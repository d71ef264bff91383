"""Multi-track batching: many independent tracks per device, each keeping
its own frame-to-frame recurrence (the port's counterpart of
hand_tracking_samples_tpu.parallel.tracks).  Tracks are the leading
dimension of every tensor, so a frame for all tracks is one `update` call;
a sequence is a Python loop over frames.  sharded_track_sequences splits
the tracks over a device mesh (parallel.mesh), with no communication
between the shards."""
from __future__ import annotations

import torch

from ..tracker.config import TrackerConfig
from ..tracker.runtime import (TrackerState, make_tracker_state,
                               physics_params, update)


def batched_tracker_state(model, n_tracks: int) -> TrackerState:
    one = make_tracker_state(model)

    def bc(x):
        return x.expand((n_tracks,) + tuple(x.shape)).clone()
    return TrackerState(body=type(one.body)(*[bc(x) for x in one.body]),
                        prev_frame_error=bc(one.prev_frame_error),
                        initializing=bc(one.initializing))


def batched_update(states: TrackerState, model, cnn_params, depths, cam,
                   config: TrackerConfig, params=None, run_cnn=None):
    """One frame for all tracks.  depths: (T, H, W) int16 (u16 bits).
    run_cnn overrides config.cnn_every_frame for this frame; the CNN frame
    needs cnn_params (cnn.model.load_cnnb)."""
    states, poses, _ = update(states, model, depths, cam, config, params,
                              cnn_params=cnn_params, run_cnn=run_cnn)
    return states, poses


def track_sequences(states: TrackerState, model, cnn_params, depth_seqs,
                    cam, config: TrackerConfig, params=None):
    """Track T independent sequences of F frames each.  depth_seqs:
    (F, T, H, W) int16, or any sequence of F (T, H, W) tensors.  Returns
    (final states, (F, T, 17, 7) user poses).

    When config.cnn_every_k > 1 (and the CNN runs at all), frames go in
    groups of k: the CNN frame on each group's first frame, the dynamics
    frame on the rest (the reference's background-CNN cadence,
    handtrack.h:45-48, 755-768, made static); the frame count must then be
    a multiple of k."""
    if params is None:
        params = physics_params(config)
    poses = []
    for depths, run_cnn in zip(depth_seqs,
                               _cadence(config, cnn_params, len(depth_seqs))):
        states, p = batched_update(states, model, cnn_params, depths, cam,
                                   config, params, run_cnn=run_cnn)
        poses.append(p)
    return states, torch.stack(poses)


def _cadence(config: TrackerConfig, cnn_params, F: int) -> list:
    """run_cnn for each of F frames: None (the config decides) unless
    config.cnn_every_k > 1 and the CNN runs, then True on each group's
    first frame.  Raises when F is not a multiple of k."""
    k = config.cnn_every_k if (config.cnn_every_frame
                               and cnn_params is not None) else 1
    if k > 1 and F % k:
        raise ValueError(f"frame count {F} must be a multiple of "
                         f"cnn_every_k={k}")
    return [(f % k == 0) if k > 1 else None for f in range(F)]


def sharded_track_sequences(mesh, states: TrackerState, model, cnn_params,
                            depth_seqs, cam, config: TrackerConfig,
                            params=None):
    """track_sequences with the tracks split over a device mesh
    (parallel.mesh.make_mesh): one contiguous shard of the T tracks a mesh
    device, holding its tracks' state, depth stream, and a copy of the
    model and net (moved with `.to`, nothing re-derived).  The shards never
    communicate.  Frames are issued frame-major (frame f of every shard,
    in mesh order, before frame f + 1), so while one card computes the
    host issues to the next; the states and (F, T, 17, 7) poses come back
    in track order on the first mesh device.  T must be a multiple of the
    mesh size (ValueError), as shard_map requires in the JAX package."""
    from .mesh import gather, replicate, shard_batch
    if params is None:
        params = physics_params(config)
    T, n = states.body.pose.shape[0], len(mesh)
    if T % n:
        raise ValueError(f"{T} tracks do not divide over {n} devices")
    runs = _cadence(config, cnn_params, len(depth_seqs))
    shard_states = shard_batch(mesh, states)
    shard_depths = (shard_batch(mesh, depth_seqs, dim=1)
                    if isinstance(depth_seqs, torch.Tensor)
                    else shard_batch(mesh, list(depth_seqs)))
    models = replicate(mesh, model)
    nets = replicate(mesh, cnn_params)
    poses = [[] for _ in range(n)]
    for f, run_cnn in enumerate(runs):
        for i in range(n):
            shard_states[i], p = batched_update(
                shard_states[i], models[i], nets[i], shard_depths[i][f], cam,
                config, params, run_cnn=run_cnn)
            poses[i].append(p)
    return (gather(mesh, shard_states),
            gather(mesh, [torch.stack(p) for p in poses], dim=1))


def dryrun_multichip(mesh, model=None) -> str:
    """One sharded tracking frame and one data-parallel SGD step over
    `mesh`, at the JAX package's dry-run sizes (__graft_entry__.py
    dryrun_multichip): 2 tracks and 2 examples a device, point budget 128,
    a depth of 3999 everywhere (no valid point), zero training inputs.
    model: a HandModel (default: the repository's, baked).  Raises when a
    shape is wrong; returns a one-line summary."""
    from ..assets_paths import DEFAULT_MODEL_JSON
    from ..cnn.model import init_params
    from ..data.synth import synth_camera
    from ..model.bake import from_numpy_model, load_hand_model
    from .mesh import make_dp_train_step
    dev, n = mesh.devices[0], 2 * len(mesh)
    model = (from_numpy_model(load_hand_model(DEFAULT_MODEL_JSON), dev)
             if model is None else model.to(dev))
    config = TrackerConfig(point_budget=128, cnn_every_frame=False,
                           min_point_num=16)
    depths = torch.full((1, n, 240, 320), 3999, dtype=torch.int16,
                        device=dev)
    _, poses = sharded_track_sequences(mesh, batched_tracker_state(model, n),
                                       model, None, depths, synth_camera(),
                                       config)
    params = init_params(torch.Generator().manual_seed(0), dev)
    new, mse = make_dp_train_step(mesh, 0.001)(
        params, torch.zeros((n, 64, 64), device=dev),
        torch.zeros((n, 2304), device=dev))
    if poses.shape != (1, n, 17, 7) or not bool(torch.isfinite(poses).all()):
        raise RuntimeError(f"dryrun_multichip: tracking {tuple(poses.shape)}")
    if any(new[k][kk].shape != params[k][kk].shape for k in params
           for kk in params[k]) or mse.dim() != 0:
        raise RuntimeError("dryrun_multichip: training step shapes")
    return (f"dryrun_multichip OK on {len(mesh)} devices: tracking "
            f"{tuple(poses.shape)}, train mse {mse.item():.6f}")
