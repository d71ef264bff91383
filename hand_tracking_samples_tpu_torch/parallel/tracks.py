"""Multi-track batching: many independent tracks per device, each keeping
its own frame-to-frame recurrence (the port's counterpart of
hand_tracking_samples_tpu.parallel.tracks).  Tracks are the leading
dimension of every tensor, so a frame for all tracks is one `update` call;
a sequence is a Python loop over frames.  The sharded multi-card variant is
a later slice."""
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
    k = config.cnn_every_k if (config.cnn_every_frame
                               and cnn_params is not None) else 1
    F = len(depth_seqs)
    if k > 1 and F % k:
        raise ValueError(f"frame count {F} must be a multiple of "
                         f"cnn_every_k={k}")
    poses = []
    for f, depths in enumerate(depth_seqs):
        states, p = batched_update(
            states, model, cnn_params, depths, cam, config, params,
            run_cnn=(f % k == 0) if k > 1 else None)
        poses.append(p)
    return states, torch.stack(poses)
