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
                   config: TrackerConfig, params=None):
    """One frame for all tracks.  depths: (T, H, W) int16 (u16 bits).
    cnn_params must be None: the CNN frame is a later slice."""
    if cnn_params is not None:
        raise NotImplementedError("the CNN frame is a later slice of the "
                                  "port")
    return update(states, model, depths, cam, config, params)


def track_sequences(states: TrackerState, model, cnn_params, depth_seqs,
                    cam, config: TrackerConfig, params=None):
    """Track T independent sequences of F frames each.  depth_seqs:
    (F, T, H, W) int16, or any sequence of F (T, H, W) tensors.  Returns
    (final states, (F, T, 17, 7) user poses)."""
    if params is None:
        params = physics_params(config)
    poses = []
    for depths in depth_seqs:
        states, p = batched_update(states, model, cnn_params, depths, cam,
                                   config, params)
        poses.append(p)
    return states, torch.stack(poses)
