"""The system under test, hand_tracking_samples_tpu_torch, as the benchmark
drives it: its baked hand model, its net, its tracker state, and one
frame for every track through `tracker/runtime.py` `update`, the call that
the port's batch entry `parallel/tracks.py` `batched_update` makes (it
returns the same state and poses and drops the third output, the CNN
frame's debug record, whose net output the comparison reads).

This is the only module of the benchmark that imports the port.  What it
hands the port (the configuration, the camera, the start poses and the
depth frames) the benchmark makes; what the port makes (its baked model,
its loaded net, its state) stays the port's.
"""
from __future__ import annotations

import os

import torch

PORT = "hand_tracking_samples_tpu_torch"
LEAVES = ("pose", "linear_momentum", "angular_momentum",
          "prev_frame_error", "initializing")


class Program:
    def __init__(self, config: dict, repo: str, device):
        from hand_tracking_samples_tpu_torch.cnn.model import load_cnnb
        from hand_tracking_samples_tpu_torch.imaging.camera import DCamera
        from hand_tracking_samples_tpu_torch.model.bake import (
            from_numpy_model, load_hand_model)
        from hand_tracking_samples_tpu_torch.parallel import tracks
        from hand_tracking_samples_tpu_torch.tracker import runtime
        from hand_tracking_samples_tpu_torch.tracker.config import (
            TrackerConfig)
        self._tracks, self._runtime = tracks, runtime
        self.device = torch.device(device)
        self.model = from_numpy_model(
            load_hand_model(os.path.join(repo, config["model"])), self.device)
        self.net = (load_cnnb(os.path.join(repo, config["net"]), self.device)
                    if config.get("net") else None)
        cam = config["camera"]
        self.cam = DCamera.make(dim=tuple(cam["dim"]),
                                focal=tuple(cam["focal"]),
                                principal=tuple(cam["principal"]),
                                depth_scale=cam["depth_scale"])
        self.config = TrackerConfig(**config["tracker"])
        self.params = runtime.physics_params(self.config)

    def initial_state(self, poses):
        """The port's batched state for len(poses) tracks, each at its
        (17, 7) bone pose."""
        st = self._tracks.batched_tracker_state(self.model, poses.shape[0])
        return st._replace(body=st.body._replace(
            pose=poses.to(self.device, torch.float32).contiguous()))

    def frame(self, state, depth, run_cnn: bool, fit=None):
        """One frame for every track: (new state, user poses (T, 17, 7)
        on the card, the net's output (T, 2304) on a CNN frame or
        None).  fit: a list that receives each FitError (T,) the frame
        computes (the runtime's `fit_error`, read by the comparison)."""
        from .check import fit_errors
        if fit is None:
            st, poses, dbg = self._runtime.update(
                state, self.model, depth, self.cam, self.config,
                self.params, cnn_params=self.net, run_cnn=run_cnn)
        else:
            with fit_errors(self._runtime) as seen:
                st, poses, dbg = self._runtime.update(
                    state, self.model, depth, self.cam, self.config,
                    self.params, cnn_params=self.net, run_cnn=run_cnn)
            fit.extend(seen)
        return st, poses, None if dbg is None else dbg.cnn_output

    @staticmethod
    def leaves(state, idx=None) -> dict:
        """The state's tensors by name, the tracks `idx` of each on the
        CPU when idx is given."""
        out = dict(zip(LEAVES[:3], state.body))
        out["prev_frame_error"] = state.prev_frame_error
        out["initializing"] = state.initializing
        if idx is None:
            return out
        return {k: v[idx].cpu() for k, v in out.items()}

    @staticmethod
    def launch_counts() -> dict:
        """The port's counters of kernel launches ({wrapper: launches},
        and the PGS wrapper's tally by plan)."""
        from hand_tracking_samples_tpu_torch import kernels
        out = dict(kernels.counts())
        out["pgs_plans"] = dict(kernels.WRAPPERS["pgs_solve"].kinds)
        return out

    @staticmethod
    def reset_launch_counts():
        from hand_tracking_samples_tpu_torch import kernels
        kernels.reset_counts()
