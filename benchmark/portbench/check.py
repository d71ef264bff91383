"""How `correct` is decided: sampled frames of sampled tracks, each
recomputed by the plain reference (the port's plain paths as frozen in
plainref/, on the CPU) from the state the program held before the frame,
on the same depth, and compared with what the program produced: the
poses it returned and the state it carried on.

A tracker's frame depends on the state its track carries, so the
reference follows the program step by step from the program's own state.
The two stages this skips are checked by themselves: the start (frame 0
from the reference's own start state, built from the same bone poses,
which is also compared with the program's) and the carry (the state the
program passes to the next frame is compared, not only the poses).

The numbers compared (each the widest over the sampled tracks and
frames; a cell's file lists those it compares, with their limits):
  pos_gap_m  positions of the returned user poses and of the carried bone
             poses, metres
  rot_gap    their quaternions, component-wise, sign-invariant
  mom_gap    the carried linear and angular momenta, each leaf's gap over
             that leaf's largest reference magnitude in the sample
  net_gap    on CNN frames, the net's output (the (T, 2304) activations
             the CNN frame decodes) over its largest reference magnitude
  fit_gap    on CNN frames, FitError of the pose before the frame (its
             cloud correspondence is kernel 7, cloud_vals; the reset
             decision compares it with full_reset_on_error) over the
             sample's largest reference value
  fit_gap_after  the same of FitError after MultiStepSim (the take
             decision compares the two)
  err_gap    the carried prev_frame_error (the error the take decision
             accumulates), over the sample's largest reference FitError
             or prev_frame_error
  init_gap   the number of sampled tracks whose carried `initializing`
             (the re-initialisation countdown) differs: exact
"""
from __future__ import annotations

import contextlib
import os
import sys

import numpy as np
import torch

NUMBERS = ("pos_gap_m", "rot_gap", "mom_gap", "net_gap", "fit_gap",
           "fit_gap_after", "err_gap", "init_gap")


def quat_gap(a, b):
    """Sign-invariant largest quaternion component difference."""
    sign = torch.sign((a * b).sum(-1, keepdim=True))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    return float((a - b * sign).abs().max())


def _rel(got, ref) -> float:
    scale = float(ref.abs().max())
    d = float((got - ref).abs().max())
    return d / scale if scale > 0 else (0.0 if d == 0 else float("inf"))


def gaps(prog_poses, prog_next: dict, ref_poses, ref_next: dict,
         prog_net=None, ref_net=None, prog_fit=None, ref_fit=None) -> dict:
    """The compared numbers for one frame of a sample of tracks.  *_fit:
    on a CNN frame the (FitError before, FitError after MultiStepSim) of
    the sampled tracks, else None."""
    pos = max(float((prog_poses[..., :3] - ref_poses[..., :3]).abs().max()),
              float((prog_next["pose"][..., :3]
                     - ref_next["pose"][..., :3]).abs().max()))
    rot = max(quat_gap(prog_poses[..., 3:], ref_poses[..., 3:]),
              quat_gap(prog_next["pose"][..., 3:],
                       ref_next["pose"][..., 3:]))
    mom = max(_rel(prog_next[k], ref_next[k])
              for k in ("linear_momentum", "angular_momentum"))
    out = {"pos_gap_m": pos, "rot_gap": rot, "mom_gap": mom,
           "net_gap": 0.0 if ref_net is None else _rel(prog_net, ref_net),
           "fit_gap": 0.0, "fit_gap_after": 0.0}
    scale = float(ref_next["prev_frame_error"].abs().max())
    if ref_fit is not None:
        out["fit_gap"] = _rel(prog_fit[0], ref_fit[0])
        out["fit_gap_after"] = _rel(prog_fit[1], ref_fit[1])
        scale = max([scale] + [float(x.abs().max()) for x in ref_fit])
    d = float((prog_next["prev_frame_error"]
               - ref_next["prev_frame_error"]).abs().max())
    out["err_gap"] = d / scale if scale > 0 else (0.0 if d == 0
                                                  else float("inf"))
    out["init_gap"] = float((prog_next["initializing"]
                             != ref_next["initializing"]).sum())
    return {k: (v if np.isfinite(v) else float("inf")) for k, v in
            out.items()}


@contextlib.contextmanager
def fit_errors(module):
    """While open, every call of `module.fit_error` (FitError, the tracker
    runtime's name for it) appends its (T,) result to the list it
    yields; update_cnn_model calls it twice a CNN frame, before the reset
    and after MultiStepSim.  The attribute is restored on exit."""
    real, seen = module.fit_error, []

    def note(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append(out)
        return out
    module.fit_error = note
    try:
        yield seen
    finally:
        module.fit_error = real


class Reference:
    """The plain reference on the CPU: its own baked model, net and camera
    from the same files and settings the program is given."""

    def __init__(self, config: dict, repo: str, model=None):
        bench = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        if bench not in sys.path:
            sys.path.insert(0, bench)
        from plainref.cnn.model import load_cnnb
        from plainref.imaging.camera import DCamera
        from plainref.tracker.config import TrackerConfig
        from plainref.tracker.runtime import physics_params
        self.model = model if model is not None else bake(config, repo,
                                                          "cpu")
        self.net = (load_cnnb(os.path.join(repo, config["net"]), "cpu")
                    if config.get("net") else None)
        cam = config["camera"]
        self.cam = DCamera.make(dim=tuple(cam["dim"]),
                                focal=tuple(cam["focal"]),
                                principal=tuple(cam["principal"]),
                                depth_scale=cam["depth_scale"])
        self.config = TrackerConfig(**config["tracker"])
        self.params = physics_params(self.config)

    def initial_leaves(self, poses) -> dict:
        """The start state of len(poses) tracks at those bone poses."""
        from plainref.tracker.runtime import make_tracker_state
        one = make_tracker_state(self.model)
        n = poses.shape[0]
        rep = lambda x: x.expand((n,) + tuple(x.shape)).clone()
        return {"pose": poses.to(torch.float32).clone(),
                "linear_momentum": rep(one.body.linear_momentum),
                "angular_momentum": rep(one.body.angular_momentum),
                "prev_frame_error": rep(one.prev_frame_error),
                "initializing": rep(one.initializing)}

    def step(self, leaves: dict, depth, run_cnn: bool):
        """One frame of the reference from state `leaves`: (user poses,
        next state's leaves, the net's output or None, the two FitErrors
        of a CNN frame or None)."""
        from plainref.physics.solver import BodyState
        from plainref.tracker import runtime
        st = runtime.TrackerState(
            BodyState(leaves["pose"], leaves["linear_momentum"],
                      leaves["angular_momentum"]),
            leaves["prev_frame_error"], leaves["initializing"])
        with fit_errors(runtime) as fit:
            new, poses, dbg = runtime.update(
                st, self.model, depth, self.cam, self.config, self.params,
                cnn_params=self.net, run_cnn=run_cnn)
        nxt = dict(zip(("pose", "linear_momentum", "angular_momentum"),
                       new.body))
        nxt["prev_frame_error"] = new.prev_frame_error
        nxt["initializing"] = new.initializing
        return (poses, nxt, None if dbg is None else dbg.cnn_output,
                tuple(fit) if run_cnn else None)


def bake(config: dict, repo: str, device):
    """The reference's own baked hand model (no cache: the same seconds
    every run)."""
    bench = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if bench not in sys.path:
        sys.path.insert(0, bench)
    from plainref.model.bake import bake_hand_model, from_numpy_model
    return from_numpy_model(
        bake_hand_model(os.path.join(repo, config["model"])).fields(),
        device)


class Case:
    """One checked frame: frame f of the sampled tracks `idx`, the state
    the program held before it and after it, the poses it returned, the
    depth it saw and, on a CNN frame, its net's output and its FitErrors
    (all on the CPU)."""

    def __init__(self, f, run_cnn, idx, before, after, poses, depth, net,
                 start=False, fit=None):
        self.f, self.run_cnn, self.idx = f, run_cnn, idx
        self.before, self.after, self.poses = before, after, poses
        self.depth, self.net, self.start = depth, net, start
        self.fit = fit


def judge(cases, ref: Reference, limits: dict, start_poses=None,
          control=None) -> dict:
    """The compared numbers over all cases, and `correct`.  A start case
    takes the reference's own start state (built from start_poses, and
    itself compared with the program's); the others the program's state
    before the frame.  control: None, or a precision of portbench.precision
    under which the reference replaces the program (its outputs are then
    judged against the full-precision reference's)."""
    worst = {k: 0.0 for k in NUMBERS}
    start_gap = 0.0
    for c in cases:
        before = c.before
        if c.start:
            mine = ref.initial_leaves(start_poses[c.idx])
            start_gap = max(start_gap, max(
                float((mine[k].to(torch.float64)
                       - before[k].to(torch.float64)).abs().max())
                for k in mine))
            before = mine
        ref_poses, ref_next, ref_net, ref_fit = ref.step(before, c.depth,
                                                         c.run_cnn)
        if control is None:
            got_poses, got_next, got_net, got_fit = (c.poses, c.after,
                                                     c.net, c.fit)
        else:
            from .precision import Rounding
            with Rounding(control):
                got_poses, got_next, got_net, got_fit = ref.step(
                    before, c.depth, c.run_cnn)
        if ref_fit is not None and (got_fit is None
                                    or len(got_fit) != len(ref_fit)):
            worst["fit_gap"] = worst["fit_gap_after"] = float("inf")
            ref_fit = got_fit = None      # the FitErrors were not seen
        for k, v in gaps(got_poses, got_next, ref_poses, ref_next, got_net,
                         ref_net, got_fit, ref_fit).items():
            worst[k] = max(worst[k], v)
    ok = all(worst[k] <= limits[k] for k in limits) and start_gap == 0.0
    return {"correct": bool(ok), "numbers": worst, "start_gap": start_gap}
