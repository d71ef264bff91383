"""Cold-start accuracy (the port's counterpart of tools/eval_coldstart.py):
the full CNN-guided pipeline from the model's rest pose (initializing = 50)
over synthetic frames, EVAL_TRACKS starts at (t*211) % (len - EVAL_FRAMES),
the per-frame mean and median joint error against the ground truth and the
share under 8 mm.  EVAL_START_STEP = k takes every k-th start (t*k*211)
and EVAL_PROTOCOL_FRAMES = P the starts of a P-frame protocol
((... ) % (len - P), default EVAL_FRAMES): EVAL_TRACKS=8,
EVAL_START_STEP=8, EVAL_PROTOCOL_FRAMES=64 and EVAL_FRAMES=8 are the
starts and frames of tests/test_coldstart_gate.py.  EVAL_HYP > 1 first applies kickstart_multi
(tracker.runtime.kickstart_hypotheses) with EVAL_HYP hypotheses on the
first EVAL_HYP_FRAMES frames (landmark weight EVAL_HYP_LM).  EVAL_DUMP
names an .npz of the errors and starts (a relative name lands under
--out), which train_finetune reads.  Also EVAL_CNNB, EVAL_SOLVER,
EVAL_POINT_BUDGET, EVAL_ACCUM and EVAL_CLOUD_ROWS, as in the JAX tool.

    python -m hand_tracking_samples_tpu_torch.tools.eval_coldstart
    EVAL_TRACKS=2 EVAL_FRAMES=2 python -m hand_tracking_samples_tpu_torch.tools.eval_coldstart --device cpu
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from .common import add_device, add_out, env_int, joint_err, render, setup


def coldstart_errors(config, dev, model, bank, cam, cnn, T, F, hyp=1,
                     hyp_frames=1, hyp_lm=0.1, report=None, step=1,
                     protocol_frames=None):
    """The per-frame errors (F, T) in m of T cold starts over F frames
    (starts (t*step*211) % (len - protocol_frames), protocol_frames F by
    default); report(f, err) after each frame."""
    from ..parallel.tracks import batched_tracker_state, batched_update
    from ..tracker.runtime import kickstart_multi, physics_params
    params = physics_params(config)
    starts = (np.arange(T) * step * 211) % (len(bank)
                                            - (protocol_frames or F))
    states = batched_tracker_state(model, T)
    states = states._replace(initializing=torch.full(
        (T,), 50, dtype=torch.int32, device=dev))
    if hyp > 1:
        for f in range(hyp_frames):
            states, _ = kickstart_multi(states, model, cnn,
                                        render(model, cam, bank[starts + f]),
                                        cam, config, params, n_hyp=hyp,
                                        lm_weight=hyp_lm)
        print(f"kickstart_multi n_hyp={hyp} applied at frames "
              f"0..{hyp_frames - 1}", flush=True)
    errs = []
    for f in range(F):
        gt = bank[starts + f]
        states, _ = batched_update(states, model, cnn,
                                   render(model, cam, gt), cam, config,
                                   params)
        errs.append(joint_err(states.body.pose, gt))
        if report:
            report(f, errs[-1])
    return np.stack(errs), starts


def main(argv=None):
    ap = add_out(add_device(argparse.ArgumentParser(
        description=__doc__.split("\n")[0])))
    args = ap.parse_args(argv)
    from ..assets_paths import DEFAULT_CNNB
    from ..tracker.config import TrackerConfig
    cnnb = os.environ.get("EVAL_CNNB", DEFAULT_CNNB)
    T, F = env_int("EVAL_TRACKS", 64), env_int("EVAL_FRAMES", 8)
    solver = os.environ.get("EVAL_SOLVER", "kernel")
    dev, model, bank, cam, cnn = setup(args.device, cnn=True, cnnb=cnnb)
    config = TrackerConfig(
        point_budget=env_int("EVAL_POINT_BUDGET", 2048),
        cnn_every_frame=True, solver=solver, use_pallas=solver == "kernel",
        accum_error_threshold=float(os.environ.get("EVAL_ACCUM", "0.0")),
        cloud_rows_per_body=env_int("EVAL_CLOUD_ROWS", 128))

    def report(f, e):
        print(f"frame {f}: mean {np.mean(e) * 1000:6.2f} mm   median "
              f"{np.median(e) * 1000:6.2f} mm   <8mm: "
              f"{(e < 0.008).mean() * 100:4.0f}%", flush=True)
    errs, starts = coldstart_errors(
        config, dev, model, bank, cam, cnn, T, F,
        hyp=env_int("EVAL_HYP", 1), hyp_frames=env_int("EVAL_HYP_FRAMES", 1),
        hyp_lm=float(os.environ.get("EVAL_HYP_LM", "0.1")), report=report,
        step=env_int("EVAL_START_STEP", 1),
        protocol_frames=env_int("EVAL_PROTOCOL_FRAMES", F))
    print(f"\ncold-start after {F} frames over {T} starts: "
          f"mean {np.mean(errs[-1]) * 1000:.2f} mm ({cnnb})")
    dump = os.environ.get("EVAL_DUMP", "")
    if dump:
        path = os.path.join(args.out, dump)     # an absolute name stays
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(path, errs=errs, starts=starts)
        print("dumped", path)
    return errs


if __name__ == "__main__":
    main()
    sys.exit(0)
