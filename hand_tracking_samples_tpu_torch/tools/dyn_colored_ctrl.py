"""The colored-solver control for the dyntrack artifact (the port's
counterpart of tools/dyn_colored_ctrl.py): the colored solver with the
plane dots (use_pallas off) tracks golden.json's dyntrack protocol (one
track from bank[0], a render of bank[f] each frame) and prints one JSON
list of the per-frame mean joint deviations from the golden's poses, in
mm.  eval_artifacts dyntrack runs it with --device cpu beside the kernel
solver's run.  EVAL_FRAMES cuts the golden's 64 frames.

    python -m hand_tracking_samples_tpu_torch.tools.dyn_colored_ctrl --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from .common import FIXTURES, add_device, env_int, joint_err, render, setup


def golden_poses():
    with open(os.path.join(FIXTURES, "golden.json")) as f:
        g = json.load(f)
    return g, np.asarray(g["dyntrack_poses"], np.float32).reshape(-1, 17, 7)


def dyntrack_devs(config, device, frames=None):
    """Per-frame mean joint deviation (m) of one track run by `config` on
    the dyntrack protocol from the golden's poses, over its first `frames`
    frames (all 64 by default)."""
    from ..parallel.tracks import batched_tracker_state, batched_update
    from ..tracker.runtime import physics_params
    _, refp = golden_poses()
    F = refp.shape[0] if frames is None else min(frames, refp.shape[0])
    dev, model, bank, cam, _ = setup(device)
    params = physics_params(config)
    states = batched_tracker_state(model, 1)
    states = states._replace(body=states.body._replace(
        pose=torch.tensor(bank[0:1], device=dev)))
    devs = []
    for f in range(F):
        d = render(model, cam, bank[f:f + 1])
        states, _ = batched_update(states, model, None, d, cam, config,
                                   params)
        devs.append(float(joint_err(states.body.pose[0], refp[f])))
    return devs


def main(argv=None):
    ap = add_device(argparse.ArgumentParser(description=__doc__.split(
        "\n")[0]))
    args = ap.parse_args(argv)
    from ..tracker.config import TrackerConfig
    config = TrackerConfig(solver="colored", use_pallas=False,
                           cnn_every_frame=False)
    devs = dyntrack_devs(config, args.device, env_int("EVAL_FRAMES", 64))
    print(json.dumps([round(d * 1000, 3) for d in devs]))
    return devs


if __name__ == "__main__":
    main()
    sys.exit(0)
