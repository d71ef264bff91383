"""Equivalence check of the solvers (the port's counterpart of
tools/check_pgs_kernel.py): one dynamics frame of 3 tracks (bank frames
10, 210 and 500 on their own renders) on the sequential, colored and kernel
solvers at a small size (point budget 256, 32 cloud rows a body,
CHECK_ITERS + CHECK_IPOST sweeps, plane-dot correspondence), the bodies'
pose differences printed, colored against kernel held to 2e-4.  On the
card the kernel solver runs the PGS and contact kernels and the reference
solvers the row sweep; with --device cpu their plain versions.

    python -m hand_tracking_samples_tpu_torch.tools.check_pgs_kernel [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from .common import add_device, env_int, render, setup

T = 3


def main(argv=None):
    ap = add_device(argparse.ArgumentParser(description=__doc__.split(
        "\n")[0]))
    args = ap.parse_args(argv)
    from ..parallel.tracks import batched_tracker_state, batched_update
    from ..tracker.config import TrackerConfig
    from ..tracker.runtime import physics_params
    dev, model, bank, cam, _ = setup(args.device)
    poses = torch.tensor(bank[[10, 210, 500]], device=dev)
    depths = render(model, cam, poses)
    print("depth ok", flush=True)
    base = TrackerConfig(point_budget=256, cnn_every_frame=False,
                         cloud_rows_per_body=32,
                         physics_iterations=env_int("CHECK_ITERS", 3),
                         physics_iterations_post=env_int("CHECK_IPOST", 2),
                         use_pallas=False)
    outs = {}
    for solver in ("sequential", "colored", "kernel"):
        config = dataclasses.replace(base, solver=solver)
        params = physics_params(config)
        states = batched_tracker_state(model, T)
        states = states._replace(body=states.body._replace(pose=poses))
        st, _ = batched_update(states, model, None, depths, cam, config,
                               params)
        outs[solver] = st.body.pose.detach().cpu().numpy()
        print(f"{solver} done", flush=True)
    for a, b in (("sequential", "colored"), ("sequential", "kernel"),
                 ("colored", "kernel")):
        d = np.abs(outs[a] - outs[b])
        print(f"{a:10s} vs {b:10s}: max|dpose| = {d.max():.3e} "
              f"pos {d[..., :3].max():.3e}")
    gap = float(np.abs(outs["colored"] - outs["kernel"]).max())
    if gap >= 2e-4:
        raise SystemExit(f"MISMATCH: colored against kernel {gap:.3e}")
    print("OK")
    return outs


if __name__ == "__main__":
    main()
    sys.exit(0)
