"""Time the dynamics frame's stages one at a time with real shapes (the
port's counterpart of tools/profile_stages.py): the point cloud, the cloud
rows (correspondence kernel and plane dots), the colored pack, the
contacts, the joint rows, the chamber rows, HandModelEnhancements, and the
colored solve with its rows at 16+4 and at 1+1 iterations.  BENCH_TRACKS
tracks (512) on renders of seeded random animbank poses, N = 1024 points,
the colored solver.  Each stage: one warm-up call, then the mean of three
(CUDA events on the card).

    python -m hand_tracking_samples_tpu_torch.tools.profile_stages
    BENCH_TRACKS=2 python -m hand_tracking_samples_tpu_torch.tools.profile_stages --device cpu
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .common import (add_device, env_int, render, setup, stage_args,
                     sync, wanted)

N = 1024
STAGES = ("cloud", "rows_kernel", "rows_dots", "pack", "contacts", "joints",
          "chamber", "enhancements", "solve", "solve_11")


def bench(dev, fn, *args, label=""):
    """ms a call: one warm-up call, then three timed together."""
    fn(*args)
    sync(dev)
    if dev.type == "cuda":
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(3):
            fn(*args)
        e1.record()
        torch.cuda.synchronize(dev)
        ms = e0.elapsed_time(e1) / 3
    else:
        import time
        t0 = time.perf_counter()
        for _ in range(3):
            fn(*args)
        ms = (time.perf_counter() - t0) / 3 * 1e3
    print(f"{label:46s} {ms:8.2f} ms", flush=True)
    return ms


def main(argv=None):
    ap = stage_args(add_device(argparse.ArgumentParser(
        description=__doc__.split("\n")[0])), STAGES)
    args = ap.parse_args(argv)
    on = wanted(ap, args, STAGES)
    from ..fitting.cloud import cloud_chamber_rows, cloud_constraint_rows
    from ..imaging.image_ops import compact_points, point_cloud
    from ..model.hand import (body_params, fit_rows, joint_angular_rows,
                              joint_linear_rows)
    from ..physics.colored import (pack_single_body_linear,
                                   physics_update_colored)
    from ..physics.contacts import contact_rows
    from ..physics.schedule import build_hand_schedule
    from ..physics.solver import BodyState
    from ..tracker.config import TrackerConfig
    from ..tracker.runtime import (BOUNDARY_OUTDIRS, hand_model_enhancements,
                                   physics_params)
    T = env_int("BENCH_TRACKS", 512)
    dev, model, bank, cam, _ = setup(args.device)
    config = TrackerConfig(point_budget=N, cnn_every_frame=False,
                           solver="colored", use_pallas=True)
    params = physics_params(config)
    rng = np.random.RandomState(0)
    poses = torch.tensor(bank[rng.randint(0, len(bank), T)], device=dev)
    depths = render(model, cam, poses)
    z = torch.zeros((T, 17, 3), device=dev)
    states = BodyState(pose=poses, linear_momentum=z, angular_momentum=z)
    out = {}

    def stage_cloud(depths):
        pts_all, mask_all = point_cloud(depths, cam, 0.1, config.drangey)
        sub = mask_all & ((torch.cumsum(mask_all.to(torch.int32), 1) - 1)
                          % 4 == 0)
        return compact_points(pts_all, sub, N)
    pts, mask = stage_cloud(depths)
    rows = cloud_constraint_rows(states.pose, model, pts, mask,
                                 use_kernel=True)
    act = torch.ones(T, dtype=torch.bool, device=dev)
    sched = build_hand_schedule(model.np, "exact")
    bp = body_params(model)

    def stage_rows(kernel):
        return lambda s, p, m: cloud_constraint_rows(s.pose, model, p, m,
                                                     use_kernel=kernel)

    def stage_solve(it, ip):
        def fn(s, p, m):
            lin, ang = fit_rows(s, model, params, p, m, contacts=True,
                                schedule=sched, cloud_slots=128,
                                use_kernel=True)
            return physics_update_colored(s, bp, lin, ang, params,
                                          iterations=it, iterations_post=ip)
        return fn
    cloud_in = (states, pts, mask)
    table = {
        "cloud": (stage_cloud, (depths,),
                  "point_cloud + subsample + compact"),
        "rows_kernel": (stage_rows(True), cloud_in,
                        "cloud_constraint_rows (corr kernel)"),
        "rows_dots": (stage_rows(False), cloud_in,
                      "cloud_constraint_rows (plane dots)"),
        "pack": (lambda r: pack_single_body_linear(r, 17, 128), (rows,),
                 "pack_single_body_linear (128 slots)"),
        "contacts": (lambda s: contact_rows(s, model, params), (states,),
                     "contact_rows (87 pairs SAT)"),
        "joints": (lambda s: (joint_linear_rows(s, model),
                              joint_angular_rows(s, model, params)),
                   (states,), "joint row factories"),
        "chamber": (lambda s, p, m: cloud_chamber_rows(
            s.pose, model, p, m, BOUNDARY_OUTDIRS, (0.0, 0.0, 0.0),
            (0.0, 0.0, 1.0), 10.0, act), cloud_in, "cloud_chamber_rows"),
        "enhancements": (lambda s: hand_model_enhancements(s, model,
                                                           params),
                         (states,), "hand_model_enhancements"),
        "solve": (stage_solve(16, 4), cloud_in,
                  "pack+joint/contact rows+colored solve"),
        "solve_11": (stage_solve(1, 1), cloud_in,
                     "  same but 1+1 iters (prep cost)"),
    }
    for name in STAGES:
        if on(name):
            fn, a, label = table[name]
            out[name] = bench(dev, fn, *a, label=label)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
