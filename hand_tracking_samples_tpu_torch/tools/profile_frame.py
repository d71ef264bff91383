"""Decompose the dynamics frame's cost by timing configuration variants
(the port's counterpart of tools/profile_frame.py): each variant drops one
stage or scales the iteration counts, and a stage's cost falls out by
subtraction or by the slope over the sweeps.  track_sequences over
BENCH_FRAMES frames of the JAX tool's renders at BENCH_TRACKS tracks, the
kernel solver at the parity defaults (PROF_BUDGET points).  Variants may be
named to time only those (all by default): base it11 nocontact nochamber
nopallas pb512; the derived lines print when their variants ran.

    python -m hand_tracking_samples_tpu_torch.tools.profile_frame [variant ...]
    BENCH_TRACKS=2 BENCH_FRAMES=1 python -m hand_tracking_samples_tpu_torch.tools.profile_frame --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from .common import (add_device, env_int, protocol_frames, render, setup,
                     stage_args, sync, wanted)

VARIANTS = ("base", "it11", "nocontact", "nochamber", "nopallas", "pb512")


def time_config(ctx, config, label):
    """ms a frame of track_sequences under config (one warm-up run, then
    one timed run, as the JAX tool does)."""
    from ..parallel.tracks import batched_tracker_state, track_sequences
    from ..tracker.runtime import physics_params
    dev, model, cam, depths, pose0 = ctx
    params = physics_params(config)

    def run():
        st = batched_tracker_state(model, pose0.shape[0])
        st = st._replace(body=st.body._replace(pose=pose0))
        out = track_sequences(st, model, None, depths, cam, config, params)
        sync(dev)
        return out
    t0 = time.perf_counter()
    run()
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    run()
    ms = (time.perf_counter() - t0) / depths.shape[0] * 1e3
    print(f"{label:42s} {ms:8.1f} ms/frame  (warmup {warm:.0f}s)",
          flush=True)
    return ms


def main(argv=None):
    ap = stage_args(add_device(argparse.ArgumentParser(
        description=__doc__.split("\n")[0])), VARIANTS)
    args = ap.parse_args(argv)
    on = wanted(ap, args, VARIANTS)
    from ..tracker.config import TrackerConfig
    T, F = env_int("BENCH_TRACKS", 512), env_int("BENCH_FRAMES", 4)
    dev, model, bank, cam, _ = setup(args.device)
    _, fids = protocol_frames(bank, T, F)
    depths = render(model, cam, bank[fids])
    ctx = (dev, model, cam, depths, torch.tensor(bank[fids[0]], device=dev))
    base = TrackerConfig(point_budget=env_int("PROF_BUDGET", 2048),
                         cnn_every_frame=False, solver="kernel",
                         cloud_rows_per_body=128, use_pallas=True,
                         contacts_mode="exact")
    r = {}
    for key, kw, label in (
            ("base", {}, "base (16+4 iters)"),
            ("it11", dict(physics_iterations=1, physics_iterations_post=1),
             "iters 1+1 (sweep cost via slope)"),
            ("nocontact", dict(physics_use_collision=0), "no contacts"),
            ("nochamber", dict(boundary_planes=0), "no boundary planes"),
            ("nopallas", dict(use_pallas=False), "plane-dot correspondence"),
            ("pb512", dict(point_budget=512), "point budget 512")):
        if on(key):
            r[key] = time_config(ctx, dataclasses.replace(base, **kw),
                                 label)
    if "base" in r and "it11" in r:
        sweep_ms = (r["base"] - r["it11"]) / 18.0  # 20 sweeps vs 2
        print(f"\nper-sweep cost      : {sweep_ms:6.2f} ms -> 20 sweeps = "
              f"{20 * sweep_ms:.1f} ms")
        print(f"non-sweep (assembly+corr+cloud): "
              f"{r['it11'] - 2 * sweep_ms:6.1f} ms")
    if "base" in r and "nocontact" in r:
        print(f"contacts total       : {r['base'] - r['nocontact']:6.1f} ms")
    if "base" in r and "nochamber" in r:
        print(f"chamber total        : {r['base'] - r['nochamber']:6.1f} ms")
    return r


if __name__ == "__main__":
    main()
    sys.exit(0)
