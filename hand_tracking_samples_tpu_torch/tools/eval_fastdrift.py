"""The tracker's fast-segment drift on the reference protocol (the port's
counterpart of tools/eval_fastdrift.py): tests/fixtures/fastdrift_ref.json
(tools/golden_gen.cpp GG_FASTDRIFT), --tracks tracks starting at
(t*37) % (len - 32) from the ground-truth pose, 32 dynamics-only frames
each, and the per-frame mean joint error beside the C++ reference's.
--frames cuts the protocol's 32 frames (the reference's columns stay its
own).  --json writes a summary; --attribution adds the median-gap matrix
(colored cap 512, kernel budget 4096, colored cap 512 budget 4096); a
setting outside a kernel's limits (kernels.KernelLimit: on the card, the
cloud-rows kernel takes N <= 2048, so kernel budget 4096; ROADMAP) is
recorded with its message under "refused".

    python -m hand_tracking_samples_tpu_torch.tools.eval_fastdrift [--solver kernel] [--cap 128] [--budget 2048]
    python -m hand_tracking_samples_tpu_torch.tools.eval_fastdrift --tracks 2 --frames 2 --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..kernels import KernelLimit
from .common import (FIXTURES, add_device, joint_err, protocol_frames,
                     render, setup, write_json)


def reference():
    with open(os.path.join(FIXTURES, "fastdrift_ref.json")) as f:
        return json.load(f)


def measure(ctx, solver, cap, budget, pallas):
    """The body poses (F, T, 17, 7) of the protocol under one setting."""
    from ..parallel.tracks import batched_tracker_state, batched_update
    from ..tracker.config import TrackerConfig
    from ..tracker.runtime import physics_params
    dev, model, cam, depths, poses = ctx
    config = TrackerConfig(point_budget=budget, cnn_every_frame=False,
                           solver=solver, cloud_rows_per_body=cap,
                           use_pallas=bool(pallas))
    params = physics_params(config)
    T = poses.shape[1]
    states = batched_tracker_state(model, T)
    states = states._replace(body=states.body._replace(
        pose=torch.tensor(poses[0], device=dev)))
    t0 = time.time()
    out = []
    for f in range(depths.shape[0]):
        states, _ = batched_update(states, model, None, depths[f], cam,
                                   config, params)
        out.append(states.body.pose.detach().cpu().numpy())
    print(f"# run {time.time() - t0:.1f}s  solver={solver} cap={cap} "
          f"budget={budget} pallas={pallas} tracks={T}", flush=True)
    return np.stack(out)


def main(argv=None):
    ap = add_device(argparse.ArgumentParser(description=__doc__.split(
        "\n")[0]))
    ap.add_argument("--solver", default="kernel")
    ap.add_argument("--cap", type=int, default=128)
    ap.add_argument("--budget", type=int, default=2048)
    ap.add_argument("--pallas", type=int, default=1)
    ap.add_argument("--tracks", type=int, default=64)
    ap.add_argument("--frames", type=int, default=0,
                    help="frames of the protocol to run (default all)")
    ap.add_argument("--json", default="", help="write a summary artifact")
    ap.add_argument("--attribution", action="store_true",
                    help="also run the median-gap attribution matrix "
                    "(colored cap512, kernel budget4096, colored cap512 "
                    "budget4096) and embed the results")
    args = ap.parse_args(argv)
    ref = reference()
    dev, model, bank, cam, _ = setup(args.device)
    T, F = args.tracks, ref["n_frames"]
    starts, fids = protocol_frames(bank, T, F)
    if args.frames:
        F, fids = min(args.frames, F), fids[:args.frames]
    poses = bank[fids]                                     # (F, T, 17, 7)
    depths = render(model, cam, poses)
    ctx = (dev, model, cam, depths, poses)
    op = measure(ctx, args.solver, args.cap, args.budget, args.pallas)
    err = joint_err(op, poses)                             # (F, T)
    rm = np.array(ref["mean_err_per_frame"])
    print(f"{'frame':>5} {'ours_mm':>8} {'ref_mm':>8}")
    for f in range(F):
        print(f"{f:5d} {err[f].mean() * 1000:8.2f} {rm[f] * 1000:8.2f}")
    print(f"final mean: ours {err[-1].mean() * 1000:.2f}mm  "
          f"ref {rm[F - 1] * 1000:.2f}mm  ratio "
          f"{err[-1].mean() / rm[F - 1]:.3f}")
    rf = np.array(ref["final_err_per_track"])[:T]
    mine = err[-1]
    if T <= 16:
        for t in range(T):
            print(f"track {t} start={starts[t]}: ours "
                  f"{mine[t] * 1000:7.1f}mm ref {rf[t] * 1000:7.1f}mm")
    print(f"per-track final: median ours {np.median(mine) * 1000:.2f} "
          f"ref {np.median(rf) * 1000:.2f}; diverged(>40mm) ours "
          f"{(mine > 0.04).sum()} ref {(rf > 0.04).sum()}")
    if args.json:
        payload = {
            "round": os.environ.get("EVAL_ROUND", ""),
            "protocol": f"{T} tracks x {F} frames dynamics-only, "
                        f"solver={args.solver} cap={args.cap} "
                        f"budget={args.budget} (GG_FASTDRIFT protocol)",
            "backend": str(dev),
            "final_mean_mm": round(float(err[-1].mean() * 1000), 2),
            "ref_final_mean_mm": round(float(rm[F - 1] * 1000), 2),
            "ratio": round(float(err[-1].mean() / rm[F - 1]), 3),
            "final_median_mm": round(float(np.median(mine) * 1000), 2),
            "ref_final_median_mm": round(float(np.median(rf) * 1000), 2),
            "diverged_gt40mm": int((mine > 0.04).sum()),
            "ref_diverged_gt40mm": int((rf > 0.04).sum()),
            "mean_err_per_frame_mm": [round(float(e * 1000), 2)
                                      for e in err.mean(-1)],
            "final_err_per_track_mm": [round(float(e * 1000), 3)
                                       for e in mine],
            "command": " ".join(
                ["python -m hand_tracking_samples_tpu_torch.tools."
                 "eval_fastdrift",
                 *(sys.argv[1:] if argv is None else argv)]),
        }
        if args.attribution:
            rows = []
            for (so, cp, bu, pa, note) in [
                    ("colored", 512, args.budget, 0,
                     "cap lifted (~uncapped), shipped budget"),
                    ("kernel", 128, 4096, 1, "budget doubled, shipped cap"),
                    ("colored", 512, 4096, 0,
                     "both lifted (accuracy-first config)")]:
                row = {"solver": so, "cap": cp, "budget": bu, "note": note}
                try:
                    em = joint_err(measure(ctx, so, cp, bu, pa), poses)[-1]
                except KernelLimit as e:    # a kernel's limit: recorded
                    row["refused"] = str(e)
                    rows.append(row)
                    print(f"#   -> refused: {e}", flush=True)
                    continue
                row.update({
                    "final_mean_mm": round(float(em.mean() * 1000), 2),
                    "final_median_mm": round(float(np.median(em) * 1000), 2),
                    "median_ratio": round(
                        float(np.median(em) / np.median(rf)), 3),
                    "diverged_gt40mm": int((em > 0.04).sum())})
                rows.append(row)
                print(f"#   -> median {rows[-1]['final_median_mm']} mm "
                      f"(ratio {rows[-1]['median_ratio']})", flush=True)
            payload["attribution"] = rows
        write_json(args.json, payload)
    return err


if __name__ == "__main__":
    main()
    sys.exit(0)
