"""The accum_error_threshold sweep on a recorded CNN-cadence fixture (the
port's counterpart of tools/eval_accum_threshold.py): the accept gate
(handtrack.h:714-726) takes the background pose when the accumulated
FitError improvement exceeds the threshold, and taking after withheld
frames snaps the pose.  One track (T=1, colored solver) through EVAL_REC
(cnntrack_rec2) at k = EVAL_K (4) for each threshold of the grid: the mean
and final joint error against the recording's poses and the p95 and
largest joint movement on CNN frames.  Writes
accum_threshold_<ROUND>.json under --out; EVAL_FRAMES cuts the recording.

    python -m hand_tracking_samples_tpu_torch.tools.eval_accum_threshold
    EVAL_FRAMES=2 python -m hand_tracking_samples_tpu_torch.tools.eval_accum_threshold --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from .common import (add_device, add_out, env_int, joint_err,
                     load_recording, setup, track_recording, write_json)

THRESHOLDS = [0.0, 0.005, 0.02, 0.05, 0.1]


def run_one(ctx, thresh, k, frames):
    """The grid row of one threshold, and the per-frame joint errors."""
    from ..tracker.config import TrackerConfig
    dev, model, ds, cam, cnn = ctx
    config = TrackerConfig(cnn_every_frame=True, cnn_every_k=k,
                           solver="colored", accum_error_threshold=thresh)
    poses = track_recording(ds, cam, model, cnn, config, k, frames, dev)
    jes = joint_err(poses, ds.pose[:frames])
    move = joint_err(poses[1:], poses[:-1])            # frame f from f - 1
    jumps = np.asarray([move[f - 1] for f in range(1, frames)
                        if f % k == 0])
    p95 = float(np.percentile(jumps, 95) * 1000) if jumps.size else 0.0
    top = float(jumps.max() * 1000) if jumps.size else 0.0
    return {"threshold": thresh,
            "mean_je_mm": round(float(np.mean(jes) * 1000), 2),
            "final_je_mm": round(float(jes[-1] * 1000), 2),
            "p95_heavy_jump_mm": round(p95, 2),
            "max_heavy_jump_mm": round(top, 2)}, jes


def main(argv=None):
    ap = add_out(add_device(argparse.ArgumentParser(
        description=__doc__.split("\n")[0])))
    args = ap.parse_args(argv)
    k, rec = env_int("EVAL_K", 4), os.environ.get("EVAL_REC",
                                                  "cnntrack_rec2")
    dev, model, _, _, cnn = setup(args.device, cnn=True)
    ds, cam = load_recording(rec)
    frames = min(env_int("EVAL_FRAMES", len(ds.pose)), len(ds.pose))
    out, curves = [], {}
    for t in THRESHOLDS:
        r, curves[t] = run_one((dev, model, ds, cam, cnn), t, k, frames)
        out.append(r)
        print(json.dumps(r), flush=True)
    write_json(os.path.join(args.out, f"accum_threshold_"
                            f"{os.environ.get('ROUND', 'r04')}.json"),
               {"rec": rec, "k": k, "frames": frames, "grid": out,
                "command": "python -m hand_tracking_samples_tpu_torch."
                "tools.eval_accum_threshold"})
    return curves


if __name__ == "__main__":
    main()
    sys.exit(0)
