"""realtime-hand-tracker equivalent on recordings: replay-and-track, the
port's counterpart of hand_tracking_samples_tpu.apps.replay_track.

The reference viewer takes a recorded .rs file as argv[1] and streams it as
if it were a live camera (realtime-tracker.cpp:38, dcam.h:345).  This CLI
tracks one or many recordings (one track each), writes the tracked poses out
in the reference .pose format, and reports fit error / deviation from any
recorded ground-truth poses.  It runs on the card (with the cloud kernels,
use_pallas) unless --device says otherwise:

    python -m hand_tracking_samples_tpu_torch.apps.replay_track recording.rs \
        --cnnb weights.cnnb --out tracked
    python -m hand_tracking_samples_tpu_torch.apps.replay_track recording.rs \
        --dynamics-only --device cpu
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..assets_paths import DEFAULT_CNNB, DEFAULT_MODEL_JSON


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("recordings", nargs="+", help=".rs files or basenames")
    ap.add_argument("--model", default=DEFAULT_MODEL_JSON)
    ap.add_argument("--cnnb", default=None, help=".cnnb weights (default: shipped trained net)")
    ap.add_argument("--out", default=None, help="write tracked poses (.pose)")
    ap.add_argument("--dynamics-only", action="store_true")
    ap.add_argument("--solver", default="colored")
    ap.add_argument("--filter", default="none", choices=["none", "ivy", "ds4"])
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                    "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)

    import dataclasses
    from ..cnn.model import load_cnnb
    from ..data.dataset import (filter_ds4, filter_ivy, load_dataset,
                                pose_line)
    from ..device import resolve_device
    from ..model.bake import from_numpy_model, load_hand_model
    from ..ops.cloud_kernel import depth_tensor
    from ..parallel.tracks import batched_tracker_state
    from ..tracker.config import TrackerConfig
    from ..tracker.runtime import physics_params, update

    dev = resolve_device(args.device)
    model = from_numpy_model(load_hand_model(args.model), dev)
    config = TrackerConfig(point_budget=2048, solver=args.solver,
                           use_pallas=dev.type == "cuda",
                           cnn_every_frame=not args.dynamics_only)
    params = physics_params(config)
    cnn_params = None
    if not args.dynamics_only:
        cnn_params = load_cnnb(args.cnnb or DEFAULT_CNNB, dev)

    for rec in args.recordings:
        bname = rec[:-3] if rec.endswith(".rs") else rec
        ds = load_dataset(bname)
        if ds.info.mirror_plane():
            config = dataclasses.replace(
                config, mirror_plane=ds.info.mirror_plane())
            print(f"mirror rig: applying MirrorPlaneSplit {ds.info.mplane}")
        cam = ds.info.camera()
        depth = ds.depth
        if args.filter == "ivy":
            depth = filter_ivy(depth, ds.info.depth_scale)
        elif args.filter == "ds4" and ds.ir is not None:
            depth = np.stack([filter_ds4(d, i)
                              for d, i in zip(depth, ds.ir)])
        if args.max_frames:
            depth = depth[: args.max_frames]
        F = len(depth)
        print(f"{bname}: {F} frames {depth.shape[2]}x{depth.shape[1]} "
              f"depth_scale={ds.info.depth_scale}")

        state = batched_tracker_state(model, 1)
        has_gt = np.abs(ds.pose).sum() > 0
        if has_gt:
            state = state._replace(body=state.body._replace(
                pose=torch.tensor(ds.pose[0], device=dev)[None]))
        out_poses = np.zeros((F, 17, 7), np.float32)
        t0 = time.time()
        for f in range(F):
            state, _, _ = update(state, model, depth_tensor(depth[f][None],
                                                            dev),
                                 cam, config, params, cnn_params=cnn_params)
            out_poses[f] = state.body.pose[0].cpu().numpy()
        dt = time.time() - t0
        print(f"  tracked in {dt:.2f}s ({F/dt:.1f} fps single-track)")
        if has_gt:
            je = np.linalg.norm(out_poses[:, :, :3] - ds.pose[:F, :, :3],
                                axis=-1).mean()
            print(f"  mean joint deviation vs recorded poses: {je*1000:.2f} mm")
        if args.out:
            path = args.out + os.path.basename(bname) + ".pose" \
                if args.out.endswith("/") else args.out + ".pose"
            with open(path, "w") as fo:
                fo.writelines(pose_line(p) for p in out_poses)
            print(f"  wrote {path}")


if __name__ == "__main__":
    sys.exit(main())
