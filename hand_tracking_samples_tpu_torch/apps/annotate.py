"""realtime-annotator / annotation-fixer equivalent: batch auto-labeling,
the port's counterpart of hand_tracking_samples_tpu.apps.annotate.

The reference's annotator captures frames live and runs `slowfit` per frame
to produce ground-truth poses (realtime-annotator.cpp:112-175); the fixer
re-simulates fits over a recorded dataset (annotation-fixer.cpp:70).  This
CLI is the offline composition of both: kickstart on the first frames, then
slowfit every frame with optional hold mode, writing the refined poses back
out in the dataset format.  It runs on the card unless --device says
otherwise:

    python -m hand_tracking_samples_tpu_torch.apps.annotate rec.rs --out rec_fit
    python -m hand_tracking_samples_tpu_torch.apps.annotate rec.rs --device cpu
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..assets_paths import DEFAULT_CNNB, DEFAULT_MODEL_JSON


def points_of(depth, cam, budget: int = 2048):
    """The annotator's cloud (JAX apps/annotate.py points_of): every 4th
    pixel of the 0.1-0.6 m range, compacted to the budget.  depth (T, H, W)
    int16 (u16 bits).  Returns (points (T, budget, 3), mask (T, budget))."""
    from ..imaging.image_ops import compact_points, point_cloud
    pts_all, mask_all = point_cloud(depth, cam, 0.1, 0.6)
    sub = mask_all & ((torch.cumsum(mask_all.to(torch.int64), 1) - 1) % 4
                      == 0)
    return compact_points(pts_all, sub, budget)


def _edits(path):
    """The report editor's per-frame commands: (nails {frame: (bone,
    xyz)}, holds {frame: level}, deleted frames)."""
    import json
    nails, holds, deletes = {}, {}, set()
    with open(path) as f:
        edits = json.load(f).get("edits", [])
    for e in edits:
        fr = int(e["frame"])
        if e.get("delete"):
            deletes.add(fr)
        if "hold" in e:
            holds[fr] = int(e["hold"])
        if "nail" in e:
            nails[fr] = (int(e["bone"]), [float(c) for c in e["nail"]])
    return nails, holds, deletes


def _dump(out_dir, ds, cam, out_poses, F):
    """Per-frame overlay PNGs, bone origins (bones_NNNN.json) and the HTML
    report with the edit panel."""
    import json
    import os
    from ..utils.report import write_html_report
    from ..utils.viz import depth_to_rgb, draw_points, write_png
    os.makedirs(out_dir, exist_ok=True)
    for f in range(F):
        img = depth_to_rgb(np.asarray(ds.depth[f]), cam.depth_scale)
        px = cam.projectz(torch.tensor(out_poses[f, :, :3])).numpy()
        write_png(os.path.join(out_dir, f"fit_{f:04d}.png"),
                  draw_points(img, px, size=2))
        with open(os.path.join(out_dir, f"bones_{f:04d}.json"), "w") as bf:
            json.dump({"frame": f, "bones": out_poses[f, :, :3].tolist()}, bf)
    print("  report:", write_html_report(out_dir))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("recordings", nargs="+")
    ap.add_argument("--model", default=DEFAULT_MODEL_JSON)
    ap.add_argument("--cnnb", default=None, help=".cnnb weights (default: shipped trained net)")
    ap.add_argument("--out", default=None, help="basename for refined output")
    ap.add_argument("--hold", type=int, default=0, choices=[0, 1, 2],
                    help="hold relative finger pose (occluded captures)")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--kickstart", type=int, default=5,
                    help="CNN kickstart frames before slowfitting")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--revert-worse", action="store_true",
                    help="per-frame accept/revert: keep the original "
                    "annotation when the refit's fit error is worse (the "
                    "annotation-fixer's per-frame startpose undo, "
                    "annotation-fixer.cpp:152-158, as a batch policy)")
    ap.add_argument("--delete-frames", default="",
                    help="comma-separated frame indices to drop from the "
                    "output (the fixer's frame-delete)")
    ap.add_argument("--inspect", action="store_true",
                    help="print per-frame fit errors (old vs refit) and exit "
                    "without writing")
    ap.add_argument("--edits", default=None,
                    help="per-frame edit commands JSON (exported by the HTML "
                    "report's editor, utils/report.py): the annotation-"
                    "fixer's interactive loop (annotation-fixer.cpp:219-260) "
                    "offline.  Schema: {\"edits\": [{\"frame\": F, \"bone\": "
                    "B, \"nail\": [x,y,z]} | {\"frame\": F, \"hold\": 0|1|2} "
                    "| {\"frame\": F, \"delete\": true}]}")
    ap.add_argument("--dump-artifacts", default=None,
                    help="dir for per-frame overlay PNGs + bone origins "
                    "(bones_NNNN.json) + the HTML report with the edit panel")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                    "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)

    import dataclasses
    from ..cnn.model import load_cnnb
    from ..data.dataset import DatasetWriter, load_dataset
    from ..device import resolve_device
    from ..fitting.cloud import fit_error
    from ..model.bake import from_numpy_model, load_hand_model
    from ..ops.cloud_kernel import depth_tensor
    from ..ops.cloud_rows import points_planes
    from ..parallel.tracks import batched_tracker_state
    from ..tracker.config import TrackerConfig
    from ..tracker.runtime import kickstart, physics_params, slowfit

    dev = resolve_device(args.device)
    model = from_numpy_model(load_hand_model(args.model), dev)
    config = TrackerConfig(point_budget=2048, solver="sequential",
                           use_pallas=False)
    params = physics_params(config)
    cnn_params = load_cnnb(args.cnnb or DEFAULT_CNNB, dev)
    pose_t = lambda p: torch.tensor(np.asarray(p, np.float32),
                                    device=dev)[None]

    for rec in args.recordings:
        bname = rec[:-3] if rec.endswith(".rs") else rec
        ds = load_dataset(bname)
        if ds.info.mirror_plane():
            config = dataclasses.replace(
                config, mirror_plane=ds.info.mirror_plane())
            print(f"mirror rig: applying MirrorPlaneSplit {ds.info.mplane}")
        cam = ds.info.camera()
        F = len(ds.depth) if not args.max_frames else min(args.max_frames,
                                                          len(ds.depth))
        state = batched_tracker_state(model, 1)
        has_start = np.abs(ds.pose).sum() > 0
        if has_start:                        # refine existing annotations
            state = state._replace(body=state.body._replace(
                pose=pose_t(ds.pose[0])))
            do_kickstart = 0
        else:
            do_kickstart = args.kickstart

        def fe(state, pts, mask, depth):
            return float(fit_error(state.body.pose, model,
                                   points_planes(pts, mask), depth, cam)[0])

        nails, holds, edit_deletes = (_edits(args.edits) if args.edits
                                      else ({}, {}, set()))
        if nails or holds or edit_deletes:
            print(f"  edits: {len(nails)} nails, {len(holds)} holds, "
                  f"{len(edit_deletes)} deletes")

        out_poses = np.zeros((F, 17, 7), np.float32)
        errors, reverted = [], 0
        refpose = pose_t(ds.pose[0]) if has_start else model.start_pose[None]
        for f in range(F):
            depth = depth_tensor(ds.depth[f][None], dev)
            if f < do_kickstart:
                state = kickstart(state, model, cnn_params, depth, cam,
                                  config, params)[0]
            pts, mask = points_of(depth, cam, config.point_budget)
            # startpose = the frame's existing annotation (dataset.h:44)
            startpose = ds.pose[f] if has_start else None
            nail = nails.get(f)
            kw = {} if nail is None else dict(
                select_bone=nail[0],
                spoint=torch.tensor([nail[1]], dtype=torch.float32,
                                    device=dev),
                rbpoint=torch.zeros((1, 3), device=dev))
            state = slowfit(state, model, pts, mask, config, params,
                            hold=holds.get(f, args.hold), refpose=refpose,
                            steps=args.steps, **kw)
            err_new = fe(state, pts, mask, depth)
            if (args.revert_worse or args.inspect) and startpose is not None:
                st_old = state._replace(body=state.body._replace(
                    pose=pose_t(startpose)))
                err_old = fe(st_old, pts, mask, depth)
                if args.inspect:
                    print(f"  frame {f:4d}: old {err_old:.4f} "
                          f"refit {err_new:.4f}"
                          f"{'  (would revert)' if err_new > err_old else ''}")
                if args.revert_worse and err_new > err_old:
                    state = st_old      # per-frame undo: keep the annotation
                    err_new = err_old
                    reverted += 1
            out_poses[f] = state.body.pose[0].cpu().numpy()
            errors.append(err_new)
        print(f"{bname}: slowfit {F} frames, mean fit error "
              f"{np.mean(errors):.4f}"
              + (f", reverted {reverted}" if args.revert_worse else ""))
        if args.dump_artifacts:
            _dump(args.dump_artifacts, ds, cam, out_poses, F)

        if args.out and not args.inspect:
            drop = {int(i) for i in args.delete_frames.split(",") if i}
            drop |= edit_deletes
            keep = [f for f in range(F) if f not in drop]
            with DatasetWriter(args.out, ds.info) as w:
                w.save_frames(ds.depth[keep], out_poses[keep],
                              None if ds.ir is None else ds.ir[keep])
            print(f"  wrote {args.out}.rs/.pose/.json ({len(keep)} frames"
                  + (f", dropped {sorted(drop)}" if drop else "") + ")")


if __name__ == "__main__":
    sys.exit(main())
