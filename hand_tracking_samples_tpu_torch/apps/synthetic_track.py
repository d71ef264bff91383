"""synthetic-hand-tracker equivalent: a camera-free end-to-end tracking
demo, the port's counterpart of hand_tracking_samples_tpu.apps.
synthetic_track (the reference's entry-point regression harness,
synthetic-tracker.cpp:85), batched over independent tracks.

Animates a ground-truth hand from animbank.pose, ray-casts synthetic depth
(data.synth.fake_depth), runs the tracker and reports the per-frame mean
joint error against the ground truth.  It runs on the card (with the cloud
kernels, use_pallas) unless --device says otherwise; on the CPU the kernels'
plain versions run and use_pallas is off, as the JAX package's CLI has it
off off the TPU:

    python -m hand_tracking_samples_tpu_torch.apps.synthetic_track \\
        --frames 64 --tracks 8
    python -m hand_tracking_samples_tpu_torch.apps.synthetic_track \\
        --frames 2 --tracks 2 --dynamics-only --device cpu
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..assets_paths import DEFAULT_ANIMBANK, DEFAULT_CNNB, DEFAULT_MODEL_JSON


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default=DEFAULT_MODEL_JSON)
    ap.add_argument("--animbank", default=DEFAULT_ANIMBANK)
    ap.add_argument("--cnnb", default=None, help=".cnnb weights (optional)")
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--tracks", type=int, default=4)
    ap.add_argument("--stride", type=int, default=1,
                    help="animbank frame step")
    ap.add_argument("--dynamics-only", action="store_true",
                    help="skip the CNN path (BASELINE config 0)")
    ap.add_argument("--solver", default="colored",
                    choices=["colored", "sequential"])
    ap.add_argument("--pallas", action="store_true", default=None)
    ap.add_argument("--dump-png", default=None, help="dir for debug PNGs")
    ap.add_argument("--cold-start", action="store_true",
                    help="start from the rest pose (tests CNN acquisition)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                    "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)

    from ..cnn.model import load_cnnb
    from ..data.animbank import load_animbank
    from ..data.synth import fake_depth, synth_camera
    from ..device import resolve_device
    from ..model.bake import from_numpy_model, load_hand_model
    from ..parallel.tracks import batched_tracker_state, batched_update
    from ..tracker.config import TrackerConfig
    from ..tracker.runtime import physics_params

    dev = resolve_device(args.device)
    use_pallas = args.pallas if args.pallas is not None \
        else dev.type == "cuda"
    model = from_numpy_model(load_hand_model(args.model), dev)
    bank = load_animbank(args.animbank)
    cam = synth_camera()
    config = TrackerConfig(
        point_budget=2048, solver=args.solver, use_pallas=use_pallas,
        cnn_every_frame=not args.dynamics_only)
    params = physics_params(config)
    cnn_params = None
    if not args.dynamics_only:
        cnn_params = load_cnnb(args.cnnb or DEFAULT_CNNB, dev)

    if args.tracks < 1 or args.frames < 1:
        ap.error("--tracks and --frames must be >= 1")
    T = args.tracks
    starts = (np.arange(T) * 131) % max(1, len(bank)
                                        - args.frames * args.stride)
    states = batched_tracker_state(model, T)
    if not args.cold_start:
        states = states._replace(body=states.body._replace(
            pose=torch.tensor(bank[starts], device=dev)))

    errs = []
    t0 = time.time()
    for f in range(args.frames):
        ids = starts + f * args.stride
        gt = torch.tensor(bank[ids], device=dev)
        depths = fake_depth(gt, model, cam)
        states, _ = batched_update(states, model, cnn_params, depths, cam,
                                   config, params)
        je = torch.linalg.vector_norm(
            states.body.pose[:, :, :3] - gt[:, :, :3], dim=-1).mean()
        errs.append(float(je))
        if f % 8 == 0 or f == args.frames - 1:
            print(f"frame {f:4d}: mean joint err {float(je)*1000:7.2f} mm")
        if args.dump_png and f % 8 == 0:
            _dump(args.dump_png, f, depths[0], states.body.pose[0], gt[0],
                  cam, model)
    if args.dump_png:
        from ..utils.report import write_html_report
        print("report:", write_html_report(args.dump_png))
    dt = time.time() - t0
    total = args.frames * T
    print(f"\ntracked {total} frames in {dt:.2f}s "
          f"({total/dt:.0f} fps incl. synthesis)")
    print(f"mean joint error: {np.mean(errs)*1000:.2f} mm "
          f"(final {errs[-1]*1000:.2f} mm)")
    return np.mean(errs)


def _dump(out_dir, f, depth, pose, gt, cam, model):
    """Track 0's render with the tracked bone origins (green) and the
    ground truth's (red) projected, and its posed OBJ (vanity bones)."""
    from ..maths.pose import pose_apply, pose_inverse
    from ..utils.viz import depth_to_rgb, draw_points, write_png
    img = depth_to_rgb(depth.cpu().numpy().view(np.uint16))
    inv = pose_inverse(torch.tensor(cam.pose))
    for pts, col in ((gt[:, :3], (255, 64, 64)), (pose[:, :3],
                                                   (64, 255, 96))):
        local = pose_apply(inv.expand(pts.shape[0], 7), pts.cpu())
        local[:, 2] = torch.clamp(local[:, 2], min=1e-6)
        px = cam.projectz(local).numpy()
        img = draw_points(img, px, colors=np.tile(col, (len(px), 1)),
                          size=2)
    write_png(os.path.join(out_dir, f"depth_{f:04d}.png"), img)
    try:
        from ..assets_paths import DEFAULT_VANITY_BONES
        from ..model.hand import get_pose_user
        from ..model.meshes import export_obj, load_display_meshes
        from ..physics.solver import BodyState
        meshes = load_display_meshes(DEFAULT_VANITY_BONES)
        z = torch.zeros_like(pose[None, :, :3])
        user = get_pose_user(BodyState(pose[None], z, z), model)[0]
        export_obj(os.path.join(out_dir, f"hand_{f:04d}.obj"), meshes,
                   user.cpu().numpy())
    except Exception as e:  # vanity_bones.json optional
        print(f"(obj export skipped: {e})", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
