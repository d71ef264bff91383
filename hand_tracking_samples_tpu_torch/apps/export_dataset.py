"""dataset-exporter equivalent: batch offline export of recordings, the
port's counterpart of hand_tracking_samples_tpu.apps.export_dataset (the
same flags and outputs).

Writes PNGs (full and segment depth, IR, debug overlays, heatmaps) and
labels_full.txt / labels_seg.txt as dataexporter.cpp:32-123 does.  The
frames of a recording go through the segmentation and the label renderers
as one batch, on the card unless --device says otherwise:

    python -m hand_tracking_samples_tpu_torch.apps.export_dataset rec.rs \
        --out tmp/ [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..assets_paths import DEFAULT_MODEL_JSON

CHUNK = 64     # frames a batch


def process(depth, pose, cam, model, drange):
    """A batch of frames: depth (T, H, W) int16 holding u16 bits, pose
    (T, 17, 7) -> (full-image inverse depth, bbox min, bbox max, landmark
    pixels, segment input, segment landmarks, labels, key angles)."""
    from ..cnn.labels import gather_hand_expected, image_feature_points
    from ..imaging.image_ops import depth_u16
    from ..maths import fma as fq
    from ..model.bake import FEATURE_BONES, FEATURE_OFFSETS
    from ..segment.handsegment import cnn_input_from_segment, hand_segment_vr
    T = depth.shape[0]
    dev = depth.device
    fp = cnn_input_from_segment(depth_u16(depth), cam.depth_scale, drange)
    # bbox of every bone's vertices projected into the full image
    verts_w = fq.pose_apply(pose[:, 1:, None], model.verts[1:][None])
    px = cam.projectz(verts_w.reshape(T, -1, 3))
    vm = model.vert_mask[1:].reshape(1, -1, 1)
    inf = torch.full((), float("inf"), device=dev)
    lim = torch.tensor([cam.dim[0] - 1, cam.dim[1] - 1], device=dev)
    bmin = torch.clamp(torch.where(vm, px, inf).amin(1).to(torch.int32),
                       min=0)
    bmax = torch.minimum(torch.where(vm, px, -inf).amax(1).to(torch.int32),
                         lim.to(torch.int32))
    # landmarks in the full image
    bones = torch.as_tensor(FEATURE_BONES, dtype=torch.int64, device=dev)
    fb = pose[:, bones]
    offs = torch.tensor(FEATURE_OFFSETS, dtype=torch.float32, device=dev)
    fpx = cam.projectz(fq.pose_apply(fb, offs)).to(torch.int32)
    fpx = torch.minimum(torch.clamp(fpx, min=0), lim.to(torch.int32))
    # segment and the segment-frame labels
    seg = hand_segment_vr(depth, cam, 0xF, drange, 0.17)
    x = cnn_input_from_segment(seg.depth, cam.depth_scale, drange)
    pose_seg = fq.pose_mul(fq.pose_inverse(seg.cam.pose)[:, None], pose)
    ident = torch.zeros_like(seg.cam.pose)
    ident[:, 6] = 1.0
    seg_cam = seg.cam._replace(pose=ident)
    seg_pts = image_feature_points(pose_seg, seg_cam)
    labels, _, vals = gather_hand_expected(pose_seg, seg_cam.sub(4))
    return fp, bmin, bmax, fpx, x, seg_pts, labels, vals


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("recordings", nargs="+")
    ap.add_argument("--model", default=DEFAULT_MODEL_JSON)
    ap.add_argument("--out", default="tmp")
    ap.add_argument("--drange", type=float, nargs=2, default=(0.20, 0.70))
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the CPU)")
    args = ap.parse_args(argv)

    from ..data.dataset import load_dataset
    from ..device import resolve_device
    from ..model.bake import from_numpy_model, load_hand_model
    from ..ops.cloud_kernel import depth_tensor
    from ..utils.viz import draw_points, to_grayscale_rgb, write_png

    dev = resolve_device(args.device)
    model = from_numpy_model(load_hand_model(args.model), dev)
    os.makedirs(args.out, exist_ok=True)
    drange = tuple(args.drange)
    k = 0
    with open(os.path.join(args.out, "labels_full.txt"), "w") as labels_full, \
            open(os.path.join(args.out, "labels_seg.txt"), "w") as labels_seg:
        for rec in args.recordings:
            bname = rec[:-3] if rec.endswith(".rs") else rec
            ds = load_dataset(bname)
            cam = ds.info.camera()
            F = len(ds.depth) if not args.max_frames \
                else min(args.max_frames, len(ds.depth))
            for c in range(0, F, CHUNK):
                out = process(depth_tensor(ds.depth[c:min(F, c + CHUNK)], dev),
                              torch.as_tensor(ds.pose[c:min(F, c + CHUNK)],
                                              device=dev),
                              cam, model, drange)
                out = [o.cpu().numpy() for o in out]
                for i, (fp, b0, b1, fpx, x, seg_pts, labels, vals) in \
                        enumerate(zip(*out)):
                    f = c + i
                    full = to_grayscale_rgb(fp)
                    write_png(f"{args.out}/full_depth_{k}.png", full)
                    if ds.ir is not None:
                        write_png(f"{args.out}/full_ir_{k}.png",
                                  to_grayscale_rgb(ds.ir[f]))
                    dbg = draw_points(full, fpx, size=2)
                    dbg[b0[1]:b1[1] + 1, [b0[0], b1[0]]] = (128, 0, 0)
                    dbg[[b0[1], b1[1]], b0[0]:b1[0] + 1] = (128, 0, 0)
                    write_png(f"{args.out}/debug_depth_{k}.png", dbg)
                    seg_rgb = to_grayscale_rgb(x)
                    write_png(f"{args.out}/segment_depth_{k}.png", seg_rgb)
                    write_png(f"{args.out}/debug_segdepth_{k}.png",
                              draw_points(seg_rgb, seg_pts))
                    hm = labels[:2048].reshape(8, 16, 16)
                    vm = labels[2048:].reshape(16, 16)
                    sheet = np.concatenate(list(hm) + [vm], axis=0)
                    write_png(f"{args.out}/heatmaps_{k}.png",
                              to_grayscale_rgb(sheet
                                               / max(sheet.max(), 1e-6)))
                    labels_full.write(f"{k}  {b0[0]} {b0[1]}  "
                                      f"{b1[0]} {b1[1]}   ")
                    for p in fpx:
                        labels_full.write(f"{p[0]} {p[1]} ")
                    labels_seg.write(f"{k}  ")
                    for p in seg_pts:
                        labels_seg.write(f"{p[0]:g} {p[1]:g}  ")
                    for v in vals:
                        labels_seg.write(f"{v:g} ")
                        labels_full.write(f"{v:g} ")
                    labels_full.write("\n")
                    labels_seg.write("\n")
                    k += 1
            print(f"{bname}: exported {F} frames")
    print(f"done: {k} frames -> {args.out}/")


if __name__ == "__main__":
    sys.exit(main())
