"""Offline visualization artifacts (replacing the reference's GL windows).

The reference apps render live; on TPU the equivalent observability story is
PNG dumps (à la dataset-exporter) of depth frames, segments, heatmaps and
landmark overlays.  The port's counterpart of hand_tracking_samples_tpu.
utils.viz, in NumPy (and PIL for write_png); the CNN debug images read the
port's CnnDebug, whose tensors carry the tracks first.
"""
from __future__ import annotations

import os

import numpy as np

RAINBOW = np.array([
    [0.75, 0.5, 0.5], [0.5, 0.75, 0.5], [0.5, 0.5, 0.75], [1, 0, 0],
    [0, 1, 0], [0, 0, 1], [1, 1, 0], [1, 0, 1]])  # handtrack.h:74


def to_grayscale_rgb(x):
    """float [0,1] or uint8 (H,W) -> (H,W,3) uint8."""
    x = np.asarray(x)
    if x.dtype != np.uint8:
        x = np.clip(x * 255.0, 0, 255).astype(np.uint8)
    return np.repeat(x[..., None], 3, axis=-1)


def depth_to_rgb(depth, depth_scale=0.001, drange=(0.1, 0.7)):
    d = np.asarray(depth).astype(np.float32) * depth_scale
    x = np.clip(1.0 - (d - drange[0]) / (drange[1] - drange[0]), 0.0, 1.0)
    return to_grayscale_rgb(x)


def draw_points(img, pts, colors=None, size=1):
    """Plot landmark pixels (rainbow by default) into an (H,W,3) image."""
    img = np.array(img)
    h, w = img.shape[:2]
    for i, p in enumerate(np.asarray(pts)):
        x, y = int(p[0]), int(p[1])
        c = (RAINBOW[i % len(RAINBOW)] * 255).astype(np.uint8) \
            if colors is None else colors[i]
        x0, x1 = max(0, x - size + 1), min(w, x + size)
        y0, y1 = max(0, y - size + 1), min(h, y + size)
        if x0 < x1 and y0 < y1:
            img[y0:y1, x0:x1] = c
    return img


def write_png(path, img):
    from PIL import Image
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = to_grayscale_rgb(arr)
    Image.fromarray(arr).save(path)


def concat_heatmaps(hmaps):
    """Stack heatmaps vertically like ImageConcat (misc_image.h:225)."""
    return np.concatenate([np.asarray(h) for h in hmaps], axis=0)


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else \
        np.asarray(x)


def last_segment_image(dbg, track: int = 0):
    """get_last_segment (handtrack.h:618-626): the 64x64 CNN input with the
    decoded landmark peaks plotted in rainbow colors.  dbg: the port's
    tracker.runtime.CnnDebug (tracks leading); track: which track's."""
    img = to_grayscale_rgb(_np(dbg.cnn_input[track]))
    return draw_points(img, _np(dbg.image_points[track]) * 4.0)


def cnn_difference_image(dbg, body_pose, model=None, upsample: int = 2,
                         track: int = 0):
    """get_cnn_difference (handtrack.h:627-640): rainbow lines between the
    current model landmarks and the CNN's landmark estimates, over the
    (upsampled) segment image.  dbg: the port's CnnDebug (tracks leading);
    body_pose: the tracks' BodyState poses (T, 17, 7); track: which
    track's.  model is unused (the landmarks are model.bake's constants)."""
    from ..model.bake import FEATURE_BONES, FEATURE_OFFSETS
    img = to_grayscale_rgb(_np(dbg.cnn_input[track]))
    img = np.repeat(np.repeat(img, upsample, 0), upsample, 1)
    # project current model landmarks into the segment camera (64x64 * up)
    pose = _np(body_pose[track])
    pts_w = np.stack([
        pose[b, :3] + _qrot_np(pose[b, 3:7], o)
        for b, o in zip(np.asarray(FEATURE_BONES), np.asarray(FEATURE_OFFSETS))])
    cam_pose = _np(dbg.segment_cam_pose[track])
    inv_q = cam_pose[3:7] * np.array([-1, -1, -1, 1])
    local = np.stack([_qrot_np(inv_q, p - cam_pose[:3]) for p in pts_w])
    # segment camera: focal from the debug? approximate with 64-crop defaults
    fpx = local[:, :2] / local[:, 2:3]
    p0 = (fpx * 64.0 + 32.0) * upsample  # principal (32,32); focal folded out
    p1 = _np(dbg.image_points[track]) * 4.0 * upsample
    for i in range(len(p1)):
        c = (RAINBOW[i % len(RAINBOW)] * 255).astype(np.uint8)
        for t in range(32):
            p = p0[i] + (p1[i] - p0[i]) * t / 31.0
            x, y = int(p[0]), int(p[1])
            if 0 <= x < img.shape[1] and 0 <= y < img.shape[0]:
                img[y, x] = c
    return img


def _qrot_np(q, v):
    qv, w = q[:3], q[3]
    t = 2 * np.cross(qv, v)
    return v + w * t + np.cross(qv, t)
