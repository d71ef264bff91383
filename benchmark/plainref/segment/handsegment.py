"""Hand segmentation: wrist-entry detection and the aligned 64x64 depth crop
(HandSegmentVR, include/handtrack.h:269-344), the port's counterpart of
hand_tracking_samples_tpu.segment.handsegment, batched over tracks (the
leading dimension of every tensor): 2x DownSampleMin twice, threshold and
Manhattan distance transform, the entry-point scan over the image edges,
the distance-weighted centroid and average depth, the in-plane rotation
that aligns the hand with the vertical axis, the scale-by-depth virtual
camera and the depth-corrected resample (SampleD).  Fixed shapes, no
data-dependent control flow."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..imaging.camera import TrackCamera
from ..imaging.image_ops import (depth_u16, distance_transform,
                                 downsample_min, sample_d, threshold)
from ..maths import fma as fq
from ..maths.fma import fma
from ..maths.libm import atan2f, quat_from_axis_angle

MIN_BLOB_RADIUS = 2  # handtrack.h:299


class SegmentResult(NamedTuple):
    depth: torch.Tensor   # (T, 64, 64) int32 u16 values, re-measured depth
    cam: TrackCamera      # the virtual cameras (pose = in-plane rotation)
    valid: torch.Tensor   # (T,) bool: blob found


def _recip(c) -> float:
    return float(np.float32(1.0) / np.float32(c))


def _xla_sum(x):
    """Sum over the last two dims of (..., 60, 80) float32 in the order the
    JAX CPU build sums them (its tree-reduction rewrite): zero-padded to
    (64, 96) with the image at rows 2-61 and columns 8-87, each 32x32 window
    summed in raster order from 0, each row of three windows summed in
    order, and the two row sums added.  The pixel-exact resample downstream
    rests on these sums: another order moves the virtual camera by an ulp
    and a few resampled pixels with it."""
    lead = x.shape[:-2]
    assert x.shape[-2:] == (60, 80), x.shape
    p = torch.zeros(lead + (64, 96), dtype=x.dtype, device=x.device)
    p[..., 2:62, 8:88] = x
    win = p.reshape(lead + (2, 32, 3, 32)).movedim(-3, -2)
    win = win.reshape(lead + (2, 3, 1024))         # windows, raster order
    acc = torch.zeros(lead + (2, 3), dtype=x.dtype, device=x.device)
    for k in range(1024):
        acc = acc + win[..., k]
    rows = (acc[..., 0] + acc[..., 1]) + acc[..., 2]
    return rows[..., 0] + rows[..., 1]


def _edge_argmax(vals, entry, entry_val, make_cand):
    """Scan one image edge (vals (T, L)) for its first maximum; it replaces
    the entry where it beats the entry's value (strict >, reference scan
    order)."""
    vmax, best = vals.max(dim=1)
    best = torch.argmax(vals, dim=1)               # first maximum
    better = vmax > entry_val
    cand = make_cand(best)
    return (torch.where(better[:, None], cand, entry),
            torch.where(better, vmax, entry_val))


def hand_segment_vr(depth, cam, entry_options: int = 0xF,
                    wrange=(0.1, 0.7), diam: float = 0.17) -> SegmentResult:
    """depth (T, H, W) int16 holding u16 bits; cam the depth camera
    (imaging.camera.DCamera)."""
    T, H, W = depth.shape
    assert (W, H) == cam.dim, (cam.dim, depth.shape)
    dev = depth.device
    d16 = depth_u16(depth)
    small = downsample_min(downsample_min(d16))
    scam = cam.sub(4)
    sh, sw = small.shape[1], small.shape[2]

    wy = int(np.float32(wrange[1]) / np.float32(cam.depth_scale))
    dt = distance_transform(threshold(small, hi=wy))

    # entry point (handtrack.h:289-293); scan order: bottom, top, right, left
    def fixed(x, y):
        return (torch.tensor([x, y], device=dev).expand(T, 2),
                dt[:, y, x])
    if entry_options == 1:
        entry, entry_val = fixed(sw // 2, sh - 1)
    elif entry_options == 4:
        entry, entry_val = fixed(sw - 1, sh // 2)
    elif entry_options == 8:
        entry, entry_val = fixed(0, sh // 2)
    else:
        entry, entry_val = fixed(0, 0)
    full = lambda b, v: torch.full_like(b, v)
    edges = [
        (entry_options & 1, dt[:, sh - 1, :],
         lambda b: torch.stack([b, full(b, sh - 1)], dim=1)),
        (entry_options & 2, dt[:, 0, :],
         lambda b: torch.stack([b, full(b, 0)], dim=1)),
        (entry_options & 4, dt[:, :, sw - 1],
         lambda b: torch.stack([full(b, sw - 1), b], dim=1)),
        (entry_options & 8, dt[:, :, 0],
         lambda b: torch.stack([full(b, 0), b], dim=1)),
    ]
    for bit, vals, make_cand in edges:
        if bit:
            entry, entry_val = _edge_argmax(vals, entry, entry_val,
                                            make_cand)

    # weighted centroid / average depth over blob pixels
    # (handtrack.h:295-315)
    gy, gx = torch.meshgrid(torch.arange(sh, dtype=torch.float32,
                                         device=dev),
                            torch.arange(sw, dtype=torch.float32,
                                         device=dev), indexing="ij")
    entf = entry.to(torch.float32)
    ex0, ex1 = entf[:, 0, None, None], entf[:, 1, None, None]
    blob = dt >= MIN_BLOB_RADIUS
    dx, dy = gx - ex0, gy - ex1
    wdist = fq.sqrt(fma(dx, dx, dy * dy)) + 1e-5
    w = torch.where(blob, wdist, torch.zeros((), device=dev))
    sums = _xla_sum(torch.stack([w, w * gx, w * gy,
                                 w * small.to(torch.float32)], dim=1))
    wtotal = sums[:, 0]
    count = blob.sum(dim=(1, 2))
    wt = torch.clamp(wtotal, min=1e-20)
    com = sums[:, 1:3] / wt[:, None]
    avgdepth = sums[:, 3] * cam.depth_scale / wt
    ok = (count > 0) & (wtotal > 0.0)
    com = torch.where(ok[:, None], com, entf)
    avgdepth = torch.where(ok, avgdepth, torch.zeros((), device=dev))

    # extreme point along entry->com (handtrack.h:317-322)
    along = fma(dx, (com[:, 0] - entf[:, 0])[:, None, None],
                dy * (com[:, 1] - entf[:, 1])[:, None, None])
    along = torch.where(blob, along, torch.full((), -torch.inf, device=dev))
    has_blob = blob.any(dim=(1, 2))
    eidx = torch.argmax(along.reshape(T, -1), dim=1)
    extreme = torch.stack([(eidx % sw).to(torch.float32),
                           (eidx // sw).to(torch.float32)], dim=1)
    extreme = torch.where(has_blob[:, None], extreme, entf)

    avgdepth = torch.clamp(avgdepth, 0.20, 1.0)
    valid = ok & (com != entf).any(dim=1)
    angle = torch.where(valid, atan2f(com[:, 0] - entf[:, 0],
                                      entf[:, 1] - com[:, 1]),
                        torch.zeros((), device=dev))
    comdir = com - entf
    cn = fq.sqrt(fma(comdir[:, 1], comdir[:, 1],
                     comdir[:, 0] * comdir[:, 0]))
    comdir = comdir / torch.clamp(cn, min=1e-20)[:, None]
    ec = extreme - com
    exrad = fma(ec[:, 1], comdir[:, 1], ec[:, 0] * comdir[:, 0])
    # com + comdir*(exrad - diam/2/avgdepth*f), contracted as the JAX CPU
    # build runs it
    half = float(np.float32(diam / 2.0))
    # a true division: PyTorch's scalar / tensor multiplies by the
    # reciprocal (two roundings)
    y = fma(-(torch.full_like(avgdepth, half) / avgdepth), scam.focal[0],
            exrad)
    com = torch.where(valid[:, None], fma(comdir, y[:, None], com), com)

    # the virtual 64x64 camera (handtrack.h:336-341); `/ diam` is a
    # multiply by its float32 reciprocal there
    focal = avgdepth * 64.0 * _recip(diam)
    one = torch.ones((T,), device=dev)
    pr = torch.tensor(scam.principal, device=dev).expand(T, 2)
    q = fq.qmul(fq.quat_from_to(scam.deprojectz_folded(pr, one),
                          scam.deprojectz_folded(com, one)),
             quat_from_axis_angle(torch.tensor([0.0, 0.0, 1.0],
                                               device=dev).expand(T, 3),
                                  angle))
    pose = torch.cat([torch.zeros((T, 3), device=dev), q], dim=1)
    dstcam = TrackCamera(dim=(64, 64),
                         focal=torch.stack([focal, focal], dim=1),
                         principal=torch.full((T, 2), 32.0, device=dev),
                         depth_scale=cam.depth_scale, pose=pose)
    bg = int(np.float32(4.0) / np.float32(cam.depth_scale))
    seg = sample_d(d16, cam, dstcam, bg)
    return SegmentResult(depth=seg, cam=dstcam, valid=valid)


def cnn_input_from_segment(seg_depth, depth_scale, drange=(0.1, 0.7)):
    """handtrack.h:700: inverse-depth normalisation to [0, 1] float."""
    x = seg_depth.to(torch.float32)
    # 1 - (x*scale - lo)/(hi - lo), contracted and with the constant divide
    # folded into a reciprocal multiply, as the JAX CPU build runs it
    y = fma(x, float(np.float32(depth_scale)), -float(np.float32(drange[0])))
    return torch.clamp(fma(-y, _recip(drange[1] - drange[0]), 1.0), 0.0,
                       1.0)
