"""CNN label generation and output decoding, the port's counterpart of
hand_tracking_samples_tpu.cnn.labels, batched over leading dims.

The training-label side (GatherHandExpectedCNN, include/handtrack.h:
152-173) renders the ground-truth pose into the 8 landmark heatmaps and the
16 1-D angle maps; the inference side (CNNOutputAnalysis, handtrack.h:
176-242) decodes the 2304 network outputs into landmark rays, sub-pixel
image points, confidences and key angles."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..imaging.heatmaps import peaks_1d
from ..maths.fma import fma
from ..maths.pose import pose_apply
from ..maths.quat import qmul, qnormalize, quat_from_axis_angle
from .model import HM, KEY_ANGLES, N_HEATMAPS

PI = 3.14159  # the reference consistently uses this truncation


class CNNAnalysis(NamedTuple):
    """Decoded network output, tracks leading."""
    crays: torch.Tensor          # (T, 8, 4) world ray dirs + peak value
    image_points: torch.Tensor   # (T, 8, 2) sub-pixel heatmap peaks
    confidence: torch.Tensor     # (T, 8)
    vals: torch.Tensor           # (T, 16) decoded 1-D values
    wristroll: torch.Tensor      # (T,)
    pitch: torch.Tensor
    tilt: torch.Tensor
    palmq: torch.Tensor          # (T, 4)
    finger_clenched: torch.Tensor  # (T, 5) 0 open .. pi clenched


def analyze_cnn_output(cnn_output, hcam) -> CNNAnalysis:
    """cnn_output (T, 2304) post-softmax; hcam the 16x16 heatmap cameras
    (imaging.camera.TrackCamera).  The heatmaps are decoded on their flat
    (8, 256) layout, as the JAX package does."""
    T = cnn_output.shape[0]
    dev = cnn_output.device
    hmf = cnn_output[:, :N_HEATMAPS * HM * HM].reshape(T, N_HEATMAPS,
                                                       HM * HM)
    iota = torch.arange(HM * HM, device=dev)
    xs = iota % HM
    ys = iota // HM
    idx = torch.argmax(hmf, dim=-1)                       # (T, 8) first max
    px = (idx % HM)[..., None]
    py = (idx // HM)[..., None]
    zero = torch.zeros((), device=dev)
    # PeakSubPixel (misc_image.h:313-326), window r=1 clamped
    inwin = ((xs >= torch.clamp(px - 1, min=0))
             & (xs < torch.clamp(px + 2, max=HM))
             & (ys >= torch.clamp(py - 1, min=0))
             & (ys < torch.clamp(py + 2, max=HM)))
    w = torch.where(inwin, hmf, zero)
    wsum = w.sum(-1)
    cx = (w * xs).sum(-1) / torch.clamp(wsum, min=1e-30)
    cy = (w * ys).sum(-1) / torch.clamp(wsum, min=1e-30)
    zero_w = wsum == 0
    image_points = torch.stack(
        [torch.where(zero_w, px[..., 0].to(torch.float32), cx),
         torch.where(zero_w, py[..., 0].to(torch.float32), cy)], dim=-1)
    # PeakVolume (misc_image.h:328-336) around round(subpixel peak)
    vx = (image_points[..., 0] + 0.5).to(torch.int64)[..., None]
    vy = (image_points[..., 1] + 0.5).to(torch.int64)[..., None]
    vwin = ((xs >= torch.clamp(vx - 1, min=0))
            & (xs < torch.clamp(vx + 2, max=HM))
            & (ys >= torch.clamp(vy - 1, min=0))
            & (ys < torch.clamp(vy + 2, max=HM)))
    confidence = torch.where(vwin, hmf, zero).sum(-1)
    n = pose_apply(hcam.pose[:, None], hcam.deprojectz(
        image_points, torch.ones((T, N_HEATMAPS), device=dev)))
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    peakval = hmf.amax(-1)
    crays = torch.cat([n, peakval[..., None]], dim=-1)

    vals = peaks_1d(cnn_output[:, N_HEATMAPS * HM * HM:].reshape(
        T, KEY_ANGLES, HM))
    # calc_angles uses 3.1415 while the label side uses 3.14159
    # (handtrack.h:196-201 vs :139-146), matched digit for digit
    PI4 = 3.1415
    wristroll = fma(vals[:, 0] * PI4, 2.0, float(np.float32(PI4 / 2.0)))
    pitch = (vals[:, 1] - 0.5) * PI4
    tilt = (vals[:, 2] - 0.5) * PI4

    def axis(*v):
        return torch.tensor(v, device=dev).expand(T, 3)
    palmq = qmul(
        qnormalize(torch.tensor([1.0, 0.0, 0.0, 1.0], device=dev)).expand(
            T, 4),
        qmul(quat_from_axis_angle(axis(-1.0, 0.0, 0.0), pitch),
             quat_from_axis_angle(axis(0.0, 0.0, 1.0), wristroll)))
    finger_clenched = vals[:, 3:8] * PI4
    return CNNAnalysis(crays, image_points, confidence, vals, wristroll,
                       pitch, tilt, palmq, finger_clenched)
