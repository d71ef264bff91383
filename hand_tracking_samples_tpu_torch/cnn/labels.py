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

from ..imaging.heatmaps import peaks_1d, render_1d_heatmaps, render_heatmaps
from ..maths import fma as fq
from ..maths.fma import fma
from ..maths.libm import acosf, asinf, atan2f
from ..maths.pose import pose_apply
from ..maths.quat import qconj, qmul, qnormalize, quat_from_axis_angle
from ..model.bake import FEATURE_BONES, FEATURE_OFFSETS
from .model import HM, KEY_ANGLES, N_HEATMAPS

PI = 3.14159  # the reference consistently uses this truncation


def _cam_pose(hcam, like):
    """hcam.pose as a tensor: a DCamera's (7,) tuple or a TrackCamera's
    (T, 7) tensor."""
    return torch.as_tensor(hcam.pose, dtype=like.dtype, device=like.device)


def skin_feature_points(poses):
    """handtrack.h:82-84 Skin: world positions of the 8 model landmarks.
    poses (..., 17, 7) bone poses -> (..., 8, 3)."""
    offs = torch.tensor(FEATURE_OFFSETS, dtype=poses.dtype,
                        device=poses.device)
    return fq.pose_apply(poses[..., torch.as_tensor(FEATURE_BONES,
                                                    dtype=torch.int64), :],
                         offs)


def image_feature_points(poses, hcam):
    """handtrack.h:92-96: the landmarks in heatmap pixels.  hcam a DCamera
    (one pose for every leading index) or a TrackCamera (poses (T, 17, 7))
    -> (..., 8, 2)."""
    inv = fq.pose_inverse(_cam_pose(hcam, poses))[..., None, :]
    return hcam.projectz(fq.pose_apply(inv, skin_feature_points(poses)))


def hand_pose_to_key_angle_set(poses, reference_frame):
    """handtrack.h:133-150: 9 scalar labels in [0, 1], padded to 16.
    poses (..., 17, 7), reference_frame (..., 7) -> (..., 16).

    As the JAX CPU build computes them: arccos and arcsin expanded to
    atan2 (maths.libm; near 1 an ulp of the argument moves arccos by
    ~3e-4), the directions and dots contracted (maths.fma), `/ PI` a
    multiply by the float32 reciprocal and `+ 0.5` fused into it."""
    ref = torch.as_tensor(reference_frame, dtype=poses.dtype,
                          device=poses.device)
    palmq = fq.qmul(qconj(ref[..., 3:7]), poses[..., 1, 3:7])
    pd = fq.qdirs(palmq)
    px, pz = pd[..., 0, :], pd[..., 2, :]
    d1 = fq.qdirs(poses[..., 1, 3:7])
    r1 = float(np.float32(1.0) / np.float32(PI))
    r2 = float(np.float32(1.0) / np.float32(PI * 2.0))

    def scaled(a, r):
        return fma(a, r, 0.5)
    vals = [
        scaled(atan2f(px[..., 0], -px[..., 2]), r2),              # roll
        scaled(asinf(torch.clamp(pz[..., 2], -1.0, 1.0)), r1),    # pitch
        scaled(asinf(torch.clamp(pz[..., 0], -1.0, 1.0)), r1),    # tilt
        acosf(fq.rsum3(d1[..., 0, :],
                       fq.qdirs(poses[..., 4, 3:7])[..., 2, :])) * r1,
    ]
    for bid in (6, 9, 12, 15):                                    # curls
        vals.append(acosf(torch.clamp(fq.rsum3(
            d1[..., 1, :], fq.qdirs(poses[..., bid, 3:7])[..., 1, :]),
            -1.0, 1.0)) * r1)
    # the arm direction: there XLA fuses pz.x as fma(y, w, z*x)
    x, y, z, w = palmq.unbind(-1)
    pzx = fma(y, w, z * x) * 2
    vals.append(scaled(atan2f(-pzx, -pz[..., 1]), r2))
    vals += [torch.zeros_like(vals[0])] * (KEY_ANGLES - len(vals))
    return torch.stack(vals, dim=-1)


def gather_hand_expected(poses, hcam):
    """GatherHandExpectedCNN (handtrack.h:160-173): the 2304-float target.
    Returns (expected (..., 2304), feature points (..., 8, 2), key angles
    (..., 16))."""
    fp = image_feature_points(poses, hcam)
    hmaps = render_heatmaps(fp, (HM, HM))                  # (..., 8, 16, 16)
    vals = hand_pose_to_key_angle_set(poses, _cam_pose(hcam, poses))
    vmap = render_1d_heatmaps(vals, HM)                    # (..., 16, 16)
    lead = poses.shape[:-2]
    r255 = float(np.float32(1.0) / np.float32(255.0))   # `/ 255`, folded
    expected = torch.cat([hmaps.reshape(lead + (-1,)).to(torch.float32),
                          vmap.reshape(lead + (-1,)).to(torch.float32)],
                         dim=-1) * r255
    return expected, fp, vals


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
