"""CNN training on segmented depth crops, the port's counterpart of
hand_tracking_samples_tpu.cnn.train.

Replicates the train-hand-pose-cnn semantics (train-cnn.cpp:31-50,
124-170):
  * compress: segment each recorded frame to the 64x64 crop, reproject the
    ground-truth poses into the segment camera's frame, zero the camera
    pose;
  * labels: GatherHandExpectedCNN against the 16x16 sub-camera;
  * even frames train, odd frames are the held-out set;
  * SGD with alpha 0.001 on the softmax-MSE loss (cnn/model.py).

Frames are compressed as a batch, tracks first.  The batch indices are the
same `np.random.RandomState` draws as the JAX package's, so from the same
weights and data the two packages take the same steps.  The synthetic path
renders animbank poses with the port's ray-caster (data/synth.py).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..data.synth import fake_depth, synth_camera
from ..imaging.camera import DCamera
from ..imaging.image_ops import depth_tensor
from ..maths import fma as fq
from ..maths.quat import quat_from_axis_angle
from ..segment.handsegment import cnn_input_from_segment, hand_segment_vr
from .labels import gather_hand_expected
from .model import forward, sgd_step


class TrainingSet(NamedTuple):
    """Compressed frames ready for training."""
    inputs: torch.Tensor   # (F, 64, 64) float32 in [0, 1]
    labels: torch.Tensor   # (F, 2304) float32
    poses: torch.Tensor    # (F, 17, 7) segment-frame poses


def compress_frame(depth, cam: DCamera, pose, drange=(0.1, 0.70)):
    """train-cnn.cpp:31-50 compress and label generation, a batch of frames
    at once: depth (T, H, W) int16 holding u16 bits, pose (T, 17, 7) ->
    (inputs (T, 64, 64), labels (T, 2304), segment-frame poses)."""
    seg = hand_segment_vr(depth, cam, 0xF, drange, 0.17)
    pose_seg = fq.pose_mul(fq.pose_inverse(seg.cam.pose)[:, None], pose)
    x = cnn_input_from_segment(seg.depth, cam.depth_scale, drange)
    ident = torch.zeros_like(seg.cam.pose)
    ident[:, 6] = 1.0
    hcam = seg.cam._replace(pose=ident).sub(4)
    labels, _, _ = gather_hand_expected(pose_seg, hcam)
    return x, labels, pose_seg


def _concat(parts) -> TrainingSet:
    return TrainingSet(*[torch.cat(p) for p in zip(*parts)])


def compress_dataset(depth_frames, cam: DCamera, poses, drange=(0.1, 0.70),
                     chunk: int = 64, device=None) -> TrainingSet:
    """compress_frame over a recording in chunks: depth (F, H, W) uint16
    (NumPy) or int16 tensor, poses (F, 17, 7)."""
    from ..device import resolve_device
    dev = resolve_device(device)
    parts = []
    for i in range(0, len(depth_frames), chunk):
        d = depth_frames[i:i + chunk]
        d = d.to(dev) if torch.is_tensor(d) else depth_tensor(d, dev)
        p = torch.as_tensor(np.asarray(poses[i:i + chunk], np.float32),
                            device=dev)
        parts.append(compress_frame(d, cam, p, drange))
    return _concat(parts)


def _augment_poses(poses, generator: torch.Generator):
    """A random global rigid transform per example keeping the hand in
    view: a rotation of up to 0.5 rad about a random axis and a translation
    within (0.06, 0.05, 0.08) m, about the palm.  poses (N, 17, 7); the
    draws are the generator's (CPU), so they differ from JAX's by design."""
    n, dev = poses.shape[0], poses.device
    axis = torch.randn((n, 3), generator=generator)
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    angle = torch.rand((n,), generator=generator) - 0.5
    dt = (torch.rand((n, 3), generator=generator) * 2.0 - 1.0) \
        * torch.tensor([0.06, 0.05, 0.08])
    dq = quat_from_axis_angle(axis, angle).to(dev)
    pivot = poses[:, 1, :3]
    dp = torch.cat([pivot + dt.to(dev), dq], dim=-1)
    un_pivot = torch.cat([-pivot, torch.tensor(
        [0.0, 0, 0, 1], device=dev).expand(n, 4)], dim=-1)
    world = fq.pose_mul(dp, un_pivot)
    return fq.pose_mul(world[:, None], poses)


def synthetic_training_set(model, bank, frame_ids, cam: DCamera | None = None,
                           chunk: int = 64, augment: bool = False,
                           seed: int = 0, device=None) -> TrainingSet:
    """Render animbank poses to depth and compress them: labelled data with
    exact ground truth (the synthetic-hand-tracker flywheel, offline).
    model the port's HandModel on `device`."""
    from ..device import resolve_device
    dev = resolve_device(device)
    if cam is None:
        cam = synth_camera()
    ids = np.asarray(frame_ids)
    parts = []
    for i in range(0, len(ids), chunk):
        poses = torch.as_tensor(np.asarray(bank[ids[i:i + chunk]],
                                           np.float32), device=dev)
        if augment:
            poses = _augment_poses(
                poses, torch.Generator().manual_seed(seed + i))
        parts.append(compress_frame(fake_depth(poses, model, cam), cam,
                                    poses))
    return _concat(parts)


def _pool(n: int, split: str):
    return np.arange(0, n, 2) if split == "even" else np.arange(n)


def train_epoch(params, data: TrainingSet, rng: np.random.RandomState,
                steps: int, batch_size: int = 64, alpha: float = 0.001,
                train_split: str = "even"):
    """Random even-frame batches (train-cnn.cpp:143), one draw of
    `rng.choice(pool, batch_size)` a step, as the JAX package draws them.
    Returns (params, the mean of the steps' mean square errors)."""
    pool = _pool(data.inputs.shape[0], train_split)
    dev = data.inputs.device
    mses = []
    for _ in range(steps):
        idx = torch.as_tensor(rng.choice(pool, batch_size), device=dev)
        params, mse = sgd_step(params, data.inputs[idx], data.labels[idx],
                               alpha)
        mses.append(mse)
    return params, float(torch.stack(mses).double().mean())


def train_epoch_scanned(params, data: TrainingSet,
                        rng: np.random.RandomState, steps: int,
                        batch_size: int = 64, alpha: float = 0.001,
                        train_split: str = "even"):
    """train_epoch with every batch drawn up front, one
    `rng.choice(pool, (steps, batch_size))`, as the JAX package's scanned
    epoch draws them; the steps then run in a loop."""
    pool = _pool(data.inputs.shape[0], train_split)
    dev = data.inputs.device
    idx = torch.as_tensor(rng.choice(pool, (steps, batch_size)), device=dev)
    mses = []
    for ix in idx:
        params, mse = sgd_step(params, data.inputs[ix], data.labels[ix],
                               alpha)
        mses.append(mse)
    return params, float(torch.stack(mses).mean())


def evaluate(params, data: TrainingSet, split: str = "odd",
             batch_size: int = 256) -> float:
    """The held-out mean square error (odd frames by default)."""
    n = data.inputs.shape[0]
    idx = np.arange(1, n, 2) if split == "odd" else np.arange(n)
    dev = data.inputs.device
    total, count = 0.0, 0
    with torch.no_grad():
        for i in range(0, len(idx), batch_size):
            b = torch.as_tensor(idx[i:i + batch_size], device=dev)
            e = forward(params, data.inputs[b]) - data.labels[b]
            total += float((e * e).mean(-1).sum())
            count += len(b)
    return total / max(count, 1)
