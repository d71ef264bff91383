"""What the port's tools share: the device flag, the assets, the renders of
the JAX tools' protocols, and timing that waits for the card."""
from __future__ import annotations

import os
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
OUT_DIR = os.path.join(REPO, "build", "eval")


def env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def add_device(ap):
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                    "PyTorch versions of the kernels)")
    return ap


def stage_args(ap, stages):
    """The optional stage names of a profiling tool (all by default)."""
    ap.add_argument("stages", nargs="*", metavar="stage",
                    help="stages to time (default all): " + " ".join(stages))
    return ap


def wanted(ap, args, stages, hint: str = ""):
    """Whether a stage was asked for; an unknown name ends the tool (with
    the hint)."""
    bad = [x for x in args.stages if x not in stages]
    if bad:
        ap.error(f"unknown stages {bad}" + (f"; {hint}" if hint else ""))
    return lambda name: not args.stages or name in args.stages


def to_raster(depth):
    """(..., H, W) int16 holding u16 depths -> the tool kernels' f32
    raster (..., H*W/128, 128)."""
    return (depth.to(torch.int32) & 0xFFFF).to(torch.float32).reshape(
        *depth.shape[:-2], -1, 128)


def add_out(ap):
    ap.add_argument("--out", default=OUT_DIR,
                    help="directory for what the tool writes (default "
                    "build/eval/)")
    return ap


def setup(device, cnn: bool = False, cnnb=None):
    """(device, hand model, animbank, synthetic camera, net or None)."""
    from ..assets_paths import DEFAULT_ANIMBANK, DEFAULT_CNNB, \
        DEFAULT_MODEL_JSON
    from ..cnn.model import load_cnnb
    from ..data.animbank import load_animbank
    from ..data.synth import synth_camera
    from ..device import resolve_device
    from ..model.bake import from_numpy_model, load_hand_model
    dev = resolve_device(device)
    model = from_numpy_model(load_hand_model(DEFAULT_MODEL_JSON), dev)
    net = load_cnnb(cnnb or DEFAULT_CNNB, dev) if cnn else None
    return dev, model, load_animbank(DEFAULT_ANIMBANK), synth_camera(), net


def render(model, cam, poses):
    """fake_depth of (..., 17, 7) poses (NumPy or tensor) -> (..., H, W)
    int16 on the model's device."""
    from ..data.synth import fake_depth
    p = (poses.to(model.device, torch.float32) if torch.is_tensor(poses)
         else torch.as_tensor(np.asarray(poses, np.float32),
                              device=model.device))
    lead = p.shape[:-2]
    d = fake_depth(p.reshape(-1, 17, 7), model, cam)
    return d.reshape(*lead, *d.shape[1:])


def protocol_frames(bank, T: int, F: int, step: int = 37):
    """The JAX tools' sequences: track t starts at (t * step) % (len - F)
    and plays F consecutive frames.  Returns (starts (T,), frame ids
    (F, T))."""
    starts = (np.arange(T) * step) % (len(bank) - F)
    return starts, starts[None, :] + np.arange(F)[:, None]


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def best_ms(fn, dev, reps: int = 3, per: int = 1) -> float:
    """The best of `reps` timed calls of fn() after one warm-up call, in ms
    divided by `per` (frames a call).  On the card each call is timed with
    CUDA events around it; on the CPU with the host clock."""
    fn()
    sync(dev)
    best = float("inf")
    for _ in range(reps):
        if dev.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize(dev)
            ms = e0.elapsed_time(e1)
        else:
            t0 = time.perf_counter()
            fn()
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms)
    return best / per


def joint_err(pose, gt):
    """Mean joint (bone origin) distance a track, (T,) NumPy, in m."""
    pose = pose.detach().cpu().numpy() if torch.is_tensor(pose) else pose
    gt = gt.detach().cpu().numpy() if torch.is_tensor(gt) else gt
    return np.linalg.norm(np.asarray(pose)[..., :3] - np.asarray(gt)[..., :3],
                          axis=-1).mean(-1)


def load_recording(name: str):
    """A recording of tests/fixtures by its base name: (Dataset, camera)."""
    from ..data.dataset import load_dataset
    ds = load_dataset(os.path.join(FIXTURES, name))
    return ds, ds.info.camera()


def track_recording(ds, cam, model, cnn, config, k: int, frames: int,
                    dev):
    """One track through the first `frames` frames of a recording at T=1:
    the CNN frame on every k-th frame (from frame 0), the dynamics frame
    on the rest, as the JAX tools step their recordings.  Returns the
    (frames, 17, 7) body poses (NumPy)."""
    from ..ops.cloud_kernel import depth_tensor
    from ..parallel.tracks import batched_tracker_state, batched_update
    from ..tracker.runtime import physics_params
    params = physics_params(config)
    states = batched_tracker_state(model, 1)
    out = []
    for f in range(frames):
        d = depth_tensor(ds.depth[f:f + 1], dev)
        states, _ = batched_update(states, model, cnn, d, cam, config,
                                   params, run_cnn=f % k == 0)
        out.append(states.body.pose[0].detach().cpu().numpy())
    return np.stack(out)


def write_json(path: str, payload: dict):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    import json
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    print("wrote", path, flush=True)
