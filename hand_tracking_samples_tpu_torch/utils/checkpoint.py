"""Checkpoint and resume, the port's counterpart of
hand_tracking_samples_tpu.utils.checkpoint.

Two levels:
  * .cnnb weight files (cnn/model.py save_cnnb/load_cnnb): the reference's
    format, read by either package;
  * the training state (parameters and step) with torch.save, in place of
    the JAX package's orbax checkpoint, and tracker-state snapshots as .npz,
    the leaves in the JAX package's flattening order (a NamedTuple's fields
    depth first), so a snapshot loads in either package.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaves(tree) -> list:
    if isinstance(tree, tuple):
        return [l for t in tree for l in _leaves(t)]
    return [tree]


def save_tracker_state(path: str, state):
    """A TrackerState (any NamedTuple of tensors) as .npz: arr_0, arr_1,
    ... in field order."""
    np.savez(path, *[l.detach().cpu().numpy() for l in _leaves(state)])


def load_tracker_state(path: str, like, device=None):
    """The .npz's arrays into `like`'s structure, on `device` (each leaf's
    own device when None)."""
    z = np.load(path)
    arrays = iter(z[k] for k in z.files)

    def rebuild(t):
        if isinstance(t, tuple):
            vals = [rebuild(x) for x in t]
            return type(t)(*vals) if hasattr(t, "_fields") else tuple(vals)
        return torch.as_tensor(next(arrays), device=t.device
                               if device is None else device)
    return rebuild(like)


def save_training_state(path: str, params: dict, step: int):
    """The net's parameters (cnn/model.py layout) and the step count."""
    torch.save({"params": {k: {kk: vv.detach().cpu()
                                for kk, vv in v.items()}
                           for k, v in params.items()},
                "step": int(step)}, path)


def load_training_state(path: str, device=None):
    """(params on `device`, step)."""
    from ..device import resolve_device
    dev = resolve_device(device)
    state = torch.load(path, map_location="cpu", weights_only=True)
    params = {k: {kk: vv.to(dev) for kk, vv in v.items()}
              for k, v in state["params"].items()}
    return params, state["step"]
