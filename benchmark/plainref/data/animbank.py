"""Animation-bank loader (synthetic-tracker.cpp:39-55).

animbank.pose is whitespace-separated floats, one line per frame, 17 bone
poses (position xyz + quaternion xyzw) per line — physics-frame poses as
recorded from PhysModel::GetPose().
"""
from __future__ import annotations

import numpy as np


def load_animbank(path: str, n_bones: int = 17) -> np.ndarray:
    """Returns (frames, n_bones, 7) float32."""
    frames = []
    with open(path) as f:
        for line in f:
            vals = np.fromstring(line, sep=" ") if False else \
                np.array(line.split(), dtype=np.float32)
            if vals.size == 0:
                break
            assert vals.size == n_bones * 7, vals.size
            frames.append(vals.reshape(n_bones, 7))
    return np.stack(frames)
