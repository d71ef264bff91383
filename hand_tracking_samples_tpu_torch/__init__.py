"""hand_tracking_samples_tpu_torch — the PyTorch/CUDA port of
hand_tracking_samples_tpu.

Same subpackage and module names as the JAX package, so each module's
counterpart is found by name.  Tracks are the leading dimension of every
tensor on the tracking path; the hot path runs hand-written CUDA kernels
(csrc/, built with nvcc on first use) and, for tensors on the CPU, their
plain PyTorch versions.  Importing the package imports neither torch's CUDA
runtime nor the kernels.
"""

__version__ = "0.1.0"

__all__ = [
    "load_hand_model", "from_numpy_model", "TrackerConfig",
    "make_tracker_state", "update", "DCamera",
]


def __getattr__(name):  # lazy: importing the package builds nothing
    if name in ("load_hand_model", "from_numpy_model"):
        from .model import bake
        return getattr(bake, name)
    if name == "TrackerConfig":
        from .tracker.config import TrackerConfig
        return TrackerConfig
    if name in ("make_tracker_state", "update"):
        from .tracker import runtime
        return getattr(runtime, name)
    if name == "DCamera":
        from .imaging.camera import DCamera
        return DCamera
    raise AttributeError(name)
