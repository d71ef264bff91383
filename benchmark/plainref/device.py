"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU
(device="cpu", as the tests do).  Geometry and the solver need full float32:
the TF32 switches are turned off once, here, before any tensor is placed.
"""
from __future__ import annotations

import torch

_CONFIGURED = False


def resolve_device(device=None) -> torch.device:
    """None -> "cuda".  Raises when CUDA is asked for and absent."""
    global _CONFIGURED
    if not _CONFIGURED:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _CONFIGURED = True
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch versions on the CPU")
    return dev
