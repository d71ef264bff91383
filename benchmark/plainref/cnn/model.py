"""The pose-initialiser CNN (PoseInitializerCNN, include/handtrack.h:
103-130): forward pass, SGD step and .cnnb weight I/O, the port's
counterpart of hand_tracking_samples_tpu.cnn.model.

    64x64x1 -> conv5x5(16) -> tanh -> maxpool -> maxpool
            -> conv4x4(16->64) -> tanh -> maxpool
            -> fc(2304->2048) -> tanh -> fc(2048->2304)
            -> chunked softmax (8 chunks of 256, 16 chunks of 16)

Parameters are a dict of the JAX package's layout (conv weights HWIO, fc
weights (in, out)), so weights carry across in either direction
(`from_numpy`, `to_numpy`).  The convolutions and matrix products are
PyTorch's (the JAX package leaves them to XLA, outside any Pallas kernel),
their gradients autograd's; TF32 stays off (device.py), so they run in full
float32.

The reference trains one example per step with SGD on the loss
0.5*sum((softmax(z) - t)^2): its backward injects e = y - t at the output
and runs it through the softmax VJP (third_party/cnn.h:558-580), which is
exactly the gradient of that loss.  Here the step is over a batch.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

KEY_ANGLES = 16          # handtrack.h:72
N_HEATMAPS = 8
HM = 16                  # heatmap side
OUT = N_HEATMAPS * HM * HM + KEY_ANGLES * HM  # 2304

_LAYOUT = [
    ("conv1", (5, 5, 1, 16)),    # reference dims {kx, ky, zin, zout}
    ("conv2", (4, 4, 16, 64)),
    ("fc1", (2304, 2048)),
    ("fc2", (2048, OUT)),
]


def load_cnnb(path, device=None) -> dict:
    """The reference's binary weight file (per layer raw float32 W then B,
    third_party/cnn.h:97-98): conv W packed x-fastest
    (kx + ky*KX + zin*KX*KY + zout*KX*KY*ZIN), fc W[j + i*N]."""
    raw = np.fromfile(path, dtype=np.float32)
    params = {}
    off = 0
    for name, dims in _LAYOUT:
        if len(dims) == 4:
            kx, ky, zin, zout = dims
            n = kx * ky * zin * zout
            w = raw[off:off + n].reshape(zout, zin, ky, kx)
            w = np.transpose(w, (2, 3, 1, 0))            # -> HWIO
            off += n
            b = raw[off:off + zout]
            off += zout
        else:
            m, nn = dims
            n = m * nn
            w = raw[off:off + n].reshape(m, nn)
            off += n
            b = raw[off:off + nn]
            off += nn
        params[name] = {"w": w, "b": b}
    if off != len(raw):
        raise ValueError(f"{path}: {len(raw)} floats, the net has {off}")
    return from_numpy(params, device)


def from_numpy(params: dict, device=None) -> dict:
    """A JAX-layout parameter dict of arrays (the JAX package's
    init_params/load_cnnb output, as NumPy) -> the port's, on `device`."""
    from ..device import resolve_device
    dev = resolve_device(device)
    return {k: {kk: torch.tensor(np.asarray(vv, np.float32), device=dev)
                for kk, vv in v.items()} for k, v in params.items()}


def _maxpool2(x):
    """2x2 max pool, NCHW."""
    return F.max_pool2d(x, 2, 2)


def chunked_softmax(z):
    """LSoftMaxChunked forward (cnn.h:493-511): a softmax per span.
    z (..., 2304)."""
    lead = z.shape[:-1]
    hm = z[..., :N_HEATMAPS * HM * HM].reshape(lead + (N_HEATMAPS, HM * HM))
    an = z[..., N_HEATMAPS * HM * HM:].reshape(lead + (KEY_ANGLES, HM))
    return torch.cat([torch.softmax(hm, -1).reshape(lead + (-1,)),
                      torch.softmax(an, -1).reshape(lead + (-1,))], dim=-1)


def forward(params, x):
    """x (N, 64, 64) float in [0, 1] -> (N, 2304) post-softmax activations
    (CNN::Eval, cnn.h:550-556)."""
    def conv(h, p):
        w = p["w"].permute(3, 2, 0, 1)                   # HWIO -> OIHW
        return F.conv2d(h, w) + p["b"][None, :, None, None]
    h = x[:, None]                                       # NCHW
    h = torch.tanh(conv(h, params["conv1"]))
    h = _maxpool2(_maxpool2(h))
    h = torch.tanh(conv(h, params["conv2"]))
    h = _maxpool2(h)
    # reference flattening is z-major (x fastest): NCHW flat
    h = h.reshape(h.shape[0], -1)
    h = torch.tanh(h @ params["fc1"]["w"] + params["fc1"]["b"])
    z = h @ params["fc2"]["w"] + params["fc2"]["b"]
    return chunked_softmax(z)


