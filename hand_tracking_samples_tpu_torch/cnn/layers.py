"""The generic CNN layer stack, the port's counterpart of
hand_tracking_samples_tpu.cnn.layers.

The reference cnn.h is a layer stack (LConv, LConvS, LFull, pools,
activations, softmax variants) with per-layer weight serialisation; the
fixed pose-initialiser net is one stack of it (handtrack.h:103-130;
cnn/model.py is its fused path).  Each layer here is a spec with init,
forward and the .cnnb pack and unpack; a Stack composes them into a batched
forward and an SGD step whose gradient (autograd's) equals CNN::Train's
backward pass.

Tensors between layers are flat (batch, n) vectors in the reference's
z-major layout (x fastest), so weight files interoperate layer by layer.
Parameters are dicts of tensors in the JAX package's layout (conv weights
HWIO, fc weights (in, out)).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F


class Layer:
    """A stateless spec; its parameters are a dict of tensors (maybe
    empty)."""
    n_out: int

    def init(self, generator: torch.Generator, device=None) -> dict:
        return {}

    def forward(self, params, x):  # x (B, n_in) -> (B, n_out)
        raise NotImplementedError

    def cnnb_arrays(self, params) -> list:
        """Arrays in the reference's .cnnb order (W then B), or []."""
        return []

    def cnnb_load(self, raw, off, device=None):
        """Consume floats of raw from off: (params, new off)."""
        return {}, off


def _xavier(generator, shape, fan_in, fan_out, device):
    r = float(np.sqrt(6.0 / (fan_in + fan_out)))
    w = torch.rand(shape, generator=generator) * (2 * r) - r
    return w.to(device)


def _np(t):
    return t.detach().cpu().numpy().astype(np.float32)


class _ConvBase(Layer):
    """The weight file and init of both convolutions; _wdims is
    (kx, ky, zin, zout)."""

    def init(self, generator, device=None):
        kx, ky, zin, zout = self._wdims()
        return {"w": _xavier(generator, (ky, kx, zin, zout), kx * ky * zin,
                             kx * ky * zout, device),
                "b": torch.zeros(zout, device=device)}

    def cnnb_arrays(self, params):
        w = np.transpose(_np(params["w"]), (3, 2, 0, 1))  # zout,zin,ky,kx
        return [w.reshape(-1), _np(params["b"]).reshape(-1)]

    def cnnb_load(self, raw, off, device=None):
        kx, ky, zin, zout = self._wdims()
        n = kx * ky * zin * zout
        w = raw[off:off + n].reshape(zout, zin, ky, kx).transpose(2, 3, 1, 0)
        off += n
        b = raw[off:off + zout]
        off += zout
        return {"w": torch.tensor(np.ascontiguousarray(w), device=device),
                "b": torch.tensor(b, device=device)}, off

    def _conv(self, params, h, **kw):
        w = params["w"].permute(3, 2, 0, 1)               # HWIO -> OIHW
        return F.conv2d(h, w, **kw) + params["b"][None, :, None, None]


@dataclasses.dataclass
class Conv(_ConvBase):
    """LConv (cnn.h:194-290): VALID cross-correlation.  indims/outdims
    (x, y, z); kernel (kx, ky, zin, zout)."""
    indims: tuple
    kernel: tuple
    outdims: tuple

    def __post_init__(self):
        self.n_out = int(np.prod(self.outdims))

    def _wdims(self):
        return self.kernel

    def forward(self, params, x):
        ix, iy, iz = self.indims
        h = self._conv(params, x.reshape(-1, iz, iy, ix))
        return h.reshape(x.shape[0], -1)


@dataclasses.dataclass
class ConvS(_ConvBase):
    """LConvS (cnn.h:292-396): a SAME-size radius conv whose stride spaces
    the kernel's offsets (taps at (p - radius) * stride), not the
    output."""
    rdims: tuple           # (x, y)
    din: int
    dout: int
    radius: tuple = (1, 1)
    stride: tuple = (1, 1)

    def __post_init__(self):
        self.n_out = self.rdims[0] * self.rdims[1] * self.dout

    def _wdims(self):
        return (2 * self.radius[0] + 1, 2 * self.radius[1] + 1, self.din,
                self.dout)

    def forward(self, params, x):
        ix, iy = self.rdims
        h = self._conv(params, x.reshape(-1, self.din, iy, ix),
                       padding=(self.radius[1] * self.stride[1],
                                self.radius[0] * self.stride[0]),
                       dilation=(self.stride[1], self.stride[0]))
        return h.reshape(x.shape[0], -1)


@dataclasses.dataclass
class Full(Layer):
    """LFull (cnn.h:398-456): a dense layer, W[j + i*N]."""
    n_in: int
    n_out: int

    def init(self, generator, device=None):
        return {"w": _xavier(generator, (self.n_in, self.n_out), self.n_in,
                             self.n_out, device),
                "b": torch.zeros(self.n_out, device=device)}

    def forward(self, params, x):
        return x @ params["w"] + params["b"]

    def cnnb_arrays(self, params):
        return [_np(params["w"]).reshape(-1), _np(params["b"]).reshape(-1)]

    def cnnb_load(self, raw, off, device=None):
        n = self.n_in * self.n_out
        w = raw[off:off + n].reshape(self.n_in, self.n_out)
        off += n
        b = raw[off:off + self.n_out]
        off += self.n_out
        return {"w": torch.tensor(w, device=device),
                "b": torch.tensor(b, device=device)}, off


@dataclasses.dataclass
class Activation(Layer):
    """LActivation<TanH|Sigmoid|ReLU|LeakyReLU> (cnn.h:24-43, 457-470)."""
    n: int
    kind: str = "tanh"

    def __post_init__(self):
        if self.kind not in ("tanh", "sigmoid", "relu", "leakyrelu"):
            raise ValueError(self.kind)
        self.n_out = self.n

    def forward(self, params, x):
        if self.kind == "tanh":
            return torch.tanh(x)
        if self.kind == "sigmoid":
            return torch.sigmoid(x)
        if self.kind == "relu":
            return torch.clamp(x, min=0.0)
        return torch.maximum(0.01 * x, x)


@dataclasses.dataclass
class _Pool(Layer):
    indims: tuple  # (x, y, z)

    def __post_init__(self):
        ix, iy, iz = self.indims
        self.n_out = (ix // 2) * (iy // 2) * iz

    def _cells(self, x):
        """(B, z, y/2, 2, x/2, 2)."""
        ix, iy, iz = self.indims
        return x.reshape(-1, iz, iy // 2, 2, ix // 2, 2)


class MaxPool(_Pool):
    """LMaxPool 2x2 (cnn.h:136-165).  amax splits the gradient evenly
    between tied maxima, as JAX's reduce max does."""

    def forward(self, params, x):
        return self._cells(x).amax(dim=(3, 5)).reshape(x.shape[0], -1)


class AvgPool(_Pool):
    """LAvgPool 2x2 (cnn.h:113-135)."""

    def forward(self, params, x):
        return self._cells(x).mean(dim=(3, 5)).reshape(x.shape[0], -1)


class SparsePool(_Pool):
    """LSparsePool 2x2 (cnn.h:166-193): the top-left sample."""

    def forward(self, params, x):
        return self._cells(x)[:, :, :, 0, :, 0].reshape(x.shape[0], -1)


@dataclasses.dataclass
class SoftMax(Layer):
    """LSoftMax (cnn.h:471-492)."""
    n: int

    def __post_init__(self):
        self.n_out = self.n

    def forward(self, params, x):
        return torch.softmax(x, dim=-1)


@dataclasses.dataclass
class SoftMaxChunked(Layer):
    """LSoftMaxChunked (cnn.h:493-528): a softmax per span."""
    spans: tuple

    def __post_init__(self):
        self.n_out = sum(self.spans)

    def forward(self, params, x):
        return torch.cat([torch.softmax(c, dim=-1)
                          for c in torch.split(x, list(self.spans), dim=1)],
                         dim=1)


@dataclasses.dataclass
class CrossEntropy(Layer):
    """LCrossEntropy (cnn.h:529-547): a softmax forward (training against
    it descends the softmax cross-entropy when targets are one-hot)."""
    n: int

    def __post_init__(self):
        self.n_out = self.n

    def forward(self, params, x):
        return torch.softmax(x, dim=-1)


class Stack:
    """CNN (cnn.h:100, 548-604): a layer list with Eval, Train, load and
    save."""

    def __init__(self, layers: Sequence[Layer]):
        self.layers = list(layers)

    def init(self, generator: torch.Generator, device=None) -> list:
        return [l.init(generator, device) for l in self.layers]

    def forward(self, params, x):
        h = x.reshape(x.shape[0], -1)
        for l, p in zip(self.layers, params):
            h = l.forward(p, h)
        return h

    def loss(self, params, x, t):
        """0.5 * sum((y - t)^2), the objective CNN::Train descends.
        Returns (loss, y)."""
        y = self.forward(params, x)
        e = y - t
        return 0.5 * (e * e).sum(), y

    def sgd_step(self, params, x, t, alpha: float):
        """One SGD step: (new params, the mean square error)."""
        req = [{k: v.detach().requires_grad_(True) for k, v in p.items()}
               for p in params]
        loss, y = self.loss(req, x, t)
        flat = [v for p in req for v in p.values()]
        grads = iter(torch.autograd.grad(loss, flat) if flat else ())
        with torch.no_grad():
            new = [{k: v - alpha * next(grads) for k, v in p.items()}
                   for p in req]
            mse = ((y.detach() - t) ** 2).mean(-1).mean()
        return new, mse

    def save_cnnb(self, params, path):
        arrays = []
        for l, p in zip(self.layers, params):
            arrays += l.cnnb_arrays(p)
        np.concatenate([np.asarray(a, np.float32) for a in arrays]
                       or [np.zeros(0, np.float32)]).tofile(path)

    def load_cnnb(self, path, device=None) -> list:
        from ..device import resolve_device
        dev = resolve_device(device)
        raw = np.fromfile(path, dtype=np.float32)
        params, off = [], 0
        for l in self.layers:
            p, off = l.cnnb_load(raw, off, dev)
            params.append(p)
        if off != len(raw):
            raise ValueError(f"{path}: {len(raw)} floats, the stack has "
                             f"{off}")
        return params


def pose_initializer_stack() -> Stack:
    """The PoseInitializerCNN architecture (handtrack.h:103-130) in the
    layer stack (cnn/model.py is its fused path)."""
    return Stack([
        Conv((64, 64, 1), (5, 5, 1, 16), (60, 60, 16)),
        Activation(60 * 60 * 16, "tanh"),
        MaxPool((60, 60, 16)),
        MaxPool((30, 30, 16)),
        Conv((15, 15, 16), (4, 4, 16, 64), (12, 12, 64)),
        Activation(12 * 12 * 64, "tanh"),
        MaxPool((12, 12, 64)),
        Full(6 * 6 * 64, 16 * 16 * 8),
        Activation(16 * 16 * 8, "tanh"),
        Full(16 * 16 * 8, 16 * 16 * 8 + 16 * 16),
        SoftMaxChunked(tuple([256] * 8 + [16] * 16)),
    ])
