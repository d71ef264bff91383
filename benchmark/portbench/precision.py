"""The control's lower precisions, applied to the plain reference on any
device: a dispatch mode that rounds what an op computes.

  tf32           the float32 inputs of every matrix product and convolution
                 rounded to TF32's 10-bit mantissa (round to nearest even),
                 the products accumulated in float32: what
                 torch.backends.cuda.matmul.allow_tf32 = True does
  bfloat16       every other float32 result rounded to bfloat16's 7-bit
                 mantissa, in place (so views and in-place ops keep their
                 aliasing): the geometry and the solver in bfloat16.  A
                 result that holds only whole numbers (a rank, a count, a
                 pixel index kept in float32) is left exact: it is
                 bookkeeping, not arithmetic of the configuration's
                 precision, and rounding it only breaks the indexing
  tf32+bfloat16  both: each kind of float32 work one step down
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

aten = torch.ops.aten
PRODUCTS = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm, aten.addbmm,
            aten.mv, aten.addmv, aten.dot, aten.vdot, aten.convolution,
            aten._convolution}
KINDS = ("tf32", "bfloat16", "tf32+bfloat16")


def round_tf32(x):
    """float32 -> float32 holding the nearest TF32 value (ties to even)."""
    if not (torch.is_tensor(x) and x.dtype == torch.float32):
        return x
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32).reshape(x.shape)


def _round_bf16_(x):
    # an expanded view (one element seen many times) shares the storage of
    # a result already rounded
    if (torch.is_tensor(x) and x.dtype == torch.float32 and x.numel()
            and torch._debug_has_internal_overlap(x) == 0
            and not bool((x == torch.trunc(x)).all())):
        x.copy_(x.to(torch.bfloat16).to(torch.float32))
    return x


class Rounding(TorchDispatchMode):
    def __init__(self, kind: str):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(f"no control precision {kind!r}")
        self.tf32 = "tf32" in kind
        self.bf16 = "bfloat16" in kind
        self.products = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket in PRODUCTS:
            self.products += 1
            if self.tf32:
                args, kwargs = tree_map(round_tf32, (args, kwargs))
                return func(*args, **kwargs)
        out = func(*args, **kwargs)
        return tree_map(_round_bf16_, out) if self.bf16 else out
