"""Device meshes: data-parallel training and sharded tracking (the port's
counterpart of hand_tracking_samples_tpu.parallel.mesh).

Tracking is embarrassingly parallel across tracks (a track's state is 17
poses and momenta; no communication on the hot path); training is plain
data parallel (the CNN has 9.4M parameters).  A mesh is an explicit,
ordered list of devices, driven by one host thread (single controller, as
JAX's jit over a mesh is): each shard's work is issued to its device in
mesh order, and CUDA's asynchronous launches let the cards run together.
A mesh may list a device more than once; that is how the CPU tests and a
one-card machine exercise the split and the merge.
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    devices: tuple
    axis: str = "data"

    def __len__(self) -> int:
        return len(self.devices)


def _indexed(dev) -> torch.device:
    dev = resolve_device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(axis: str = "data", n: int | None = None,
              devices=None) -> Mesh:
    """The first n of `devices` (default: every visible card, in index
    order).  Raises when no card is visible and the caller named no
    device; tests pass devices=["cpu"] * k."""
    if devices is None:
        count = torch.cuda.device_count()
        devices = [f"cuda:{i}" for i in range(count)] if count else [None]
    devs = tuple(_indexed(d) for d in devices)[:n]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devs, axis)


def tree_map(fn, tree):
    """fn on every tensor of a nested tuple / NamedTuple / list / dict;
    other leaves (None, numbers) are kept.  An object with a `to` method
    that is not a tensor (model.bake.HandModel) counts as a leaf."""
    if isinstance(tree, torch.Tensor) or (
            hasattr(tree, "to") and not isinstance(tree, (tuple, list,
                                                          dict))):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[tree_map(fn, x) for x in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree


def _leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def shard_batch(mesh: Mesh, tree, dim: int = 0) -> list:
    """One shard a mesh device: every tensor of `tree` split along `dim`
    into len(mesh) contiguous, equal parts, part i on mesh.devices[i].
    Raises ValueError when the size does not divide."""
    n = len(mesh)
    sizes = {x.shape[dim] for x in _leaves(tree)}
    bad = [s for s in sizes if s % n]
    if bad:
        raise ValueError(f"batch size {bad[0]} along dim {dim} does not "
                         f"divide over {n} devices")
    return [tree_map(lambda x, i=i, dev=dev: x.chunk(n, dim)[i].to(dev),
                     tree) for i, dev in enumerate(mesh.devices)]


def replicate(mesh: Mesh, tree) -> list:
    """One copy of `tree` a mesh device (tensors, and HandModels through
    their `to`; a device that already holds a tensor shares it)."""
    return [tree_map(lambda x, dev=dev: x.to(dev), tree)
            for dev in mesh.devices]


def gather(mesh: Mesh, shards: list, dim: int = 0):
    """shard_batch's inverse: each tensor of the shards' trees concatenated
    along dim, in shard order, on the first mesh device."""
    dev = mesh.devices[0]
    per_shard = [_leaves(s) for s in shards]
    cat = iter([torch.cat([ls[i].to(dev) for ls in per_shard], dim)
                for i in range(len(per_shard[0]))])
    return tree_map(lambda _: next(cat), shards[0])


def make_dp_train_step(mesh: Mesh, alpha: float):
    """Data-parallel CNN SGD step, single controller: step(params, x, t)
    for the whole batch returns (new params, the batch's mean square
    error) on the first mesh device.  The parameters are replicated, each
    shard runs forward and backward on its device, and the gradients are
    summed into the first device in shard order (deterministic).  The loss
    (cnn.model.loss_fn) is a sum over the batch, so the batch's gradient is
    the sum of the shards' (an average would make the step len(mesh) times
    too small); the MSE is each shard's mean weighted by its size."""
    from ..cnn.model import loss_fn

    def step(params, x, t):
        dev = mesh.devices[0]
        leaves = [(k, kk) for k in params for kk in params[k]]
        grads, sq = None, None
        for p, xs, ts in zip(replicate(mesh, params), shard_batch(mesh, x),
                             shard_batch(mesh, t)):
            req = {k: {kk: p[k][kk].detach().requires_grad_(True)
                       for kk in p[k]} for k in p}
            loss, y = loss_fn(req, xs, ts)
            g = torch.autograd.grad(loss, [req[k][kk] for k, kk in leaves])
            with torch.no_grad():
                e = y.detach() - ts
                s = (e * e).mean(-1).sum().to(dev)
                g = [gi.to(dev) for gi in g]
                grads = g if grads is None else [a + b for a, b in
                                                 zip(grads, g)]
                sq = s if sq is None else sq + s
        new = {k: {} for k in params}
        with torch.no_grad():
            for (k, kk), gi in zip(leaves, grads):
                new[k][kk] = params[k][kk].to(dev) - alpha * gi
        return new, sq / x.shape[0]

    return step
