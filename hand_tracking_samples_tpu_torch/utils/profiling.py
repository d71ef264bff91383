"""Per-stage timing and device tracing (the port's counterpart of
hand_tracking_samples_tpu.utils.profiling): host-side stage timers that
wait for the card, and a torch.profiler capture written as a Chrome trace
(chrome://tracing, Perfetto)."""
from __future__ import annotations

import contextlib
import os
import time
import types
from collections import defaultdict

import torch


def _sync(out):
    """Wait for the cards that hold a tensor of `out` (a nested tuple,
    list or dict of tensors)."""
    from ..parallel.mesh import tree_map
    cards = set()
    tree_map(lambda x: cards.add(x.device) if getattr(x, "is_cuda", False)
             else None, out)
    for dev in cards:
        torch.cuda.synchronize(dev)
    return out


class StageTimer:
    """Accumulating per-stage wall timers; `time` times device work
    correctly by waiting for the cards its output lies on."""

    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        yield
        t1 = time.perf_counter()
        self.total[name] += t1 - t0
        self.count[name] += 1

    def time(self, name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = _sync(fn(*args, **kw))
        self.total[name] += time.perf_counter() - t0
        self.count[name] += 1
        return out

    def report(self):
        lines = []
        for name in sorted(self.total, key=self.total.get, reverse=True):
            lines.append(f"{name:32s} {self.total[name]*1000:9.1f} ms "
                         f"({self.count[name]} calls, "
                         f"{self.total[name]/max(self.count[name],1)*1000:.2f}"
                         f" ms/call)")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a torch.profiler trace of the host and, where there is a
    card, its kernels; written on exit as a Chrome trace,
    logdir/trace_<pid>_<n>.json (the path is `trace.path` of the yielded
    object)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    n = len([f for f in os.listdir(logdir) if f.startswith("trace_")])
    handle = types.SimpleNamespace(
        path=os.path.join(logdir, f"trace_{os.getpid()}_{n}.json"))
    with profile(activities=acts) as prof:
        yield handle
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(handle.path)
