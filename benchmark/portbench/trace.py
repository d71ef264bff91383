"""What the traced run reads: a torch.profiler Chrome trace of a few frames
after the window, each device op charged to a layer of the port by the
Python frames around its launch, and the port kernels' launches with
their inputs.

`nest` and `source_of` are copied from the port's tools/prof_trace.py.
The layer of an op comes from the rules of `layers/*.json`: the first
rule that matches any port frame on the op's launch stack names it.  The
files are read last name first, so a file whose name sorts after the
others (`port.json`, then say `port_spans.json`) has the first say: a
later change adds or refines layers in a file of its own without editing
a rule that is there.
"""
from __future__ import annotations

import contextlib
import glob
import json
import os
import sys

PORT = "hand_tracking_samples_tpu_torch"
HOST = ("cpu_op", "python_function", "cuda_runtime", "cuda_driver")
DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
MARK = "portbench.traced"


def nest(events):
    """Give each host event of a Chrome trace its enclosing event on its
    thread (_parent) and its time less its children's (_self, us)."""
    threads = {}
    for e in events:
        if e.get("cat") in HOST:
            threads.setdefault((e["pid"], e["tid"]), []).append(e)
    for evs in threads.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []
        for e in evs:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
                stack.pop()
            e["_parent"] = stack[-1] if stack else None
            e["_self"] = e["dur"]
            if stack:
                stack[-1]["_self"] -= e["dur"]
            stack.append(e)


def _port_frame(name: str):
    """'.../hand_tracking_samples_tpu_torch/tracker/runtime.py(883): update'
    -> ('tracker/runtime.py', 'update', 'tracker/runtime.py(883): update'),
    or None for a frame outside the port."""
    key = PORT + "/"
    i = name.find(key)
    if i < 0 or "): " not in name:
        return None
    tail = name[i + len(key):]
    path, func = tail.split("): ", 1)
    return path.split("(")[0], func, tail


def source_of(e) -> str:
    """The innermost Python frame of the port around host event e."""
    p = e.get("_parent")
    while p is not None:
        if p.get("cat") == "python_function":
            f = _port_frame(p["name"])
            if f is not None:
                return f[2]
        p = p.get("_parent")
    return "?"


def port_stack(e) -> list:
    """The port's (module, function) frames around host event e,
    innermost first."""
    out = []
    p = e.get("_parent")
    while p is not None:
        if p.get("cat") == "python_function":
            f = _port_frame(p["name"])
            if f is not None:
                out.append(f[:2])
        p = p.get("_parent")
    return out


def load_rules(layer_dir: str) -> list:
    """The rules of every layers/*.json, the last file name first, each
    file's rules in their order: each {"layer", "module", "functions"
    (optional: every function)}."""
    rules = []
    for path in sorted(glob.glob(os.path.join(layer_dir, "*.json")),
                       reverse=True):
        with open(path) as f:
            for r in json.load(f)["rules"]:
                rules.append((r["layer"], r["module"],
                              frozenset(r.get("functions", ()))))
    return rules


def layer_of(stack, rules) -> str:
    """The layer of an op launched under `stack` ((module, function)
    frames): the first rule matching a frame; "outside" without a port
    frame, "unmapped" when no rule matches."""
    if not stack:
        return "outside"
    for layer, module, funcs in rules:
        for mod, func in stack:
            if mod == module and (not funcs or func in funcs):
                return layer
    return "unmapped"


def union(intervals):
    """Merge (start, end) intervals: a sorted list of disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _marks(events):
    """The host side of the harness's MARK range (the profiler also
    mirrors it on the device's lane)."""
    return [e for e in events if e.get("name") == MARK
            and e.get("cat") == "user_annotation"]


class Trace:
    """The traced segment of one run: `frames` frames (`cnn_frames` of them
    CNN frames) between the harness's MARK range's ends."""

    def __init__(self, events, rules, frames: int, cnn_frames: int):
        self.frames, self.cnn_frames = frames, cnn_frames
        events = [e for e in events if e.get("ph") == "X" and "dur" in e]
        marks = _marks(events)
        if not marks:
            raise RuntimeError(f"the trace has no {MARK} range")
        t0 = min(e["ts"] for e in marks)
        t1 = max(e["ts"] + e["dur"] for e in marks)
        self.window_us = t1 - t0
        nest(events)
        launch = {e["args"]["correlation"]: e for e in events
                  if e.get("cat") in ("cuda_runtime", "cuda_driver")
                  and "correlation" in e.get("args", {})}
        dev = [e for e in events if e.get("cat") in DEVICE
               and e["ts"] < t1 and e["ts"] + e["dur"] > t0]
        self.device_ops = len(dev)
        self.op_us, self.layer_us = {}, {}
        for e in dev:
            us = min(e["ts"] + e["dur"], t1) - max(e["ts"], t0)
            self.op_us[e["name"]] = self.op_us.get(e["name"], 0.0) + us
            host = launch.get(e.get("args", {}).get("correlation"))
            layer = layer_of(port_stack(host), rules) if host else "outside"
            self.layer_us[layer] = self.layer_us.get(layer, 0.0) + us
        busy = union((max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                     for e in dev)
        self.busy_us = sum(e - s for s, e in busy)
        self.gaps = self._gaps(busy, t0, t1, events)

    @staticmethod
    def _gaps(busy, t0, t1, events):
        """{what the host ran at an idle gap's start: idle us}, over the
        gaps between the device's busy intervals inside [t0, t1]."""
        edges = [t0] + [x for iv in busy for x in iv] + [t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        marks = _marks(events)
        tid = (marks[0]["pid"], marks[0]["tid"])
        host = sorted((e for e in events if e.get("cat") in HOST
                       and (e["pid"], e["tid"]) == tid),
                      key=lambda e: (e["ts"], -e["dur"]))
        out, stack, i = {}, [], 0
        for s, e in gaps:
            while i < len(host) and host[i]["ts"] <= s:
                stack.append(host[i])
                i += 1
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= s:
                stack.pop()
            label = "?"
            for h in reversed(stack):
                if h["ts"] + h["dur"] <= s:
                    continue
                if h.get("cat") == "python_function" \
                        and _port_frame(h["name"]):
                    label = _port_frame(h["name"])[2]
                    break
                if h.get("cat") == "cpu_op" and label == "?":
                    label = source_of(h) if source_of(h) != "?" \
                        else h["name"]
                    break
            out[label] = out.get(label, 0.0) + (e - s)
        return out

    def kernels_us(self, *names) -> float:
        """Device time of the ops whose name contains one of `names`."""
        return sum(us for op, us in self.op_us.items()
                   if any(n in op for n in names))

    def breakdown(self) -> dict:
        top = sorted(self.op_us.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, us / 1e6] for n, us in top],
                "idle_gaps": [[n, us / 1e6] for n, us in gaps]}


class _Recorder:
    """Stands in for one port kernel wrapper while launches are recorded:
    notes (name, args) and calls the wrapper; its launch counters are the
    wrapper's own."""

    def __init__(self, name, fn, sink):
        self.name, self.fn, self.sink = name, fn, sink

    def __call__(self, *args, **kwargs):
        self.sink.append((self.name, args))
        return self.fn(*args, **kwargs)

    launches = property(lambda s: s.fn.launches,
                        lambda s, v: setattr(s.fn, "launches", v))
    kinds = property(lambda s: s.fn.kinds)


@contextlib.contextmanager
def record_launches(sink: list):
    """While open, every call of a port kernel wrapper (the port's
    `kernels.WRAPPERS`) from any loaded module of the port is noted in
    `sink` with its arguments.  The module attributes are restored on
    exit."""
    from hand_tracking_samples_tpu_torch import kernels
    wrapped = {id(fn): (name, fn) for name, fn in kernels.WRAPPERS.items()}
    patched = []
    for mod in list(sys.modules.values()):
        if getattr(mod, "__name__", "").split(".")[0] != PORT:
            continue
        for attr, val in list(vars(mod).items()):
            if id(val) in wrapped:
                name, fn = wrapped[id(val)]
                patched.append((mod, attr, val))
                setattr(mod, attr, _Recorder(name, fn, sink))
    try:
        yield sink
    finally:
        for mod, attr, val in patched:
            setattr(mod, attr, val)


def capture(run_frames, out_dir: str):
    """Run run_frames() under torch.profiler with Python stacks, inside the
    MARK range; returns the Chrome trace's events."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, with_stack=True) as p:
        with record_function(MARK):
            run_frames()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    path = os.path.join(out_dir, "trace.json")
    p.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    return events
