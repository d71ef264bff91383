"""Device-op attribution with torch.profiler (the port's counterpart of
tools/prof_trace.py): one F-frame run of update_full, update_dyn or msim
(prof_full's stages; any other of them too) after a warm-up run, traced, and the top device ops by
total time, aggregated by name (on the CPU, where there is no device, the
host ops by self time).  With PROF_BY_SOURCE=1 (the default) the ops are
also attributed to the topmost source line of the port that issued them,
which catches the long tail of small launches the name-ranked view hides.
The Chrome trace is written under --out (default build/eval/).

    PROF_TRACKS=512 python -m hand_tracking_samples_tpu_torch.tools.prof_trace [update_full|update_dyn|msim]
    PROF_TRACKS=2 PROF_FRAMES=1 python -m hand_tracking_samples_tpu_torch.tools.prof_trace update_dyn --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from .common import add_device, add_out, env_int, sync
from .prof_full import STAGES, Profile

PORT = "hand_tracking_samples_tpu_torch" + os.sep
HOST = ("cpu_op", "python_function", "cuda_runtime", "cuda_driver")
DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")


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


def source_of(e) -> str:
    """The innermost Python frame of the port around host event e."""
    p = e.get("_parent")
    while p is not None:
        if p.get("cat") == "python_function" and PORT in p["name"]:
            return p["name"][p["name"].index(PORT):]
        p = p.get("_parent")
    return "?"


def attribute(path: str, by_src: bool):
    """From a torch.profiler Chrome trace: ({op name: [us, count]},
    {source line: us}).  With device events (kernels, copies, sets) those
    are the ops, each charged to the source around its launch (the
    runtime call of the same correlation id); without, the host ops by
    their self time."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in events if e.get("cat") in DEVICE]
    nest(events)
    if dev:
        ops = dev
        launch = {e["args"]["correlation"]: e for e in events
                  if e.get("cat") in ("cuda_runtime", "cuda_driver")
                  and "correlation" in e.get("args", {})}
        src = lambda e: source_of(launch[e["args"]["correlation"]]) \
            if e.get("args", {}).get("correlation") in launch else "?"
        us = lambda e: e["dur"]
    else:
        ops = [e for e in events if e.get("cat") == "cpu_op"]
        src, us = source_of, lambda e: e["_self"]
    names, lines = {}, {}
    for e in ops:
        a = names.setdefault(e["name"], [0.0, 0])
        a[0] += us(e)
        a[1] += 1
        if by_src:
            k = src(e)
            lines[k] = lines.get(k, 0.0) + us(e)
    return names, lines


def main(argv=None):
    ap = add_out(add_device(argparse.ArgumentParser(
        description=__doc__.split("\n")[0])))
    ap.add_argument("which", nargs="?", default="update_full",
                    choices=STAGES, help="update_full, update_dyn, msim "
                    "(the JAX tool's), or another stage of prof_full")
    args = ap.parse_args(argv)
    T, F = env_int("PROF_TRACKS", 512), env_int("PROF_FRAMES", 4)
    by_src = os.environ.get("PROF_BY_SOURCE", "1") == "1"
    from torch.profiler import ProfilerActivity, profile
    prof = Profile(args.device, T, F)
    run = prof.runner(args.which)
    device = prof.dev.type == "cuda"
    run()                                                   # warm-up
    sync(prof.dev)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device
                                     else [])
    with profile(activities=acts, with_stack=by_src) as p:
        run()
        sync(prof.dev)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"trace_{args.which}.json")
    p.export_chrome_trace(path)
    agg, lines = attribute(path, by_src)
    total = sum(v[0] for v in agg.values()) / 1e3
    kind = "device" if device else "host (no device)"
    print(f"== {args.which}: {kind} total {total:.1f} ms over {F} frames "
          f"({total / F:.2f} ms/frame, T={T}) ==")
    for n, (us, cnt) in sorted(agg.items(), key=lambda kv: -kv[1][0])[:40]:
        print(f"{us / 1e3:9.2f} ms  {us / 1e3 / F:8.3f}/frame  x{cnt:5d}  "
              f"{n[:90]}")
    if by_src:
        print("\n-- by source line (ms/frame) --")
        for src, us in sorted(lines.items(), key=lambda kv: -kv[1])[:30]:
            print(f"{us / 1e3 / F:8.3f}  {src}")
    print("trace:", path)
    return dict(total_ms=total, ops=agg)


if __name__ == "__main__":
    main()
    sys.exit(0)
