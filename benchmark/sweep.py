#!/usr/bin/env python3
"""The sweep that fixed each configuration's batch T (the tracks of its
cells): for each T, a few frames of the cell's traffic after its warm-up,
the host clock a frame, the device's busy time a frame under
torch.profiler (over two cycles of frames traced after them), its share
of the untraced host clock, and the peak of allocated device memory.  The
cell's T is the smallest at which the card is busy for at least half of
each frame's wall time.

    python3 benchmark/sweep.py --workload dyn_kernel.synth \\
        --tracks 512 1024 2048 4096 8192 --frames 8 [--out FILE]
"""
import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]


def device_ms(cell, frames: int) -> float:
    """The union of device busy time a frame over `frames` frames under
    the profiler (no stacks), ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from portbench.trace import union
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        for _ in range(frames):
            cell.step()
        torch.cuda.synchronize()
    iv = [(e.time_range.start, e.time_range.end) for e in p.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e - s for s, e in union(iv)) / 1e3 / frames


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--tracks", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch
    from portbench.runner import Cell
    rows, pool = [], None
    for T in args.tracks:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        row = {"tracks": T}
        try:
            cell = Cell(args.workload, args.seed, "cuda", tracks=T)
            t0 = time.perf_counter()
            cell.setup(pool)
            pool = cell.pool
            row["setup_s"] = time.perf_counter() - t0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.frames):
                cell.step()
            torch.cuda.synchronize()
            row["host_ms_per_frame"] = (time.perf_counter() - t0) * 1e3 \
                / args.frames
            ms = device_ms(cell, max(cell.k, 1) * 2)
            row["device_ms_per_frame"] = ms
            row["busy_share"] = ms / row["host_ms_per_frame"]
            row["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
        except torch.cuda.OutOfMemoryError as e:
            row["error"] = f"out of memory: {str(e)[:200]}"
        cell = None
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
