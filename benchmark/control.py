#!/usr/bin/env python3
"""The readings that the limits of `correct` are set from, for one cell at
its own size: for each seed, a short window of the program, then the
compared numbers of its checked frames against the plain reference (the
sound readings), and for the first --control-seeds seeds the same frames
recomputed by the reference in the configuration's control precision
(its "control" key, or --precision: a kind of portbench/precision.py) and
judged the same way (the control's readings).  One process drives the
card and renders one pool; with --workers N the comparisons (on the CPU)
run in N processes beside it while it runs the next seeds' windows.

    python3 benchmark/control.py --workload cnn_kernel.synth \\
        --seeds 11 12 13 --seconds 10 --control-seeds 3 --workers 4 \\
        [--out FILE]
"""
import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

_REF = None


def _worker_init(config, threads):
    global _REF
    import torch
    from portbench import check as checks
    from portbench.runner import REPO
    torch.set_num_threads(threads)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _REF = checks.Reference(config, REPO)


def _judge(cases, limits, start_poses, control):
    """One comparison in a worker: (numbers, start_gap, seconds)."""
    from portbench import check as checks
    t = time.perf_counter()
    v = checks.judge(cases, _REF, limits, start_poses, control=control)
    return v["numbers"], v["start_gap"], time.perf_counter() - t


def readings(name, seeds, seconds, control_seeds, precision=None,
             device="cuda", tracks=None, log=sys.stderr, workers=0):
    """[{seed, sound: {number: value}, control: {...} or None}]."""
    import torch
    from portbench import check as checks
    from portbench.runner import REPO, Cell, Run
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows, pool, jobs, ex = [], None, [], None
    for i, seed in enumerate(seeds):
        cell = Cell(name, seed, device, tracks)
        cell.setup(pool)
        pool = cell.pool
        cell.window(seconds, Run())
        cases = cell.cases()
        limits = cell.spec["check"]["limits"]
        ctl = (precision or cell.config["control"]) if i < control_seeds \
            else None
        row = {"seed": seed, "frames": [c.f for c in cases],
               "control": None}
        if workers:
            if ex is None:
                import multiprocessing as mp
                from concurrent.futures import ProcessPoolExecutor
                ex = ProcessPoolExecutor(
                    workers, mp.get_context("spawn"), _worker_init,
                    (cell.config, max(1, (os.cpu_count() or 2) // workers)))
            jobs.append((row, ex.submit(_judge, cases, limits,
                                        cell.start_poses, None),
                         None if ctl is None else ex.submit(
                             _judge, cases, limits, cell.start_poses, ctl)))
        else:
            ref = checks.Reference(cell.config, REPO, cell.ref_model)
            t = time.perf_counter()
            sound = checks.judge(cases, ref, limits, cell.start_poses)
            row.update(sound=sound["numbers"], start_gap=sound["start_gap"],
                       sound_s=time.perf_counter() - t)
            if ctl is not None:
                t = time.perf_counter()
                row["control"] = checks.judge(cases, ref, limits,
                                              cell.start_poses,
                                              control=ctl)["numbers"]
                row["control_s"] = time.perf_counter() - t
            print(json.dumps(row), file=log, flush=True)
        rows.append(row)
        cell.state = cell.keep = cell.last = None
    for row, sound, ctl in jobs:
        row["sound"], row["start_gap"], row["sound_s"] = sound.result()
        if ctl is not None:
            row["control"], _, row["control_s"] = ctl.result()
        print(json.dumps(row), file=log, flush=True)
    if ex is not None:
        ex.shutdown()
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--precision", help="the control's precision (default: "
                    "the configuration's control)")
    ap.add_argument("--workers", type=int, default=0,
                    help="processes for the comparisons (0: in this one)")
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    rows = readings(args.workload, args.seeds, args.seconds,
                    args.control_seeds, args.precision,
                    workers=args.workers)
    sound = {k: max(r["sound"][k] for r in rows) for k in rows[0]["sound"]}
    ctl = [r["control"] for r in rows if r["control"]]
    least = {k: min(c[k] for c in ctl) for k in ctl[0]} if ctl else None
    out = {"workload": args.workload, "rows": rows, "sound_max": sound,
           "control_min": least,
           "device": torch.cuda.get_device_name(0)
           if torch.cuda.is_available() else "cpu"}
    print(json.dumps({"sound_max": sound, "control_min": least}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
