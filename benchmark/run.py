#!/usr/bin/env python3
"""The benchmark of hand_tracking_samples_tpu_torch (the PyTorch port of the
hand tracker) on NVIDIA GPUs.  One command runs one cell once, from the
root of a checkout:

    python3 benchmark/run.py --workload dyn_kernel.synth --seed 7 \\
        --seconds 30 --trace 0

and prints one JSON line as the last line of its standard output:
{"correct", "attempted", "failed", "metrics", "device"[, "breakdown"],
"checks"}.  --trace 0 reports the cell's end-to-end metrics, --trace 1 its
per-layer metrics (a few frames after the window under torch.profiler).
BENCHMARK.json at the root names the cells; each cell's configuration,
traffic mix, sizes, layer map and metric readers are files under
benchmark/ found by those names.  Without a CUDA device, or with fewer
than the cell asks for, it exits 2 and prints no result.
"""
import os
import sys
import time

T_PROC0 = time.perf_counter()
BENCH = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(BENCH)
# every build and kernel cache inside the checkout, at fixed paths
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(REPO, "build",
                                                       "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(REPO, "build",
                                                           "torch_ext"))
os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    import argparse
    import json
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [p for p in (BENCH, REPO) if p not in sys.path]
    import torch
    from portbench import runner
    w, _, _, _ = runner.cell_spec(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(w["chips"]):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"no result: the cell needs {w['chips']} CUDA device(s), "
              f"this machine has {have}", file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    out, _, _ = runner.execute(args.workload, args.seed, args.seconds,
                               bool(args.trace), T_PROC0)
    bad = runner.forbidden_modules()
    if bad:
        print(f"no result: modules of JAX or the JAX package were loaded: "
              f"{bad}", file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(f"correct {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
