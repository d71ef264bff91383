"""The per-round eval artifacts (the port's counterpart of
tools/eval_artifacts.py): machine-readable JSON of the headline accuracy
claims, written under --out (default build/eval/) as <name>_<ROUND>.json
with the JAX tool's keys:
  coldstart        64 starts x 64 frames of the full pipeline from the
                   rest pose (eval_coldstart's protocol)
  fastdrift        eval_fastdrift --attribution --json (a subprocess)
  dyntrack         the dyntrack golden (64 frames) tracked by the kernel
                   solver with use_pallas at the shipped defaults, beside
                   the colored solver's control on the CPU
                   (dyn_colored_ctrl, a subprocess)
  cnntrack_kernel  the shipped configuration over the 128-frame
                   cnntrack_rec2 recording at k = 4 against the C++
                   HandTracker's trajectory golden on it
The JAX tool's bench_full subprocesses the JAX package's bench.py; the
port's counterpart waits for the port's benchmark, so it is refused here.
EVAL_TRACKS and EVAL_FRAMES cut coldstart's and fastdrift's protocols
(eval_fastdrift's --tracks and --frames) and EVAL_FRAMES the others'.

    ROUND=r06 python -m hand_tracking_samples_tpu_torch.tools.eval_artifacts [which ...]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

from .common import (FIXTURES, REPO, add_device, add_out, env_int,
                     joint_err, load_recording, setup, track_recording,
                     write_json)

WHICH = ("coldstart", "fastdrift", "dyntrack", "cnntrack_kernel")
PKG = "hand_tracking_samples_tpu_torch.tools"


class Artifacts:
    def __init__(self, args):
        self.args, self.round = args, os.environ.get("ROUND", "r04")
        self.frames = env_int("EVAL_FRAMES", 0)

    def write(self, name, payload, which):
        payload = dict(payload, round=self.round, command=(
            f"ROUND={self.round} python -m {PKG}.eval_artifacts {which}"))
        write_json(os.path.join(self.args.out,
                                f"{name}_{self.round}.json"), payload)

    def run_tool(self, tool, *argv, device=None):
        cmd = [sys.executable, "-m", f"{PKG}.{tool}", "--device",
               device or self.args.device, *argv]
        return subprocess.run(cmd, cwd=REPO, check=True, text=True,
                              capture_output=True, env={
                                  **os.environ, "EVAL_ROUND": self.round})

    def coldstart(self):
        from ..tracker.config import TrackerConfig
        from .eval_coldstart import coldstart_errors
        T = env_int("EVAL_TRACKS", 64)
        F = self.frames or 64
        dev, model, bank, cam, cnn = setup(self.args.device, cnn=True)
        config = TrackerConfig(cnn_every_frame=True, solver="kernel",
                               use_pallas=True)

        def report(f, e):
            if f % 16 == 15:
                print(f"frame {f}: mean {e.mean() * 1000:.2f} mm",
                      flush=True)
        errs, _ = coldstart_errors(config, dev, model, bank, cam, cnn, T, F,
                                   report=report)
        err = errs[-1]
        self.write("coldstart", {
            "protocol": f"{T} starts x {F} frames, full pipeline, defaults",
            "mean_mm": round(float(err.mean() * 1000), 2),
            "median_mm": round(float(np.median(err) * 1000), 2),
            "pct_lt8mm": round(float((err < 0.008).mean() * 100), 1),
            "reference_mean_mm": 8.21, "reference_pct_lt8mm": 72.0,
            "per_start_mm": [round(float(e * 1000), 2) for e in err],
        }, "coldstart")

    def fastdrift(self):
        path = os.path.join(self.args.out, f"fastdrift_{self.round}.json")
        extra = ["--frames", str(self.frames)] if self.frames else []
        if "EVAL_TRACKS" in os.environ:
            extra += ["--tracks", os.environ["EVAL_TRACKS"]]
        res = self.run_tool("eval_fastdrift", "--attribution", "--json",
                            path, *extra)
        print(res.stdout.strip().splitlines()[-1], flush=True)

    def dyntrack(self):
        from ..tracker.config import TrackerConfig
        from .dyn_colored_ctrl import dyntrack_devs, golden_poses
        config = TrackerConfig(solver="kernel", use_pallas=True,
                               cnn_every_frame=False)
        devs = dyntrack_devs(config, self.args.device, self.frames or None)
        F = len(devs)
        ctrl = self.run_tool("dyn_colored_ctrl", device="cpu")
        colored = json.loads(ctrl.stdout.strip().splitlines()[-1])
        g, _ = golden_poses()
        refje = [round(x * 1000, 2) for x in g["dyntrack_joint_err"]][:F]
        stable = [f for f in range(F) if refje[f] < 2.0]
        self.write("dyntrack_kernel", {
            "protocol": f"{F}-frame dyntrack golden, solver=kernel with "
                        f"use_pallas, device {self.args.device}, shipped "
                        f"defaults (budget {config.point_budget}, cap "
                        f"{config.cloud_rows_per_body}); colored control "
                        f"on the CPU on the identical horizon "
                        f"(dyn_colored_ctrl)",
            "per_frame_dev_mm": [round(d * 1000, 3) for d in devs],
            "max_dev_mm": round(max(devs) * 1000, 3),
            "mean_dev_mm": round(sum(devs) / F * 1000, 3),
            "colored_cpu_dev_mm": colored,
            "ref_joint_err_mm": refje,
            "stable_frames": stable,
            "stable_max_dev_mm": round(max([devs[f] for f in stable],
                                           default=0.0) * 1000, 3),
        }, "dyntrack")

    def cnntrack_kernel(self):
        from ..tracker.config import TrackerConfig
        dev, model, _, _, cnn = setup(self.args.device, cnn=True)
        ds, cam = load_recording("cnntrack_rec2")
        with open(os.path.join(FIXTURES, "cnntrack_ref2_k4.json")) as f:
            ref = json.load(f)
        k, F = ref["k"], ref["n_frames"]
        F = min(self.frames or F, F)
        refp = np.asarray(ref["cnntrack_poses"], np.float32).reshape(
            -1, 17, 7)[:F]
        ref_je = np.asarray(ref["cnntrack_joint_err"])[:F]
        config = TrackerConfig(cnn_every_frame=True, cnn_every_k=k,
                               solver="kernel", use_pallas=True)
        poses = track_recording(ds, cam, model, cnn, config, k, F, dev)
        devs, jes = joint_err(poses, refp), joint_err(poses, ds.pose[:F])
        self.write("cnntrack_kernel", {
            "protocol": f"cnntrack_rec2 ({F} recorded real-speed frames), "
                        f"k={k} cadence, solver=kernel + use_pallas (the "
                        f"shipped bench configuration), device "
                        f"{self.args.device}, vs the C++ HandTracker "
                        f"trajectory golden on the identical recording",
            "per_frame_dev_mm": [round(float(d) * 1000, 2) for d in devs],
            "per_frame_je_mm": [round(float(j) * 1000, 2) for j in jes],
            "ref_je_mm": [round(float(j) * 1000, 2) for j in ref_je],
            "mean_dev_mm": round(float(np.mean(devs)) * 1000, 2),
            "mean_je_mm": round(float(np.mean(jes)) * 1000, 2),
            "ref_mean_je_mm": round(float(np.mean(ref_je)) * 1000, 2),
        }, "cnntrack_kernel")


def main(argv=None):
    ap = add_out(add_device(argparse.ArgumentParser(
        description=__doc__.split("\n")[0])))
    ap.add_argument("which", nargs="*", metavar="which",
                    help="artifacts to write (default all): "
                    + " ".join(WHICH))
    args = ap.parse_args(argv)
    if "bench_full" in args.which:
        ap.error("bench_full drives the JAX package's bench.py; its port "
                 "waits for the port's benchmark")
    bad = [w for w in args.which if w not in WHICH]
    if bad:
        ap.error(f"unknown artifacts {bad}")
    a = Artifacts(args)
    for w in args.which or WHICH:
        getattr(a, w)()


if __name__ == "__main__":
    main()
    sys.exit(0)
