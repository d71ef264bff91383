#!/usr/bin/env python3
"""A/B of the two solve kernels, the row sweep and the PGS kernel, on one
NVIDIA GPU: this tree's kernels against an earlier tree's, on
chip_smoke.py's exact-contact inputs.  Run from the repository root:

    python3 chip_ab.py --parent DIR [--json PATH]

DIR holds an earlier tree's row_sweep.cu, pgs_kernel.cu and common.cuh,
e.g. `git archive <commit> hand_tracking_samples_tpu_torch/csrc` unpacked
under build/; its PGS class record has no per-body lists or jacobi
fields, its row-sweep arguments no jmax.  The earlier kernels are built by
one nvcc call (kernels.NVCC_FLAGS) under build/chip_ab/.  The inputs are
taken at T=512 after 3 dynamics frames: the dynamics frame's PGS solve,
and a sequential and a colored frame's rows for the row sweep.  The
outputs of both trees are held equal (torch.equal) before they are timed.
Times are CUDA events over repeated launches, in the order earlier, this,
this, earlier, twice, ms a launch.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
T = 512


def ab(args) -> int:
    """The row sweep and the PGS kernel of this tree against the earlier
    tree's in args.parent."""
    import torch
    import chip_smoke
    from hand_tracking_samples_tpu_torch import kernels
    from hand_tracking_samples_tpu_torch.physics import pgs_kernel as pk
    from hand_tracking_samples_tpu_torch.physics import row_sweep as rs
    d = os.path.join(REPO, "build", "chip_ab", "parent_solves")
    os.makedirs(d, exist_ok=True)
    srcs = ("row_sweep.cu", "pgs_kernel.cu", "common.cuh")
    for f in srcs:
        with open(os.path.join(os.path.abspath(args.parent), f)) as fh:
            text = fh.read()
        with open(os.path.join(d, f), "w") as fh:
            fh.write(text)
    lib_path = os.path.join(d, "lib_parent_solves.so")
    r = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", d, "-o",
                        lib_path, *[os.path.join(d, f) for f in srcs[:2]]],
                       capture_output=True, text=True)
    if r.returncode != 0:
        print(f"chip_ab: the parent's solves did not build:\n"
              f"{(r.stdout + r.stderr)[-2000:]}")
        return 1
    old = ctypes.CDLL(lib_path)
    new = kernels.library()
    for lib in (old, new):
        lib.hts_row_sweep.argtypes = [ctypes.c_void_p] * 2
        lib.hts_pgs_solve.argtypes = [ctypes.c_void_p] * 2
    ptx = {"parent": {k: v for k, v in kernels.ptxas_summary(
        r.stdout + r.stderr).items() if "pgs" in k or "row_sweep" in k}}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, "ptxas", json.dumps(ptx), flush=True)

    class OldClass(ctypes.Structure):   # the earlier tree's PgsClass
        _fields_ = [("rows", ctypes.c_void_p), ("ub0", ctypes.c_void_p),
                    ("ub1", ctypes.c_void_p), ("U", ctypes.c_int),
                    ("W", ctypes.c_int), ("n_groups", ctypes.c_int),
                    ("friction", ctypes.c_int)]

    class OldArgs(ctypes.Structure):
        _fields_ = [(n, t) for n, t in pk._Args._fields_[:-2]] + [
            ("lin", OldClass * pk.MAX_CLASSES),
            ("ang", OldClass * pk.MAX_CLASSES)]

    s = chip_smoke.Smoke()
    dev = s.dev
    stream = kernels.stream_ptr(dev)
    st, _ = s.run(s.init_state(T), 3, T)
    depth = s.depth_frame(3, T)
    launches = {}
    # the PGS kernel on the dynamics frame's solve
    plan, it, ip, mom0, mi, singles, lin, ang = \
        s.kernel_inputs(st, depth)["pgs_solve"]
    lin = [pk._aligned(r.contiguous()) for r in lin]
    ang = [pk._aligned(r.contiguous()) for r in ang]
    singles = pk._aligned(singles.contiguous())
    ids = pk._unit_ids(plan, dev)
    for name, lib in (("parent", old), ("new", new)):
        out = torch.empty((T, 2, 6, plan.bp), device=dev)
        a = (OldArgs if name == "parent" else pk._Args)()
        a.mom0, a.mi, a.out = mom0.data_ptr(), mi.data_ptr(), out.data_ptr()
        a.singles, a.T, a.CS, a.BP = singles.data_ptr(), T, plan.CS, plan.bp
        a.iters, a.iters_post = it, ip
        a.n_lin, a.n_ang = len(plan.lin_classes), len(plan.ang_classes)
        nl = len(plan.lin_classes)
        for k, (c, rw) in enumerate(zip(plan.lin_classes + plan.ang_classes,
                                        lin + ang)):
            rec = (OldClass(rw.data_ptr(), ids[k][0], ids[k][1], c.U, c.W,
                            c.n_groups, int(c.friction))
                   if name == "parent" else pk._class(c, rw.data_ptr(),
                                                      ids[k]))
            (a.lin if k < nl else a.ang)[k if k < nl else k - nl] = rec
        launches["pgs dynamics", name] = (lib.hts_pgs_solve,
                                          (ctypes.byref(a), stream), out, a)
    # the row sweep on a sequential and a colored frame's rows
    inp = s.ref_inputs(st.body, depth)
    for key in ("row_sweep", "row_sweep[colored]"):
        m0, massinv, rows, it, ip = inp[key]
        B = m0.shape[1]
        lf, af = (x if x.data_ptr() % 16 == 0 else x.clone()
                  for x in (rows.lf.contiguous(), rows.af.contiguous()))
        Rl, Ra = lf.shape[1], af.shape[1]
        for name, lib in (("parent", old), ("new", new)):
            scratch = (torch.empty((T, Rl + Ra, rs.REC), device=dev),
                       torch.empty((T, Rl + Ra, 2), dtype=torch.int32,
                                   device=dev))
            out = torch.empty((T, 2, B, 6), device=dev)
            a = rs._Args(m0.data_ptr(), massinv.data_ptr(), lf.data_ptr(),
                         af.data_ptr(), scratch[0].data_ptr(),
                         scratch[1].data_ptr(), out.data_ptr(), 0, T, B, Rl,
                         Ra, it, ip, rows.jmax)
            launches[key, name] = (lib.hts_row_sweep,
                                   (ctypes.byref(a), stream), out,
                                   (a, scratch))
    res = {"device": smi, "ptxas": ptx, "times": {}, "equal": {}}
    for key in ("pgs dynamics", "row_sweep", "row_sweep[colored]"):
        outs = {}
        for name in ("parent", "new"):
            fn, a, out, _ = launches[key, name]
            assert fn(*a) == 0, (key, name)
            torch.cuda.synchronize()
            outs[name] = out.clone()
        res["equal"][key] = torch.equal(outs["parent"], outs["new"])
        if not res["equal"][key]:
            raise SystemExit(f"chip_ab: {key}: the two trees differ")
        for name in ("parent", "new", "new", "parent") * 2:
            fn, a, _, _ = launches[key, name]
            ms, _ = s.event_ms(fn, a, warm=2, reps=20)
            res["times"].setdefault(key, {}).setdefault(name, []).append(ms)
        print(key, json.dumps({k: [round(x, 4) for x in v] for k, v in
                               res["times"][key].items()}), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps({"ok": True, "device": smi}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--json")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    return ab(args)


if __name__ == "__main__":
    sys.exit(main())
