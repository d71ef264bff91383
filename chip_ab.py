#!/usr/bin/env python3
"""A/B of the two solve kernels, the row sweep and the PGS kernel, on one
NVIDIA GPU: this tree's kernels against an earlier tree's, on
chip_smoke.py's inputs.  Run from the repository root:

    python3 chip_ab.py --parent DIR [--json PATH]

DIR holds an earlier tree's row_sweep.cu, pgs_kernel.cu and common.cuh,
e.g. `git archive <commit> hand_tracking_samples_tpu_torch/csrc` unpacked
under build/; its argument records are those of the tree before the
jacobi redesign (its PGS class record has no compact-copy pointer, its
row-sweep arguments no jacobi level count).  Each tree's two solves are
built by one nvcc call (kernels.NVCC_FLAGS) under build/chip_ab/, and
ptxas's registers and stack of both are recorded.  The inputs,
T=512:
  exact contacts   the dynamics frame's PGS solve after 3 frames, the CNN
                   frame's multistep and unibody solves (phase 7's start),
                   a sequential and a colored frame's rows for the row
                   sweep (chip_smoke's phases 5, 8, 9);
  contact poses    phase 18's: the PGS dynamics and multistep plans and
                   the colored row sweep, each with jacobi contacts and
                   with exact ones on the same poses.
The outputs of both trees are held equal (torch.equal) before they are
timed.  Times are CUDA events over repeated launches, in the order
earlier, this, this, earlier, twice, ms a launch.
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
    from types import SimpleNamespace

    import torch
    import chip_smoke
    from hand_tracking_samples_tpu_torch import kernels
    from hand_tracking_samples_tpu_torch.physics import pgs_kernel as pk
    from hand_tracking_samples_tpu_torch.physics import row_sweep as rs
    srcs = ("row_sweep.cu", "pgs_kernel.cu", "common.cuh")

    def build(src, name):
        """The two solves of the tree in src, built by one nvcc call into
        build/chip_ab/<name>/: (library, its ptxas log)."""
        d = os.path.join(REPO, "build", "chip_ab", name)
        os.makedirs(d, exist_ok=True)
        for f in srcs:
            with open(os.path.join(os.path.abspath(src), f)) as fh:
                text = fh.read()
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
        lib_path = os.path.join(d, "lib_solves.so")
        r = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", d,
                            "-o", lib_path,
                            *[os.path.join(d, f) for f in srcs[:2]]],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"chip_ab: the {name} solves did not build:\n"
                               f"{(r.stdout + r.stderr)[-2000:]}")
        lib = ctypes.CDLL(lib_path)
        lib.hts_row_sweep.argtypes = [ctypes.c_void_p] * 2
        lib.hts_pgs_solve.argtypes = [ctypes.c_void_p] * 2
        return lib, r.stdout + r.stderr

    old, old_log = build(args.parent, "parent")
    new, new_log = build(kernels.SRC_DIR, "new")
    pick = lambda log: {k: v for k, v in kernels.ptxas_summary(log).items()
                        if "pgs" in k or "row_sweep" in k}
    ptx = {"parent": pick(old_log), "new": pick(new_log)}
    if not ptx["parent"] or len([k for k in ptx["new"]
                                 if "pgs_kernel" in k]) != 2:
        raise RuntimeError(f"chip_ab: ptxas reported no parent kernel or "
                           f"not the PGS kernel's two instances: {ptx}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, "ptxas", json.dumps(ptx), flush=True)

    class OldClass(ctypes.Structure):   # the earlier tree's PgsClass
        _fields_ = [(n, t) for n, t in pk._Class._fields_
                    if n != "jrows"]

    class OldArgs(ctypes.Structure):
        _fields_ = [(n, t) for n, t in pk._Args._fields_[:-2]] + [
            ("lin", OldClass * pk.MAX_CLASSES),
            ("ang", OldClass * pk.MAX_CLASSES)]

    class OldSweep(ctypes.Structure):   # the earlier tree's RowSweepArgs
        _fields_ = rs._Args._fields_[:-1]

    s = chip_smoke.Smoke()
    dev = s.dev
    stream = kernels.stream_ptr(dev)

    def pgs(inputs):
        """(earlier, this) launches of the PGS kernel on pgs_solve's
        arguments, each (entry, its arguments, out, what it holds)."""
        plan, it, ip, mom0, mi, singles, lin, ang = inputs
        pk.check_plan(plan, mom0.shape[2])
        mom0, mi = mom0.contiguous(), mi.contiguous()
        lin = [pk._aligned(x.contiguous()) for x in lin]
        ang = [pk._aligned(x.contiguous()) for x in ang]
        singles = pk._aligned(singles.contiguous()) if plan.CS else None
        ids = pk._unit_ids(plan, dev)
        res = []
        for name, lib in (("parent", old), ("new", new)):
            out = torch.empty((T, 2, 6, plan.bp), device=dev)
            a, keep = pk.kernel_args(plan, it, ip, mom0, mi, singles, lin,
                                     ang, out)
            if name == "parent":
                b = OldArgs()
                for f, _ in OldArgs._fields_[:-2]:
                    setattr(b, f, getattr(a, f))
                for k, c in enumerate(a.lin):
                    b.lin[k] = OldClass(*[getattr(c, f) for f, _ in
                                          OldClass._fields_])
                for k, c in enumerate(a.ang):
                    b.ang[k] = OldClass(*[getattr(c, f) for f, _ in
                                          OldClass._fields_])
                a = b
            res.append((lib.hts_pgs_solve, (ctypes.byref(a), stream), out,
                        (a, keep, mom0, mi, lin, ang, singles, ids)))
        return res

    def sweep(inputs):
        m0, massinv, rows, it, ip = inputs
        B = m0.shape[1]
        lf, af = (x if x.data_ptr() % 16 == 0 else x.clone()
                  for x in (rows.lf.contiguous(), rows.af.contiguous()))
        Rl, Ra = lf.shape[1], af.shape[1]
        res = []
        for name, lib in (("parent", old), ("new", new)):
            scratch = (torch.empty((T, Rl + Ra, rs.REC), device=dev),
                       torch.empty((T, Rl + Ra, 2), dtype=torch.int32,
                                   device=dev))
            out = torch.empty((T, 2, B, 6), device=dev)
            vals = (m0.data_ptr(), massinv.data_ptr(), lf.data_ptr(),
                    af.data_ptr(), scratch[0].data_ptr(),
                    scratch[1].data_ptr(), out.data_ptr(), 0, T, B, Rl, Ra,
                    it, ip, rows.jmax)
            a = (OldSweep(*vals) if name == "parent"
                 else rs._Args(*vals, rows.jlev))
            res.append((lib.hts_row_sweep, (ctypes.byref(a), stream), out,
                        (a, scratch, lf, af)))
        return res

    cases = {}
    # exact contacts: the dynamics frame, the CNN frame, the reference rows
    st, _ = s.run(s.init_state(T), 3, T)
    depth = s.depth_frame(3, T)
    cases["pgs dynamics"] = pgs(s.kernel_inputs(st, depth)["pgs_solve"])
    s.cnn_setup()
    cnn = s.cnn_kernel_inputs(s.cnn_state(T), s.cnn_depth(0, T))
    cases["pgs multistep"] = pgs(cnn["pgs_solve[multistep]"])
    cases["pgs unibody"] = pgs(cnn["pgs_solve[unibody]"])
    inp = s.ref_inputs(st.body, depth)
    cases["row_sweep"] = sweep(inp["row_sweep"])
    cases["row_sweep[colored]"] = sweep(inp["row_sweep[colored]"])
    # the contact poses (phase 18), jacobi and exact contacts
    frames, body = s.contact_poses()
    cdepth = s.contact_depth(frames)
    cst = SimpleNamespace(body=body)
    for mode in ("jacobi", "exact"):
        cases[f"pgs dynamics, contact poses, {mode}"] = pgs(
            s.kernel_inputs(cst, cdepth, mode)["pgs_solve"])
        cases[f"pgs multistep, contact poses, {mode}"] = pgs(
            s.cnn_kernel_inputs(cst, cdepth, mode)["pgs_solve[multistep]"])
        cases[f"row_sweep[colored], contact poses, {mode}"] = sweep(
            s.ref_inputs(body, cdepth, mode)["row_sweep[colored]"])
    res = {"device": smi, "ptxas": ptx, "times": {}, "equal": {}}
    for key, launches in cases.items():
        outs = []
        for fn, a, out, _ in launches:
            assert fn(*a) == 0, key
            torch.cuda.synchronize()
            outs.append(out.clone())
        res["equal"][key] = torch.equal(*outs)
        if not res["equal"][key]:
            raise SystemExit(f"chip_ab: {key}: the two trees differ")
        times = res["times"][key] = {"parent": [], "new": []}
        for name in ("parent", "new", "new", "parent") * 2:
            fn, a, _, _ = launches[name == "new"]
            ms, _ = s.event_ms(fn, a, warm=2, reps=20)
            times[name].append(ms)
        print(key, json.dumps({k: [round(x, 4) for x in v]
                               for k, v in times.items()}), flush=True)
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
