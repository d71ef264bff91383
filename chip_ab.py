#!/usr/bin/env python3
"""A/B of redesigned kernels on one NVIDIA GPU: this tree's kernels against
an earlier tree's, on chip_smoke.py's inputs.  Run from the repository
root:

    python3 chip_ab.py --parent DIR [--kernel solves|prof_cloud] [--json PATH]

--kernel solves (the default): the two solve kernels, the row sweep and
the PGS kernel.  DIR holds an earlier tree's row_sweep.cu, pgs_kernel.cu
and common.cuh, e.g. `git archive <commit> hand_tracking_samples_tpu_torch/csrc`
unpacked under build/; its argument records are those of the tree before
the jacobi redesign (its PGS class record has no compact-copy pointer, its
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

--kernel prof_cloud: the profiling kernels of csrc/prof_cloud.cu, the
staged cloud kernel's five stages and the group sum at 1-16 tracks a
block.  DIR holds an earlier tree's prof_cloud.cu and common.cuh (its
hts_cloud_stage without the divisor, cluster, staging and counter
arguments).  Each tree's file is built by its own nvcc call, both at
once; ptxas's record of both, and the SASS of each stage kernel
(`cuobjdump -sass`): the subroutines it calls and whether any is a 64-bit
integer division or remainder.  On phase 4's renders (frame 0) at T=512:
both trees' stages held equal (stages 1-4 torch.equal, stage 0 within
chip_smoke.P22_SUM_REL, its bit equality recorded), this tree's also
equal to stage_plain, the group sums torch.equal; then timed earlier,
this, this, earlier, twice.  Then this tree's variants, each stage timed
in the same call and its clock64 counters a pass read from one more
launch (mean cycles a CTA): C = 1, 2, 4, 8 CTAs a track reading the
raster from device memory, and C = 2, 4, 8 with the slices copied into
shared memory, each with its shared memory and
cudaOccupancyMaxActiveClusters.
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
    if args.kernel == "prof_cloud":
        return ab_prof_cloud(args)
    from types import SimpleNamespace

    import torch
    import chip_smoke
    from hand_tracking_samples_tpu_torch import kernels
    from hand_tracking_samples_tpu_torch.physics import pgs_kernel as pk
    from hand_tracking_samples_tpu_torch.physics import row_sweep as rs
    srcs = ("row_sweep.cu", "pgs_kernel.cu", "common.cuh")

    libs = _build_many({"parent": (args.parent, srcs, 2),
                        "new": (kernels.SRC_DIR, srcs, 2)})
    (old, old_log, _), (new, new_log, _) = libs["parent"], libs["new"]
    for lib in (old, new):
        lib.hts_row_sweep.argtypes = [ctypes.c_void_p] * 2
        lib.hts_pgs_solve.argtypes = [ctypes.c_void_p] * 2
    pick = lambda log: {k: v for k, v in kernels.ptxas_summary(log).items()
                        if "pgs" in k or "row_sweep" in k}
    ptx = {"parent": pick(old_log), "new": pick(new_log)}
    if not ptx["parent"] or len([k for k in ptx["new"]
                                 if "pgs_kernel" in k]) != 2:
        raise RuntimeError(f"chip_ab: ptxas reported no parent kernel or "
                           f"not the PGS kernel's two instances: {ptx}")
    smi = _smi()
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


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def _build_many(jobs):
    """jobs: {name: (source dir, files, first n files compiled)}: each
    copied under build/chip_ab/<name>/ and built by its own nvcc call, all
    at once.  Returns {name: (ctypes library, its ptxas log, path)}."""
    from hand_tracking_samples_tpu_torch import kernels
    procs = {}
    for name, (src, files, ncu) in jobs.items():
        d = os.path.join(REPO, "build", "chip_ab", name)
        os.makedirs(d, exist_ok=True)
        for f in files:
            with open(os.path.join(os.path.abspath(src), f)) as fh:
                text = fh.read()
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
        lib_path = os.path.join(d, f"lib_{name}.so")
        procs[name] = (lib_path, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", d, "-o", lib_path,
             *[os.path.join(d, f) for f in files[:ncu]]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib_path, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"chip_ab: {name} did not build:\n"
                               f"{log[-2000:]}")
        out[name] = (ctypes.CDLL(lib_path), log, lib_path)
    return out


def sass_calls(lib_path: str, match: str) -> dict:
    """{function: [its CALL instructions' targets]} for the functions of
    the library whose name contains `match` (cuobjdump -sass)."""
    import re
    from hand_tracking_samples_tpu_torch import kernels
    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if match in m.group(1) else None
            if name:
                out[name] = []
        elif name:
            m = re.search(r"CALL\S*\s+([^;]+);", line)
            if m:
                out[name].append(m.group(1).strip())
    return out


def div64_routines(lib_path: str) -> list:
    """The 64-bit integer division and remainder routines (nvcc's
    __cuda_sm*_div_s64 and kin) named in the library's code, by cuobjdump
    -sass and by nvdisasm of its cubins."""
    import re
    import tempfile
    from hand_tracking_samples_tpu_torch import kernels
    bindir = os.path.dirname(kernels._nvcc())
    pat = re.compile(r"__cuda_sm\w*_(?:div|rem)\w*64\w*")
    text = subprocess.run([os.path.join(bindir, "cuobjdump"), "-sass",
                           lib_path], capture_output=True, text=True).stdout
    found = set(pat.findall(text))
    with tempfile.TemporaryDirectory() as d:
        subprocess.run([os.path.join(bindir, "cuobjdump"), "-xelf", "all",
                        lib_path], cwd=d, capture_output=True)
        for f in os.listdir(d):
            found |= set(pat.findall(subprocess.run(
                [os.path.join(bindir, "nvdisasm"), os.path.join(d, f)],
                capture_output=True, text=True).stdout))
    return sorted(found)


def ab_prof_cloud(args) -> int:
    """The staged cloud kernel and the group sum of this tree against the
    earlier tree's in args.parent, then this tree's variants."""
    import torch
    import chip_smoke
    from hand_tracking_samples_tpu_torch import kernels
    from hand_tracking_samples_tpu_torch.ops.cloud_kernel import (
        depth_tensor, synthetic_depths)
    from hand_tracking_samples_tpu_torch.tools import prof_cloud_kernel as pk
    from hand_tracking_samples_tpu_torch.tools.common import to_raster
    files = ("prof_cloud.cu", "common.cuh")
    libs = _build_many({"prof_parent": (args.parent, files, 1),
                        "prof_new": (kernels.SRC_DIR, files, 1)})
    old, old_log, old_path = libs["prof_parent"]
    new, new_log, new_path = libs["prof_new"]
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    old.hts_cloud_stage.argtypes = [P, P, I, I, I, I, I, I, F, F, F, P]
    new.hts_cloud_stage.argtypes = [P, P, I, I, I, I, ctypes.c_uint, I, I,
                                    I, F, F, F, I, I, P, P]
    new.hts_cloud_stage_config.argtypes = [I] * 6 + [P]
    for lib in (old, new):
        lib.hts_group_sum.argtypes = [P, P, I, ctypes.c_longlong, F, P]
    pick = lambda log: {k: v for k, v in kernels.ptxas_summary(log).items()
                        if "cloud_stage" in k or "group_sum" in k}
    ptx = {"parent": pick(old_log), "new": pick(new_log)}
    calls = {"parent": sass_calls(old_path, "cloud_stage"),
             "new": sass_calls(new_path, "cloud_stage")}
    div64 = {side: div64_routines(path)
             for side, path in (("parent", old_path), ("new", new_path))}
    ncalls = {side: {k: len(v) for k, v in cs.items()}
              for side, cs in calls.items()}
    smi = _smi()
    print(smi, "ptxas", json.dumps(ptx), flush=True)
    print("SASS CALLs a stage kernel", json.dumps(ncalls), "; 64-bit "
          "division routines", json.dumps(div64), flush=True)
    if not ptx["new"] or not ptx["parent"] or not calls["new"]:
        raise RuntimeError(f"chip_ab: no stage kernel in the ptxas or SASS "
                           f"record: {ptx} {calls}")

    s = chip_smoke.Smoke()
    dev = s.dev
    stream = kernels.stream_ptr(dev)
    draw = to_raster(s.depth_frame(0, T)).contiguous()
    seeded = to_raster(depth_tensor(synthetic_depths(T, 240, 320, seed=23),
                                    dev)).contiguous()
    scal = pk.scalars()
    lo, hi, scale = scal[:3]
    S, frac, W = pk.BUDGET, pk.FRAC, pk.WIDTH
    R = draw.shape[1]
    fm, fs = pk.frac_divisor(frac)
    outs = {k: torch.empty((T, S, 8), device=dev)
            for k in ("parent", "new")}

    def old_stage(x, st):
        return (old.hts_cloud_stage, (x.data_ptr(), outs["parent"].data_ptr(),
                                      T, R * 128, W, frac, S, st, lo, hi,
                                      scale, stream))

    def new_stage(x, st, C=0, staged=-1, cyc=None):
        return (new.hts_cloud_stage, (
            x.data_ptr(), outs["new"].data_ptr(), T, R * 128, W, frac, fm, fs,
            S, st, lo, hi, scale, C, staged,
            0 if cyc is None else cyc.data_ptr(), stream))

    def run(launch):
        fn, a = launch
        err = fn(*a)
        if err != 0:
            raise RuntimeError(f"chip_ab: launch failed: cudaError {err}")

    def config(st, C, staged):
        res = (ctypes.c_int * 5)()
        kernels.check(new.hts_cloud_stage_config(R * 128, frac, S, st, C,
                                                 staged, res), "config")
        return dict(zip(("C", "staged", "smem", "max_active_clusters",
                         "thin32"), list(res)))

    res = {"device": smi, "ptxas": ptx, "sass_calls": calls,
           "sass_call_count": ncalls, "div64_routines": div64, "times": {}, "equal": {},
           "max_abs_err": {}, "variants": {}}
    rel = chip_smoke.P22_SUM_REL
    for label, x in (("renders", draw), ("seeded", seeded)):
        for st in range(5):
            run(old_stage(x, st))
            run(new_stage(x, st))
            torch.cuda.synchronize()
            a, b = outs["parent"].clone(), outs["new"].clone()
            plain = pk.stage_plain(x, scal, st, S, frac, W)
            eq = torch.equal(a, b)
            key = f"cloud_stage[{st}] {label}"
            res["equal"][key] = eq
            res["max_abs_err"][key] = (a - b).abs().max().item()
            ok = eq if st else bool(((a - b).abs() <= rel * a.abs()).all())
            ok_plain = (torch.equal(b, plain) if st else bool(
                ((b - plain).abs() <= rel * plain.abs()).all()))
            if not (ok and ok_plain):
                raise SystemExit(f"chip_ab: {key}: parent / plain differ "
                                 f"(equal to parent {eq}, plain {ok_plain})")
    cases = {}
    for st in range(5):
        cases[f"cloud_stage[{st}]"] = (old_stage(draw, st),
                                       new_stage(draw, st))
    gout = {k: torch.empty((T, 8, 128), device=dev)
            for k in ("parent", "new")}
    for trk in chip_smoke.P22_TRK:
        x = draw.reshape(T // trk, -1)
        la = [(lib.hts_group_sum, (x.data_ptr(), gout[k].data_ptr(),
                                   T // trk, x.shape[1], scale, stream))
              for k, lib in (("parent", old), ("new", new))]
        for launch in la:
            run(launch)
        torch.cuda.synchronize()
        eq = torch.equal(gout["parent"][:T // trk], gout["new"][:T // trk])
        res["equal"][f"group_sum[trk={trk}]"] = eq
        if not eq:
            raise SystemExit(f"chip_ab: group_sum[trk={trk}]: the two trees "
                             f"differ")
        cases[f"group_sum[trk={trk}]"] = tuple(la)
    for key, (la, lb) in cases.items():
        times = res["times"][key] = {"parent": [], "new": []}
        for name in ("parent", "new", "new", "parent") * 2:
            fn, a = lb if name == "new" else la
            ms, _ = s.event_ms(fn, a, warm=2, reps=20)
            times[name].append(ms)
        print(key, json.dumps({k: [round(v, 4) for v in x]
                               for k, x in times.items()}), flush=True)
    # this tree's variants: C CTAs a track, from device memory or staged
    variants = [(C, 0) for C in (1, 2, 4, 8)] + [(C, 1) for C in (2, 4, 8)]
    plains = [pk.stage_plain(draw, scal, st, S, frac, W) for st in range(5)]
    for C, staged in variants:
        name = f"C={C} {'staged' if staged else 'device memory'}"
        v = res["variants"][name] = {"config": config(4, C, staged),
                                     "ms": {}, "cycles": {}}
        for st in range(5):
            ms = [s.event_ms(*new_stage(draw, st, C, staged), warm=2,
                             reps=20)[0] for _ in range(2)]
            cyc = torch.zeros((T * C, 8), dtype=torch.int64, device=dev)
            run(new_stage(draw, st, C, staged, cyc))
            torch.cuda.synchronize()
            b, want = outs["new"], plains[st]
            if not (torch.equal(b, want) if st else bool(
                    ((b - want).abs() <= rel * want.abs()).all())):
                raise SystemExit(f"chip_ab: {name} stage {st} differs from "
                                 f"stage_plain")
            c = cyc.double()
            v["ms"][st] = ms
            v["cycles"][st] = dict(zip(
                ("pass1", "row_scan", "exchange1", "stage_pass",
                 "exchange2_fill", "cta"), c[:, :6].mean(0).tolist()))
            v["cycles"][st]["cta_max"] = c[:, 5].max().item()
            v["cycles"][st]["sms"] = int(torch.unique(cyc[:, 6]).numel())
        print(name, json.dumps(v), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps({"ok": True, "device": smi}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--kernel", choices=("solves", "prof_cloud"),
                    default="solves")
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
