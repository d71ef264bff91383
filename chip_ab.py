#!/usr/bin/env python3
"""A/B of the cloud-rows kernels (2, 2.5, 6 and 7) on one NVIDIA GPU: this
tree's kernels against an earlier tree's, and against variants of this
tree's kernel 6, on chip_smoke.py's inputs.  Run from the repository root:

    python3 chip_ab.py --parent DIR [--json PATH]

DIR holds an earlier tree's cloud_rows.cu and common.cuh with this tree's
C interface but for hts_cloud_rows_unpacked, which there takes no evals
argument, e.g. `git archive <commit> hand_tracking_samples_tpu_torch/csrc`
unpacked under build/.  Each library is built by its own nvcc call
(kernels.NVCC_FLAGS) under build/chip_ab/, all started together.  Every
output of this tree's kernels and of the variants is held to the plain
PyTorch version (torch.equal) before it is timed; the earlier kernel 6's
difference from it is recorded.  Times are CUDA events over repeated
launches, in the order earlier, this, this, earlier (then the variants
twice each), ms a launch.  Kernel 6 is timed at T=512 on phase 8's
UnibodyFit inputs (the reset's rows at the PoseFromScratch pose, N=512),
on their T=128 subset (every 4th track: the tracks the CNN frame resets on
its first frame) and on a synthetic_cloud; its variants report the share
of hull planes their scan took (the evals counter) and ptxas's registers.
The variants named x_* drop a part of the row pass (x_norows all of it
and the stores) and are timed only, for the time each part takes.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
CR = "cloud_rows.cu"
T = 512
VARIANTS = {   # kernel 6's: name -> [(text, replacement)] in cloud_rows.cu
    "k6_noexit": [("if (__all_sync(0xffffffffu, lost)) break;", "")],
    "k6_chunk4": [("#define CV_CHUNK 8", "#define CV_CHUNK 4")],
    "k6_chunk16": [("#define CV_CHUNK 8", "#define CV_CHUNK 16")],
    "k6_2blocks": [("#define UR_THREADS 512", "#define UR_THREADS 256")],
    "k6_4blocks": [("#define UR_THREADS 512", "#define UR_THREADS 128")],
    "k6_k2": [("#define UR_THREADS 512", "#define UR_THREADS 256"),
              ("#define UR_K 1", "#define UR_K 2")],
    "k6_k4": [("#define UR_THREADS 512", "#define UR_THREADS 128"),
              ("#define UR_K 1", "#define UR_K 4")],
    # timing only (their rows differ by construction): the kernel without
    # a part of its row pass, for the time each part takes
    "x_noblend": [("  if (hull) {          // the blend",
                   "  if (false) {          // the blend")],
    "x_noclip": [("  if (front) {         // the slab clip",
                  "  if (false) {         // the slab clip")],
    "x_nodiv": [("den != 0.0f ? dw0 / den : 0.0f", "den != 0.0f ? dw0 * den "
                 ": 0.0f")],
    "x_norows": [("    if (p >= N) continue;\n    const bool hull",
                  "    continue;\n    const bool hull")],
}
# a warp's points (32 x the points a thread)
WARP_POINTS = {"k6_k2": 64, "k6_k4": 128}


def build(kernels, name, src, subs=()):
    """Start one nvcc build of cloud_rows.cu from `src` with `subs`
    applied; returns (name, library path, process)."""
    d = os.path.join(REPO, "build", "chip_ab", name)
    os.makedirs(d, exist_ok=True)
    for f in (CR, "common.cuh"):
        with open(os.path.join(src, f)) as fh:
            text = fh.read()
        for old, new in subs if f == CR else ():
            assert old in text, (name, old)
            text = text.replace(old, new)
        with open(os.path.join(d, f), "w") as fh:
            fh.write(text)
    lib = os.path.join(d, f"lib_{name}.so")
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", d, "-o", lib,
           os.path.join(d, CR)]
    return name, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)


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
    import chip_smoke
    from hand_tracking_samples_tpu_torch import kernels
    from hand_tracking_samples_tpu_torch.ops import cloud_rows as crm
    new_src = os.path.join(REPO, "hand_tracking_samples_tpu_torch", "csrc")
    jobs = [build(kernels, "parent", os.path.abspath(args.parent))]
    jobs += [build(kernels, n, new_src, subs) for n, subs in VARIANTS.items()]
    libs = {"new": kernels.library()}
    P, I = ctypes.c_void_p, ctypes.c_int
    ptx = {}
    for name, path, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"chip_ab: {name} did not build:\n{log[-2000:]}")
            return 1
        lib = ctypes.CDLL(path)
        lib.hts_cloud_rows_unpacked.argtypes = (
            [P] * 5 + [I] * 4 + [P] if name == "parent"
            else [P] * 6 + [I] * 4 + [P])
        lib.hts_cloud_vals.argtypes = [P] * 5 + [I] * 4 + [P]
        lib.hts_cloud_rows_solve.argtypes = [P] * 6 + [I] * 6 + [P]
        lib.hts_cloud_rows_packed.argtypes = [P] * 6 + [I] * 6 + [P]
        libs[name] = lib
        ptx[name] = kernels.ptxas_summary(log)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    print("ptxas", json.dumps({n: {k: v for k, v in p.items()
                                   if "unpacked" in k or "vals" in k}
                               for n, p in ptx.items()}), flush=True)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    s = chip_smoke.Smoke()
    dev = s.dev

    # each kernel's launch: (library function, its arguments, output),
    # the arguments prepared once so that the host issues a timed launch
    # well inside the kernel's time
    def k6(name, pts, planes, body, misc, evals=None):
        n, _, N = pts.shape
        out = torch.empty((n, 8, N), device=dev)
        a = [pts.data_ptr(), planes.data_ptr(), body.data_ptr(),
             misc.data_ptr(), out.data_ptr()]
        if name != "parent":
            a.append(0 if evals is None else evals.data_ptr())
        a += [n, N, planes.shape[1] // 5, planes.shape[2], stream()]
        return libs[name].hts_cloud_rows_unpacked, a, out

    def k7(name, pts, planes, body, misc):
        n, _, N = pts.shape
        out = torch.empty((n, 2, N), device=dev)
        return libs[name].hts_cloud_vals, [
            pts.data_ptr(), planes.data_ptr(), body.data_ptr(),
            out.data_ptr(), 0, n, N, planes.shape[1] // 5, planes.shape[2],
            stream()], out

    def pack(name, fn, pts, planes, body, misc, C):
        n, _, N = pts.shape
        ch = 12 if fn == "hts_cloud_rows_solve" else 16
        out = (torch.empty((n, ch, 24 * C), device=dev),
               torch.empty((n, 24), device=dev))
        return getattr(libs[name], fn), [
            pts.data_ptr(), planes.data_ptr(), body.data_ptr(),
            misc.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), n, N,
            planes.shape[1] // 5, planes.shape[2], C, 24, stream()], out

    def run(launch):
        fn, a, out = launch
        err = fn(*a)
        assert err == 0, err
        return out

    res = {"device": smi, "ptxas": ptx, "times": {}, "checks": {},
           "k6_scanned_share": {}}

    def timed(key, names, launch, reps):
        """launch(name): the prepared launch of `name`'s kernel."""
        for name in names:
            fn, a, out = launch(name)
            run((fn, a, out))
            ms, _ = s.event_ms(fn, a, warm=2, reps=reps)
            res["times"].setdefault(key, {}).setdefault(name, []).append(ms)
        print(key, json.dumps({k: [round(x, 4) for x in v] for k, v in
                               res["times"][key].items()}), flush=True)

    def hold(key, ok):
        res["checks"][key] = bool(ok)
        if not ok:
            raise SystemExit(f"chip_ab: {key} differs")

    ab = ["parent", "new", "new", "parent"]
    # kernels 6 and 7: phase 8's CNN-frame inputs (after 8 frames) and
    # ops.cloud_rows.synthetic_cloud around the initial poses
    s.cnn_setup()
    st, _ = s.cnn_run(s.cnn_state(T), 8, T)
    inp = s.cnn_kernel_inputs(st, s.cnn_depth(7, T))
    pose = s.init_state(T).body.pose
    rest = crm._kernel_inputs_ph(pose, s.model, (0.0, 0.0, 0.0),
                                 torch.zeros(pose.shape[1], device=dev), 0.0)
    # the raw calls below take contiguous tensors, as the wrappers make
    # them (UnibodyFit's compacted cloud is a slice)
    ua = tuple(x.contiguous() for x in inp["cloud_rows_unpacked"])
    rows = {"phase8 T=512": ua,
            "phase8 T=128": tuple(x[3::4].contiguous() for x in ua),
            "synthetic T=512": (crm.synthetic_cloud(pose, 512, seed=T + 512),)
            + rest}
    k6names = ["new"] + list(VARIANTS)
    for key, a in rows.items():
        p = crm.cloud_rows_unpacked_plain(*a)
        res["checks"][f"k6 {key} parent max_abs_err"] = \
            (run(k6("parent", *a)) - p).abs().max().item()
        n, _, N = a[0].shape
        Pn, B = a[1].shape[1] // 5, a[1].shape[2]
        for name in k6names:
            if name[:2] != "x_":
                hold(f"k6 {key} {name}", torch.equal(run(k6(name, *a)), p))
            ev = torch.zeros(n, dtype=torch.int64, device=dev)
            run(k6(name, *a, evals=ev))
            wp = WARP_POINTS.get(name, 32)
            full = n * -(-N // wp) * B * (-(-Pn // 8) * 8)
            res["k6_scanned_share"][f"{key} {name}"] = int(ev.sum()) / full
        timed(f"k6 {key}", ab + (k6names[1:] * 2 if key[:6] == "phase8"
                                 else []), lambda name: k6(name, *a), 50)
    print("k6 scanned share", json.dumps(res["k6_scanned_share"]),
          flush=True)
    vals = {"phase8": tuple(x.contiguous() for x in inp["cloud_vals"]),
            "synthetic": (crm.synthetic_cloud(pose, 2048, seed=T + 2048),)
            + rest}
    for key, a in vals.items():
        p = crm.cloud_vals_plain(*a[:3])
        for name in ("parent", "new"):
            hold(f"k7 {key} {name}", torch.equal(run(k7(name, *a)), p))
        timed(f"k7 {key}", ab, lambda name: k7(name, *a), 20)

    # kernels 2 and 2.5: phase 14's inputs (one cutting-plane frame in)
    st, _ = s.run(s.init_state(T), 1, T, cfg=s.cloud_cfg(
        "mirror", plane=chip_smoke.CUT_PLANE))
    for fn, dt in (("hts_cloud_rows_solve", s.params.deltaT),
                   ("hts_cloud_rows_packed", 0.0)):
        for n, a in s.pack_inputs(st, s.depth_frame(1, T), dt).items():
            ko, kn = run(pack("parent", fn, *a)), run(pack("new", fn, *a))
            hold(f"{fn} N={n}", all(torch.equal(x, y) for x, y in
                                    zip(ko, kn)))
            timed(f"{fn} N={n}", ab, lambda name: pack(name, fn, *a), 20)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps({"ok": True, "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
