#!/usr/bin/env python3
"""A/B of the cloud kernel (1) and the vals kernel (7) on one NVIDIA GPU:
this tree's kernels against an earlier tree's, and against variants of
this tree's sources, at T=512 on chip_smoke.py's inputs.  Run from the
repository root:

    python3 chip_ab.py --parent DIR [--json PATH]

DIR holds an earlier tree's cloud_kernel.cu, cloud_rows.cu and common.cuh
with the C interface they had before the vals kernel got its own entry
point (hts_cloud_from_depth with a scratch row, hts_cloud_rows_unpacked
with a vals_only flag), e.g. `git archive <commit>
hand_tracking_samples_tpu_torch/csrc` unpacked under build/.  Each library
is built by its own nvcc call (kernels.NVCC_FLAGS) under build/chip_ab/.  Every output is held to the plain PyTorch version
(torch.equal) before it is timed; kernels 2, 2.5 and 6, whose sources did
not change, are held to the earlier tree's bit for bit and timed beside
it.  Times are CUDA events over repeated launches, in the order earlier,
this, this, earlier (then the variants twice), ms a launch.  The cloud
kernel's "stamped" variant writes clock64 stamps at its phase boundaries
and reports the cycles a block spends in each.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CK, CR = "cloud_kernel.cu", "cloud_rows.cu"
T = 512
# the stamped cloud kernel: clock64 at the start of pass 1, before the
# scan, before pass 3 and before the strided loop, by thread 0 of a block
STAMPS = [
    (CK, '#include "common.cuh"', '#include "common.cuh"\n'
     "__device__ unsigned long long ck_stamps[1024 * 4];\n"
     'extern "C" __attribute__((visibility("default"))) int '
     "ck_read_stamps(void* dst) {\n  return (int)cudaMemcpyFromSymbol("
     "dst, ck_stamps, sizeof(ck_stamps));\n}\n"
     "#define CK_STAMP(k) if (threadIdx.x == 0) "
     "ck_stamps[blockIdx.x * 4 + (k)] = clock64()"),
    (CK, "  // pass 1: the valid masks", "  CK_STAMP(0);\n"
     "  // pass 1: the valid masks"),
    (CK, "  ck_block_scan(vt, vtt, ntile);", "  CK_STAMP(1);\n"
     "  ck_block_scan(vt, vtt, ntile);"),
    (CK, "  // pass 3: each kept", "  CK_STAMP(2);\n  // pass 3: each kept"),
    (CK, "  // the constant rows, and the empty",
     "  CK_STAMP(3);\n  // the constant rows, and the empty"),
]
VARIANTS = {   # name: (file, [(text, replacement)])
    "k1_stamped": (CK, [x[1:] for x in STAMPS]),
    "k1_256": (CK, [("#define CK_THREADS 512", "#define CK_THREADS 256")]),
    "k1_1024": (CK, [("#define CK_THREADS 512", "#define CK_THREADS 1024")]),
    "k1_unroll2": (CK, [("#define CK_UNROLL 4", "#define CK_UNROLL 2")]),
    "k1_unroll8": (CK, [("#define CK_UNROLL 4", "#define CK_UNROLL 8")]),
    "k7_noexit": (CR, [("if (__all_sync(0xffffffffu, lost)) break;", "")]),
    "k7_strided": (CR, [("p0 + j", "p0 + j * nt"),
                        ("blockIdx.y * (nt * CV_K) + tid * CV_K;",
                         "blockIdx.y * (nt * CV_K) + tid;")]),
    "k7_chunk4": (CR, [("#define CV_CHUNK 8", "#define CV_CHUNK 4")]),
    "k7_chunk16": (CR, [("#define CV_CHUNK 8", "#define CV_CHUNK 16")]),
    "k7_3blocks": (CR, [("__launch_bounds__(CV_THREADS, 2)",
                         "__launch_bounds__(CV_THREADS, 3)")]),
    "k7_256": (CR, [("#define CV_THREADS 512", "#define CV_THREADS 256"),
                    ("__launch_bounds__(CV_THREADS, 2)",
                     "__launch_bounds__(CV_THREADS, 4)")]),
}


def build(kernels, name, src, files, subs=()):
    """Start one nvcc build of `files` from `src` with `subs` applied;
    returns (name, library path, process)."""
    d = os.path.join(REPO, "build", "chip_ab", name)
    os.makedirs(d, exist_ok=True)
    for f in files + ["common.cuh"]:
        with open(os.path.join(src, f)) as fh:
            text = fh.read()
        for old, new in subs if f != "common.cuh" else ():
            assert old in text, (name, old)
            text = text.replace(old, new)
        with open(os.path.join(d, f), "w") as fh:
            fh.write(text)
    lib = os.path.join(d, f"lib_{name}.so")
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", d, "-o", lib,
           *[os.path.join(d, f) for f in files]]
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
    from hand_tracking_samples_tpu_torch.ops import cloud_kernel as ckm
    from hand_tracking_samples_tpu_torch.ops import cloud_rows as crm
    new_src = os.path.join(REPO, "hand_tracking_samples_tpu_torch", "csrc")
    jobs = [build(kernels, "parent", os.path.abspath(args.parent), [CK, CR])]
    jobs += [build(kernels, n, new_src, [f], subs)
             for n, (f, subs) in VARIANTS.items()]
    libs = {"new": kernels.library()}
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ptx = {}
    for name, path, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"chip_ab: {name} did not build:\n{log[-2000:]}")
            return 1
        lib = ctypes.CDLL(path)
        if name == "parent":
            lib.hts_cloud_from_depth.argtypes = [P, P, P] + [I] * 6 + [F] * 8 \
                + [P]
            lib.hts_cloud_rows_unpacked.argtypes = [P] * 5 + [I] * 5 + [P]
            lib.hts_cloud_rows_solve.argtypes = [P] * 6 + [I] * 6 + [P]
            lib.hts_cloud_rows_packed.argtypes = [P] * 6 + [I] * 6 + [P]
        elif name.startswith("k1"):
            lib.hts_cloud_from_depth.argtypes = [P, P] + [I] * 7 + [F] * 6 \
                + [P]
        else:
            lib.hts_cloud_vals.argtypes = [P] * 5 + [I] * 4 + [P]
        libs[name] = lib
        ptx[name] = {k: v for k, v in kernels.ptxas_summary(log).items()
                     if "cloud_from_depth" in k or "cloud_vals" in k}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    s = chip_smoke.Smoke()
    dev = s.dev

    def k1(name, depth, cam, lo, hi, frac, S):
        n, H, W = depth.shape
        k = ckm._scalars(cam, lo, hi, frac)
        out = torch.empty((n, 8, S), device=dev)
        sc = [k[x] for x in ("scale", "inv_frac", "cx", "cy", "rfx", "rfy")]
        if name == "parent":
            mk = -(-(H * W) // frac)
            scratch = torch.empty((n, mk), dtype=torch.int32, device=dev)
            err = libs[name].hts_cloud_from_depth(
                depth.data_ptr(), out.data_ptr(), scratch.data_ptr(), n, H,
                W, frac, S, mk, k["lo"], k["hi"], *sc, stream())
        else:
            ulo, uhi = ckm.valid_range(k["scale"], k["lo"], k["hi"])
            err = libs[name].hts_cloud_from_depth(
                depth.data_ptr(), out.data_ptr(), n, H, W, frac, S, ulo,
                uhi, *sc, stream())
        assert err == 0, err
        return out

    def k7(name, pts, planes, body, misc, evals=None):
        n, _, N = pts.shape
        Pn, B = planes.shape[1] // 5, planes.shape[2]
        out = torch.empty((n, 2, N), device=dev)
        if name == "parent":
            err = libs[name].hts_cloud_rows_unpacked(
                pts.data_ptr(), planes.data_ptr(), body.data_ptr(),
                misc.data_ptr(), out.data_ptr(), n, N, Pn, B, 1, stream())
        else:
            err = libs[name].hts_cloud_vals(
                pts.data_ptr(), planes.data_ptr(), body.data_ptr(),
                out.data_ptr(), 0 if evals is None else evals.data_ptr(), n,
                N, Pn, B, stream())
        assert err == 0, err
        return out

    def k6(name, pts, planes, body, misc):
        n, _, N = pts.shape
        a = [pts.data_ptr(), planes.data_ptr(), body.data_ptr(),
             misc.data_ptr()]
        out = torch.empty((n, 8, N), device=dev)
        a += [out.data_ptr(), n, N, planes.shape[1] // 5, planes.shape[2]]
        err = libs[name].hts_cloud_rows_unpacked(
            *a, *((0,) if name == "parent" else ()), stream())
        assert err == 0, err
        return out

    def pack(name, fn, pts, planes, body, misc, C):
        n, _, N = pts.shape
        ch = 12 if fn == "hts_cloud_rows_solve" else 16
        out = (torch.empty((n, ch, 24 * C), device=dev),
               torch.empty((n, 24), device=dev))
        err = getattr(libs[name], fn)(
            pts.data_ptr(), planes.data_ptr(), body.data_ptr(),
            misc.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), n, N,
            planes.shape[1] // 5, planes.shape[2], C, 24, stream())
        assert err == 0, err
        return out

    res = {"device": smi, "ptxas": ptx, "times": {}, "checks": {}}

    def timed(key, names, fn, reps):
        for name in names:
            ms, _ = s.event_ms(lambda: fn(name), (), warm=2, reps=reps)
            res["times"].setdefault(key, {}).setdefault(name, []).append(ms)
        print(key, json.dumps({k: [round(x, 4) for x in v] for k, v in
                               res["times"][key].items()}), flush=True)

    def hold(key, ok):
        res["checks"][key] = bool(ok)
        if not ok:
            raise SystemExit(f"chip_ab: {key} differs")

    ab = ["parent", "new", "new", "parent"]
    # the cloud kernel: phase 5's rasters (frame 29 after 30 frames) and
    # ops.cloud_kernel.synthetic_depths at frac 4 and 3
    cfg = s.cfg
    s.run(s.init_state(T), 30, T)
    inputs = {"phase5": (s.depth_frame(29, T), s.cam, 0.1, cfg.drangey,
                         cfg.subsample_fraction, cfg.point_budget)}
    for frac in (4, 3):
        d = ckm.depth_tensor(ckm.synthetic_depths(
            T, 240, 320, seed=T + frac, frac=frac, budget=2048), dev)
        inputs[f"synthetic_frac{frac}"] = (d, s.cam, 0.1, cfg.drangey, frac,
                                           2048)
    k1names = ["parent", "new"] + [n for n in libs if n[:2] == "k1"]
    for key, a in inputs.items():
        p = ckm.cloud_from_depth_planes_plain(*a)
        for name in k1names:
            hold(f"k1 {key} {name}", torch.equal(k1(name, *a), p))
        variants = [n for n in k1names[2:] if n != "k1_stamped"]
        timed(f"k1 {key}", ab + (variants * 2 if key == "phase5" else []),
              lambda name: k1(name, *a), 50)
    for _ in range(3):
        k1("k1_stamped", *inputs["phase5"])
    torch.cuda.synchronize()
    buf = np.zeros(1024 * 4, np.uint64)
    libs["k1_stamped"].ck_read_stamps.argtypes = [P]
    assert libs["k1_stamped"].ck_read_stamps(buf.ctypes.data) == 0
    cyc = np.diff(buf.reshape(1024, 4)[:T].astype(np.int64), axis=1)
    res["k1_block_cycles"] = dict(zip(("pass1", "scan", "pass3"),
                                      cyc.mean(0).tolist()))
    print("k1 cycles a block", json.dumps(res["k1_block_cycles"]), flush=True)

    # the vals kernel and kernel 6: phase 8's CNN-frame inputs (after 8
    # frames) and ops.cloud_rows.synthetic_cloud
    s.cnn_setup()
    st, _ = s.cnn_run(s.cnn_state(T), 8, T)
    inp = s.cnn_kernel_inputs(st, s.cnn_depth(7, T))
    pose = s.init_state(T).body.pose
    rest = crm._kernel_inputs_ph(pose, s.model, (0.0, 0.0, 0.0),
                                 torch.zeros(pose.shape[1], device=dev), 0.0)
    vals = {"phase8": inp["cloud_vals"],
            "synthetic": (crm.synthetic_cloud(pose, 2048, seed=T + 2048),)
            + rest}
    k7names = ["parent", "new"] + [n for n in VARIANTS if n[:2] == "k7"]
    for key, a in vals.items():
        p = crm.cloud_vals_plain(*a[:3])
        for name in k7names:
            hold(f"k7 {key} {name}", torch.equal(k7(name, *a), p))
            if name != "parent":
                ev = torch.zeros(T, dtype=torch.int64, device=dev)
                k7(name, *a, evals=ev)
                N, Pn, B = a[0].shape[2], a[1].shape[1] // 5, a[1].shape[2]
                full = T * -(-N // 128) * B * (-(-Pn // 8) * 8)
                res.setdefault("k7_scanned_share", {})[f"{key} {name}"] = \
                    int(ev.sum()) / full
        timed(f"k7 {key}", ab + (k7names[2:] * 2 if key == "phase8" else []),
              lambda name: k7(name, *a), 20)
    print("k7 scanned share", json.dumps(res["k7_scanned_share"]),
          flush=True)
    ua = inp["cloud_rows_unpacked"]
    hold("k6 phase8", torch.equal(k6("parent", *ua), k6("new", *ua)))
    timed("k6 phase8", ab, lambda name: k6(name, *ua), 20)

    # kernels 2 and 2.5: phase 14's inputs (one cutting-plane frame in)
    st, _ = s.run(s.init_state(T), 1, T, cfg=s.cloud_cfg(
        "mirror", plane=chip_smoke.CUT_PLANE))
    for fn, dt in (("hts_cloud_rows_solve", s.params.deltaT),
                   ("hts_cloud_rows_packed", 0.0)):
        for n, a in s.pack_inputs(st, s.depth_frame(1, T), dt).items():
            ko, kn = pack("parent", fn, *a), pack("new", fn, *a)
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
