"""Build, load and count the port's CUDA kernels.

Every kernel source under csrc/ is compiled by ONE nvcc call into one shared
library with a plain C interface, loaded with ctypes (no PyTorch headers, so
the build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -Xptxas -v
         -o build/libhts_kernels_<hash>.so csrc/*.cu

The library lands in build/ at the repository root, named by a hash of the
sources and flags, so an edited source rebuilds it.  -fmad=false keeps nvcc
from contracting a*b+c into one FMA: the kernels then round each operation
as the plain PyTorch versions do, which is what lets the cloud kernel be
bit-identical to its plain version and the others agree to the last bits.
-Xptxas -v puts each kernel's registers, stack, spills and static shared
memory into the build log (`BUILD_INFO["log"]`, `ptxas_summary`).

Each kernel wrapper (ops/cloud_kernel.py, ops/cloud_rows.py (four),
ops/correspondence.py, physics/contact_kernel.py, physics/pgs_kernel.py,
physics/row_sweep.py, and the profiling tools' three in
tools/prof_cloud_kernel.py, prof_cloud_mt.py and prof_cloud_pre.py)
registers itself here with
`wrapper(name)`; its `launches` attribute counts the launches it made.
Every launch goes through `launch`, which makes the tensors' card the
current device.
Nothing here runs when the package is imported.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIB = None
WRAPPERS: dict = {}
BUILD_INFO: dict = {}


def wrapper(name: str):
    """Register a kernel wrapper under `name` and give it a launch count
    (`launches`) and a per-kind tally of the same launches (`kinds`, for a
    wrapper whose kernel serves several plans)."""
    def deco(fn):
        fn.launches = 0
        fn.kinds = {}
        WRAPPERS[name] = fn
        return fn
    return deco


def reset_counts():
    for fn in WRAPPERS.values():
        fn.launches = 0
        fn.kinds.clear()


def counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def sources() -> list:
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(SRC_DIR, "*.cuh")))


def library_path() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libhts_kernels_{h.hexdigest()[:12]}.so")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def build() -> str:
    """Compile csrc/*.cu into the library unless it is already built.
    Returns the library path; BUILD_INFO records the seconds it took."""
    path = library_path()
    if os.path.exists(path):
        if BUILD_INFO.get("path") != path:
            BUILD_INFO.update(path=path, seconds=0.0, built=False)
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cu = [p for p in sources() if p.endswith(".cu")]
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", SRC_DIR, "-o", tmp, *cu]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + res.stdout + res.stderr)
    os.replace(tmp, path)
    BUILD_INFO.update(path=path, seconds=time.perf_counter() - t0,
                      built=True, log=res.stdout + res.stderr)
    return path


def ptxas_summary(log: str) -> dict:
    """{kernel entry name: {registers, stack, spill_stores, spill_loads,
    static_smem}} (bytes but the registers) from an -Xptxas -v log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name].update(stack=int(m.group(1)), spill_stores=int(
                m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem"] = int(m.group(1)) if m else 0
    return out


def _declare(lib):
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hts_cloud_from_depth.argtypes = [P, P, I, I, I, I, I, I, I, F, F,
                                         F, F, F, F, P]
    lib.hts_cloud_rows_solve.argtypes = [P, P, P, P, P, P, I, I, I, I, I,
                                         I, P]
    lib.hts_cloud_rows_packed.argtypes = lib.hts_cloud_rows_solve.argtypes
    lib.hts_contact_fields.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I,
                                       I, F, P]
    lib.hts_cloud_rows_unpacked.argtypes = [P] * 6 + [I] * 4 + [P]
    lib.hts_cloud_vals.argtypes = [P, P, P, P, P, I, I, I, I, P]
    lib.hts_pgs_solve.argtypes = [P, P]
    lib.hts_correspondence.argtypes = [P] * 8 + [I, I, I, I, P]
    lib.hts_row_sweep.argtypes = [P, P]
    lib.hts_row_sweep_occupancy.argtypes = [P]
    lib.hts_pgs_occupancy.argtypes = [P]
    lib.hts_cloud_stage.argtypes = [P, P, I, I, I, I, I, I, F, F, F, P]
    lib.hts_group_sum.argtypes = [P, P, I, ctypes.c_longlong, F, P]
    for fn in (lib.hts_cloud_from_depth, lib.hts_cloud_rows_solve,
               lib.hts_cloud_rows_packed, lib.hts_cloud_rows_unpacked,
               lib.hts_cloud_vals,
               lib.hts_contact_fields,
               lib.hts_pgs_solve, lib.hts_correspondence,
               lib.hts_row_sweep, lib.hts_row_sweep_occupancy,
               lib.hts_pgs_occupancy, lib.hts_cloud_stage,
               lib.hts_group_sum):
        fn.restype = ctypes.c_int


def library():
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        _declare(lib)
        _LIB = lib
    return _LIB


def check(err: int, name: str):
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def on_device(entry, device, *args):
    """entry(*args) with `device` the calling thread's current device: each
    C entry point sets its kernel's attributes, queries occupancy and
    launches on the current device, which on a mesh of several cards need
    not be the one its tensors lie on.  (When it already is, the switch is
    skipped: it costs more host time than a short kernel runs.)"""
    import torch
    if device.index == torch.cuda.current_device():
        return entry(*args)
    with torch.cuda.device(device):
        return entry(*args)


def launch(name: str, entry, device, *args):
    """Launch C entry point `entry` on `device`: its arguments, then the
    device's current stream; raises when it fails."""
    check(on_device(entry, device, *args, stream_ptr(device)), name)


class KernelLimit(ValueError):
    """A shape outside a kernel's limits (ROADMAP, "Limits of the
    kernels"), which its wrapper refuses rather than launch."""


def require_cuda(*tensors):
    """The checks every wrapper makes before a launch."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return dev
