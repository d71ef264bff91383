"""Build, load and count the port's CUDA kernels.

Every kernel source under csrc/ is compiled by ONE nvcc call into one shared
library with a plain C interface, loaded with ctypes (no PyTorch headers, so
the build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -o build/libhts_kernels_<hash>.so csrc/*.cu

The library lands in build/ at the repository root, named by a hash of the
sources and flags, so an edited source rebuilds it.  -fmad=false keeps nvcc
from contracting a*b+c into one FMA: the kernels then round each operation
as the plain PyTorch versions do, which is what lets the cloud kernel be
bit-identical to its plain version and the others agree to the last bits.

Each kernel wrapper (ops/cloud_kernel.py, ops/cloud_rows.py (four),
ops/correspondence.py, physics/contact_kernel.py, physics/pgs_kernel.py,
physics/row_sweep.py) registers itself here with
`wrapper(name)`; its `launches` attribute counts the launches it made.
Nothing here runs when the package is imported.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

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


def _declare(lib):
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hts_cloud_from_depth.argtypes = [P, P, P, I, I, I, I, I, I, F, F, F,
                                         F, F, F, F, F, P]
    lib.hts_cloud_rows_solve.argtypes = [P, P, P, P, P, P, I, I, I, I, I,
                                         I, P]
    lib.hts_cloud_rows_packed.argtypes = lib.hts_cloud_rows_solve.argtypes
    lib.hts_contact_fields.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I,
                                       I, F, P]
    lib.hts_cloud_rows_unpacked.argtypes = [P, P, P, P, P, I, I, I, I, I,
                                            P]
    lib.hts_pgs_solve.argtypes = [P, P]
    lib.hts_correspondence.argtypes = [P] * 8 + [I, I, I, I, P]
    lib.hts_row_sweep.argtypes = [P, P]
    for fn in (lib.hts_cloud_from_depth, lib.hts_cloud_rows_solve,
               lib.hts_cloud_rows_packed, lib.hts_cloud_rows_unpacked,
               lib.hts_contact_fields,
               lib.hts_pgs_solve, lib.hts_correspondence,
               lib.hts_row_sweep):
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
