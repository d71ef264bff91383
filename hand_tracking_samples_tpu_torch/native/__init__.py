"""The native (C++) streaming dataset loader, bound via ctypes: the port's
counterpart of hand_tracking_samples_tpu.native.

The reference overlaps disk IO with work on a std::async thread
(train-cnn.cpp:61, 126-138); here the stream decode runs on a C++ worker
thread behind a bounded ring of batches.

    from hand_tracking_samples_tpu_torch.native import StreamingLoader
    with StreamingLoader(["rec1", "rec2"], batch=64) as ld:
        for depth, pose, ids in ld:       # NumPy arrays
            ...

The port keeps its own copy of the reader (loader.cpp).  It builds at first
use with the host's C++ compiler into build/ at the repository root, named
by a hash of the source and flags, and never beside the source.  A failed
build raises: there is no fallback reader.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "loader.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
_LIB = []


def library_path() -> str:
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libhts_loader_{h.hexdigest()[:12]}.so")


def build() -> str:
    """Compile loader.cpp unless the library for this source is built."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    res = subprocess.run(["c++", *CXX_FLAGS, _SRC, "-o", tmp],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("building the loader failed:\n" + res.stdout
                           + res.stderr)
    os.replace(tmp, path)
    return path


def _lib():
    if _LIB:
        return _LIB[0]
    lib = ctypes.CDLL(build())
    lib.hts_open.restype = ctypes.c_void_p
    lib.hts_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                             ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int]
    lib.hts_total_frames.restype = ctypes.c_int64
    lib.hts_total_frames.argtypes = [ctypes.c_void_p]
    lib.hts_next_batch.restype = ctypes.c_int
    lib.hts_next_batch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_void_p]
    lib.hts_close.argtypes = [ctypes.c_void_p]
    _LIB.append(lib)
    return lib


class StreamingLoader:
    """Iterates (depth (B, H, W) uint16, pose (B, 17, 7) float32,
    ids (B,) int32) over the recordings' frames in order; the last batch
    may be short.  A recording without a .pose file gives zero poses."""

    def __init__(self, basenames, width=320, height=240, batch=64,
                 capacity=4):
        self._lib = _lib()
        arr = (ctypes.c_char_p * len(basenames))(
            *[b.encode() for b in basenames])
        self._h = self._lib.hts_open(arr, len(basenames), width, height,
                                     batch, capacity)
        if not self._h:
            raise RuntimeError("hts_open failed")
        self.width, self.height, self.batch = width, height, batch
        self.total_frames = self._lib.hts_total_frames(self._h)

    def __iter__(self):
        while True:
            depth = np.empty((self.batch, self.height, self.width), np.uint16)
            pose = np.empty((self.batch, 17, 7), np.float32)
            ids = np.empty((self.batch,), np.int32)
            n = self._lib.hts_next_batch(
                self._h, depth.ctypes.data_as(ctypes.c_void_p),
                pose.ctypes.data_as(ctypes.c_void_p),
                ids.ctypes.data_as(ctypes.c_void_p))
            if n <= 0:
                return
            yield depth[:n], pose[:n], ids[:n]

    def close(self):
        if self._h:
            self._lib.hts_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
