"""Dataset I/O: the reference's parallel-file recording format, bit-compatible.

Format (include/dataset.h:1-10):
  <name>.json   camera intrinsics + header (DatasetInfo)
  <name>.rs     binary uint16 depth, width*height per frame, appended
  <name>.ir     uint8 IR, same layout
  <name>.pose   ascii: 17 x (position xyz, quaternion xyzw) per line
  <name>.rgb / <name>.feye   optional colour / fisheye streams

Recordings made by the reference's realtime-annotator load here unchanged,
and recordings written here load in the reference apps.  The port's
counterpart of hand_tracking_samples_tpu.data.dataset, in NumPy alone: the
same arrays on load and the same bytes on write (tests/test_torch_dataset.py
holds the two to each other); `DatasetInfo.camera()` is the port's DCamera.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from ..imaging.camera import DCamera


@dataclasses.dataclass
class DatasetInfo:
    """dataset.h:21-37 DatasetInfo; field names match visit_fields."""
    dims: tuple = (320, 240)
    focal: tuple = (241.811768, 241.811768)
    principal: tuple = (162.830505, 118.740089)
    depth_scale: float = 0.001
    mplane: tuple = (0.0, 0.0, 0.0, 0.0)
    fname: str = ""
    camtype: str = "tpu"
    hasir: bool = False
    rgb_dim: tuple = (640, 480)
    feye_dim: tuple = (640, 480)
    segment_scale: float = 0.17

    def to_json_dict(self):
        return {
            "dcamera": {
                "dims": list(self.dims),
                "focal": list(self.focal),
                "principal": list(self.principal),
                "depth_scale": self.depth_scale,
            },
            "mplane": list(self.mplane),
            "fname": self.fname,
            "camtype": self.camtype,
            "hasir": self.hasir,
            "rgb_dim": list(self.rgb_dim),
            "feyedim": list(self.feye_dim),
            "segment_scale": self.segment_scale,
        }

    @staticmethod
    def from_json_dict(js):
        cam = js.get("dcamera", {})
        return DatasetInfo(
            dims=tuple(cam.get("dims", (320, 240))),
            focal=tuple(cam.get("focal", (241.811768, 241.811768))),
            principal=tuple(cam.get("principal", (162.830505, 118.740089))),
            depth_scale=float(cam.get("depth_scale", 0.001)),
            mplane=tuple(js.get("mplane", (0, 0, 0, 0))),
            fname=js.get("fname", ""),
            camtype=js.get("camtype", ""),
            hasir=bool(js.get("hasir", False)),
            rgb_dim=tuple(js.get("rgb_dim", (640, 480))),
            feye_dim=tuple(js.get("feyedim", (640, 480))),
            segment_scale=float(js.get("segment_scale", 0.17)),
        )

    def mirror_plane(self) -> tuple:
        """The dataset's mirror-rig plane, or () when absent.  The reference
        stores sentinels (0,0,0,0)/(0,0,0,FLT_MAX) for no-mirror
        (dataset.h:24,45); a real plane has a unit-ish normal."""
        n = self.mplane[:3]
        return tuple(self.mplane) if (n[0] ** 2 + n[1] ** 2 + n[2] ** 2) > 0.25 \
            else ()

    def camera(self) -> DCamera:
        return DCamera.make(self.dims, self.focal, self.principal,
                            self.depth_scale)


@dataclasses.dataclass
class Dataset:
    """A loaded recording: batched arrays instead of per-frame objects."""
    info: DatasetInfo
    depth: np.ndarray          # (F, H, W) uint16
    pose: np.ndarray           # (F, 17, 7) float32 (zeros if absent)
    ir: np.ndarray | None      # (F, H, W) uint8 or None
    rgb: np.ndarray | None = None   # (F, RH, RW, 3) uint8 or None
    feye: np.ndarray | None = None  # (F, FH, FW) uint8 or None


def _read_frames(path, frame_bytes, frames, shape, dtype):
    """Optional parallel stream: per-frame reads, zero-filled where the file
    runs short (dataset.h:140-146 reads into a zeroed buffer and ignores
    short reads)."""
    if not os.path.exists(path) or frame_bytes == 0:
        return None
    raw = np.fromfile(path, dtype=np.uint8)
    have = min(frames, len(raw) // frame_bytes)
    out = np.zeros((frames, frame_bytes), np.uint8)
    out[:have] = raw[: have * frame_bytes].reshape(have, frame_bytes)
    return out.view(dtype).reshape((frames,) + shape)


def load_dataset(bname: str, n_bones: int = 17) -> Dataset:
    """load_dataset (dataset.h:109-163) as one batched read.  Reads all six
    parallel files: .json/.rs/.ir/.pose plus the optional .rgb (byte3 at
    rgb_dim) and .feye (byte at feye_dim) streams, and the deprecated
    interleaved-`hasir` .rs layout (depth u16 then ir u8 per frame,
    dataset.h:134-138)."""
    if not os.path.exists(bname + ".json"):
        raise FileNotFoundError(
            f"no recording '{bname}': expected {bname}.json/.rs "
            f"(pass the basename or the .rs path)")
    with open(bname + ".json") as f:
        info = DatasetInfo.from_json_dict(json.load(f))
    w, h = info.dims
    if info.hasir:
        # legacy interleaved layout: each frame is w*h u16 depth followed by
        # w*h u8 ir in the same .rs file
        raw = np.fromfile(bname + ".rs", dtype=np.uint8)
        stride = w * h * 3
        frames = len(raw) // stride
        raw = raw[: frames * stride].reshape(frames, stride)
        depth = (raw[:, : w * h * 2].copy().view(np.uint16)
                 .reshape(frames, h, w))
        ir_inter = raw[:, w * h * 2:].reshape(frames, h, w).copy()
    else:
        raw = np.fromfile(bname + ".rs", dtype=np.uint16)
        frames = len(raw) // (w * h)
        depth = raw[: frames * w * h].reshape(frames, h, w)
        ir_inter = None

    pose = np.zeros((frames, n_bones, 7), np.float32)
    if os.path.exists(bname + ".pose"):
        vals = np.loadtxt(bname + ".pose", dtype=np.float32, ndmin=2)
        vals = vals.reshape(-1, n_bones, 7)[:frames]
        pose[: len(vals)] = vals

    # a parallel .ir file overrides the interleaved ir (dataset.h:139-140)
    ir = _read_frames(bname + ".ir", w * h, frames, (h, w), np.uint8)
    if ir is None:
        ir = ir_inter
    rw, rh = info.rgb_dim
    rgb = _read_frames(bname + ".rgb", rw * rh * 3, frames, (rh, rw, 3),
                       np.uint8)
    fw, fh = info.feye_dim
    feye = _read_frames(bname + ".feye", fw * fh, frames, (fh, fw), np.uint8)
    return Dataset(info=info, depth=depth, pose=pose, ir=ir, rgb=rgb,
                   feye=feye)


def pose_line(pose) -> str:
    """One frame's (17, 7) poses as a line of the .pose file."""
    parts = []
    for p in np.asarray(pose, np.float32):
        parts.append(" ".join(f"{v:g}" for v in p[:3]) + "  "
                     + " ".join(f"{v:g}" for v in p[3:]))
    return "   ".join(parts) + "\n"


class DatasetWriter:
    """DepthDataStreamOut (dataset.h:62-106): streaming append writer."""

    def __init__(self, prefix: str, info: DatasetInfo | None = None):
        self.prefix = prefix
        self.info = info or DatasetInfo(fname=prefix)
        self.info.fname = prefix
        os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
        with open(prefix + ".json", "w") as f:
            json.dump(self.info.to_json_dict(), f, indent=2)
        self._depth = open(prefix + ".rs", "wb")
        self._ir = open(prefix + ".ir", "wb")
        self._pose = open(prefix + ".pose", "w")
        self._rgb = None
        self._feye = None

    def add_rgb(self) -> "DatasetWriter":
        """Open the optional colour stream (dataset.h:77 AddRGB)."""
        self._rgb = open(self.prefix + ".rgb", "wb")
        return self

    def add_fisheye(self) -> "DatasetWriter":
        """Open the optional fisheye stream (dataset.h:78 AddFishEye)."""
        self._feye = open(self.prefix + ".feye", "wb")
        return self

    def save_frame(self, depth: np.ndarray, pose: np.ndarray,
                   ir: np.ndarray | None = None,
                   rgb: np.ndarray | None = None,
                   fisheye: np.ndarray | None = None):
        """depth (H,W) uint16; pose (17,7); ir (H,W) uint8, rgb (RH,RW,3)
        uint8 and fisheye (FH,FW) uint8 optional (written only when their
        streams were opened, dataset.h:98-103)."""
        np.asarray(depth, np.uint16).tofile(self._depth)
        if ir is None:
            ir = np.zeros(depth.shape, np.uint8)
        np.asarray(ir, np.uint8).tofile(self._ir)
        self._pose.write(pose_line(pose))
        if self._rgb is not None and rgb is not None:
            np.asarray(rgb, np.uint8).tofile(self._rgb)
        if self._feye is not None and fisheye is not None:
            np.asarray(fisheye, np.uint8).tofile(self._feye)

    def save_frames(self, depth, pose, ir=None, rgb=None, fisheye=None):
        for f in range(len(depth)):
            self.save_frame(depth[f], pose[f],
                            None if ir is None else ir[f],
                            None if rgb is None else rgb[f],
                            None if fisheye is None else fisheye[f])

    def close(self):
        self._depth.close()
        self._ir.close()
        self._pose.close()
        for f in (self._rgb, self._feye):
            if f is not None:
                f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def update_background(background, depth, fudge: int = 3):
    """RSCam::addbackground (dcam.h:157-162): running min of observed depth
    (minus a fudge) used by FilterDS4's background subtraction.
    background None -> initialised at 4096."""
    if background is None:
        background = np.full(depth.shape, 4096, np.uint16)
    return np.minimum(background,
                      (depth.astype(np.int32) - fudge).clip(0).astype(np.uint16))


def filter_ivy(depth: np.ndarray, depth_scale: float = 0.001) -> np.ndarray:
    """FilterIvy (dcam.h:209-226): zero depth -> 4 m fill."""
    const = np.uint16(4.0 / depth_scale)
    return np.where(depth == 0, const, depth)


def filter_ds4(depth: np.ndarray, ir: np.ndarray,
               background: np.ndarray | None = None) -> np.ndarray:
    """FilterDS4 (dcam.h:174-208): dark-IR and flying-pixel rejection plus
    optional background subtraction, vectorised."""
    d = depth.astype(np.int32)
    out = depth.copy()
    out[(depth < 30) | (ir < 8)] = 4096
    d = out.astype(np.int32)

    def has_neighbor(axis, dist):
        lo = np.abs(np.roll(d, dist, axis) - d) < 10
        hi = np.abs(np.roll(d, -dist, axis) - d) < 10
        return lo | hi

    flying = ~(has_neighbor(1, 1) & has_neighbor(0, 1)
               & has_neighbor(1, 2) & has_neighbor(0, 2))
    flying[:2, :] = False
    flying[-2:, :] = False
    flying[:, :2] = False
    flying[:, -2:] = False
    out[flying] = 4096
    if background is not None:
        out[out > background] = 4096
    return out
