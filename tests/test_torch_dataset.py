"""The recording format in the port (data/dataset.py, NumPy alone) against
the JAX package's module: the same arrays on load (the committed replay and
CNN-track recordings, and tests/dataset_fixture.py's six-stream and legacy
interleaved recordings), the same bytes on write, the same filters on
seeded inputs; and the port's copies of utils/viz.py and utils/report.py
(the annotate CLI's overlays and editor page) against the JAX ones."""
import os

import numpy as np
import pytest
import torch

from tests.conftest import FIXTURES

# the port tests run small tensors: one intra-op thread each, so the
# suite's parallel workers do not oversubscribe the cores
torch.set_num_threads(1)

RECORDINGS = ["replay_rec", "cnntrack_rec", "recmix", "reclegacy"]
STREAMS = ("json", "rs", "ir", "pose", "rgb", "feye")


def _pkgs():
    from hand_tracking_samples_tpu.data import dataset as jd
    from hand_tracking_samples_tpu_torch.data import dataset as pd
    return jd, pd


@pytest.fixture(scope="module")
def synthetic_recordings(tmp_path_factory):
    """dataset_fixture's two recordings, written by the JAX package."""
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from dataset_fixture import write_fixture_recordings
    d = str(tmp_path_factory.mktemp("dsfix"))
    mix, legacy, _ = write_fixture_recordings(d)
    return {"recmix": mix, "reclegacy": legacy}


@pytest.mark.parametrize("name", RECORDINGS)
def test_load_dataset_matches_jax(name, synthetic_recordings):
    """Every stream the same array (dtype, shape, bits) and the same
    header; the camera the same intrinsics."""
    jd, pd = _pkgs()
    base = synthetic_recordings.get(name, os.path.join(FIXTURES, name))
    want, got = jd.load_dataset(base), pd.load_dataset(base)
    assert got.info.to_json_dict() == want.info.to_json_dict()
    assert got.info.mirror_plane() == want.info.mirror_plane()
    for k in ("depth", "pose", "ir", "rgb", "feye"):
        a, b = getattr(got, k), getattr(want, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert a.tobytes() == b.tobytes(), k
    jc, pc = want.info.camera(), got.info.camera()
    assert pc.dim == tuple(jc.dim)
    for k in ("focal", "principal", "pose"):
        np.testing.assert_array_equal(np.float32(getattr(pc, k)),
                                      np.asarray(getattr(jc, k)))
    assert np.float32(pc.depth_scale) == np.asarray(jc.depth_scale)


@pytest.mark.parametrize("streams", ["six", "depth_pose"])
def test_dataset_writer_bytes_match_jax(tmp_path, streams):
    """The same frames through both writers: every file the same bytes
    (six streams with a mirror plane, or depth and poses alone with the
    default header and a zero IR stream)."""
    jd, pd = _pkgs()
    rng = np.random.RandomState(11)
    F, w, h = 3, 40, 30
    depth = (rng.rand(F, h, w) * 4000).astype(np.uint16)
    pose = (rng.randn(F, 17, 7) * 0.3).astype(np.float32)
    ir = (rng.rand(F, h, w) * 255).astype(np.uint8)
    rgb = (rng.rand(F, 6, 8, 3) * 255).astype(np.uint8)
    feye = (rng.rand(F, 5, 10) * 255).astype(np.uint8)
    for pkg, sub in ((jd, "jax"), (pd, "port")):
        base = str(tmp_path / sub / "rec")
        if streams == "six":
            info = pkg.DatasetInfo(dims=(w, h), rgb_dim=(8, 6),
                                   feye_dim=(10, 5),
                                   mplane=(0.0, 0.0, -1.0, 0.6))
            with pkg.DatasetWriter(base, info) as wr:
                wr.add_rgb().add_fisheye()
                wr.save_frames(depth, pose, ir, rgb, feye)
        else:
            with pkg.DatasetWriter(base) as wr:
                wr.save_frames(depth, pose)
    for ext in STREAMS:
        a = tmp_path / "jax" / f"rec.{ext}"
        b = tmp_path / "port" / f"rec.{ext}"
        assert a.exists() == b.exists(), ext
        if not a.exists():
            continue
        ja, pb = a.read_bytes(), b.read_bytes()
        if ext == "json":           # the header names its own prefix
            ja = ja.replace(str(tmp_path / "jax").encode(), b"")
            pb = pb.replace(str(tmp_path / "port").encode(), b"")
        assert ja == pb, ext


@pytest.mark.parametrize("which", ["ivy", "ds4", "ds4_background",
                                   "background"])
def test_filters_match_jax(which):
    """filter_ivy, filter_ds4 (with and without a background) and
    update_background on seeded depth/IR frames with holes, dark pixels
    and flying pixels: the same arrays."""
    jd, pd = _pkgs()
    rng = np.random.RandomState(5)
    depth = (300 + rng.rand(48, 64) * 300).astype(np.uint16)
    depth[rng.rand(48, 64) < 0.1] = 0
    depth[rng.rand(48, 64) < 0.05] = 3000
    ir = (rng.rand(48, 64) * 40).astype(np.uint8)
    bg = (250 + rng.rand(48, 64) * 500).astype(np.uint16)
    if which == "ivy":
        fn = lambda m: m.filter_ivy(depth, 0.000125)
    elif which == "ds4":
        fn = lambda m: m.filter_ds4(depth, ir)
    elif which == "ds4_background":
        fn = lambda m: m.filter_ds4(depth, ir, bg)
    else:
        fn = lambda m: m.update_background(m.update_background(None, depth),
                                           bg)
    want, got = fn(jd), fn(pd)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_viz_and_report_match_jax(tmp_path, hand_model):
    """depth_to_rgb, draw_points, write_png (the same PNG bytes), the CNN
    debug images on the port's CnnDebug (tracks leading) against JAX's
    one-track CnnDebug, and the report page (the same page but for the
    editor's line naming the annotate CLI)."""
    import json
    import jax.numpy as jnp
    from hand_tracking_samples_tpu.tracker.runtime import CnnDebug as JDbg
    from hand_tracking_samples_tpu.utils import report as jr
    from hand_tracking_samples_tpu.utils import viz as jv
    from hand_tracking_samples_tpu_torch.tracker.runtime import CnnDebug
    from hand_tracking_samples_tpu_torch.utils import report as pr
    from hand_tracking_samples_tpu_torch.utils import viz as pv
    rng = np.random.RandomState(2)
    depth = (rng.rand(30, 40) * 900).astype(np.uint16)
    pts = rng.rand(17, 2) * 40 - 2
    imgs = [m.draw_points(m.depth_to_rgb(depth, 0.001), pts, size=2)
            for m in (jv, pv)]
    assert imgs[0].tobytes() == imgs[1].tobytes()
    dbg = dict(cnn_input=rng.rand(2, 64, 64).astype(np.float32),
               cnn_output=rng.rand(2, 2304).astype(np.float32),
               image_points=(rng.rand(2, 8, 2) * 16).astype(np.float32),
               segment_cam_pose=np.float32([[0.01, -0.02, 0.0, 0, 0, 0, 1],
                                            [0, 0, 0.05, 0, 0.1, 0, 0.995]]))
    pose = np.asarray(hand_model.start_pose, np.float32)[None].repeat(2, 0)
    pose[1, :, :3] += 0.3
    pd_ = CnnDebug(**{k: torch.tensor(v) for k, v in dbg.items()})
    for t in range(2):
        jd_ = JDbg(**{k: jnp.asarray(v[t]) for k, v in dbg.items()})
        assert np.array_equal(pv.last_segment_image(pd_, track=t),
                              jv.last_segment_image(jd_))
        assert np.array_equal(
            pv.cnn_difference_image(pd_, torch.tensor(pose), track=t),
            jv.cnn_difference_image(jd_, pose[t], hand_model))
    pytest.importorskip("PIL")
    for m, sub in ((jv, "jax"), (pv, "port")):
        d = tmp_path / sub
        for f in range(2):
            m.write_png(str(d / f"fit_{f:04d}.png"), imgs[0])
            with open(d / f"bones_{f:04d}.json", "w") as bf:
                json.dump({"frame": f, "bones": pose[f, :, :3].tolist()}, bf)
    for ext in ("fit_0000.png", "fit_0001.png"):
        assert ((tmp_path / "jax" / ext).read_bytes()
                == (tmp_path / "port" / ext).read_bytes())
    pages = [open(m.write_html_report(str(tmp_path / s))).read()
             for m, s in ((jr, "jax"), (pr, "port"))]
    assert "annotation editor" in pages[1] and "editview(" in pages[1]
    assert pages[1] == pages[0].replace(
        "python -m hand_tracking_samples_tpu.apps.annotate",
        "python -m hand_tracking_samples_tpu_torch.apps.annotate")
