"""The flywheel's streaming loader and CLIs in the port against the JAX
package:

  StreamingLoader  the port's own copy of loader.cpp, built into build/ at
                   the repository root: every batch equal to
                   data/dataset.load_dataset, depth and ids bit for bit and
                   poses within 1e-6 (tests/test_native_loader.py:24,
                   test_data.py:43), on replay_rec, cnntrack_rec and a
                   seeded 4-frame recording; a source that does not compile
                   raises (no fallback reader);
  export_dataset   `cnntrack_rec.rs --max-frames 4` on the CPU:
                   labels_full.txt and labels_seg.txt equal to the JAX
                   CLI's character for character, and every PNG byte for
                   byte;
  train_cnn        `cnntrack_rec.rs --synthetic 8 --steps 2 --batch 4
                   --eval-every 1 --init-cnnb golden_cnn_init.cnnb` on the
                   CPU: the printed train and test MSEs equal to the JAX
                   CLI's (6 decimals), and the written .cnnb within 1e-5 of
                   the JAX CLI's on every 256th float, its update's norm per
                   layer within 1e-4 relative.

The JAX CLIs' outputs are cached in tests/fixtures/cache/flywheel_*.json
and flywheel_*.npz (`python -m tests.test_torch_flywheel` writes them,
~40 s)."""
import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.conftest import FIXTURES

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REC = os.path.join(FIXTURES, "cnntrack_rec.rs")
INIT = os.path.join(FIXTURES, "golden_cnn_init.cnnb")
EXPORT_ARGS = [REC, "--max-frames", "4"]
TRAIN_ARGS = [REC, "--synthetic", "8", "--steps", "2", "--batch", "4",
              "--eval-every", "1", "--init-cnnb", INIT]
STRIDE = 256          # the cached .cnnb floats: every STRIDE-th
LAYERS = (5 * 5 * 16 + 16, 4 * 4 * 16 * 64 + 64, 2304 * 2048 + 2048,
          2048 * 2304 + 2304)   # floats of each layer, W then B


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha1(f.read()).hexdigest()


def _export_outputs(out):
    return {name: (open(os.path.join(out, name)).read()
                   if name.endswith(".txt")
                   else _digest(os.path.join(out, name)))
            for name in sorted(os.listdir(out))}


def _mse_lines(text):
    return [ln.split("(")[0].strip() for ln in text.splitlines()
            if ln.startswith("step")]


def _update_norms(cnnb):
    upd = (np.fromfile(cnnb, np.float32).astype(np.float64)
           - np.fromfile(INIT, np.float32))
    return [float(np.sqrt((u * u).sum()))
            for u in np.split(upd, np.cumsum(LAYERS)[:-1])]


def jax_reference(tmp):
    """The JAX CLIs' outputs, cached."""
    h = hashlib.sha1(repr((EXPORT_ARGS, TRAIN_ARGS, STRIDE)).encode()
                     + _digest(REC.replace(".rs", ".pose")).encode()
                     + b"flywheel 1").hexdigest()[:12]
    path = os.path.join(FIXTURES, "cache", f"flywheel_{h}")
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            return json.load(f), np.load(path + ".npz")["cnnb"]
    from hand_tracking_samples_tpu.apps import export_dataset, train_cnn
    out = os.path.join(tmp, "jax_export")
    export_dataset.main(EXPORT_ARGS + ["--out", out])
    cnnb = os.path.join(tmp, "jax.cnnb")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_cnn.main(TRAIN_ARGS + ["--out", cnnb])
    ref = dict(export=_export_outputs(out), train=_mse_lines(buf.getvalue()),
               update_norms=_update_norms(cnnb))
    sample = np.fromfile(cnnb, np.float32)[::STRIDE]
    with open(path + ".json", "w") as f:
        json.dump(ref, f)
    np.savez_compressed(path + ".npz", cnnb=sample)
    return ref, sample


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return jax_reference(str(tmp_path_factory.mktemp("jax")))


def _seeded_recording(tmp):
    from hand_tracking_samples_tpu_torch.data.dataset import DatasetWriter
    rng = np.random.RandomState(0)
    base = os.path.join(tmp, "rec")
    with DatasetWriter(base) as w:
        w.save_frames((rng.rand(4, 240, 320) * 4000).astype(np.uint16),
                      rng.rand(4, 17, 7).astype(np.float32),
                      (rng.rand(4, 240, 320) * 255).astype(np.uint8))
    return base


@pytest.mark.parametrize("rec,batch", [("replay_rec", 4),
                                       ("cnntrack_rec", 64),
                                       ("seeded", 3)])
def test_streaming_loader_matches_load_dataset(tmp_path, rec, batch):
    from hand_tracking_samples_tpu_torch.data.dataset import load_dataset
    from hand_tracking_samples_tpu_torch.native import StreamingLoader
    base = (_seeded_recording(str(tmp_path)) if rec == "seeded"
            else os.path.join(FIXTURES, rec))
    ds = load_dataset(base)
    with StreamingLoader([base], batch=batch) as sl:
        assert sl.total_frames == len(ds.depth)
        got = list(sl)
    assert all(len(b[0]) == batch for b in got[:-1])
    np.testing.assert_array_equal(np.concatenate([b[2] for b in got]),
                                  np.arange(len(ds.depth)))
    np.testing.assert_array_equal(np.concatenate([b[0] for b in got]),
                                  ds.depth)
    np.testing.assert_allclose(np.concatenate([b[1] for b in got]), ds.pose,
                               atol=1e-6)


def test_loader_builds_into_build(tmp_path, monkeypatch):
    from hand_tracking_samples_tpu_torch import native
    path = native.build()
    assert os.path.dirname(path) == os.path.join(REPO, "build")
    assert os.path.exists(path)
    bad = tmp_path / "loader.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_LIB", [])
    with pytest.raises(RuntimeError, match="building the loader failed"):
        native.StreamingLoader([os.path.join(FIXTURES, "replay_rec")])


def _port_cli(module, args):
    res = subprocess.run(
        [sys.executable, "-m", f"hand_tracking_samples_tpu_torch.apps."
         f"{module}", *args, "--device", "cpu"], cwd=REPO,
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-2000:]
    return res.stdout


def test_export_cli_matches_jax(tmp_path, reference):
    out = str(tmp_path / "export")
    _port_cli("export_dataset", EXPORT_ARGS + ["--out", out])
    assert _export_outputs(out) == reference[0]["export"]


def test_train_cli_matches_jax(tmp_path, reference):
    cnnb = str(tmp_path / "port.cnnb")
    text = _port_cli("train_cnn", TRAIN_ARGS + ["--out", cnnb])
    assert "streaming" in text and "training set: 40 frames" in text
    assert _mse_lines(text) == reference[0]["train"]
    mine = np.fromfile(cnnb, np.float32)
    assert mine.size == sum(LAYERS)
    assert np.abs(mine[::STRIDE] - reference[1]).max() < 1e-5
    np.testing.assert_allclose(_update_norms(cnnb),
                               reference[0]["update_norms"], rtol=1e-4)


if __name__ == "__main__":
    import tempfile
    import jax
    jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory() as d:
        print(sorted(jax_reference(d)[0]))
