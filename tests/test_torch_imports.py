"""The PyTorch port stands alone: no module of it (nor chip_smoke.py)
imports jax or the JAX package, and importing it builds nothing."""
import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

# the port tests run small tensors: one intra-op thread each, so the
# suite's parallel workers do not oversubscribe the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "hand_tracking_samples_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "hand_tracking_samples_tpu")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax():
    files = _port_files()
    assert len(files) > 20
    bad = [(os.path.relpath(p, REPO), name) for p in files
           for name in _imports(p)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_wrappers_registered_and_plain_on_cpu():
    """The twelve kernel wrappers register their launch counts; on CPU
    tensors they run the plain version and count no launch."""
    from hand_tracking_samples_tpu_torch import kernels
    from hand_tracking_samples_tpu_torch.imaging.camera import DCamera
    from hand_tracking_samples_tpu_torch.ops import cloud_kernel
    import hand_tracking_samples_tpu_torch.ops.cloud_rows  # noqa: F401
    import hand_tracking_samples_tpu_torch.physics.contact_kernel  # noqa
    import hand_tracking_samples_tpu_torch.physics.pgs_kernel  # noqa: F401
    import hand_tracking_samples_tpu_torch.ops.correspondence  # noqa: F401
    import hand_tracking_samples_tpu_torch.physics.row_sweep  # noqa: F401
    from hand_tracking_samples_tpu_torch.tools import (prof_cloud_kernel,
                                                       prof_cloud_mt,
                                                       prof_cloud_pre)
    from hand_tracking_samples_tpu_torch.tools.common import to_raster
    assert set(kernels.counts()) == {"cloud_from_depth", "cloud_rows_solve",
                                     "cloud_rows_packed",
                                     "cloud_rows_unpacked", "cloud_vals",
                                     "contact_fields", "pgs_solve",
                                     "correspondence", "row_sweep",
                                     "cloud_stage", "group_sum",
                                     "track_sum"}
    kernels.reset_counts()
    cam = DCamera.make((64, 8), (30.0, 30.0), (32.0, 4.0), 0.001)
    d = torch.full((2, 8, 64), 300, dtype=torch.int16)
    ph = cloud_kernel.cloud_from_depth_planes(d, cam, 0.1, 0.7, 4, 32)
    assert ph.shape == (2, 8, 32) and bool((ph[:, 4] == 1).all())
    draw = to_raster(d)                              # (2, 4, 128): all valid
    out = prof_cloud_kernel.cloud_stage(draw, prof_cloud_kernel.scalars(), 4,
                                        budget=32, W=64)
    assert out.shape == (2, 32, 8) and bool((out[:, :, 3] == 1).all())
    sums = prof_cloud_mt.group_sum(draw.reshape(1, 8, 128))
    assert sums.shape == (1, 8, 128)
    assert torch.allclose(sums, prof_cloud_pre.track_sum(draw).sum(0)[None])
    assert all(n == 0 for n in kernels.counts().values())
    assert "sm_90a" in " ".join(kernels.NVCC_FLAGS)
    assert os.path.basename(kernels.library_path()).startswith(
        "libhts_kernels_")


def test_config_matches_jax_package():
    from hand_tracking_samples_tpu.tracker.config import TrackerConfig as J
    from hand_tracking_samples_tpu_torch.tracker.config import TrackerConfig
    assert dataclasses.asdict(TrackerConfig()) == dataclasses.asdict(J())


def test_entry_points_refuse_later_slices():
    from hand_tracking_samples_tpu_torch.tracker.config import TrackerConfig
    from hand_tracking_samples_tpu_torch.tracker import runtime
    clouds = (dict(), dict(subsample_voxel=1, subsample_size=0.005),
              dict(mirror_plane=(0.0, 0.0, -1.0, 0.6)),
              dict(subsample_voxel=1, subsample_size=0.005,
                   mirror_plane=(0.0, 0.0, -1.0, 0.6)))
    for cloud in clouds:                       # the ported frames
        for cnn in (False, True):
            runtime._check_config(TrackerConfig(cnn_every_frame=cnn,
                                                solver="kernel",
                                                use_pallas=True, **cloud))
        for solver in ("sequential", "colored"):
            for pallas in (False, True):
                for cnn in (False, True):
                    runtime._check_config(TrackerConfig(
                        cnn_every_frame=cnn, solver=solver,
                        use_pallas=pallas, **cloud))
    # the settings the later slices brought: every one is accepted now,
    # on every solver (slowfit runs the same check)
    for kw in (dict(angles_only=True), dict(use_pallas=False),
               dict(contacts_mode="jacobi")):
        for solver in ("kernel", "sequential", "colored"):
            for cnn in (False, True):
                cfg = dict(cnn_every_frame=cnn, solver=solver,
                           use_pallas=True)
                cfg.update(kw)
                runtime._check_config(TrackerConfig(**cfg))
    assert callable(runtime.kickstart_multi)
    for bad in (dict(solver="jacobi"), dict(contacts_mode="gauss")):
        with pytest.raises(ValueError):
            runtime._check_config(TrackerConfig(**bad))


def test_every_port_module_imports():
    """Every module of the port imports on a machine without CUDA, nvcc
    or Triton, and importing builds no kernel."""
    import importlib
    import pkgutil
    import hand_tracking_samples_tpu_torch as pkg
    from hand_tracking_samples_tpu_torch import kernels
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")]
    for name in ("cnn.model", "cnn.labels", "segment.handsegment",
                 "imaging.heatmaps", "imaging.image_ops", "maths.fma",
                 "maths.libm", "ops.correspondence", "physics.row_sweep",
                 "physics.colored", "physics.contacts", "physics.solver",
                 "data.dataset", "utils.viz", "utils.report",
                 "apps.annotate", "apps.replay_track",
                 "apps.synthetic_track", "model.meshes", "cnn.layers",
                 "cnn.train", "native", "utils.checkpoint",
                 "apps.train_cnn", "apps.export_dataset",
                 "parallel.mesh", "utils.profiling"):
        assert f"{pkg.__name__}.{name}" in names, name
    for name in names:
        importlib.import_module(name)
    assert kernels._LIB is None


def test_device_helper():
    from hand_tracking_samples_tpu_torch.device import resolve_device
    assert resolve_device("cpu").type == "cpu"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    if not torch.cuda.is_available():
        from hand_tracking_samples_tpu_torch.model.bake import (
            bake_hand_model, from_numpy_model)
        from hand_tracking_samples_tpu_torch.ops.cloud_kernel import (
            depth_tensor)
        with pytest.raises(RuntimeError):
            resolve_device()
        with pytest.raises(RuntimeError):
            depth_tensor(np.zeros((1, 2, 2), np.uint16))
        with pytest.raises(RuntimeError):
            from_numpy_model(bake_hand_model(os.path.join(
                REPO, "assets", "model_hand.json")))
