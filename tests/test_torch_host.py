"""The port's host-side copies against the JAX package's: the mesh
builders, the model scaling, the row schedules, the camera, the config
loader and the package's lazy entry points."""
import dataclasses
import json

import numpy as np
import torch

from hand_tracking_samples_tpu.geometry import primitives as jprim
from hand_tracking_samples_tpu.imaging.camera import DCamera as JCam
from hand_tracking_samples_tpu.model.bake import scale_model as j_scale
from hand_tracking_samples_tpu.physics.schedule import (
    build_hand_schedule as j_schedule)
from hand_tracking_samples_tpu_torch.geometry import primitives as prim
from hand_tracking_samples_tpu_torch.imaging.camera import DCamera
from hand_tracking_samples_tpu_torch.maths import pose as ppose
from hand_tracking_samples_tpu_torch.model.bake import (HandModelArrays,
                                                        scale_model)
from hand_tracking_samples_tpu_torch.physics.schedule import (
    build_hand_schedule)
from hand_tracking_samples_tpu_torch.tracker.config import TrackerConfig

# the port tests run small tensors: one intra-op thread each, so the
# suite's parallel workers do not oversubscribe the cores
torch.set_num_threads(1)


def test_mesh_builders_match_jax_package():
    cases = [("mesh_box", ([-0.2, -0.3, -0.1], [0.25, 0.15, 0.35])),
             ("mesh_cube", (0.3,)), ("mesh_cylinder", (8, 0.5, 1.25)),
             ("mesh_cone", (7, 0.4, 0.9))]
    for name, args in cases:
        v, f = getattr(prim, name)(*args)
        jv, jf = getattr(jprim, name)(*args)
        np.testing.assert_array_equal(v, jv, err_msg=name)
        assert [list(x) for x in f] == [list(x) for x in jf], name
        np.testing.assert_array_equal(prim.face_planes(v, f),
                                      jprim.face_planes(jv, jf))
    v, f = prim.mesh_cube(0.5)
    cv, cf = prim.mesh_crop(v, f, np.array([0.3, 0.2, 0.9, -0.1]))
    jcv, jcf = jprim.mesh_crop(v, f, np.array([0.3, 0.2, 0.9, -0.1]))
    np.testing.assert_array_equal(cv, jcv)
    dv, df = prim.mesh_dual(cv, cf)
    jdv, jdf = jprim.mesh_dual(jcv, jcf)
    np.testing.assert_array_equal(dv, jdv)


def test_scale_model_matches_jax(hand_model):
    fields = {f.name: np.asarray(getattr(hand_model, f.name))
              for f in dataclasses.fields(hand_model)}
    mine = scale_model(HandModelArrays(**fields), 1.1).fields()
    ref = j_scale(type(hand_model)(**fields), 1.1)
    for k, v in mine.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(ref, k)),
                                      err_msg=k)


def test_schedules_match_jax(hand_model):
    fields = {f.name: np.asarray(getattr(hand_model, f.name))
              for f in dataclasses.fields(hand_model)}
    mine = build_hand_schedule(fields)
    ref = j_schedule(hand_model)

    def groups(sched):
        gidx, gmask = np.asarray(sched[0]), np.asarray(sched[1])
        return [list(g[m]) for g, m in zip(gidx, gmask)]
    assert mine.joint_lin == groups(ref.joint_lin)
    assert mine.joint_ang == groups(ref.joint_ang)
    assert mine.contact == groups(ref.contact)


def test_camera_and_pose_ops():
    cam = DCamera.default_320x240()
    jcam = JCam.default_320x240()
    assert cam.focal == tuple(float(x) for x in np.asarray(jcam.focal))
    assert cam.principal == tuple(float(x)
                                  for x in np.asarray(jcam.principal))
    rng = np.random.RandomState(0)
    v = rng.rand(16, 3).astype(np.float32) + [0, 0, 0.3]
    np.testing.assert_allclose(cam.projectz(torch.tensor(v)).numpy(),
                               np.asarray(jcam.projectz(v)), rtol=1e-6)
    p = np.concatenate([rng.randn(16, 3), rng.randn(16, 4)], 1).astype(
        np.float32)
    p[:, 3:] /= np.linalg.norm(p[:, 3:], axis=1, keepdims=True)
    tp = torch.tensor(p)
    ident = ppose.pose_mul(tp, ppose.pose_inverse(tp))
    np.testing.assert_allclose(ident.numpy()[:, :3], 0, atol=1e-5)
    np.testing.assert_allclose(np.abs(ident.numpy()[:, 6]), 1, atol=1e-5)
    plane = torch.tensor(np.tile([0.0, 0, 1, -0.5], (16, 1)).astype(
        np.float32))
    wp = ppose.transform_plane(tp, plane)
    x = ppose.pose_apply(tp, torch.tensor([[0.0, 0, 0.5]]).expand(16, 3))
    np.testing.assert_allclose((wp[:, :3] * x).sum(-1) + wp[:, 3], 0,
                               atol=1e-5)


def test_config_load_json(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"physics_iterations": 8, "unknown": 1}))
    cfg = TrackerConfig().load_json(str(path))
    assert cfg.physics_iterations == 8 and cfg.steps == 5


def test_package_lazy_entry_points():
    import hand_tracking_samples_tpu_torch as pkg
    from hand_tracking_samples_tpu_torch.tracker import runtime
    assert pkg.update is runtime.update
    assert pkg.TrackerConfig is TrackerConfig
    assert callable(pkg.from_numpy_model) and callable(pkg.load_hand_model)
