"""The label side of the CNN in the port against the JAX package and the
C++ goldens:

  heatmaps     render_heatmap(s) and render_1d_heatmaps byte for byte with
               golden.json (heatmap_7p3_4p6, heatmap1d) and with JAX (eager
               and jitted) on 4096 seeded peaks and 4096 seeded values;
  labels       skin_feature_points, image_feature_points,
               hand_pose_to_key_angle_set and gather_hand_expected: the
               golden frame at tests/test_cnn.py's tolerances (key angles
               1e-5, feature points 1e-3, the 2304-float target 1e-5), and
               bit for bit with JAX's jitted labels on every 7th animbank
               pose (334 poses); the decode recovers the encoded landmarks;
  quat_from_mat   within 1e-6 of JAX on 512 seeded rotations, and the
               inverse of qmat;
  libm         expf, acosf and asinf bit for bit with JAX's jitted exp,
               arccos and arcsin;
  image ops    downsample_max/avg/fst and upsample exactly equal to JAX on
               seeded u16 and float32 rasters, sample and image_clip
               exactly, depth_mesh's masks and triangles exactly and its
               vertices within 3e-7 m of JAX's jitted mesh (2.4e-7
               measured; its eager mesh exactly).

The JAX calls here are small and run in the test (about 10 s in all)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import DEFAULT_ANIMBANK, FIXTURES

torch.set_num_threads(1)


def _dcams():
    from hand_tracking_samples_tpu.imaging.camera import DCamera as JC
    from hand_tracking_samples_tpu_torch.imaging.camera import DCamera as PC
    return JC, PC


def test_heatmaps_golden(golden):
    from hand_tracking_samples_tpu_torch.imaging.heatmaps import (
        render_1d_heatmaps, render_heatmap)
    hm = render_heatmap(torch.tensor([7.3, 4.6])).numpy()
    np.testing.assert_array_equal(
        hm, np.array(golden["heatmap_7p3_4p6"]).reshape(16, 16))
    vm = render_1d_heatmaps(torch.tensor([0.2, 0.55, 0.91]), 16).numpy()
    np.testing.assert_array_equal(vm,
                                  np.array(golden["heatmap1d"]).reshape(3, 16))


def test_heatmaps_match_jax():
    from hand_tracking_samples_tpu.imaging import heatmaps as J
    from hand_tracking_samples_tpu_torch.imaging import heatmaps as P
    rng = np.random.RandomState(11)
    peaks = rng.uniform(-2.5, 18.5, (4096, 2)).astype(np.float32)
    vals = rng.uniform(-0.1, 1.1, 4096).astype(np.float32)
    mine = P.render_heatmaps(torch.tensor(peaks)).numpy()
    mine1 = P.render_1d_heatmaps(torch.tensor(vals)).numpy()
    for fn in (lambda f: f, jax.jit):
        np.testing.assert_array_equal(
            mine, np.asarray(fn(J.render_heatmaps)(jnp.asarray(peaks))))
        np.testing.assert_array_equal(
            mine1, np.asarray(fn(J.render_1d_heatmaps)(jnp.asarray(vals))))
    # the renormalisation: a splat inside the image sums to 255 - < 25
    s = mine.reshape(len(peaks), -1).astype(np.int64).sum(1)
    inside = ((peaks >= 2) & (peaks < 14)).all(1)
    assert ((s[inside] <= 255) & (s[inside] > 230)).all()


def test_labels_golden(golden):
    from hand_tracking_samples_tpu_torch.cnn.labels import (
        gather_hand_expected, hand_pose_to_key_angle_set,
        image_feature_points)
    _, PC = _dcams()
    poses = torch.tensor(np.array(golden["animbank_frame0"], np.float32))
    hcam = PC.make((16, 16))
    vals = hand_pose_to_key_angle_set(poses, torch.tensor(
        [0, 0, 0, 0, 0, 0, 1.0]))
    np.testing.assert_allclose(vals.numpy(), golden["key_angles_frame0"],
                               atol=1e-5)
    fp = image_feature_points(poses, hcam)
    np.testing.assert_allclose(fp.numpy().reshape(-1),
                               golden["feature_points_frame0"], atol=1e-3)
    exp, _, _ = gather_hand_expected(poses, hcam)
    np.testing.assert_allclose(exp.numpy(), golden["cnn_expected_frame0"],
                               atol=1e-5)


def test_labels_match_jax():
    from hand_tracking_samples_tpu.cnn import labels as J
    from hand_tracking_samples_tpu_torch.cnn import labels as P
    from hand_tracking_samples_tpu_torch.data.animbank import load_animbank
    JC, PC = _dcams()
    bank = load_animbank(DEFAULT_ANIMBANK)
    poses = bank[np.arange(0, len(bank), 7)]
    want = jax.jit(jax.vmap(lambda p: J.gather_hand_expected(
        p, JC.make((16, 16)))))(jnp.asarray(poses))
    got = P.gather_hand_expected(torch.tensor(poses), PC.make((16, 16)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    skin = jax.jit(jax.vmap(J.skin_feature_points))(jnp.asarray(poses))
    np.testing.assert_array_equal(
        P.skin_feature_points(torch.tensor(poses)).numpy(), np.asarray(skin))


def test_analysis_decodes_labels(golden):
    from hand_tracking_samples_tpu_torch.cnn.labels import (
        analyze_cnn_output, gather_hand_expected)
    from hand_tracking_samples_tpu_torch.imaging.camera import TrackCamera
    poses = torch.tensor(np.array(golden["animbank_frame0"], np.float32))
    hcam = TrackCamera((16, 16), torch.tensor([[16.0, 16.0]]),
                       torch.tensor([[8.0, 8.0]]), 0.001,
                       torch.tensor([[0, 0, 0, 0, 0, 0, 1.0]]))
    exp, fp, vals = gather_hand_expected(poses[None], hcam)
    a = analyze_cnn_output(exp, hcam)
    fp = fp.numpy()
    inside = ((fp > 0.5) & (fp < 14.5)).all(-1)
    assert np.abs(a.image_points.numpy() - fp)[inside].max() < 0.25
    assert np.abs(a.vals.numpy() - vals.numpy()).max() < 0.04


def test_quat_from_mat():
    from hand_tracking_samples_tpu.maths.quat import quat_from_mat as J
    from hand_tracking_samples_tpu_torch.maths.quat import (qmat,
                                                            quat_from_mat)
    rng = np.random.RandomState(5)
    q = rng.randn(512, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    m = qmat(torch.tensor(q))
    got = quat_from_mat(m).numpy()
    np.testing.assert_allclose(got, np.asarray(J(jnp.asarray(m.numpy()))),
                               atol=1e-6)
    sign = np.sign((got * q).sum(1, keepdims=True))
    np.testing.assert_allclose(got * sign, q, atol=1e-5)


def test_libm_match_jax():
    from hand_tracking_samples_tpu_torch.maths.libm import (acosf, asinf,
                                                            expf)
    rng = np.random.RandomState(2)
    x = np.concatenate([rng.uniform(-95, 88, 1 << 18),
                        rng.uniform(-1, 1, 1 << 16)]).astype(np.float32)
    np.testing.assert_array_equal(expf(torch.tensor(x)).numpy(),
                                  np.asarray(jax.jit(jnp.exp)(x)))
    c = np.concatenate([rng.uniform(-1, 1, 1 << 18),
                        1 - rng.uniform(0, 1e-3, 1 << 14),
                        [-1.0, 0.0, 1.0]]).astype(np.float32)
    ja, js = jax.jit(lambda v: (jnp.arccos(v), jnp.arcsin(v)))(c)
    np.testing.assert_array_equal(acosf(torch.tensor(c)).numpy(),
                                  np.asarray(ja))
    np.testing.assert_array_equal(asinf(torch.tensor(c)).numpy(),
                                  np.asarray(js))


@pytest.fixture(scope="module")
def rasters():
    rng = np.random.RandomState(9)
    return ((rng.rand(3, 240, 320) * 8000).astype(np.uint16),
            rng.rand(2, 24, 32).astype(np.float32))


@pytest.mark.parametrize("name", ["downsample_max", "downsample_avg",
                                  "downsample_fst", "upsample"])
def test_pyramid_ops_match_jax(rasters, name):
    from hand_tracking_samples_tpu.imaging import image_ops as J
    from hand_tracking_samples_tpu_torch.imaging import image_ops as P
    u16, f32 = rasters
    got = getattr(P, name)(torch.tensor(u16.astype(np.int32))).numpy()
    want = np.stack([np.asarray(getattr(J, name)(jnp.asarray(x)))
                     for x in u16])
    np.testing.assert_array_equal(got, want.astype(np.int64))
    got = getattr(P, name)(torch.tensor(f32)).numpy()
    want = np.stack([np.asarray(getattr(J, name)(jnp.asarray(x)))
                     for x in f32])
    np.testing.assert_array_equal(got, want)


def test_resample_mesh_clip_match_jax(rasters):
    from hand_tracking_samples_tpu.imaging import image_ops as J
    from hand_tracking_samples_tpu_torch.imaging import image_ops as P
    JC, PC = _dcams()
    u16 = rasters[0]
    cams = [C.make((320, 240), (305, 305), (160, 120)) for C in (JC, PC)]
    pose = [0.01, -0.02, 0.0, 0.1, 0.05, -0.03, 0.99]
    dst = [C.make((64, 64), (120, 120), (32, 32), pose=pose)
           for C in (JC, PC)]
    t = torch.tensor(u16.astype(np.int32))
    plane = np.array([0.3, -0.2, -0.93, 3.0], np.float32)
    got_s = P.sample(t, cams[1], dst[1], 7).numpy()
    got_c = P.image_clip(t, cams[1], plane, 4000).numpy()
    got_m = P.depth_mesh(t, cams[1], 0.1, 7.0, 0.05, 2)
    for f, x in enumerate(u16):
        xj = jnp.asarray(x)
        np.testing.assert_array_equal(
            got_s[f], np.asarray(J.sample(xj, cams[0], dst[0], 7)))
        np.testing.assert_array_equal(got_c[f], np.asarray(
            jax.jit(lambda d: J.image_clip(d, cams[0], jnp.asarray(plane),
                                           4000))(xj)))
        for fn, tol in ((lambda g: g, 0.0), (jax.jit, 3e-7)):
            v, vm, tri, tm = fn(lambda d: J.depth_mesh(
                d, cams[0], 0.1, 7.0, 0.05, 2))(xj)
            assert np.abs(got_m[0][f].numpy() - np.asarray(v)).max() <= tol
            np.testing.assert_array_equal(got_m[1][f].numpy(), np.asarray(vm))
            np.testing.assert_array_equal(got_m[2].numpy(), np.asarray(tri))
            np.testing.assert_array_equal(got_m[3][f].numpy(), np.asarray(tm))
    assert 0.2 < (got_c == 4000).mean() < 0.8      # the plane cuts the image
    assert (got_s != 7).mean() > 0.5                # most samples land inside
