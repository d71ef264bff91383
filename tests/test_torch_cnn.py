"""The CNN frame's front end, the port's plain path against the JAX
package on the same seeded inputs: the .cnnb reader, the net's forward
pass, the image operations and the segmentation behind the net's input,
and the decoding of the net's output.

Tolerances: integer image operations (DownSampleMin, threshold, the
distance transform, the planes-carrier compaction) exactly; the CNN forward
within 1e-5 absolute; the decoded output with equal argmax peaks and every
other field within 1e-5.  The segmentation exactly: every crop of the 352
cached renders, its virtual camera and the net's input bit-identical to the
JAX package's.  That rests on the port computing the segmentation's
float32 sums in the JAX CPU build's order, its products contracted as that
build runs them (maths/fma.py, including the rotation of the resample rays,
whose unit z the build folds), its float32 atan2, sin and cos by the C
library's algorithms that build calls (maths/libm.py), and a true division
where PyTorch's scalar / tensor would multiply by the reciprocal."""
import glob
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hand_tracking_samples_tpu.cnn.labels import (
    analyze_cnn_output as j_analyze)
from hand_tracking_samples_tpu.cnn.model import (
    forward as j_forward, init_params, load_cnnb as j_load)
from hand_tracking_samples_tpu.data.synth import synth_camera as j_cam
from hand_tracking_samples_tpu.imaging.image_ops import (
    compact_planes as j_compact, distance_transform as j_dt,
    downsample_min as j_down, threshold as j_thr)
from hand_tracking_samples_tpu.segment.handsegment import (
    cnn_input_from_segment as j_input, hand_segment_vr as j_seg)
from hand_tracking_samples_tpu_torch.cnn import model as cm
from hand_tracking_samples_tpu_torch.cnn.labels import analyze_cnn_output
from hand_tracking_samples_tpu_torch.data.synth import synth_camera
from hand_tracking_samples_tpu_torch.imaging import image_ops as io
from hand_tracking_samples_tpu_torch.imaging.camera import TrackCamera
from hand_tracking_samples_tpu_torch.ops.cloud_kernel import depth_tensor
from hand_tracking_samples_tpu_torch.segment.handsegment import (
    cnn_input_from_segment, hand_segment_vr)
from tests.conftest import FIXTURES

# the port tests run small tensors: one intra-op thread each, so the
# suite's parallel workers do not oversubscribe the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def renders():
    """Every cached render of the suite (352 frames of 240x320 u16)."""
    return np.concatenate([
        np.load(f)["depths"].reshape(-1, 240, 320)
        for f in sorted(glob.glob(os.path.join(FIXTURES, "cache",
                                               "depths_*.npz")))
    ]).astype(np.uint16)


@pytest.fixture(scope="module")
def segs(renders):
    """(JAX crops, cameras and net inputs; the port's)."""
    cam = j_cam()

    def one(d):
        s = j_seg(d, cam, 0xF, (0.1, 0.7), 0.17)
        return (s.depth, s.cam.pose, s.cam.focal, s.valid,
                j_input(s.depth, cam.depth_scale, (0.1, 0.7)))
    ref = [np.asarray(x) for x in
           jax.jit(jax.vmap(one))(jnp.asarray(renders))]
    s = hand_segment_vr(depth_tensor(renders, "cpu"), synth_camera(), 0xF,
                        (0.1, 0.7), 0.17)
    mine = (s.depth.numpy(), s.cam.pose.numpy(), s.cam.focal.numpy(),
            s.valid.numpy(),
            cnn_input_from_segment(s.depth, 0.001, (0.1, 0.7)).numpy())
    return ref, mine


def test_image_ops_match_jax(renders):
    d = renders[:8]
    small_j = jax.vmap(lambda x: j_down(j_down(x)))(jnp.asarray(d))
    dt_j = jax.vmap(lambda x: j_dt(j_thr(x, hi=jnp.uint16(699))))(small_j)
    small = io.downsample_min(io.downsample_min(
        io.depth_u16(depth_tensor(d, "cpu"))))
    dt = io.distance_transform(io.threshold(small, hi=699))
    np.testing.assert_array_equal(small.numpy(), np.asarray(small_j))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dt_j))
    assert (dt.numpy() > 2).sum() > 1000

    rng = np.random.default_rng(5)
    ph = rng.standard_normal((3, 8, 256)).astype(np.float32)
    ph[:, 3] = 1.0
    ph[:, 4] = rng.random((3, 256)) < 0.7
    ph[:, 5:] = 0.0
    keep = (ph[:, 4] > 0.5) & (rng.random((3, 256)) < 0.5)
    ref = jax.vmap(lambda p, k: j_compact(p, k, 96))(jnp.asarray(ph),
                                                     jnp.asarray(keep))
    mine = io.compact_planes(torch.tensor(ph), torch.tensor(keep), 96)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))


def test_segmentation_matches_jax(segs):
    (jd, jp, jf, jv, ji), (td, tp, tf, tv, ti) = segs
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)                   # focal
    np.testing.assert_array_equal(tp, jp)                   # camera pose
    np.testing.assert_array_equal(td, jd)                   # every crop
    np.testing.assert_array_equal(ti, ji)                   # the net input


def test_cnnb_load_and_forward_match_jax(tmp_path):
    """The .cnnb reader on a file the JAX package wrote (seeded init) and on
    the shipped net; the forward pass on 4 seeded inputs within 1e-5."""
    from hand_tracking_samples_tpu.cnn.model import save_cnnb
    from hand_tracking_samples_tpu_torch.assets_paths import DEFAULT_CNNB
    p = init_params(jax.random.PRNGKey(3))
    path = str(tmp_path / "seeded.cnnb")
    save_cnnb(p, path)
    for f in (path, DEFAULT_CNNB):
        ref = j_load(f)
        mine = cm.load_cnnb(f, "cpu")
        for layer in ("conv1", "conv2", "fc1", "fc2"):
            for k in ("w", "b"):
                np.testing.assert_array_equal(mine[layer][k].numpy(),
                                              np.asarray(ref[layer][k]))
    x = np.random.default_rng(1).random((4, 64, 64)).astype(np.float32)
    for params in (p, j_load(DEFAULT_CNNB)):
        ref = np.asarray(jax.jit(j_forward)(params, jnp.asarray(x)))
        mine = cm.forward(cm.from_numpy(
            jax.tree.map(np.asarray, params), "cpu"), torch.tensor(x))
        assert mine.shape == (4, cm.OUT)
        assert np.abs(mine.numpy() - ref).max() < 1e-5


def test_analyze_cnn_output_matches_jax(segs):
    """The decoded net output on the shipped net's outputs for 16 crops."""
    from hand_tracking_samples_tpu_torch.assets_paths import DEFAULT_CNNB
    (_, jp, jf, _, ji), _ = segs
    k = np.arange(0, len(ji), len(ji) // 16)[:16]
    out = np.asarray(jax.jit(j_forward)(j_load(DEFAULT_CNNB),
                                        jnp.asarray(ji[k])))
    cam = j_cam()

    def one(o, pose, focal):
        hc = cam._replace(dim=(64, 64), focal=focal,
                          principal=jnp.asarray([32.0, 32.0]),
                          pose=pose).sub(4)
        return j_analyze(o, hc)
    ref = jax.jit(jax.vmap(one))(jnp.asarray(out), jnp.asarray(jp[k]),
                                 jnp.asarray(jf[k]))
    hc = TrackCamera((64, 64), torch.tensor(jf[k]),
                     torch.full((16, 2), 32.0), 0.001,
                     torch.tensor(jp[k])).sub(4)
    mine = analyze_cnn_output(torch.tensor(out), hc)
    peaks_j = out[:, :2048].reshape(16, 8, 256).argmax(-1)
    peaks_p = torch.tensor(out[:, :2048]).reshape(16, 8, 256).argmax(-1)
    np.testing.assert_array_equal(peaks_p.numpy(), peaks_j)
    for f in mine._fields:
        err = np.abs(getattr(mine, f).numpy()
                     - np.asarray(getattr(ref, f))).max()
        assert err < 1e-5, (f, err)


def test_libm_matches_jax():
    """maths.libm's float32 atan2, sin and cos equal the JAX CPU build's
    bit for bit (2^20 inputs each; the zero, unit and tiny-ratio cases of
    atan2 among them)."""
    from hand_tracking_samples_tpu_torch.maths import libm
    rng = np.random.default_rng(1)
    n = 1 << 20
    y = rng.standard_normal(n).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    y[:1000] = 0.0
    x[1000:2000] = 0.0
    x[2000:2100] = 1.0
    x[2200:2300] *= 1e-20
    y[2300:2400] *= 1e-20
    np.testing.assert_array_equal(
        libm.atan2f(torch.tensor(y), torch.tensor(x)).numpy(),
        np.asarray(jax.jit(jnp.arctan2)(y, x)))
    a = rng.uniform(-100.0, 100.0, n).astype(np.float32)
    a[:n // 2] *= np.float32(np.pi / 200.0)
    np.testing.assert_array_equal(libm.sinf(torch.tensor(a)).numpy(),
                                  np.asarray(jax.jit(jnp.sin)(a)))
    np.testing.assert_array_equal(libm.cosf(torch.tensor(a)).numpy(),
                                  np.asarray(jax.jit(jnp.cos)(a)))


def test_fma_forms_match_jax():
    """maths.fma's CPU form (addcmul where this build fuses it) and
    fma_exact equal the JAX CPU build's contracted c + a*b bit for bit, on
    2^16 inputs half of which cancel a*b (where rounding a*b first
    changes the result) and a double-rounding case."""
    from hand_tracking_samples_tpu_torch.maths import fma as fq
    rng = np.random.default_rng(2)
    n = 1 << 16
    a, b, c = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    c[: n // 2] = -(a[: n // 2].astype(np.float64)
                    * b[: n // 2]).astype(np.float32)
    x = np.float32(1 + 2 ** -12)
    a[0], b[0], c[0] = x, x, np.float32(2 ** -70)
    ref = np.asarray(jax.jit(lambda a, b, c: c + a * b)(a, b, c))
    for f in (fq.fma, fq.fma_exact):
        np.testing.assert_array_equal(
            f(*(torch.tensor(v) for v in (a, b, c))).numpy(), ref)


def test_camera_heatmaps_and_compaction_match_jax():
    """The rest of this slice's host helpers on seeded inputs: the camera
    algebra (fov, deproject_extents, crop, sub, scaled), the heatmap decode
    (first-maximum peaks, sub-pixel peaks, volumes, 1-D peaks), the point
    compaction and the cloud-force scaling."""
    from hand_tracking_samples_tpu.fitting.cloud import (
        scale_cloud_forces as j_scale)
    from hand_tracking_samples_tpu.imaging import heatmaps as jh
    from hand_tracking_samples_tpu.imaging.image_ops import (
        compact_points as j_cpts)
    from hand_tracking_samples_tpu_torch.fitting.cloud import (
        scale_cloud_forces)
    from hand_tracking_samples_tpu_torch.imaging import heatmaps as th
    from hand_tracking_samples_tpu_torch.physics.solver import LinearRows
    jc, tc = j_cam(), synth_camera()
    # fov: two atan2s, the two libraries' float32 atan2 agree to an ulp
    assert np.abs(tc.fov().numpy() - np.asarray(jc.fov())).max() < 1e-6
    np.testing.assert_array_equal(tc.deproject_extents().numpy(),
                                  np.asarray(jc.deproject_extents()))
    for j, t in ((jc.crop((10, 7), (64, 48)), tc.crop((10, 7), (64, 48))),
                 (jc.sub(4), tc.sub(4)), (jc.scaled(2), tc.scaled(2))):
        assert j.dim == t.dim
        np.testing.assert_array_equal(np.float32(t.focal),
                                      np.asarray(j.focal))
        np.testing.assert_array_equal(np.float32(t.principal),
                                      np.asarray(j.principal))

    rng = np.random.default_rng(7)
    img = rng.random((6, 16, 16)).astype(np.float32)
    img[0, 3, 4] = img[0, 9, 1] = 2.0                       # a tie
    mx_j = np.stack([np.asarray(jh.image_find_max(jnp.asarray(i)))
                     for i in img])
    mx = th.image_find_max(torch.tensor(img))
    np.testing.assert_array_equal(mx.numpy(), mx_j)
    pk_j = np.stack([np.asarray(jh.peak_subpixel(jnp.asarray(i),
                                                 jnp.asarray(m)))
                     for i, m in zip(img, mx_j)])
    pk = th.peak_subpixel(torch.tensor(img), mx)
    assert np.abs(pk.numpy() - pk_j).max() < 1e-5
    pv_j = np.stack([np.asarray(jh.peak_volume(jnp.asarray(i),
                                               jnp.asarray(p)))
                     for i, p in zip(img, pk_j)])
    assert np.abs(th.peak_volume(torch.tensor(img), pk).numpy()
                  - pv_j).max() < 1e-5
    rows = rng.random((4, 16, 16)).astype(np.float32)
    p1_j = np.stack([np.asarray(jh.peaks_1d(jnp.asarray(r))) for r in rows])
    assert np.abs(th.peaks_1d(torch.tensor(rows)).numpy() - p1_j).max() \
        < 1e-6

    pts = rng.standard_normal((3, 200, 3)).astype(np.float32)
    mask = rng.random((3, 200)) < 0.4
    ref = [jax.vmap(lambda p, m: j_cpts(p, m, 64)[k])(jnp.asarray(pts),
                                                      jnp.asarray(mask))
           for k in (0, 1)]
    cp, cm = io.compact_points(torch.tensor(pts), torch.tensor(mask), 64)
    np.testing.assert_array_equal(cp.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(cm.numpy(), np.asarray(ref[1]))

    f = rng.standard_normal((3, 5)).astype(np.float32)
    sc = rng.random((3, 5)).astype(np.float32)
    z = np.zeros((3, 5), np.float32)
    fields = dict(b0=z, b1=z, normal=z, r0=z, r1=z, targetdist=z,
                  targetspeednobias=z, fmin=-np.abs(f), fmax=np.abs(f),
                  friction_master=z, friction_coef=z, active=z)
    from hand_tracking_samples_tpu.physics.solver import LinearRows as JRows
    j = j_scale(JRows(**{k: jnp.asarray(v) for k, v in fields.items()}),
                jnp.asarray(sc))
    t = scale_cloud_forces(LinearRows(**{k: torch.tensor(v) for k, v in
                                         fields.items()}), torch.tensor(sc))
    np.testing.assert_array_equal(t.fmin.numpy(), np.asarray(j.fmin))
    np.testing.assert_array_equal(t.fmax.numpy(), np.asarray(j.fmax))
