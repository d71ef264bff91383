"""Kernels 6 and 7 (csrc/cloud_rows.cu) through their plain versions,
against the JAX package's Pallas kernels in interpret mode, batched over
tracks, at the CNN frame's widths:

  kernel 7  ops/cloud_rows.cloud_vals_ph, FitError's correspondence, on the
            2048-point frame cloud; then fitting/cloud.fit_error;
  kernel 6  ops/cloud_rows.cloud_rows_unibody, UnibodyFit's per-point rows,
            on the 512-point stride-4 subsample, directed from the camera.

Tolerance: equal winner bodies; winner values, FitError and the rows'
fields within 1e-6 (relative for FitError), the cloud-rows tolerances of
tests/test_torch_cloud_rows.py (measured: bit-identical, the port computes
the JAX CPU build's contracted plane values)."""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from hand_tracking_samples_tpu.assets_paths import DEFAULT_ANIMBANK
from hand_tracking_samples_tpu.data.animbank import load_animbank
from hand_tracking_samples_tpu.data.synth import synth_camera as j_cam
from hand_tracking_samples_tpu.fitting.cloud import fit_error as j_fit_error
from hand_tracking_samples_tpu.imaging.image_ops import (
    cloud_from_depth_planes as j_planes, compact_points as j_compact)
from hand_tracking_samples_tpu.ops.cloud_kernel import (
    planes_points as j_points)
from hand_tracking_samples_tpu.ops.cloud_rows import (
    cloud_rows_unibody as j_unibody, cloud_vals_ph as j_vals)
from hand_tracking_samples_tpu.physics.solver import BodyState as JBody
from hand_tracking_samples_tpu_torch.data.synth import synth_camera
from hand_tracking_samples_tpu_torch.fitting.cloud import fit_error
from hand_tracking_samples_tpu_torch.imaging.image_ops import compact_planes
from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
from hand_tracking_samples_tpu_torch.ops.cloud_kernel import depth_tensor
from hand_tracking_samples_tpu_torch.ops.cloud_rows import (
    cloud_rows_unibody, cloud_vals_ph)
from tests.conftest import cached_fake_depths

# the port tests run small tensors: one intra-op thread each, so the
# suite's parallel workers do not oversubscribe the cores
torch.set_num_threads(1)


def _case(hand_model):
    """Three tracks: two on their renders (one 4 mm off), one far off."""
    bank = load_animbank(DEFAULT_ANIMBANK)
    dyn = cached_fake_depths(hand_model, np.asarray(bank[:30])[:, None],
                             "dyn30")[:, 0]
    depths = np.stack([dyn[3], dyn[12], dyn[20]]).astype(np.uint16)
    poses = bank[[3, 12, 25]].copy()
    poses[1, :, 0] += 0.004
    ph = jax.jit(jax.vmap(lambda d: j_planes(d, j_cam(), 0.1, 0.7, 4,
                                             2048)))(jnp.asarray(depths))
    model = from_numpy_model({k: np.asarray(v) for k, v in
                              vars(hand_model).items()}, "cpu")
    return depths, poses, np.asarray(ph), model


def _jbody(p):
    return JBody(pose=p, linear_momentum=jnp.zeros((17, 3)),
                 angular_momentum=jnp.zeros((17, 3)))


def test_cloud_vals_and_fit_error_match_jax(hand_model):
    depths, poses, ph, model = _case(hand_model)
    jb, jv = jax.jit(jax.vmap(lambda p, h: j_vals(_jbody(p), hand_model,
                                                  h)))(
        jnp.asarray(poses), jnp.asarray(ph))
    tb, tv = cloud_vals_ph(torch.tensor(poses), model, torch.tensor(ph))
    act = ph[:, 4] > 0.5
    np.testing.assert_array_equal(tb.numpy()[act], np.asarray(jb)[act])
    assert np.abs(tv.numpy() - np.asarray(jv))[act].max() < 1e-6
    assert len(np.unique(tb.numpy()[act])) > 10

    cam = j_cam()
    ref = jax.jit(jax.vmap(lambda p, h, d: j_fit_error(
        _jbody(p), hand_model, None, h[4] > 0.5, d, cam, 4.0,
        use_kernel=True, points_ph=h)))(
        jnp.asarray(poses), jnp.asarray(ph), jnp.asarray(depths))
    mine = fit_error(torch.tensor(poses), model, torch.tensor(ph),
                     depth_tensor(depths, "cpu"), synth_camera(), 4.0)
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=1e-6)
    assert mine[2] > 10 * mine[0]              # the far track fits worst


def test_unibody_rows_match_jax(hand_model):
    _, poses, ph, model = _case(hand_model)
    mask = ph[:, 4] > 0.5
    keep = mask & ((np.cumsum(mask, 1) - 1) % 4 == 0)
    origin = np.zeros(3, np.float32)

    def one(p, h, k):
        pts, m = j_points(h)
        upts, umask = j_compact(pts, k, 512)
        blk = j_unibody(_jbody(p), hand_model, upts, umask,
                        jnp.asarray(origin), p[1, :3], 0.1)
        return blk, umask
    ref, umask = jax.jit(jax.vmap(one))(jnp.asarray(poses), jnp.asarray(ph),
                                        jnp.asarray(keep))
    uph = compact_planes(torch.tensor(ph), torch.tensor(keep), 512)
    T = len(poses)
    mine = cloud_rows_unibody(torch.tensor(poses), model, uph,
                              torch.zeros((T, 3)),
                              torch.tensor(poses[:, 1, :3]), 0.1)
    act = np.asarray(umask)
    assert act.sum() > 300
    np.testing.assert_array_equal(mine.active.numpy()[..., 0], act)
    for f in ("normal", "r1", "targetdist", "fmin", "fmax"):
        d = np.abs(getattr(mine, f).numpy() - np.asarray(getattr(ref, f)))
        assert d[act].max() < 1e-6, (f, d[act].max())
