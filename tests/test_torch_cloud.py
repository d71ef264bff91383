"""Kernel 1's plain version (ops/cloud_kernel's
cloud_from_depth_planes_plain, what the port runs on the CPU) is
bit-identical to the JAX package's imaging.image_ops.cloud_from_depth on the
cached renders, the uniform overflow thinning included; and the port's
fake_depth renders what the JAX package's did."""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from hand_tracking_samples_tpu.data.synth import synth_camera as j_cam
from hand_tracking_samples_tpu.imaging.image_ops import (
    cloud_from_depth as j_cloud)
from hand_tracking_samples_tpu.assets_paths import DEFAULT_ANIMBANK
from hand_tracking_samples_tpu.data.animbank import load_animbank
from hand_tracking_samples_tpu_torch.data.synth import fake_depth, synth_camera
from hand_tracking_samples_tpu_torch.imaging.image_ops import (
    cloud_from_depth, depth_tensor)
from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
from tests.conftest import cached_fake_depths

# the port tests run small tensors: one intra-op thread each, so the
# suite's parallel workers do not oversubscribe the cores
torch.set_num_threads(1)


def _depths(hand_model):
    bank = load_animbank(DEFAULT_ANIMBANK)
    dyn = cached_fake_depths(hand_model, np.asarray(bank[:30])[:, None],
                             "dyn30")[:, 0]
    pgs = cached_fake_depths(hand_model, np.asarray(bank[[10, 400]]), "pgs2")
    return np.concatenate([dyn[[0, 17, 29]], pgs]), bank


def test_cloud_bit_identical(hand_model):
    depths, _ = _depths(hand_model)
    cam, jc = synth_camera(), j_cam()
    for frac, budget in ((4, 2048), (4, 1024), (3, 1024)):
        pts, ok = cloud_from_depth(depth_tensor(depths, "cpu"), cam, 0.1,
                                   0.7, frac, budget)
        f = jax.jit(jax.vmap(lambda d: j_cloud(d, jc, 0.1, 0.7, frac,
                                               budget)))
        jp, jo = (np.asarray(x) for x in f(jnp.asarray(depths)))
        np.testing.assert_array_equal(ok.numpy(), jo)
        np.testing.assert_array_equal(pts.numpy(), jp)


def test_cloud_overflow_uniform(hand_model):
    """More kept points than the budget: both take the same uniform subset
    (never a raster-order tail cut), every slot valid, bit-identical."""
    depths, _ = _depths(hand_model)
    cam, jc = synth_camera(), j_cam()
    full, okf = cloud_from_depth(depth_tensor(depths, "cpu"), cam, 0.1, 0.7,
                                 4, 4096)
    budget = 128
    assert (okf.sum(1) > budget).all()
    pts, ok = cloud_from_depth(depth_tensor(depths, "cpu"), cam, 0.1, 0.7, 4,
                               budget)
    f = jax.jit(jax.vmap(lambda d: j_cloud(d, jc, 0.1, 0.7, 4, budget)))
    jp, jo = (np.asarray(x) for x in f(jnp.asarray(depths)))
    np.testing.assert_array_equal(ok.numpy(), jo)
    np.testing.assert_array_equal(pts.numpy(), jp)
    assert ok.all()
    for t in range(len(depths)):
        ys_f = full[t][okf[t], 1].numpy()
        ys_b = pts[t, :, 1].numpy()
        assert ys_b.min() < np.percentile(ys_f, 2)
        assert ys_b.max() > np.percentile(ys_f, 98)


def test_fake_depth_matches_cached_render(hand_model):
    """The port's renderer against the JAX-rendered cache: the same pixels
    are hit, and depths agree to the unit (float32 rounding of the slab
    clip can flip the truncation to u16 by one)."""
    depths, bank = _depths(hand_model)
    model = from_numpy_model({k: np.asarray(v) for k, v in
                              vars(hand_model).items()}, "cpu")
    mine = fake_depth(torch.tensor(bank[[0, 17]]), model, synth_camera())
    mine = mine.to(torch.int32).numpy() & 0xFFFF
    ref = depths[:2].astype(np.int32)
    assert np.array_equal(mine == 3999, ref == 3999)
    assert np.abs(mine - ref).max() <= 1
    assert (mine == ref).mean() > 0.999
