"""Kernel 2.5's plain version (ops/cloud_rows.cloud_rows_packed_plain, the
16-channel parity pack) against the JAX package's
ops.cloud_rows.cloud_rows_packed_planes_ph (its Pallas kernel in interpret
mode), T=2 tracks at full width (17 bodies, 96 planes a hull, 128 slots a
body):

  N=2048  the dynamics pass's cloud (cloud_from_depth at the point budget),
          renders on which some body wins more than 128 points, so the
          uniform thinning runs;
  N=512   MultiStepSim's cloud (the stride-4 subsample compacted to 512),
          with the camera off the origin.

Tolerance: the counts equal, the same slots occupied, and every channel of
every active slot within 1e-6, the bound test_torch_cloud_rows.py holds
kernel 2 to (the JAX suite's row-field bound, test_cloud_rows_kernel.py:49).
The SingleBodyLinear that cloud_rows_packed_ph rebuilds and its `dropped`
counts equal the JAX package's cloud_rows_packed_ph."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hand_tracking_samples_tpu.assets_paths import DEFAULT_ANIMBANK
from hand_tracking_samples_tpu.data.animbank import load_animbank
from hand_tracking_samples_tpu.data.synth import synth_camera as j_cam
from hand_tracking_samples_tpu.imaging.image_ops import (
    cloud_from_depth as j_cloud, compact_points as j_compact)
from hand_tracking_samples_tpu.ops.cloud_rows import (
    cloud_rows_packed_ph as j_block, cloud_rows_packed_planes_ph as j_pack,
    points_planes as j_points_planes)
from hand_tracking_samples_tpu.physics.solver import BodyState as JBody
from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
from hand_tracking_samples_tpu_torch.ops.cloud_rows import (
    _kernel_inputs_ph, cloud_rows_packed_ph, cloud_rows_packed_plain)
from tests.conftest import cached_fake_depths

# the port tests run small tensors: one intra-op thread each, so the
# suite's parallel workers do not oversubscribe the cores
torch.set_num_threads(1)

SLOTS = 128
B = 17
ORIGIN = {2048: (0.0, 0.0, 0.0), 512: (0.01, -0.02, 0.005)}


def _case(hand_model, n):
    """(poses (2, 17, 7), (N, 3) points (2, n, 3), mask (2, n)) on the
    dyn30 renders 3 and 12, the second track 4 mm off its render."""
    bank = load_animbank(DEFAULT_ANIMBANK)
    dyn = cached_fake_depths(hand_model, np.asarray(bank[:30])[:, None],
                             "dyn30")[:, 0]
    depths = np.stack([dyn[3], dyn[12]])
    poses = bank[[2, 11]].copy()
    poses[1, :, 0] += 0.004

    def cloud(d):
        pts, mask = j_cloud(d, j_cam(), 0.1, 0.7, 4, 2048)
        if n == 2048:
            return pts, mask
        keep = mask & ((jnp.cumsum(mask) - 1) % 4 == 0)   # MultiStepSim's
        return j_compact(pts, keep, n)
    pts, mask = jax.jit(jax.vmap(cloud))(jnp.asarray(depths))
    return poses, np.asarray(pts), np.asarray(mask)


@pytest.fixture(scope="module")
def port(hand_model):
    return from_numpy_model({k: np.asarray(v) for k, v in
                             vars(hand_model).items()}, "cpu")


def _scale():
    return np.where(np.arange(B) <= 2, 0.4, 1.0).astype(np.float32)


def _jax_side(hand_model, poses, pts, mask, origin):
    def one(p, x, m):
        s = JBody(pose=p, linear_momentum=jnp.zeros((B, 3)),
                  angular_momentum=jnp.zeros((B, 3)))
        ph = j_points_planes(x, m)
        o = jnp.asarray(origin, jnp.float32)
        sc = jnp.asarray(_scale())
        return (j_pack(s, hand_model, ph, o, sc, SLOTS),
                j_block(s, hand_model, ph, o, sc, SLOTS))
    (jp, jc), (blk, dropped) = jax.jit(jax.vmap(one))(
        jnp.asarray(poses), jnp.asarray(pts), jnp.asarray(mask))
    return (np.asarray(jp), np.asarray(jc)[:, :, 0],
            jax.tree.map(np.asarray, blk), np.asarray(dropped))


@pytest.mark.parametrize("n", [2048, 512])
def test_cloud_rows_packed_matches_jax(hand_model, port, n):
    from hand_tracking_samples_tpu_torch.ops.cloud_rows import points_planes
    poses, pts, mask = _case(hand_model, n)
    origin = ORIGIN[n]
    jp, jc, jblk, jdrop = _jax_side(hand_model, poses, pts, mask, origin)
    tpose = torch.tensor(poses)
    ph = points_planes(torch.tensor(pts), torch.tensor(mask))
    args = _kernel_inputs_ph(tpose, port, origin, torch.tensor(_scale()),
                             0.0)
    tp, tc = (x.numpy() for x in cloud_rows_packed_plain(ph, *args, SLOTS))

    np.testing.assert_array_equal(tc, jc)                    # counts
    if n == 2048:
        assert (tc > SLOTS).any()              # the uniform thinning runs
    occ = jp[:, 15] > 0.5
    np.testing.assert_array_equal(tp[:, 15] > 0.5, occ)     # winners, slots
    assert occ.sum() > 200
    d = np.abs(tp - jp)
    for ch in range(16):
        assert d[:, ch][occ].max() < 1e-6, (ch, d[:, ch][occ].max())
        assert (tp[:, ch][~occ] == 0).all(), ch              # empty slots

    blk, dropped = cloud_rows_packed_ph(tpose, port, ph, origin,
                                        torch.tensor(_scale()), SLOTS)
    np.testing.assert_array_equal(dropped.numpy(), jdrop)
    if n == 2048:
        assert dropped.numpy().max() > 0
    for f in blk._fields:
        np.testing.assert_array_equal(getattr(blk, f).numpy(),
                                      getattr(jblk, f), err_msg=f)
