"""Kernel 2's plain version (ops/cloud_rows.cloud_rows_solve_plain) against
the JAX package's 12-channel solve pack (ops.cloud_rows.cloud_rows_solve_ph,
its Pallas kernel in interpret mode), batched over tracks.

Tolerance: the same winners (slot occupancy) and per-body counts exactly,
and every channel of every active slot within 1e-6, the JAX suite's bound
on the row fields (test_cloud_rows_kernel.py:49), tsm compared as
tsm*dt (= targetdist).  The port computes the plane values that pick the
winner and the hull-normal blend, the world inverse inertia and J1, K1 and
dinv with the JAX CPU build's contracted expressions (maths/fma.py), so
near-coplanar hull planes that tie to the last ulp tie in both packages
(measured: every channel bit-identical at both widths)."""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from hand_tracking_samples_tpu.assets_paths import DEFAULT_ANIMBANK
from hand_tracking_samples_tpu.data.animbank import load_animbank
from hand_tracking_samples_tpu.data.synth import synth_camera as j_cam
from hand_tracking_samples_tpu.imaging.image_ops import (
    cloud_from_depth_planes as j_planes)
from hand_tracking_samples_tpu.ops.cloud_rows import (
    cloud_rows_solve_ph as j_solve)
from hand_tracking_samples_tpu.physics.solver import BodyState as JBody
from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
from hand_tracking_samples_tpu_torch.ops.cloud_rows import (
    _kernel_inputs_ph, cloud_rows_solve_plain)
from tests.conftest import cached_fake_depths

# the port tests run small tensors: one intra-op thread each, so the
# suite's parallel workers do not oversubscribe the cores
torch.set_num_threads(1)

DT = float(np.float32(1.0 / 60.0))


def _case(hand_model, budget):
    bank = load_animbank(DEFAULT_ANIMBANK)
    dyn = cached_fake_depths(hand_model, np.asarray(bank[:30])[:, None],
                             "dyn30")[:, 0]
    pgs = cached_fake_depths(hand_model, np.asarray(bank[[10, 400]]), "pgs2")
    depths = np.stack([dyn[3], dyn[12], pgs[1]])
    poses = bank[[2, 11, 400]].copy()
    poses[1, :, 0] += 0.004                       # a track off its render
    ph = jax.jit(jax.vmap(lambda d: j_planes(d, j_cam(), 0.1, 0.7, 4,
                                             budget)))(jnp.asarray(depths))
    return poses, np.asarray(ph)


def _compare(hand_model, budget, slots):
    poses, ph = _case(hand_model, budget)
    B = 17
    scale_b = np.where(np.arange(B) <= 2, 0.4, 1.0).astype(np.float32)

    def one(p, h):
        s = JBody(pose=p, linear_momentum=jnp.zeros((B, 3)),
                  angular_momentum=jnp.zeros((B, 3)))
        return j_solve(s, hand_model, h, jnp.zeros(3), jnp.asarray(scale_b),
                       slots, jnp.float32(DT))
    jp, jc = (np.asarray(x) for x in jax.jit(jax.vmap(one))(
        jnp.asarray(poses), jnp.asarray(ph)))
    model = from_numpy_model({k: np.asarray(v) for k, v in
                              vars(hand_model).items()}, "cpu")
    args = _kernel_inputs_ph(torch.tensor(poses), model, (0.0, 0.0, 0.0),
                             torch.tensor(scale_b), DT)
    tp, tc = cloud_rows_solve_plain(torch.tensor(ph), *args, slots)
    tp, tc = tp.numpy(), tc.numpy()

    np.testing.assert_array_equal(tc, jc[:, :, 0])          # counts
    occ = jp[:, 9] != 0
    np.testing.assert_array_equal(tp[:, 9] != 0, occ)       # winners, slots
    assert occ.sum() > 100
    d = np.abs(tp - jp)
    for ch in range(12):
        err = d[:, ch][occ].max()
        if ch == 10:                           # tsm = td / dt
            err = err * DT
        assert err < 1e-6, (ch, err)
    return tc


def test_cloud_rows_solve_matches_jax(hand_model):
    counts = _compare(hand_model, 2048, 128)
    assert (counts > 128).any()                # the uniform thinning runs


def test_cloud_rows_solve_matches_jax_small_cap(hand_model):
    counts = _compare(hand_model, 512, 32)
    assert (counts > 32).sum() >= 3


def test_reference_rows_and_chamber_match_jax(hand_model):
    """fitting/cloud.py's reference-shaped rows (closest_planes,
    cloud_constraint_rows) and the boundary-plane chamber
    against the JAX package's: the same winning bodies, fields within 1e-6
    (test_cloud_rows_kernel.py:49)."""
    from hand_tracking_samples_tpu.fitting.cloud import (
        cloud_chamber_rows as j_chamber, cloud_constraint_rows as j_rows)
    from hand_tracking_samples_tpu.imaging.image_ops import (
        cloud_from_depth as j_cloud)
    from hand_tracking_samples_tpu.tracker.runtime import BOUNDARY_OUTDIRS
    from hand_tracking_samples_tpu_torch.fitting.cloud import (
        cloud_chamber_rows, cloud_constraint_rows)
    bank = load_animbank(DEFAULT_ANIMBANK)
    depths = cached_fake_depths(hand_model, np.asarray(bank[[10, 400]]),
                                "pgs2")
    poses = bank[[10, 400]].copy()
    poses[:, :, 0] += 0.003
    model = from_numpy_model({k: np.asarray(v) for k, v in
                              vars(hand_model).items()}, "cpu")

    @jax.jit
    def jax_side(pose, depth):
        pts, mask = j_cloud(depth, j_cam(), 0.1, 0.7, 4, 1024)
        s = JBody(pose, jnp.zeros((17, 3)), jnp.zeros((17, 3)))
        return (pts, mask, j_rows(s, hand_model, pts, mask),
                j_chamber(s, hand_model, pts, mask, BOUNDARY_OUTDIRS,
                          jnp.zeros(3), jnp.asarray([0.0, 0, 1]), 10.0,
                          active=mask.sum() > 400))
    for t in range(2):
        pts, mask, ref, ref_ch = jax_side(jnp.asarray(poses[t]),
                                          jnp.asarray(depths[t]))
        tp = torch.tensor(poses[t:t + 1])
        tpts = torch.tensor(np.asarray(pts))[None]
        tmask = torch.tensor(np.asarray(mask))[None]
        mine = cloud_constraint_rows(tp, model, tpts, tmask)
        act = np.asarray(mask)
        np.testing.assert_array_equal(mine.b1[0].numpy()[act],
                                      np.asarray(ref.b1)[act])
        for f in ("normal", "r1", "targetdist"):
            d = np.abs(getattr(mine, f)[0].numpy() - np.asarray(
                getattr(ref, f)))[act]
            assert d.max() < 1e-6, (t, f, d.max())
        ch = cloud_chamber_rows(tp, model, tpts, tmask,
                                ((-1.0, -0.25, 0.0), (-1.0, -1.0, 0.0),
                                 (0.0, -1.0, 0.0), (1.0, -1.0, 0.0),
                                 (1.0, -0.25, 0.0)), (0.0, 0.0, 0.0),
                                (0.0, 0.0, 1.0), 10.0,
                                active=tmask.sum(-1) > 400)
        for f in ("b1", "active", "fmin", "fmax"):
            np.testing.assert_array_equal(getattr(ch, f)[0].numpy(),
                                          np.asarray(getattr(ref_ch, f)))
        for f in ("normal", "r0", "r1", "targetdist"):
            d = np.abs(getattr(ch, f)[0].numpy()
                       - np.asarray(getattr(ref_ch, f)))
            assert d.max() < 1e-6, (t, "chamber", f, d.max())
