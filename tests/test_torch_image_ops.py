"""The voxel and mirror clouds' image operations (imaging/image_ops.py)
against the JAX package's on two cached dyn30 renders, bit for bit, each
JAX function jitted with its configuration a constant as the tracking
frame runs it:

  point_cloud         the full-image cloud (76,800 points, stride 1);
  mirror_plane_split  with a tilted cutting plane through the cloud's
                      median point: points under it, in the 2 cm coplanar
                      band and over it all occur;
  voxel_subsample     at 0.005 m with min_voxel_num 4 (the tracker passes
                      subsample_fraction there): centroids, mask and the
                      bucket counts;
  compact_points      of the voxel cloud to the 2048-point budget;

and the mirror split of the two clouds the frame feeds it: the budgeted
stride-4 cloud (cloud_from_depth, whose points XLA recomputes inside the
reflection: the port passes the camera) and the compacted voxel cloud.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hand_tracking_samples_tpu.assets_paths import DEFAULT_ANIMBANK
from hand_tracking_samples_tpu.data.animbank import load_animbank
from hand_tracking_samples_tpu.data.synth import synth_camera as j_cam
from hand_tracking_samples_tpu.imaging import image_ops as J
from hand_tracking_samples_tpu_torch.data.synth import synth_camera
from hand_tracking_samples_tpu_torch.imaging import image_ops as P
from hand_tracking_samples_tpu_torch.ops.cloud_kernel import depth_tensor
from tests.conftest import cached_fake_depths

# the port tests run small tensors: one intra-op thread each, so the
# suite's parallel workers do not oversubscribe the cores
torch.set_num_threads(1)

FRAMES = (0, 20)
VOXEL = 0.005
MIN_VOXEL = 4
# unit normal ~(0.3, -0.2, -0.93) through the median valid point of dyn30
# render 0, (0.0792, 0.0692, 0.408) m
CUT_PLANE = (0.3007679283618927, -0.20051196217536926, -0.9323806166648865,
             0.370469868183136)


@pytest.fixture(scope="module")
def depths(hand_model):
    bank = load_animbank(DEFAULT_ANIMBANK)
    dyn = cached_fake_depths(hand_model, np.asarray(bank[:30])[:, None],
                             "dyn30")[:, 0]
    return np.stack([dyn[f] for f in FRAMES])


@pytest.fixture(scope="module")
def jax_side(depths):
    cam = j_cam()

    def one(d):
        pts, mask = J.point_cloud(d, cam, 0.1, 0.7)
        mp, mm = J.mirror_plane_split(pts, mask,
                                      jnp.asarray(CUT_PLANE, jnp.float32))
        vp, vm = J.voxel_subsample(pts, mask, VOXEL, MIN_VOXEL)
        ipos = jnp.floor(pts / VOXEL).astype(jnp.int32).astype(jnp.uint32)
        h = (ipos * jnp.asarray([54851, 11909, 24781], jnp.uint32)).sum(1)
        h = (h & jnp.uint32(2047)).astype(jnp.int32)
        cnts = jnp.zeros(2048, jnp.float32).at[h].add(
            mask.astype(jnp.float32))
        cp, cm = J.compact_points(vp, vm, 2048)
        plane = jnp.asarray(CUT_PLANE, jnp.float32)
        fp, fm = J.mirror_plane_split(
            *J.cloud_from_depth(d, cam, 0.1, 0.7, 4, 2048), plane)
        wp, wm = J.mirror_plane_split(cp, cm, plane)
        return pts, mask, mp, mm, vp, vm, cnts, cp, cm, fp, fm, wp, wm
    out = jax.jit(jax.vmap(one))(jnp.asarray(depths))
    return [np.asarray(x) for x in out]


def test_point_cloud_and_mirror_match_jax(depths, jax_side):
    pts, mask, mp, mm = jax_side[:4]
    fp, fm = jax_side[9:11]
    tp, tm = P.point_cloud(depth_tensor(depths, "cpu"), synth_camera(), 0.1,
                           0.7)
    assert tp.shape == (2, 76800, 3)
    np.testing.assert_array_equal(tp.numpy(), pts)
    np.testing.assert_array_equal(tm.numpy(), mask)
    under, cop, over = P.plane_split_masks(tp, CUT_PLANE)
    for m in (under, cop, over):
        assert ((m & tm).sum(1) > 100).all()
    xp, xm = P.mirror_plane_split(tp, tm, CUT_PLANE, cam=synth_camera())
    np.testing.assert_array_equal(xp.numpy(), mp)
    np.testing.assert_array_equal(xm.numpy(), mm)
    assert not np.array_equal(mp[mask], pts[mask])        # points moved
    # update's cloud: the budgeted stride-4 cloud (the cloud kernel's)
    cp, cm = P.mirror_plane_split(*P.cloud_from_depth(
        depth_tensor(depths, "cpu"), synth_camera(), 0.1, 0.7, 4, 2048),
        CUT_PLANE, cam=synth_camera())
    np.testing.assert_array_equal(cp.numpy(), fp)
    np.testing.assert_array_equal(cm.numpy(), fm)


def test_voxel_subsample_and_compaction_match_jax(depths, jax_side):
    pts, mask = jax_side[:2]
    vp, vm, cnts, cp, cm, _, _, wp, wm = jax_side[4:]
    tp, tm = torch.tensor(pts), torch.tensor(mask)
    _, tc = P.voxel_buckets(tp, tm, VOXEL)
    np.testing.assert_array_equal(tc.numpy(), cnts.astype(np.int64))
    xp, xm = P.voxel_subsample(tp, tm, VOXEL, MIN_VOXEL)
    np.testing.assert_array_equal(xp.numpy(), vp)
    np.testing.assert_array_equal(xm.numpy(), vm)
    assert (xm.sum(1) > 400).all()      # above min_point_num at 5 mm
    # negative voxel cells (left of / above the principal point) occur
    assert (np.floor(pts[mask] / VOXEL) < 0).any()
    yp, ym = P.compact_points(xp, xm, 2048)
    np.testing.assert_array_equal(yp.numpy(), cp)
    np.testing.assert_array_equal(ym.numpy(), cm)
    # the voxel cloud through the mirror: stored points, no camera
    zp, zm = P.mirror_plane_split(yp, ym, CUT_PLANE)
    np.testing.assert_array_equal(zp.numpy(), wp)
    np.testing.assert_array_equal(zm.numpy(), wm)
