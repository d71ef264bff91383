"""One CNN frame at the slice's full width (point budget 2048, 128 cloud
rows per body, the trained net DEFAULT_CNNB), T=2 tracks, through the
port's batched_update(run_cnn=True) against the JAX package's kernel-solver
path on the same renders:

  track 0  animbank frame 5's render, started at its ground-truth pose:
           FitError stays under full_reset_on_error, no reset;
  track 1  animbank frame 12's render, started from initial_state: FitError
           exceeds it, so PoseFromScratch and the three UnibodyFits run.

The JAX package's frame takes about ten minutes on the CPU (its Pallas
kernels in interpret mode), so its results are cached as JSON text in
tests/fixtures/cache/ under a hash of the inputs, as the renders are
(tests/conftest.cached_fake_depths): the FitError before the refit, the
state after update_cnn_model, and the poses after the frame's dynamics
pass.  `python -m tests.test_torch_cnn_frame`
writes the cache.

Held: the two packages' do_reset and take decisions are equal, and the
poses agree to 1e-5 m and quat_err 1e-4, the slice's tolerance
(tests/test_torch_slice_jax.py).

The CNN curve: 3 consecutive CNN frames on the renders chip_smoke.py's
phase 7 tracks (bank[30:33], here JAX's renders), T=2: track 0 started at
bank[30] (the card's tracks on the hand), track 1 from initial_state (its
reset tracks).  JAX runs one track at a time (as
tests/test_torch_cnn_ref_frame.py does; its vmapped frame may sum in
another order), cached as cnncurve_*.json; held per frame to the same
tolerance, with each track's mean joint error against the animbank (the
card's curve, PERF.md) beside JAX's."""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from tests.conftest import FIXTURES, MODEL_JSON, cached_fake_depths, quat_err

# the port tests run small tensors: one intra-op thread each, so the
# suite's parallel workers do not oversubscribe the cores
torch.set_num_threads(1)

FRAMES = (5, 12)
FULL = dict(point_budget=2048, cnn_every_frame=True, cloud_rows_per_body=128,
            solver="kernel", use_pallas=True)


def _inputs(hand_model):
    from hand_tracking_samples_tpu.assets_paths import DEFAULT_ANIMBANK
    from hand_tracking_samples_tpu.data.animbank import load_animbank
    bank = load_animbank(DEFAULT_ANIMBANK)
    dyn = cached_fake_depths(hand_model, np.asarray(bank[:30])[:, None],
                             "dyn30")[:, 0]
    depth = np.stack([dyn[f] for f in FRAMES]).astype(np.uint16)
    start = np.asarray(hand_model.start_pose, np.float32)
    poses = np.stack([bank[FRAMES[0]], start]).astype(np.float32)
    return bank, depth, poses


def _cnnb():
    from hand_tracking_samples_tpu_torch.assets_paths import DEFAULT_CNNB
    return DEFAULT_CNNB


def jax_reference(hand_model):
    """The JAX package's frame on _inputs, cached."""
    import jax
    import jax.numpy as jnp
    from hand_tracking_samples_tpu.cnn.model import load_cnnb
    from hand_tracking_samples_tpu.data.synth import synth_camera
    from hand_tracking_samples_tpu.fitting.cloud import fit_error
    from hand_tracking_samples_tpu.imaging.image_ops import (
        cloud_from_depth_planes)
    from hand_tracking_samples_tpu.parallel.tracks import (
        batched_tracker_state, batched_update)
    from hand_tracking_samples_tpu.tracker.config import TrackerConfig
    from hand_tracking_samples_tpu.tracker.runtime import (
        physics_params, update_cnn_model)
    _, depth, poses = _inputs(hand_model)
    with open(_cnnb(), "rb") as f:
        wh = hashlib.sha1(f.read()).hexdigest()
    h = hashlib.sha1(depth.tobytes() + poses.tobytes() + wh.encode()
                     + repr(sorted(FULL.items())).encode()).hexdigest()[:12]
    path = os.path.join(FIXTURES, "cache", f"cnnframe_{h}.json")
    if os.path.exists(path):
        with open(path) as f:
            return {k: np.asarray(v, np.float32 if k != "mid_init"
                                  else np.int32)
                    for k, v in json.load(f).items()}
    cfg = TrackerConfig(**FULL)
    params = physics_params(cfg)
    cam = synth_camera()
    cnn = load_cnnb(_cnnb())
    st = batched_tracker_state(hand_model, 2)
    st = st._replace(body=st.body._replace(pose=jnp.asarray(poses)))
    d = jnp.asarray(depth)

    def olderr(body, dd):
        ph = cloud_from_depth_planes(dd, cam, 0.1, cfg.drangey,
                                     cfg.subsample_fraction,
                                     cfg.point_budget)
        return fit_error(body, hand_model, ph, ph[4] > 0.5, dd, cam,
                         cfg.bone_sum_error_scale, use_kernel=True,
                         points_ph=ph)
    old = jax.jit(jax.vmap(olderr))(st.body, d)
    mid = jax.jit(jax.vmap(lambda s, dd: update_cnn_model(
        s, hand_model, cnn, dd, cam, cfg, params)[0]))(st, d)
    final = jax.jit(lambda s, dd: batched_update(
        s, hand_model, cnn, dd, cam, cfg, params, run_cnn=False))(mid, d)[0]
    out = dict(olderror=np.asarray(old), mid_pose=np.asarray(mid.body.pose),
               mid_prev=np.asarray(mid.prev_frame_error),
               mid_init=np.asarray(mid.initializing),
               final_pose=np.asarray(final.body.pose))
    with open(path, "w") as f:       # text: float32 values round-trip
        json.dump({k: v.tolist() for k, v in out.items()}, f)
    return out


@pytest.fixture(scope="module")
def frame(hand_model):
    from hand_tracking_samples_tpu_torch.cnn.model import load_cnnb
    from hand_tracking_samples_tpu_torch.data.synth import synth_camera
    from hand_tracking_samples_tpu_torch.fitting.cloud import fit_error
    from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
    from hand_tracking_samples_tpu_torch.ops.cloud_kernel import (
        cloud_from_depth_planes, depth_tensor)
    from hand_tracking_samples_tpu_torch.parallel.tracks import (
        batched_tracker_state, batched_update)
    from hand_tracking_samples_tpu_torch.tracker.config import TrackerConfig
    from hand_tracking_samples_tpu_torch.tracker.runtime import (
        physics_params, update_cnn_model)
    ref = jax_reference(hand_model)
    bank, depth, poses = _inputs(hand_model)
    model = from_numpy_model({k: np.asarray(v) for k, v in
                              vars(hand_model).items()}, "cpu")
    cfg = TrackerConfig(**FULL)
    cam = synth_camera()
    cnn = load_cnnb(_cnnb(), "cpu")
    d = depth_tensor(depth, "cpu")
    st = batched_tracker_state(model, 2)
    st = st._replace(body=st.body._replace(pose=torch.tensor(poses)))
    ph = cloud_from_depth_planes(d, cam, 0.1, cfg.drangey,
                                 cfg.subsample_fraction, cfg.point_budget)
    old = fit_error(st.body.pose, model, ph, d, cam,
                    cfg.bone_sum_error_scale).numpy()
    mid, _ = update_cnn_model(st, model, cnn, d, cam, cfg,
                              physics_params(cfg))
    final, _ = batched_update(st, model, cnn, d, cam, cfg, run_cnn=True)
    mine = dict(olderror=old, mid_pose=mid.body.pose.numpy(),
                mid_prev=mid.prev_frame_error.numpy(),
                mid_init=mid.initializing.numpy(),
                final_pose=final.body.pose.numpy())
    return bank, poses, ref, mine


def test_cnn_frame_decisions_match_jax(frame):
    """do_reset (FitError above full_reset_on_error) fires on track 1 only,
    in both packages; the take decisions (the refit pose replaced the
    state's) are equal; FitError agrees to 1e-6 relative."""
    _, poses, ref, mine = frame
    thr = 0.6                                  # full_reset_on_error
    np.testing.assert_allclose(mine["olderror"], ref["olderror"],
                               rtol=1e-6)
    reset_j = ref["olderror"] > thr
    reset_p = mine["olderror"] > thr
    assert reset_j.tolist() == [False, True]
    assert reset_p.tolist() == reset_j.tolist()
    take_j = (ref["mid_pose"] != poses).any(axis=(1, 2))
    take_p = (mine["mid_pose"] != poses).any(axis=(1, 2))
    assert take_p.tolist() == take_j.tolist()
    assert take_j[1]
    np.testing.assert_array_equal(mine["mid_init"], ref["mid_init"])
    np.testing.assert_allclose(mine["mid_prev"], ref["mid_prev"],
                               atol=1e-6)


def test_cnn_frame_matches_jax(frame):
    """The poses after the refit and after the whole frame agree to 1e-5 m
    and quat_err 1e-4 on both tracks; the reset track lands on the hand
    (mean joint error against the animbank under 20 mm)."""
    bank, _, ref, mine = frame
    for k in ("mid_pose", "final_pose"):
        assert np.abs(mine[k][..., :3] - ref[k][..., :3]).max() < 1e-5, k
        assert quat_err(mine[k][..., 3:].reshape(-1, 4),
                        ref[k][..., 3:].reshape(-1, 4)) < 1e-4, k
    err = np.linalg.norm(mine["final_pose"][1, :, :3]
                         - bank[FRAMES[1], :, :3], axis=-1).mean()
    assert err < 0.02, err


CURVE_BANK, CURVE_FRAMES = 30, 3


def _curve_inputs(hand_model):
    """(bank, depths (F, H, W) of bank[30:33], start poses (2, 17, 7))."""
    from hand_tracking_samples_tpu.assets_paths import DEFAULT_ANIMBANK
    from hand_tracking_samples_tpu.data.animbank import load_animbank
    bank = load_animbank(DEFAULT_ANIMBANK)
    ids = CURVE_BANK + np.arange(CURVE_FRAMES)
    depth = cached_fake_depths(hand_model, np.asarray(bank[ids]),
                               "cnn3").astype(np.uint16)
    start = np.asarray(hand_model.start_pose, np.float32)
    poses = np.stack([bank[CURVE_BANK], start]).astype(np.float32)
    return bank, depth, poses


def jax_curve(hand_model):
    """JAX's poses after each of the CURVE_FRAMES CNN frames, one track at
    a time: (F, 2, 17, 7), cached."""
    _, depth, poses = _curve_inputs(hand_model)
    with open(_cnnb(), "rb") as f:
        wh = hashlib.sha1(f.read()).hexdigest()
    h = hashlib.sha1(depth.tobytes() + poses.tobytes() + wh.encode()
                     + repr(sorted(FULL.items())).encode()
                     + b"per track").hexdigest()[:12]
    path = os.path.join(FIXTURES, "cache", f"cnncurve_{h}.json")
    if os.path.exists(path):
        with open(path) as f:
            return np.asarray(json.load(f), np.float32)
    import jax
    import jax.numpy as jnp
    from hand_tracking_samples_tpu.cnn.model import load_cnnb
    from hand_tracking_samples_tpu.data.synth import synth_camera
    from hand_tracking_samples_tpu.parallel.tracks import (
        batched_tracker_state, batched_update)
    from hand_tracking_samples_tpu.tracker.config import TrackerConfig
    from hand_tracking_samples_tpu.tracker.runtime import physics_params
    cfg = TrackerConfig(**FULL)
    params, cam, cnn = physics_params(cfg), synth_camera(), load_cnnb(_cnnb())
    step = jax.jit(lambda s, d: batched_update(s, hand_model, cnn, d, cam,
                                               cfg, params)[0])
    out = np.zeros((CURVE_FRAMES, 2, 17, 7), np.float32)
    for i in range(2):                       # one track at a time
        st = batched_tracker_state(hand_model, 1)
        st = st._replace(body=st.body._replace(
            pose=jnp.asarray(poses[i:i + 1])))
        for f in range(CURVE_FRAMES):
            st = step(st, jnp.asarray(depth[f:f + 1]))
            out[f, i] = np.asarray(st.body.pose[0])
    with open(path, "w") as f:       # text: float32 values round-trip
        json.dump(out.tolist(), f)
    return out


def test_cnn_curve_matches_jax(hand_model):
    """Three consecutive CNN frames: every frame's poses within 1e-5 m and
    quat_err 1e-4 of JAX's on both tracks; each track's per-frame mean
    joint error (mm) equal to JAX's within 0.01 mm, the reset track on the
    hand by the last frame (under 20 mm)."""
    from hand_tracking_samples_tpu_torch.cnn.model import load_cnnb
    from hand_tracking_samples_tpu_torch.data.synth import synth_camera
    from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
    from hand_tracking_samples_tpu_torch.ops.cloud_kernel import (
        depth_tensor)
    from hand_tracking_samples_tpu_torch.parallel.tracks import (
        batched_tracker_state, batched_update)
    from hand_tracking_samples_tpu_torch.tracker.config import TrackerConfig
    ref = jax_curve(hand_model)
    bank, depth, poses = _curve_inputs(hand_model)
    model = from_numpy_model({k: np.asarray(v) for k, v in
                              vars(hand_model).items()}, "cpu")
    cfg, cam, cnn = TrackerConfig(**FULL), synth_camera(), load_cnnb(
        _cnnb(), "cpu")
    st = batched_tracker_state(model, 2)
    st = st._replace(body=st.body._replace(pose=torch.tensor(poses)))
    mine = []
    for d in depth:
        st, _ = batched_update(st, model, cnn,
                               depth_tensor(np.stack([d, d]), "cpu"), cam,
                               cfg)
        mine.append(st.body.pose.numpy())
    mine = np.stack(mine)
    for f in range(CURVE_FRAMES):
        assert np.abs(mine[f, ..., :3] - ref[f, ..., :3]).max() < 1e-5, f
        assert quat_err(mine[f, ..., 3:].reshape(-1, 4),
                        ref[f, ..., 3:].reshape(-1, 4)) < 1e-4, f
    want = bank[CURVE_BANK:CURVE_BANK + CURVE_FRAMES, None, :, :3]

    def joint_err_mm(p):
        return np.linalg.norm(p[..., :3] - want, axis=-1).mean(-1) * 1e3
    je, je_ref = joint_err_mm(mine), joint_err_mm(ref)
    assert np.abs(je - je_ref).max() < 0.01, (je, je_ref)
    assert je[-1, 1] < 20.0, je


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from hand_tracking_samples_tpu.model.bake import load_hand_model
    hm = jax.tree_util.tree_map(jnp.asarray, load_hand_model(
        MODEL_JSON, cache_dir=os.path.join(FIXTURES, "cache")))
    print({k: v.shape for k, v in jax_reference(hm).items()})
    print("curve", jax_curve(hm).shape)
