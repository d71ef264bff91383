"""The angles-only frame, kickstart_multi and the kernel solver without
use_pallas, in the port against the JAX package, T=2 at full width (point
budget 2048, 128 cloud rows per body, the trained net DEFAULT_CNNB):

  angles-only   the CNN frame with angles_only=True (every track resets
                and takes the refit; MultiStepSim has its angle rows on
                every step and no keypoint or cloud rows; no main-thread
                pass) on the kernel solver (the JAX package's batched
                frame, its Pallas kernels in interpret mode) and on the
                sequential solver with use_pallas=False (the JAX
                package's default tracker, run one track at a time as
                tests/test_torch_cnn_ref_frame.py does);
  kickstart     kickstart_multi with 4 palm-flip hypotheses from the rest
                pose on the kernel solver (JAX one track at a time, its
                hypotheses batched): the same hypothesis chosen per track,
                the per-hypothesis scores to 1e-5 relative;
  no pallas     the dynamics frame on the kernel solver with
                use_pallas=False (the reference-shaped cloud rows packed
                into the PGS kernel's solve), batched.

Inputs: animbank frames 5 and 12's renders (the dyn30 cache); the CNN
cases start track 0 at frame 5's ground truth and track 1 at
initial_state, the kickstart at initial_state, the no-pallas frame from
frames 4 and 11's ground truth.  Held: poses to 1e-5 m and quat_err 1e-4,
the CNN frame's tolerance (tests/test_torch_cnn_frame.py).  The JAX sides
take minutes on the CPU, so they are cached as JSON text in
tests/fixtures/cache/ (anglesonly_*.json); `python -m
tests.test_torch_angles_only` writes them."""
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
N_HYP = 4
CASES = {
    "kernel": dict(solver="kernel", use_pallas=True, angles_only=True),
    "sequential": dict(solver="sequential", use_pallas=False,
                       angles_only=True),
    "kickstart": dict(solver="kernel", use_pallas=True),
    "nopallas": dict(solver="kernel", use_pallas=False,
                     cnn_every_frame=False),
}


def _config(cls, case):
    kw = dict(point_budget=2048, cnn_every_frame=True,
              cloud_rows_per_body=128)
    kw.update(CASES[case])
    return cls(**kw)


def _inputs(hand_model, case):
    from hand_tracking_samples_tpu.assets_paths import DEFAULT_ANIMBANK
    from hand_tracking_samples_tpu.data.animbank import load_animbank
    bank = load_animbank(DEFAULT_ANIMBANK)
    dyn = cached_fake_depths(hand_model, np.asarray(bank[:30])[:, None],
                             "dyn30")[:, 0]
    depth = np.stack([dyn[f] for f in FRAMES]).astype(np.uint16)
    start = np.asarray(hand_model.start_pose, np.float32)
    if case == "kickstart":
        poses = np.stack([start, start])
    elif case == "nopallas":
        poses = np.stack([bank[f - 1] for f in FRAMES])
    else:
        poses = np.stack([bank[FRAMES[0]], start])
    return bank, depth, poses.astype(np.float32)


def _cnnb():
    from hand_tracking_samples_tpu_torch.assets_paths import DEFAULT_CNNB
    return DEFAULT_CNNB


def _jax_case(hand_model, case, depth, poses):
    """The JAX package's result for one case: a dict of arrays."""
    import jax
    import jax.numpy as jnp
    from hand_tracking_samples_tpu.cnn.model import load_cnnb
    from hand_tracking_samples_tpu.data.synth import synth_camera
    from hand_tracking_samples_tpu.parallel.tracks import (
        batched_tracker_state, batched_update)
    from hand_tracking_samples_tpu.tracker import runtime
    from hand_tracking_samples_tpu.tracker.config import TrackerConfig
    cam = synth_camera()
    cnn = load_cnnb(_cnnb())
    cfg = _config(TrackerConfig, case)
    params = runtime.physics_params(cfg)
    if case in ("kernel", "nopallas"):              # batched
        st = batched_tracker_state(hand_model, 2)
        st = st._replace(body=st.body._replace(pose=jnp.asarray(poses)))
        d = jnp.asarray(depth)
        out = {}
        if case == "kernel":
            mid = jax.jit(jax.vmap(lambda s, dd: runtime.update_cnn_model(
                s, hand_model, cnn, dd, cam, cfg, params)[0]))(st, d)
            out.update(mid_pose=np.asarray(mid.body.pose),
                       mid_prev=np.asarray(mid.prev_frame_error))
        final = jax.jit(lambda s, dd: batched_update(
            s, hand_model, cnn, dd, cam, cfg, params))(st, d)[0]
        out["final_pose"] = np.asarray(final.body.pose)
        return out
    from jax.experimental.pallas import tpu as pltpu
    rec = {}
    for i in range(len(FRAMES)):                    # one track at a time
        st = runtime.make_tracker_state(hand_model)
        st = st._replace(body=st.body._replace(pose=jnp.asarray(poses[i])))
        d = jnp.asarray(depth[i])
        with pltpu.force_tpu_interpret_mode():
            if case == "sequential":
                mid = jax.jit(lambda s, dd: runtime.update_cnn_model(
                    s, hand_model, cnn, dd, cam, cfg, params)[0])(st, d)
                final = jax.jit(lambda s, dd: runtime.update(
                    s, hand_model, cnn, dd, cam, cfg, params,
                    run_cnn=False)[0])(mid, d)
                one = dict(mid_pose=mid.body.pose,
                           mid_prev=mid.prev_frame_error,
                           final_pose=final.body.pose)
            else:                                   # kickstart_multi
                seen = {}
                argmin = jnp.argmin

                def spy(x, *a, **k):
                    seen["errs"] = x
                    return argmin(x, *a, **k)

                def run(s, dd):
                    jnp.argmin = spy
                    try:
                        new = runtime.kickstart_multi(
                            s, hand_model, cnn, dd, cam, cfg, params,
                            n_hyp=N_HYP)[0]
                    finally:
                        jnp.argmin = argmin
                    return new, seen.pop("errs")
                new, errs = jax.jit(run)(st, d)
                one = dict(final_pose=new.body.pose, errs=errs,
                           prev=new.prev_frame_error,
                           init=new.initializing)
        for k, v in one.items():
            rec.setdefault(k, []).append(np.asarray(v))
    return {k: np.stack(v) for k, v in rec.items()}


def jax_one_hypothesis(hand_model, track: int, hyp: int):
    """JAX's kickstart_multi score of one hypothesis run alone (a batch
    of one) on the kickstart case's track: beside the cached batch of
    N_HYP it shows JAX's own spread (`python -m
    tests.test_torch_angles_only spread` prints both; ~10 min)."""
    import jax
    import jax.numpy as jnp
    from hand_tracking_samples_tpu.cnn.model import load_cnnb
    from hand_tracking_samples_tpu.data.synth import synth_camera
    from hand_tracking_samples_tpu.tracker import runtime
    from hand_tracking_samples_tpu.tracker.config import TrackerConfig
    _, depth, poses = _inputs(hand_model, "kickstart")
    cfg = _config(TrackerConfig, "kickstart")
    st = runtime.make_tracker_state(hand_model)
    st = st._replace(body=st.body._replace(pose=jnp.asarray(poses[track])))
    seen, argmin, flips = {}, jnp.argmin, runtime._HYP_FLIPS

    def spy(x, *a, **k):
        seen["errs"] = x
        return argmin(x, *a, **k)

    def run(s, d):
        jnp.argmin, runtime._HYP_FLIPS = spy, flips[hyp:hyp + 1]
        try:
            runtime.kickstart_multi(s, hand_model, load_cnnb(_cnnb()), d,
                                    synth_camera(), cfg,
                                    runtime.physics_params(cfg), n_hyp=1)
        finally:
            jnp.argmin, runtime._HYP_FLIPS = argmin, flips
        return seen.pop("errs")
    return float(jax.jit(run)(st, jnp.asarray(depth[track]))[0])


def jax_reference(hand_model, case):
    """The JAX package's result for `case`, cached."""
    _, depth, poses = _inputs(hand_model, case)
    with open(_cnnb(), "rb") as f:
        wh = hashlib.sha1(f.read()).hexdigest()
    h = hashlib.sha1(depth.tobytes() + poses.tobytes() + wh.encode()
                     + repr(sorted(CASES[case].items())).encode()
                     + case.encode()).hexdigest()[:12]
    path = os.path.join(FIXTURES, "cache", f"anglesonly_{case}_{h}.json")
    if os.path.exists(path):
        with open(path) as f:
            return {k: np.asarray(v, np.float32)
                    for k, v in json.load(f).items()}
    out = _jax_case(hand_model, case, depth, poses)
    with open(path, "w") as f:       # text: float32 values round-trip
        json.dump({k: np.asarray(v, np.float32).tolist()
                   for k, v in out.items()}, f)
    return out


@pytest.fixture(scope="module")
def port(hand_model):
    from hand_tracking_samples_tpu_torch.cnn.model import load_cnnb
    from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
    model = from_numpy_model({k: np.asarray(v) for k, v in
                              vars(hand_model).items()}, "cpu")
    return model, load_cnnb(_cnnb(), "cpu")


def _state(model, poses):
    from hand_tracking_samples_tpu_torch.parallel.tracks import (
        batched_tracker_state)
    st = batched_tracker_state(model, len(poses))
    return st._replace(body=st.body._replace(pose=torch.tensor(poses)))


def _close(mine, ref, quat=1e-4):
    assert np.abs(mine[..., :3] - ref[..., :3]).max() < 1e-5
    assert quat_err(mine[..., 3:].reshape(-1, 4),
                    ref[..., 3:].reshape(-1, 4)) < quat


@pytest.mark.parametrize("case", ["kernel", "sequential"])
def test_angles_only_frame_matches_jax(hand_model, port, case, monkeypatch):
    """Every track resets and takes the refit: the pose after
    update_cnn_model and after the frame (no main-thread pass: the same
    pose) agree with JAX to 1e-5 m and quat_err 1e-4; the accumulated
    error to 1e-6."""
    from hand_tracking_samples_tpu_torch.data.synth import synth_camera
    from hand_tracking_samples_tpu_torch.ops.cloud_kernel import (
        depth_tensor)
    from hand_tracking_samples_tpu_torch.parallel.tracks import (
        batched_update)
    from hand_tracking_samples_tpu_torch.tracker import runtime
    from hand_tracking_samples_tpu_torch.tracker.config import TrackerConfig
    model, cnn = port
    ref = jax_reference(hand_model, case)
    _, depth, poses = _inputs(hand_model, case)
    seen, resets = [], []
    real, real_reset = runtime.update_cnn_model, runtime.reset_tracks

    def spy(*a, **k):
        seen.append(real(*a, **k))
        return seen[-1]

    def spy_reset(do_reset, *a, **k):
        resets.append(do_reset.clone())
        return real_reset(do_reset, *a, **k)
    monkeypatch.setattr(runtime, "update_cnn_model", spy)
    monkeypatch.setattr(runtime, "reset_tracks", spy_reset)
    final, _ = batched_update(_state(model, poses), model, cnn,
                              depth_tensor(depth, "cpu"), synth_camera(),
                              _config(TrackerConfig, case))
    (mid, _), = seen
    assert bool(resets[0].all())
    mid_pose, fin = mid.body.pose.numpy(), final.body.pose.numpy()
    assert np.array_equal(mid_pose, fin)         # no main-thread pass
    assert (mid_pose != poses).any(axis=(1, 2)).all()   # every track took
    _close(mid_pose, ref["mid_pose"])
    _close(fin, ref["final_pose"])
    np.testing.assert_allclose(mid.prev_frame_error.numpy(),
                               ref["mid_prev"].reshape(-1), atol=1e-6)


def test_kickstart_multi_matches_jax(hand_model, port, monkeypatch):
    """kickstart_multi (4 hypotheses folded into the track dimension): the
    same hypothesis chosen on each track, the chosen poses to 1e-5 m /
    quat_err 1e-4, prev_frame_error 0 and initializing unchanged; the
    per-hypothesis scores (FitError + 0.1 x the landmark-ray
    disagreement) to 1e-4 relative.  The scores' bound is JAX's own
    spread: track 1's second hypothesis (a flipped palm) scores 0.936978
    in JAX's batch of 4 hypotheses and 0.937045 alone (7.2e-5 relative,
    the batched ops' order; jax_one_hypothesis); the port's 0.937056
    lies 1.1e-5 from the latter."""
    from hand_tracking_samples_tpu_torch.data.synth import synth_camera
    from hand_tracking_samples_tpu_torch.ops.cloud_kernel import (
        depth_tensor)
    from hand_tracking_samples_tpu_torch.tracker import runtime
    from hand_tracking_samples_tpu_torch.tracker.config import TrackerConfig
    model, cnn = port
    ref = jax_reference(hand_model, "kickstart")
    _, depth, poses = _inputs(hand_model, "kickstart")
    cfg = _config(TrackerConfig, "kickstart")
    st = _state(model, poses)
    st = st._replace(initializing=torch.tensor([3, 0], dtype=torch.int32))
    seen = []
    real = runtime.kickstart_hypotheses

    def spy(*a, **k):
        seen.append(real(*a, **k))
        return seen[-1]
    monkeypatch.setattr(runtime, "kickstart_hypotheses", spy)
    new, _ = runtime.kickstart_multi(st, model, cnn, depth_tensor(depth,
                                                                  "cpu"),
                                     synth_camera(), cfg,
                                     runtime.physics_params(cfg),
                                     n_hyp=N_HYP)
    (bodies, errs, _), = seen
    assert errs.shape == (2, N_HYP)
    np.testing.assert_allclose(errs.numpy(), ref["errs"], rtol=1e-4)
    k = errs.argmin(dim=1).numpy()
    assert k.tolist() == ref["errs"].argmin(axis=1).tolist()
    fin = new.body.pose.numpy()
    assert np.array_equal(fin, bodies.pose[[0, 1], k].numpy())
    _close(fin, ref["final_pose"])
    assert new.prev_frame_error.tolist() == [0.0, 0.0]
    assert new.initializing.tolist() == [3, 0]


def test_kernel_without_pallas_matches_jax(hand_model, port):
    """The dynamics frame on the kernel solver with use_pallas=False: the
    reference-shaped cloud rows (plane dots, the weak force) as one more
    single-body block of the PGS solve, against JAX's batched frame:
    1e-5 m, quat_err 1e-4."""
    from hand_tracking_samples_tpu_torch.data.synth import synth_camera
    from hand_tracking_samples_tpu_torch.ops.cloud_kernel import (
        depth_tensor)
    from hand_tracking_samples_tpu_torch.parallel.tracks import (
        batched_update)
    from hand_tracking_samples_tpu_torch.tracker.config import TrackerConfig
    model, _ = port
    ref = jax_reference(hand_model, "nopallas")
    _, depth, poses = _inputs(hand_model, "nopallas")
    final, _ = batched_update(_state(model, poses), model, None,
                              depth_tensor(depth, "cpu"), synth_camera(),
                              _config(TrackerConfig, "nopallas"))
    fin = final.body.pose.numpy()
    _close(fin, ref["final_pose"])
    assert np.abs(fin[..., :3] - poses[..., :3]).max() > 1e-3   # moved


if __name__ == "__main__":
    import sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from hand_tracking_samples_tpu.model.bake import load_hand_model
    hm = jax.tree_util.tree_map(jnp.asarray, load_hand_model(
        MODEL_JSON, cache_dir=os.path.join(FIXTURES, "cache")))
    if sys.argv[1:] == ["spread"]:
        print("track 1, hypothesis 1: batch of", N_HYP,
              jax_reference(hm, "kickstart")["errs"][1, 1], "alone",
              jax_one_hypothesis(hm, 1, 1))
        sys.exit(0)
    for c in sys.argv[1:] or CASES:
        print(c, {k: v.shape for k, v in jax_reference(hm, c).items()},
              flush=True)
