"""The CNN frame on the reference-shaped solvers (the JAX package's default
tracker: cnn_every_frame, solver="sequential", use_pallas=False), T=2
tracks at full width (point budget 2048, the trained net DEFAULT_CNNB),
through the port's batched_update(run_cnn=True) against the JAX package's
update_cnn_model and dynamics pass on the same renders, for
(sequential, use_pallas False), (sequential, True) and (colored, False):

  track 0  animbank frame 5's render, started at its ground-truth pose:
           FitError stays under full_reset_on_error, no reset;
  track 1  animbank frame 12's render, started from initial_state: FitError
           exceeds it, so PoseFromScratch and the three UnibodyFits run.

The JAX frames run one track at a time (its update_cnn_model, then its
update without the CNN): under jax.vmap XLA sums the batched plane dots in
another order, and on this input one correspondence winner then flips in
MultiStepSim's third step, so that JAX's own batched sequential
use_pallas=False frame lies 2.9e-4 m from its unbatched one (the port
follows the unbatched one to 3e-7 m at every stage).  They take minutes on
the CPU (the use_pallas=True kernels in interpret mode), so their results
are cached as JSON text in tests/fixtures/cache/ under a hash of the inputs
(cnnrefframe_*.json), as cnnframe_*.json is: the FitError before the
refit, the state after update_cnn_model, and the poses after the frame's
dynamics pass.  `python -m tests.test_torch_cnn_ref_frame` writes the
cache.

Held: the two packages' do_reset and take decisions are equal, and the
poses agree to 1e-5 m and quat_err 1e-4, the slice's tolerance
(tests/test_torch_cnn_frame.py).  The cnn_every_k cadence of
track_sequences runs the CNN frame on the reference solvers too."""
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
SETTINGS = [("sequential", False), ("sequential", True), ("colored", False)]


def _config(cls, solver, use_pallas, **kw):
    return cls(point_budget=2048, cnn_every_frame=True, solver=solver,
               use_pallas=use_pallas, **kw)


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
    """The JAX package's frame on _inputs for each setting, cached:
    {"<solver>_<use_pallas>": {olderror, mid_pose, mid_prev, mid_init,
    final_pose}}."""
    _, depth, poses = _inputs(hand_model)
    with open(_cnnb(), "rb") as f:
        wh = hashlib.sha1(f.read()).hexdigest()
    h = hashlib.sha1(depth.tobytes() + poses.tobytes() + wh.encode()
                     + repr(SETTINGS).encode() + b"per track"
                     ).hexdigest()[:12]
    path = os.path.join(FIXTURES, "cache", f"cnnrefframe_{h}.json")
    if os.path.exists(path):
        with open(path) as f:
            return {s: {k: np.asarray(v, np.int32 if k == "mid_init"
                                      else np.float32)
                        for k, v in d.items()}
                    for s, d in json.load(f).items()}
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from hand_tracking_samples_tpu.cnn.model import load_cnnb
    from hand_tracking_samples_tpu.data.synth import synth_camera
    from hand_tracking_samples_tpu.fitting.cloud import fit_error
    from hand_tracking_samples_tpu.imaging.image_ops import cloud_from_depth
    from hand_tracking_samples_tpu.physics.schedule import (
        build_hand_schedule)
    from hand_tracking_samples_tpu.tracker.config import TrackerConfig
    from hand_tracking_samples_tpu.tracker.runtime import (
        make_tracker_state, physics_params, update, update_cnn_model)
    cam = synth_camera()
    cnn = load_cnnb(_cnnb())
    out = {}
    for solver, up in SETTINGS:
        cfg = _config(TrackerConfig, solver, up)
        params = physics_params(cfg)
        sched = (build_hand_schedule(hand_model, cfg.contacts_mode)
                 if solver == "colored" else None)

        def olderr(body, dd, cfg=cfg):
            pts, mask = cloud_from_depth(dd, cam, 0.1, cfg.drangey,
                                         cfg.subsample_fraction,
                                         cfg.point_budget)
            return fit_error(body, hand_model, pts, mask, dd, cam,
                             cfg.bone_sum_error_scale,
                             use_kernel=cfg.use_pallas)
        refit = jax.jit(lambda s, dd, cfg=cfg, params=params, sched=sched:
                        update_cnn_model(s, hand_model, cnn, dd, cam, cfg,
                                         params, schedule=sched)[0])
        dyn = jax.jit(lambda s, dd, cfg=cfg, params=params: update(
            s, hand_model, cnn, dd, cam, cfg, params, run_cnn=False)[0])
        rec = {k: [] for k in ("olderror", "mid_pose", "mid_prev",
                               "mid_init", "final_pose")}
        for i in range(len(FRAMES)):            # one track at a time
            st = make_tracker_state(hand_model)
            st = st._replace(body=st.body._replace(
                pose=jnp.asarray(poses[i])))
            d = jnp.asarray(depth[i])
            with pltpu.force_tpu_interpret_mode():
                rec["olderror"].append(np.asarray(jax.jit(olderr)(st.body,
                                                                   d)))
                mid = refit(st, d)
                final = dyn(mid, d)
            rec["mid_pose"].append(np.asarray(mid.body.pose))
            rec["mid_prev"].append(np.asarray(mid.prev_frame_error))
            rec["mid_init"].append(np.asarray(mid.initializing))
            rec["final_pose"].append(np.asarray(final.body.pose))
        out[f"{solver}_{up}"] = {k: np.stack(v) for k, v in rec.items()}
    with open(path, "w") as f:       # text: float32 values round-trip
        json.dump({s: {k: v.tolist() for k, v in r.items()}
                   for s, r in out.items()}, f)
    return out


@pytest.fixture(scope="module")
def port(hand_model):
    from hand_tracking_samples_tpu_torch.cnn.model import load_cnnb
    from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
    model = from_numpy_model({k: np.asarray(v) for k, v in
                              vars(hand_model).items()}, "cpu")
    return model, load_cnnb(_cnnb(), "cpu")


def _frame(hand_model, port, solver, use_pallas, monkeypatch):
    """The port's frame: the FitError before the refit, the state the
    refit (update_cnn_model) hands back, the poses after the whole frame
    (both recorded on their way through batched_update)."""
    from hand_tracking_samples_tpu_torch.data.synth import synth_camera
    from hand_tracking_samples_tpu_torch.ops.cloud_kernel import (
        depth_tensor)
    from hand_tracking_samples_tpu_torch.parallel.tracks import (
        batched_tracker_state, batched_update)
    from hand_tracking_samples_tpu_torch.tracker import runtime
    from hand_tracking_samples_tpu_torch.tracker.config import TrackerConfig
    model, cnn = port
    _, depth, poses = _inputs(hand_model)
    cfg = _config(TrackerConfig, solver, use_pallas)
    st = batched_tracker_state(model, 2)
    st = st._replace(body=st.body._replace(pose=torch.tensor(poses)))
    seen = {"fit_error": [], "update_cnn_model": []}
    for name in seen:
        def spy(*a, _real=getattr(runtime, name), _out=seen[name], **k):
            _out.append(_real(*a, **k))
            return _out[-1]
        monkeypatch.setattr(runtime, name, spy)
    final, _ = batched_update(st, model, cnn, depth_tensor(depth, "cpu"),
                              synth_camera(), cfg, run_cnn=True)
    (mid, _), = seen["update_cnn_model"]
    return dict(olderror=seen["fit_error"][0].numpy(),
                mid_pose=mid.body.pose.numpy(),
                mid_prev=mid.prev_frame_error.numpy(),
                mid_init=mid.initializing.numpy(),
                final_pose=final.body.pose.numpy())


@pytest.mark.parametrize("solver,use_pallas", SETTINGS)
def test_cnn_ref_frame_matches_jax(hand_model, port, solver, use_pallas,
                                   monkeypatch):
    """do_reset (FitError above full_reset_on_error) fires on track 1 only
    in both packages; the take decisions are equal; FitError agrees to
    1e-6 relative; the poses after the refit and after the whole frame
    agree to 1e-5 m and quat_err 1e-4; the reset track lands on the hand
    (mean joint error against the animbank under 20 mm)."""
    bank, _, poses = _inputs(hand_model)
    ref = jax_reference(hand_model)[f"{solver}_{use_pallas}"]
    mine = _frame(hand_model, port, solver, use_pallas, monkeypatch)
    thr = 0.6                                  # full_reset_on_error
    np.testing.assert_allclose(mine["olderror"], ref["olderror"],
                               rtol=1e-6)
    assert (ref["olderror"] > thr).tolist() == [False, True]
    assert (mine["olderror"] > thr).tolist() == [False, True]
    take_j = (ref["mid_pose"] != poses).any(axis=(1, 2))
    take_p = (mine["mid_pose"] != poses).any(axis=(1, 2))
    assert take_p.tolist() == take_j.tolist()
    assert take_j[1]
    np.testing.assert_array_equal(mine["mid_init"], ref["mid_init"])
    np.testing.assert_allclose(mine["mid_prev"], ref["mid_prev"],
                               atol=1e-6)
    for k in ("mid_pose", "final_pose"):
        assert np.abs(mine[k][..., :3] - ref[k][..., :3]).max() < 1e-5, k
        assert quat_err(mine[k][..., 3:].reshape(-1, 4),
                        ref[k][..., 3:].reshape(-1, 4)) < 1e-4, k
    err = np.linalg.norm(mine["final_pose"][1, :, :3]
                         - bank[FRAMES[1], :, :3], axis=-1).mean()
    assert err < 0.02, err


def test_cnn_every_k_on_reference_solver(hand_model, port, monkeypatch):
    """track_sequences' cadence (cnn_every_k=2) on the sequential solver:
    the CNN frame (update_cnn_model, here recorded and skipped) runs on
    each group's first frame only, with the frame's own cloud, and every
    frame runs the dynamics pass (512 points, 2+1 sweeps: the wiring is
    under test)."""
    from hand_tracking_samples_tpu_torch.data.synth import synth_camera
    from hand_tracking_samples_tpu_torch.ops.cloud_kernel import (
        depth_tensor)
    from hand_tracking_samples_tpu_torch.parallel.tracks import (
        batched_tracker_state, track_sequences)
    from hand_tracking_samples_tpu_torch.tracker import runtime
    from hand_tracking_samples_tpu_torch.tracker.config import TrackerConfig
    model, cnn = port
    _, depth, poses = _inputs(hand_model)
    calls = []

    def spy(state, model, cnn_params, depth, cam, config, params, ph=None,
            schedule=None):
        calls.append((depth.shape, ph is not None, config.solver))
        return state, None
    monkeypatch.setattr(runtime, "update_cnn_model", spy)
    cfg = TrackerConfig(point_budget=512, cnn_every_frame=True,
                        solver="sequential", use_pallas=False,
                        cnn_every_k=2, physics_iterations=2,
                        physics_iterations_post=1)
    st = batched_tracker_state(model, 1)
    st = st._replace(body=st.body._replace(pose=torch.tensor(poses[:1])))
    d = depth_tensor(depth[:1], "cpu")
    _, out = track_sequences(st, model, cnn, [d, d], synth_camera(), cfg)
    assert calls == [((1, 240, 320), True, "sequential")]
    assert out.shape == (2, 1, 17, 7) and torch.isfinite(out).all()
    assert not torch.equal(out[0], out[1])       # both frames moved it


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from hand_tracking_samples_tpu.model.bake import load_hand_model
    hm = jax.tree_util.tree_map(jnp.asarray, load_hand_model(
        MODEL_JSON, cache_dir=os.path.join(FIXTURES, "cache")))
    print({s: {k: v.shape for k, v in r.items()}
           for s, r in jax_reference(hm).items()})
