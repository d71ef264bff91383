"""The port's scale-out paths (parallel/mesh.py, parallel/tracks.py
sharded_track_sequences) and utils/profiling.py on the CPU, against the
JAX package's at tests/test_parallel.py's inputs:

  tracking  T=8 tracks, F=2 frames of JAX's fake_depth renders of bank
            frame (29 t + f) % len(bank), each track started on its first
            pose; the colored solver, point budget 256, 32 cloud rows a
            body, 4+2 sweeps, no CNN.  The port sharded over ["cpu"] * 2
            and ["cpu"] * 4 against the port unsharded (bit for bit) and
            against JAX's sharded_track_sequences on its 8-device CPU mesh
            (1e-5 m, quat_err 1e-4, the slice's tolerance; JAX's own gate
            between sharded and unsharded is 2e-5).  JAX's poses are cached
            as tests/fixtures/cache/parallel_*.json (`python -m
            tests.test_torch_parallel` writes it).
  training  one SGD step at batch 8 from JAX's init_params(PRNGKey(0)),
            alpha 1e-3: the port's data-parallel step on ["cpu"] * 2 and
            ["cpu"] * 4 against JAX's make_dp_train_step (run here: its
            weights do not fit a cache) and against the port's single
            step, at tests/test_parallel.py's gates (MSE 1e-6, every
            parameter 2e-6)."""
import hashlib
import json
import os
import time

import numpy as np
import pytest
import torch

from tests.conftest import FIXTURES, MODEL_JSON, cached_fake_depths, quat_err

# the port tests run small tensors: one intra-op thread each, so the
# suite's parallel workers do not oversubscribe the cores
torch.set_num_threads(1)

T, F = 8, 2
CONFIG = dict(point_budget=256, cnn_every_frame=False,
              cloud_rows_per_body=32, physics_iterations=4,
              physics_iterations_post=2, solver="colored")


def _inputs(hand_model):
    """(depths (F, T, H, W) u16, poses (F, T, 17, 7))."""
    from hand_tracking_samples_tpu.assets_paths import DEFAULT_ANIMBANK
    from hand_tracking_samples_tpu.data.animbank import load_animbank
    bank = load_animbank(DEFAULT_ANIMBANK)
    ids = (np.arange(T)[None, :] * 29 + np.arange(F)[:, None]) % len(bank)
    poses = np.asarray(bank[ids], np.float32)
    depths = cached_fake_depths(hand_model, poses, "par16")
    return depths.astype(np.uint16), poses


def jax_reference(hand_model):
    """JAX's sharded_track_sequences on its 8-device CPU mesh and its
    unsharded track_sequences: {"sharded_poses", "sharded_state",
    "poses", "state"}, cached."""
    depths, poses = _inputs(hand_model)
    h = hashlib.sha1(depths.tobytes() + poses.tobytes()
                     + repr(sorted(CONFIG.items())).encode()
                     ).hexdigest()[:12]
    path = os.path.join(FIXTURES, "cache", f"parallel_{h}.json")
    if os.path.exists(path):
        with open(path) as f:
            return {k: np.asarray(v, np.float32)
                    for k, v in json.load(f).items()}
    import jax
    import jax.numpy as jnp
    from hand_tracking_samples_tpu.data.synth import synth_camera
    from hand_tracking_samples_tpu.parallel.mesh import make_mesh
    from hand_tracking_samples_tpu.parallel.tracks import (
        batched_tracker_state, sharded_track_sequences, track_sequences)
    from hand_tracking_samples_tpu.tracker.config import TrackerConfig
    assert len(jax.devices()) == 8
    cfg, cam = TrackerConfig(**CONFIG), synth_camera()
    st = batched_tracker_state(hand_model, T)
    st = st._replace(body=st.body._replace(pose=jnp.asarray(poses[0])))
    d = jnp.asarray(depths)
    su, pu = jax.jit(lambda s, dd: track_sequences(
        s, hand_model, None, dd, cam, cfg))(st, d)
    ss, ps = sharded_track_sequences(make_mesh("tracks"), st, hand_model,
                                     None, d, cam, cfg)
    out = dict(poses=np.asarray(pu), state=np.asarray(su.body.pose),
               sharded_poses=np.asarray(ps),
               sharded_state=np.asarray(ss.body.pose))
    with open(path, "w") as f:       # text: float32 values round-trip
        json.dump({k: v.tolist() for k, v in out.items()}, f)
    return out


@pytest.fixture(scope="module")
def tracking(hand_model):
    """The port's unsharded run and its runs sharded over 2 and 4 CPU
    devices: {k: (final state, (F, T, 17, 7) poses)}, k = 1, 2, 4."""
    from hand_tracking_samples_tpu_torch.data.synth import synth_camera
    from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
    from hand_tracking_samples_tpu_torch.ops.cloud_kernel import (
        depth_tensor)
    from hand_tracking_samples_tpu_torch.parallel.mesh import make_mesh
    from hand_tracking_samples_tpu_torch.parallel.tracks import (
        batched_tracker_state, sharded_track_sequences, track_sequences)
    from hand_tracking_samples_tpu_torch.tracker.config import TrackerConfig
    depths, poses = _inputs(hand_model)
    model = from_numpy_model({k: np.asarray(v) for k, v in
                              vars(hand_model).items()}, "cpu")
    st = batched_tracker_state(model, T)
    st = st._replace(body=st.body._replace(pose=torch.tensor(poses[0])))
    d = depth_tensor(depths, "cpu")
    cfg, cam = TrackerConfig(**CONFIG), synth_camera()
    out = {1: track_sequences(st, model, None, d, cam, cfg)}
    for k in (2, 4):
        out[k] = sharded_track_sequences(make_mesh("tracks", devices=[
            "cpu"] * k), st, model, None, d, cam, cfg)
    return out


@pytest.mark.parametrize("k", [2, 4])
def test_sharded_equals_unsharded(tracking, k):
    """Sharded over k CPU devices, the port's states and poses equal its
    unsharded run's bit for bit: the tracks are independent, and each
    track's arithmetic does not depend on its batch."""
    st1, p1 = tracking[1]
    stk, pk = tracking[k]
    assert pk.shape == (F, T, 17, 7)
    assert torch.equal(pk, p1)
    for a, b in zip(stk, st1):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_sharded_cnn_cadence_equals_unsharded(hand_model):
    """The kernel solver's CNN frame with cnn_every_k=2 (a CNN frame, then
    a dynamics frame) sharded over 2 CPU devices, T=4 (tracks 1 and 3 from
    the start pose, so the reset runs in both shards): bit for bit with
    the unsharded run (point budget 512, 32 cloud rows a body, 4+2
    sweeps)."""
    from hand_tracking_samples_tpu_torch.assets_paths import DEFAULT_CNNB
    from hand_tracking_samples_tpu_torch.cnn.model import load_cnnb
    from hand_tracking_samples_tpu_torch.data.synth import synth_camera
    from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
    from hand_tracking_samples_tpu_torch.ops.cloud_kernel import (
        depth_tensor)
    from hand_tracking_samples_tpu_torch.parallel.mesh import make_mesh
    from hand_tracking_samples_tpu_torch.parallel.tracks import (
        batched_tracker_state, sharded_track_sequences, track_sequences)
    from hand_tracking_samples_tpu_torch.tracker.config import TrackerConfig
    depths, poses = _inputs(hand_model)
    model = from_numpy_model({k: np.asarray(v) for k, v in
                              vars(hand_model).items()}, "cpu")
    st = batched_tracker_state(model, 4)
    start = st.body.pose.clone()
    start[[0, 2]] = torch.tensor(poses[0, [0, 2]])
    st = st._replace(body=st.body._replace(pose=start))
    d = depth_tensor(depths[:, :4], "cpu")
    cfg = TrackerConfig(point_budget=512, cloud_rows_per_body=32,
                        physics_iterations=4, physics_iterations_post=2,
                        solver="kernel", use_pallas=True,
                        cnn_every_frame=True, cnn_every_k=2)
    cnn, cam = load_cnnb(DEFAULT_CNNB, "cpu"), synth_camera()
    st1, p1 = track_sequences(st, model, cnn, d, cam, cfg)
    st2, p2 = sharded_track_sequences(make_mesh(devices=["cpu"] * 2), st,
                                      model, cnn, d, cam, cfg)
    assert torch.equal(p1, p2) and torch.equal(st1.body.pose,
                                               st2.body.pose)
    assert torch.equal(st1.initializing, st2.initializing)
    assert np.abs(p1[-1, 1].numpy() - p1[0, 1].numpy()).max() > 1e-4


def test_sharded_matches_jax(hand_model, tracking):
    """The port sharded over 4 devices against JAX's sharded run (and
    JAX's sharded against its unsharded, tests/test_parallel.py's gate)."""
    ref = jax_reference(hand_model)
    np.testing.assert_allclose(ref["sharded_poses"], ref["poses"],
                               atol=2e-5)
    st, user = tracking[4]
    pose = st.body.pose.numpy()
    assert np.abs(pose[..., :3] - ref["sharded_state"][..., :3]).max() \
        < 1e-5
    assert quat_err(pose[..., 3:].reshape(-1, 4),
                    ref["sharded_state"][..., 3:].reshape(-1, 4)) < 1e-4
    user = user.numpy()
    assert np.abs(user[..., :3] - ref["sharded_poses"][..., :3]).max() \
        < 1e-5
    assert quat_err(user[..., 3:].reshape(-1, 4),
                    ref["sharded_poses"][..., 3:].reshape(-1, 4)) < 1e-4
    _, poses = _inputs(hand_model)
    assert np.abs(pose[..., :3] - poses[0, ..., :3]).max() > 1e-4  # moved


def test_uneven_shards_raise(hand_model):
    """T not divisible by the mesh size raises ValueError, as JAX's
    shard_map refuses it; shard_batch too; make_mesh with no card and no
    device named raises."""
    from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
    from hand_tracking_samples_tpu_torch.parallel.mesh import (
        make_mesh, replicate, shard_batch)
    from hand_tracking_samples_tpu_torch.parallel.tracks import (
        batched_tracker_state, sharded_track_sequences)
    from hand_tracking_samples_tpu_torch.tracker.config import TrackerConfig
    model = from_numpy_model({k: np.asarray(v) for k, v in
                              vars(hand_model).items()}, "cpu")
    mesh = make_mesh(devices=["cpu"] * 3)
    assert len(mesh) == 3 and mesh.axis == "data"
    st = batched_tracker_state(model, T)
    with pytest.raises(ValueError):
        sharded_track_sequences(mesh, st, model, None,
                                torch.zeros((1, T, 240, 320), dtype=torch.int16),
                                None, TrackerConfig(**CONFIG))
    with pytest.raises(ValueError):
        shard_batch(mesh, torch.zeros(8, 2))
    parts = shard_batch(mesh, {"a": torch.arange(6), "b": (torch.zeros(3),)})
    assert [p["a"].tolist() for p in parts] == [[0, 1], [2, 3], [4, 5]]
    assert all(p["b"][0].shape == (1,) for p in parts)
    copies = replicate(mesh, model)
    assert all(c is model for c in copies)   # already on the device
    assert make_mesh(n=2, devices=["cpu"] * 4).devices == (
        torch.device("cpu"),) * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh()


def test_dp_step_matches_jax():
    """The data-parallel step over 2 and 4 CPU devices against JAX's
    make_dp_train_step and the port's single sgd_step (MSE 1e-6, every
    parameter 2e-6); the step moved the weights."""
    import jax
    import jax.numpy as jnp
    from hand_tracking_samples_tpu.cnn.model import init_params
    from hand_tracking_samples_tpu.parallel.mesh import (
        make_dp_train_step as j_dp, make_mesh as j_mesh)
    from hand_tracking_samples_tpu_torch.cnn.model import (
        from_numpy, sgd_step)
    from hand_tracking_samples_tpu_torch.parallel.mesh import (
        make_dp_train_step, make_mesh)
    rng = np.random.RandomState(0)
    jp = init_params(jax.random.PRNGKey(0))
    x = rng.rand(8, 64, 64).astype(np.float32)
    t = rng.rand(8, 2304).astype(np.float32)
    jp_dp, jmse = j_dp(j_mesh("data"), 1e-3)(jp, jnp.asarray(x),
                                              jnp.asarray(t))
    ref = {k: {kk: np.asarray(v) for kk, v in d.items()}
           for k, d in jp_dp.items()}
    p0 = from_numpy({k: {kk: np.asarray(v) for kk, v in d.items()}
                     for k, d in jp.items()}, "cpu")
    xt, tt = torch.tensor(x), torch.tensor(t)
    single, smse = sgd_step(p0, xt, tt, 1e-3)
    for k in (2, 4):
        new, mse = make_dp_train_step(make_mesh(devices=["cpu"] * k),
                                      1e-3)(p0, xt, tt)
        assert abs(mse.item() - float(jmse)) < 1e-6
        assert abs(mse.item() - smse.item()) < 1e-6
        for name in ref:
            for kk in ref[name]:
                got = new[name][kk].numpy()
                assert np.abs(got - ref[name][kk]).max() < 2e-6, (name, kk)
                assert np.abs(got - single[name][kk].numpy()).max() < 2e-6
    moved = max(np.abs(new[n][kk].numpy() - p0[n][kk].numpy()).max()
                for n in new for kk in new[n])
    assert moved > 1e-6


def test_dryrun_multichip(hand_model):
    """The port's counterpart of __graft_entry__.dryrun_multichip on two
    CPU devices: one sharded frame and one data-parallel step, shapes
    held."""
    from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
    from hand_tracking_samples_tpu_torch.parallel.mesh import make_mesh
    from hand_tracking_samples_tpu_torch.parallel.tracks import (
        dryrun_multichip)
    model = from_numpy_model({k: np.asarray(v) for k, v in
                              vars(hand_model).items()}, "cpu")
    msg = dryrun_multichip(make_mesh("tracks", devices=["cpu"] * 2), model)
    assert msg.startswith("dryrun_multichip OK on 2 devices: tracking "
                          "(1, 4, 17, 7)"), msg


def test_stage_timer_and_trace(tmp_path):
    """StageTimer: stage() and time() accumulate, report() lists the
    stages, the slower first; device_trace writes a Chrome trace that
    names the traced operations."""
    from hand_tracking_samples_tpu_torch.utils.profiling import (
        StageTimer, device_trace)
    timer = StageTimer()
    with timer.stage("slow"):
        time.sleep(0.02)
    out = timer.time("fast", lambda a: (a + 1, {"b": a * 2}),
                     torch.ones(3))
    timer.time("fast", torch.ones, 2)
    assert out[1]["b"].tolist() == [2.0, 2.0, 2.0]
    lines = timer.report().splitlines()
    assert [ln.split()[0] for ln in lines] == ["slow", "fast"]
    assert "(2 calls" in lines[1] and "ms/call" in lines[1]
    with device_trace(str(tmp_path)) as trace:
        torch.mm(torch.randn(64, 64), torch.randn(64, 64))
    assert os.path.exists(trace.path)
    with open(trace.path) as f:
        assert "aten::mm" in f.read()


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from hand_tracking_samples_tpu.model.bake import load_hand_model
    hm = jax.tree_util.tree_map(jnp.asarray, load_hand_model(
        MODEL_JSON, cache_dir=os.path.join(FIXTURES, "cache")))
    r = jax_reference(hm)
    print({k: v.shape for k, v in r.items()},
          np.abs(r["sharded_poses"] - r["poses"]).max())
