"""The port's dynamics frame on the reference-shaped solvers (plain
versions, CPU), T=2 tracks at full width (point budget 2048, 16+4 sweeps,
exact contacts, boundary planes):

  * solver="sequential", use_pallas=False (the JAX package's defaults and
    the C++ golden's setting) over the first 3 frames of the dyntrack
    golden, at tests/test_tracker_e2e.py:39's bounds: each frame's mean
    joint deviation from the golden < 1.5 mm and the joint error against
    the animbank < the reference's + 1.5 mm;
  * one frame of each of {sequential, colored} x {use_pallas True, False}
    against the JAX package's `batched_update` on the same renders and
    states, within 1e-5 m and quat_err 1e-4 (the bound the kernel-solver
    slice holds, tests/test_torch_slice_jax.py).

Track 0 is the golden's (bank[0] on the dyn30 render 0); track 1 starts
2 mm off bank[12] on the dyn30 render 12.  The JAX frames take minutes on
the CPU (the interpret-mode correspondence kernel among them), so they are
cached as JSON text in tests/fixtures/cache/ under a hash of the inputs, as
cnnframe_*.json is; `python -m tests.test_torch_seq_frame` writes the
cache, and also the JAX curve chip_smoke.py holds its odd tracks to
(`jax_odd_curve`), and prints the port's CPU gap to that curve."""
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

SETTINGS = [("sequential", False), ("sequential", True), ("colored", False),
            ("colored", True)]
GOLDEN_FRAMES = 3


def _config(cls, solver, use_pallas):
    return cls(point_budget=2048, cnn_every_frame=False, solver=solver,
               use_pallas=use_pallas)


def _inputs(hand_model):
    """(bank, dyn30 renders (30, H, W) u16, the T=2 depth of the compared
    frame (2, H, W), the start poses (2, 17, 7))."""
    from hand_tracking_samples_tpu.assets_paths import DEFAULT_ANIMBANK
    from hand_tracking_samples_tpu.data.animbank import load_animbank
    bank = load_animbank(DEFAULT_ANIMBANK)
    dyn = cached_fake_depths(hand_model, np.asarray(bank[:30])[:, None],
                             "dyn30")[:, 0]
    poses = np.stack([bank[0], bank[12]]).astype(np.float32)
    poses[1, :, 0] += 0.002
    return bank, dyn, np.stack([dyn[0], dyn[12]]), poses


def jax_reference(hand_model):
    """The JAX package's frame on _inputs for each setting, cached:
    {"<solver>_<use_pallas>": poses (2, 17, 7)}."""
    _, _, depth, poses = _inputs(hand_model)
    h = hashlib.sha1(depth.tobytes() + poses.tobytes()
                     + repr(SETTINGS).encode()).hexdigest()[:12]
    path = os.path.join(FIXTURES, "cache", f"seqframe_{h}.json")
    if os.path.exists(path):
        with open(path) as f:
            return {k: np.asarray(v, np.float32)
                    for k, v in json.load(f).items()}
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from hand_tracking_samples_tpu.data.synth import synth_camera
    from hand_tracking_samples_tpu.parallel.tracks import (
        batched_tracker_state, batched_update)
    from hand_tracking_samples_tpu.tracker.config import TrackerConfig
    from hand_tracking_samples_tpu.tracker.runtime import physics_params
    out = {}
    for solver, up in SETTINGS:
        cfg = _config(TrackerConfig, solver, up)
        params = physics_params(cfg)
        st = batched_tracker_state(hand_model, 2)
        st = st._replace(body=st.body._replace(pose=jnp.asarray(poses)))
        with pltpu.force_tpu_interpret_mode():
            new = jax.jit(lambda s, d: batched_update(
                s, hand_model, None, d, synth_camera(), cfg, params)[0])(
                st, jnp.asarray(depth))
        out[f"{solver}_{up}"] = np.asarray(new.body.pose)
    with open(path, "w") as f:       # text: float32 values round-trip
        json.dump({k: v.tolist() for k, v in out.items()}, f)
    return out


ODD_FRAMES = (30, 60)     # chip_smoke.py's odd tracks: fake_depth renders


def jax_odd_curve(hand_model):
    """The JAX package's sequential frame (use_pallas=True) on the port's
    fake_depth renders of bank[30:60], one track started at bank[30]: the
    per-frame mean joint error against the animbank in mm, cached as
    seqcurve_<hash>.json.  chip_smoke.py holds its odd tracks (the same
    renders on the card) to this curve."""
    from hand_tracking_samples_tpu.assets_paths import DEFAULT_ANIMBANK
    from hand_tracking_samples_tpu.data.animbank import load_animbank
    from hand_tracking_samples_tpu_torch.data.synth import (
        fake_depth, synth_camera)
    from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
    bank = load_animbank(DEFAULT_ANIMBANK)
    a, b = ODD_FRAMES
    model = from_numpy_model({k: np.asarray(v) for k, v in
                              vars(hand_model).items()}, "cpu")
    depths = fake_depth(torch.tensor(bank[a:b]), model, synth_camera(),
                        chunk=8).numpy().view(np.uint16)
    h = hashlib.sha1(depths.tobytes()).hexdigest()[:12]
    path = os.path.join(FIXTURES, "cache", f"seqcurve_{h}.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from hand_tracking_samples_tpu.data.synth import synth_camera as j_cam
    from hand_tracking_samples_tpu.tracker.config import TrackerConfig
    from hand_tracking_samples_tpu.tracker.runtime import (
        make_tracker_state, physics_params, update)
    cfg = _config(TrackerConfig, "sequential", True)
    params = physics_params(cfg)
    st = make_tracker_state(hand_model)
    st = st._replace(body=st.body._replace(pose=jnp.asarray(bank[a])))
    with pltpu.force_tpu_interpret_mode():
        step = jax.jit(lambda s, d: update(s, hand_model, None, d, j_cam(),
                                           cfg, params)[0])
        curve = []
        for f in range(b - a):
            st = step(st, jnp.asarray(depths[f]))
            curve.append(float(np.linalg.norm(
                np.asarray(st.body.pose)[:, :3] - bank[a + f][:, :3],
                axis=1).mean() * 1e3))
    out = {"frames": [a, b], "joint_err_mm": curve}
    with open(path, "w") as f:
        json.dump(out, f)
    return out


@pytest.fixture(scope="module")
def port(hand_model):
    from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
    return from_numpy_model({k: np.asarray(v) for k, v in
                             vars(hand_model).items()}, "cpu")


def _run(model, poses, depths, solver, use_pallas):
    """The port's frames: per-frame poses (F, 2, 17, 7)."""
    from hand_tracking_samples_tpu_torch.data.synth import synth_camera
    from hand_tracking_samples_tpu_torch.ops.cloud_kernel import (
        depth_tensor)
    from hand_tracking_samples_tpu_torch.parallel.tracks import (
        batched_tracker_state, batched_update)
    from hand_tracking_samples_tpu_torch.tracker.config import (
        TrackerConfig)
    cfg = _config(TrackerConfig, solver, use_pallas)
    st = batched_tracker_state(model, 2)
    st = st._replace(body=st.body._replace(pose=torch.tensor(poses)))
    out = []
    for d in depths:
        st, _ = batched_update(st, model, None, depth_tensor(d, "cpu"),
                               synth_camera(), cfg)
        out.append(st.body.pose.numpy().copy())
    return np.stack(out)


@pytest.fixture(scope="module")
def golden_run(hand_model, port):
    """Sequential, use_pallas=False: frames 0-2 of the golden on track 0,
    frame 0 of the compared render on track 1."""
    bank, dyn, depth, poses = _inputs(hand_model)
    seq = [depth] + [np.stack([dyn[f], dyn[12]])
                     for f in range(1, GOLDEN_FRAMES)]
    return _run(port, poses, seq, "sequential", False)


def test_sequential_frames_match_golden(golden, hand_model, golden_run):
    bank = _inputs(hand_model)[0]
    ref = np.array(golden["dyntrack_poses"], np.float32).reshape(-1, 17, 7)
    for f in range(GOLDEN_FRAMES):
        mine = golden_run[f, 0]
        dev = np.linalg.norm(mine[:, :3] - ref[f, :, :3], axis=1)
        assert dev.mean() < 1.5e-3, (f, dev.mean())
        je = np.linalg.norm(mine[:, :3] - bank[f][:, :3], axis=1).mean()
        assert je < golden["dyntrack_joint_err"][f] + 1.5e-3, (f, je)


@pytest.mark.parametrize("solver,use_pallas", SETTINGS)
def test_frame_matches_jax(hand_model, port, golden_run, solver,
                           use_pallas):
    ref = jax_reference(hand_model)[f"{solver}_{use_pallas}"]
    if (solver, use_pallas) == ("sequential", False):
        mine = golden_run[0]
    else:
        _, _, depth, poses = _inputs(hand_model)
        mine = _run(port, poses, [depth], solver, use_pallas)[0]
    assert np.abs(mine[..., :3] - ref[..., :3]).max() < 1e-5
    assert quat_err(mine[..., 3:], ref[..., 3:]) < 1e-4


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from hand_tracking_samples_tpu.model.bake import load_hand_model
    hm = jax.tree_util.tree_map(jnp.asarray, load_hand_model(
        MODEL_JSON, cache_dir=os.path.join(FIXTURES, "cache")))
    print({k: v.shape for k, v in jax_reference(hm).items()})
    curve = jax_odd_curve(hm)["joint_err_mm"]
    print("JAX curve", curve)
    # the port's plain path on the CPU on the same renders, against it
    from hand_tracking_samples_tpu.assets_paths import DEFAULT_ANIMBANK
    from hand_tracking_samples_tpu.data.animbank import load_animbank
    from hand_tracking_samples_tpu_torch.data.synth import (
        fake_depth, synth_camera)
    from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
    from hand_tracking_samples_tpu_torch.parallel.tracks import (
        batched_tracker_state, batched_update)
    from hand_tracking_samples_tpu_torch.tracker.config import (
        TrackerConfig)
    bank = load_animbank(DEFAULT_ANIMBANK)
    a, b = ODD_FRAMES
    model = from_numpy_model({k: np.asarray(v) for k, v in
                              vars(hm).items()}, "cpu")
    depths = fake_depth(torch.tensor(bank[a:b]), model, synth_camera(),
                        chunk=8)
    cfg = _config(TrackerConfig, "sequential", True)
    st = batched_tracker_state(model, 1)
    st = st._replace(body=st.body._replace(pose=torch.tensor(bank[a:a + 1])))
    gap = []
    for f in range(b - a):
        st, _ = batched_update(st, model, None, depths[f:f + 1],
                               synth_camera(), cfg)
        err = float(np.linalg.norm(st.body.pose[0, :, :3].numpy()
                                   - bank[a + f][:, :3], axis=1).mean()
                    * 1e3)
        gap.append(abs(err - curve[f]))
    print("port CPU |gap| mm per frame", [round(g, 4) for g in gap],
          "max", max(gap))
