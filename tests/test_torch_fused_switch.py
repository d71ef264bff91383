"""The JAX package's HTS_FUSED switch against the port's one kernel-fit
route.  The JAX package builds the kernel solver's rows two ways: the fused
tracks-last pipeline (physics/fused_fit.py, the default) and, under
HTS_FUSED=0, the per-track row factories (model/hand.py
_fit_point_cloud_pgs), read by its main fit and by MultiStepSim
(tracker/runtime.py _use_fused).  Both run the same kernels (the cloud-rows
pack and the PGS solve).  The port has the fused route only
(model/hand.fit_fused); these tests hold it against JAX's per-track route
on the CPU, at the slice's full width (point budget 2048, 128 cloud rows a
body, 16+4 sweeps, exact contacts, boundary planes), T=2:

  dynamics frame  dyn30 renders 0 and 12, track 0 at bank[0], track 1
                  2 mm off bank[12];
  CNN frame       dyn30 renders 5 and 12, track 0 at its ground truth,
                  track 1 from the start pose: FitError exceeds
                  full_reset_on_error there, so the reset, the unibody fits
                  and MultiStepSim's per-track route all run.

JAX runs with HTS_FUSED=0 set through pytest's MonkeyPatch and its jit
caches cleared before and after (the switch is read at trace time).  Its
frames take minutes on the CPU (its Pallas kernels in interpret mode), so
they are cached as JSON text in tests/fixtures/cache/fusedswitch_*.json,
with JAX's fused dynamics frame on the same inputs beside them (its fused
CNN frame is test_torch_cnn_frame.py's cache); `python -m
tests.test_torch_fused_switch` writes the cache.

Held: the port's frames within 1e-5 m and quat_err 1e-4 (the slice's
tolerance) of JAX's per-track route, and JAX's two routes within the same
of each other."""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from tests.conftest import FIXTURES, MODEL_JSON, cached_fake_depths, quat_err
from tests import test_torch_cnn_frame as cnn_frame

# the port tests run small tensors: one intra-op thread each, so the
# suite's parallel workers do not oversubscribe the cores
torch.set_num_threads(1)

DYN_FRAMES = (0, 12)
FULL = dict(point_budget=2048, cloud_rows_per_body=128, solver="kernel",
            use_pallas=True)


def _dyn_inputs(hand_model):
    from hand_tracking_samples_tpu.assets_paths import DEFAULT_ANIMBANK
    from hand_tracking_samples_tpu.data.animbank import load_animbank
    bank = load_animbank(DEFAULT_ANIMBANK)
    dyn = cached_fake_depths(hand_model, np.asarray(bank[:30])[:, None],
                             "dyn30")[:, 0]
    poses = np.stack([bank[0], bank[12]]).astype(np.float32)
    poses[1, :, 0] += 0.002
    return np.stack([dyn[f] for f in DYN_FRAMES]).astype(np.uint16), poses


def jax_reference(hand_model):
    """JAX's dynamics frame with the fused route and with HTS_FUSED=0, and
    its CNN frame with HTS_FUSED=0 (mid_pose after update_cnn_model,
    final_pose after the frame's dynamics pass), cached."""
    ddepth, dposes = _dyn_inputs(hand_model)
    _, cdepth, cposes = cnn_frame._inputs(hand_model)
    with open(cnn_frame._cnnb(), "rb") as f:
        wh = hashlib.sha1(f.read()).hexdigest()
    h = hashlib.sha1(ddepth.tobytes() + dposes.tobytes() + cdepth.tobytes()
                     + cposes.tobytes() + wh.encode()
                     + repr(sorted(FULL.items())).encode()).hexdigest()[:12]
    path = os.path.join(FIXTURES, "cache", f"fusedswitch_{h}.json")
    if os.path.exists(path):
        with open(path) as f:
            return {k: np.asarray(v, np.float32)
                    for k, v in json.load(f).items()}
    import jax
    import jax.numpy as jnp
    from hand_tracking_samples_tpu.cnn.model import load_cnnb
    from hand_tracking_samples_tpu.data.synth import synth_camera
    from hand_tracking_samples_tpu.parallel.tracks import (
        batched_tracker_state, batched_update)
    from hand_tracking_samples_tpu.tracker.config import TrackerConfig
    from hand_tracking_samples_tpu.tracker.runtime import (
        physics_params, update_cnn_model)
    cam = synth_camera()
    cnn = load_cnnb(cnn_frame._cnnb())

    def state(poses):
        st = batched_tracker_state(hand_model, 2)
        return st._replace(body=st.body._replace(pose=jnp.asarray(poses)))

    def dynamics():
        cfg = TrackerConfig(cnn_every_frame=False, **FULL)
        return np.asarray(jax.jit(lambda s, d: batched_update(
            s, hand_model, None, d, cam, cfg, physics_params(cfg))[0])(
            state(dposes), jnp.asarray(ddepth)).body.pose)

    out = {}
    jax.clear_caches()
    out["dyn_fused"] = dynamics()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HTS_FUSED", "0")
        jax.clear_caches()
        out["dyn_unfused"] = dynamics()
        cfg = TrackerConfig(cnn_every_frame=True, **FULL)
        params = physics_params(cfg)
        d = jnp.asarray(cdepth)
        mid = jax.jit(jax.vmap(lambda s, dd: update_cnn_model(
            s, hand_model, cnn, dd, cam, cfg, params)[0]))(state(cposes), d)
        final = jax.jit(lambda s, dd: batched_update(
            s, hand_model, cnn, dd, cam, cfg, params,
            run_cnn=False))(mid, d)[0]
        out["cnn_unfused_mid_pose"] = np.asarray(mid.body.pose)
        out["cnn_unfused_final_pose"] = np.asarray(final.body.pose)
    jax.clear_caches()
    with open(path, "w") as f:       # text: float32 values round-trip
        json.dump({k: v.tolist() for k, v in out.items()}, f)
    return out


def _close(mine, want):
    """(position gap in m, quat_err); asserts the slice's tolerance."""
    dp = float(np.abs(mine[..., :3] - want[..., :3]).max())
    dq = float(quat_err(mine[..., 3:].reshape(-1, 4),
                        want[..., 3:].reshape(-1, 4)))
    assert dp < 1e-5 and dq < 1e-4, (dp, dq)
    return dp, dq


@pytest.fixture(scope="module")
def port(hand_model):
    from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
    return from_numpy_model({k: np.asarray(v) for k, v in
                             vars(hand_model).items()}, "cpu")


def test_dynamics_frame_matches_unfused_jax(hand_model, port):
    """The port's dynamics frame (the fused route) against JAX's with
    HTS_FUSED=0; JAX's fused frame against its unfused one."""
    from hand_tracking_samples_tpu_torch.data.synth import synth_camera
    from hand_tracking_samples_tpu_torch.ops.cloud_kernel import (
        depth_tensor)
    from hand_tracking_samples_tpu_torch.parallel.tracks import (
        batched_tracker_state, batched_update)
    from hand_tracking_samples_tpu_torch.tracker.config import (
        TrackerConfig)
    ref = jax_reference(hand_model)
    depth, poses = _dyn_inputs(hand_model)
    st = batched_tracker_state(port, 2)
    st = st._replace(body=st.body._replace(pose=torch.tensor(poses)))
    st, _ = batched_update(st, port, None, depth_tensor(depth, "cpu"),
                           synth_camera(),
                           TrackerConfig(cnn_every_frame=False, **FULL))
    mine = st.body.pose.numpy()
    assert np.abs(mine[..., :3] - poses[..., :3]).max() > 1e-4   # moved
    _close(mine, ref["dyn_unfused"])
    _close(ref["dyn_fused"], ref["dyn_unfused"])


def test_cnn_frame_matches_unfused_jax(hand_model, port, monkeypatch):
    """The port's CNN frame (MultiStepSim and the main fit on the fused
    route) against JAX's with HTS_FUSED=0, after the refit and after the
    whole frame; JAX's fused CNN frame (test_torch_cnn_frame.py's cache)
    against its unfused one; the reset track takes the refit."""
    from hand_tracking_samples_tpu_torch.cnn.model import load_cnnb
    from hand_tracking_samples_tpu_torch.data.synth import synth_camera
    from hand_tracking_samples_tpu_torch.ops.cloud_kernel import (
        depth_tensor)
    from hand_tracking_samples_tpu_torch.parallel.tracks import (
        batched_tracker_state, batched_update)
    from hand_tracking_samples_tpu_torch.tracker import runtime
    from hand_tracking_samples_tpu_torch.tracker.config import (
        TrackerConfig)
    ref = jax_reference(hand_model)
    fused = cnn_frame.jax_reference(hand_model)
    _, depth, poses = cnn_frame._inputs(hand_model)
    seen = []

    def spy(*a, _real=runtime.update_cnn_model, **k):
        seen.append(_real(*a, **k))
        return seen[-1]
    monkeypatch.setattr(runtime, "update_cnn_model", spy)
    st = batched_tracker_state(port, 2)
    st = st._replace(body=st.body._replace(pose=torch.tensor(poses)))
    final, _ = batched_update(st, port, load_cnnb(cnn_frame._cnnb(), "cpu"),
                              depth_tensor(depth, "cpu"), synth_camera(),
                              TrackerConfig(cnn_every_frame=True, **FULL))
    (mid, _), = seen
    mid = mid.body.pose.numpy()
    assert (mid != poses).any(axis=(1, 2)).tolist()[1]
    for k, mine in (("mid_pose", mid), ("final_pose",
                                        final.body.pose.numpy())):
        _close(mine, ref[f"cnn_unfused_{k}"])
        _close(fused[k], ref[f"cnn_unfused_{k}"])


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from hand_tracking_samples_tpu.model.bake import load_hand_model
    hm = jax.tree_util.tree_map(jnp.asarray, load_hand_model(
        MODEL_JSON, cache_dir=os.path.join(FIXTURES, "cache")))
    r = jax_reference(hm)
    print({k: v.shape for k, v in r.items()})
    f = cnn_frame.jax_reference(hm)
    for a, b in (("dyn_fused", "dyn_unfused"),
                 ("mid_pose", "cnn_unfused_mid_pose"),
                 ("final_pose", "cnn_unfused_final_pose")):
        x = f[a] if a in f else r[a]
        print(a, "vs", b, "m", np.abs(x[..., :3] - r[b][..., :3]).max())
