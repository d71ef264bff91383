"""The voxel and mirror clouds through whole frames: the port's
batched_update (plain versions, CPU) against the JAX package's on the same
renders and states, T=2 tracks at full width (point budget 2048, 128 cloud
rows a body, 16+4 sweeps, exact contacts, boundary planes):

  dynamics frames  the kernel solver with the voxel cloud (0.005 m, buckets
                   of at least subsample_fraction = 4 points), with the
                   mirror's cutting plane, and with both; the sequential
                   and colored solvers (use_pallas) with each, and the
                   sequential solver with the mirror and use_pallas off
                   (the plane dots in place of the correspondence kernel).
                   dyn30 renders 0 and 12, track 0 at bank[0], track 1
                   2 mm off bank[12];
  CNN frames       the kernel solver with the cutting plane, and with the
                   voxel cloud (whose CNN refit takes the frame's
                   cloud_from_depth cloud, not the voxel cloud).  dyn30
                   renders 5 and 12, track 0 at its ground truth, track 1
                   from the model's start pose, so FitError exceeds
                   full_reset_on_error and PoseFromScratch and the three
                   UnibodyFits run.

The cutting plane is a tilted unit normal ~(0.3, -0.2, -0.93) through the
median valid point of render 0: points under it (reflected), in its 2 cm
band (dropped) and over it all occur.  Held: poses within 1e-5 m and
quat_err 1e-4 (the port's frame bound, tests/test_torch_slice_jax.py); for
the CNN frames also equal do_reset and take decisions, and kernel 2.5 (the
16-channel pack) running 5 times a frame, 4 in MultiStepSim and 1 in the
dynamics pass (counted through its plain version's calls on the CPU).

The JAX frames take many minutes on the CPU (the Pallas kernels in
interpret mode), so their results are cached as JSON text in
tests/fixtures/cache/ under a hash of the inputs, as seqframe_*.json is;
`python -m tests.test_torch_cloud_frames` writes the cache."""
import dataclasses
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

CUT_PLANE = (0.3007679283618927, -0.20051196217536926, -0.9323806166648865,
             0.370469868183136)
CLOUDS = {"voxel": dict(subsample_voxel=1, subsample_size=0.005),
          "mirror": dict(mirror_plane=CUT_PLANE),
          "voxel_mirror": dict(subsample_voxel=1, subsample_size=0.005,
                               mirror_plane=CUT_PLANE),
          "mirror_nopallas": dict(mirror_plane=CUT_PLANE, use_pallas=False)}
DYN = [("kernel", "voxel"), ("kernel", "mirror"), ("kernel", "voxel_mirror"),
       ("sequential", "voxel"), ("sequential", "mirror"),
       ("colored", "voxel"), ("colored", "mirror"),
       ("sequential", "mirror_nopallas")]
CNN = ["mirror", "voxel"]
DYN_FRAMES = (0, 12)
CNN_FRAMES = (5, 12)


def _config(cls, solver, cloud, cnn=False):
    return cls(point_budget=2048, cloud_rows_per_body=128,
               cnn_every_frame=cnn, solver=solver,
               **{"use_pallas": True, **CLOUDS[cloud]})


def _inputs(hand_model):
    """(bank, dyn depth (2, H, W), dyn poses, CNN depth, CNN poses)."""
    from hand_tracking_samples_tpu.assets_paths import DEFAULT_ANIMBANK
    from hand_tracking_samples_tpu.data.animbank import load_animbank
    bank = load_animbank(DEFAULT_ANIMBANK)
    dyn = cached_fake_depths(hand_model, np.asarray(bank[:30])[:, None],
                             "dyn30")[:, 0]
    dposes = np.stack([bank[0], bank[12]]).astype(np.float32)
    dposes[1, :, 0] += 0.002
    start = np.asarray(hand_model.start_pose, np.float32)
    cposes = np.stack([bank[CNN_FRAMES[0]], start]).astype(np.float32)
    return (bank, np.stack([dyn[f] for f in DYN_FRAMES]), dposes,
            np.stack([dyn[f] for f in CNN_FRAMES]), cposes)


def _cnnb():
    from hand_tracking_samples_tpu_torch.assets_paths import DEFAULT_CNNB
    return DEFAULT_CNNB


def jax_reference(hand_model):
    """The JAX package's frames on _inputs, cached: {"<solver>_<cloud>":
    poses (2, 17, 7)} for the dynamics frames, and for each CNN frame
    "cnn_<cloud>_<field>" with the fields olderror, mid_pose (after
    update_cnn_model) and final_pose (after the frame's dynamics pass)."""
    _, ddepth, dposes, cdepth, cposes = _inputs(hand_model)
    with open(_cnnb(), "rb") as f:
        wh = hashlib.sha1(f.read()).hexdigest()
    h = hashlib.sha1(ddepth.tobytes() + dposes.tobytes() + cdepth.tobytes()
                     + cposes.tobytes() + wh.encode()
                     + repr((CLOUDS, DYN, CNN)).encode()).hexdigest()[:12]
    path = os.path.join(FIXTURES, "cache", f"cloudframe_{h}.json")
    if os.path.exists(path):
        with open(path) as f:
            return {k: np.asarray(v, np.float32)
                    for k, v in json.load(f).items()}
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from hand_tracking_samples_tpu.cnn.model import load_cnnb
    from hand_tracking_samples_tpu.data.synth import synth_camera
    from hand_tracking_samples_tpu.fitting.cloud import fit_error
    from hand_tracking_samples_tpu.imaging.image_ops import (
        cloud_from_depth, mirror_plane_split)
    from hand_tracking_samples_tpu.parallel.tracks import (
        batched_tracker_state, batched_update)
    from hand_tracking_samples_tpu.tracker.config import TrackerConfig
    from hand_tracking_samples_tpu.tracker.runtime import (
        physics_params, update_cnn_model)
    cam = synth_camera()
    out = {}

    def state(poses):
        st = batched_tracker_state(hand_model, 2)
        return st._replace(body=st.body._replace(pose=jnp.asarray(poses)))
    with pltpu.force_tpu_interpret_mode():
        for solver, cloud in DYN:
            cfg = _config(TrackerConfig, solver, cloud)
            params = physics_params(cfg)
            new = jax.jit(lambda s, d: batched_update(
                s, hand_model, None, d, cam, cfg, params)[0])(
                state(dposes), jnp.asarray(ddepth))
            out[f"{solver}_{cloud}"] = np.asarray(new.body.pose)
        cnn = load_cnnb(_cnnb())
        for cloud in CNN:
            cfg = _config(TrackerConfig, "kernel", cloud, cnn=True)
            params = physics_params(cfg)
            st = state(cposes)
            d = jnp.asarray(cdepth)

            def olderr(body, dd):
                pts, mask = cloud_from_depth(dd, cam, 0.1, cfg.drangey,
                                             cfg.subsample_fraction,
                                             cfg.point_budget)
                if cfg.mirror_plane:
                    pts, mask = mirror_plane_split(
                        pts, mask, jnp.asarray(cfg.mirror_plane, jnp.float32))
                return fit_error(body, hand_model, pts, mask, dd, cam,
                                 cfg.bone_sum_error_scale, use_kernel=True)
            old = jax.jit(jax.vmap(olderr))(st.body, d)
            mid = jax.jit(jax.vmap(lambda s, dd: update_cnn_model(
                s, hand_model, cnn, dd, cam, cfg, params)[0]))(st, d)
            final = jax.jit(lambda s, dd: batched_update(
                s, hand_model, cnn, dd, cam, cfg, params,
                run_cnn=False))(mid, d)[0]
            out[f"cnn_{cloud}_olderror"] = np.asarray(old)
            out[f"cnn_{cloud}_mid_pose"] = np.asarray(mid.body.pose)
            out[f"cnn_{cloud}_final_pose"] = np.asarray(final.body.pose)
    with open(path, "w") as f:       # text: float32 values round-trip
        json.dump({k: v.tolist() for k, v in out.items()}, f)
    return out


VOXEL_CURVE_FRAMES = {"kernel": 30, "sequential": 10}


def jax_voxel_curve(hand_model):
    """The JAX package's dynamics frame with the voxel cloud on chip_smoke.py
    phase 4's renders, T=2: track 0 on the dyn30 renders from bank[0],
    track 1 on the port's fake_depth renders of bank[30:60] from bank[30];
    per solver ("kernel" 30 frames, "sequential" 10) the per-frame mean
    joint error of each track against the animbank in mm, cached as
    voxcurve_<hash>.json.  chip_smoke.py holds the card's voxel tracks to
    it."""
    from hand_tracking_samples_tpu.assets_paths import DEFAULT_ANIMBANK
    from hand_tracking_samples_tpu.data.animbank import load_animbank
    from hand_tracking_samples_tpu_torch.data.synth import (
        fake_depth, synth_camera)
    from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
    bank = load_animbank(DEFAULT_ANIMBANK)
    model = from_numpy_model({k: np.asarray(v) for k, v in
                              vars(hand_model).items()}, "cpu")
    fake = fake_depth(torch.tensor(bank[30:60]), model, synth_camera(),
                      chunk=8).numpy().view(np.uint16)
    dyn = cached_fake_depths(hand_model, np.asarray(bank[:30])[:, None],
                             "dyn30")[:, 0]
    depths = np.stack([dyn, fake], axis=1)                 # (30, 2, H, W)
    h = hashlib.sha1(depths.tobytes() + repr(
        (CLOUDS["voxel"], VOXEL_CURVE_FRAMES)).encode()).hexdigest()[:12]
    path = os.path.join(FIXTURES, "cache", f"voxcurve_{h}.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from hand_tracking_samples_tpu.data.synth import synth_camera as j_cam
    from hand_tracking_samples_tpu.parallel.tracks import (
        batched_tracker_state, batched_update)
    from hand_tracking_samples_tpu.tracker.config import TrackerConfig
    from hand_tracking_samples_tpu.tracker.runtime import physics_params
    out = {}
    for solver, frames in VOXEL_CURVE_FRAMES.items():
        cfg = _config(TrackerConfig, solver, "voxel")
        params = physics_params(cfg)
        st = batched_tracker_state(hand_model, 2)
        st = st._replace(body=st.body._replace(
            pose=jnp.asarray(bank[[0, 30]])))
        with pltpu.force_tpu_interpret_mode():
            step = jax.jit(lambda s, d: batched_update(
                s, hand_model, None, d, j_cam(), cfg, params)[0])
            curve = []
            for f in range(frames):
                st = step(st, jnp.asarray(depths[f]))
                want = bank[[f, 30 + f]][:, :, :3]
                curve.append((np.linalg.norm(
                    np.asarray(st.body.pose)[:, :, :3] - want,
                    axis=-1).mean(-1) * 1e3).tolist())
        out[solver] = curve                  # (frames, 2) mm
    with open(path, "w") as f:
        json.dump(out, f)
    return out


@pytest.fixture(scope="module")
def port(hand_model):
    from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
    return from_numpy_model({k: np.asarray(v) for k, v in
                             vars(hand_model).items()}, "cpu")


@pytest.fixture(scope="module")
def ref(hand_model):
    return jax_reference(hand_model)


def _close(mine, want):
    assert np.abs(mine[..., :3] - want[..., :3]).max() < 1e-5
    assert quat_err(mine[..., 3:].reshape(-1, 4),
                    want[..., 3:].reshape(-1, 4)) < 1e-4


@pytest.mark.parametrize("solver,cloud", DYN)
def test_dynamics_frame_matches_jax(hand_model, port, ref, solver, cloud):
    from hand_tracking_samples_tpu_torch.data.synth import synth_camera
    from hand_tracking_samples_tpu_torch.ops.cloud_kernel import (
        depth_tensor)
    from hand_tracking_samples_tpu_torch.parallel.tracks import (
        batched_tracker_state, batched_update)
    from hand_tracking_samples_tpu_torch.tracker.config import (
        TrackerConfig)
    _, depth, poses, _, _ = _inputs(hand_model)
    st = batched_tracker_state(port, 2)
    st = st._replace(body=st.body._replace(pose=torch.tensor(poses)))
    st, _ = batched_update(st, port, None, depth_tensor(depth, "cpu"),
                           synth_camera(),
                           _config(TrackerConfig, solver, cloud))
    _close(st.body.pose.numpy(), ref[f"{solver}_{cloud}"])


@pytest.mark.parametrize("cloud", CNN)
def test_cnn_frame_matches_jax(hand_model, port, ref, cloud, monkeypatch):
    from hand_tracking_samples_tpu_torch.cnn.model import load_cnnb
    from hand_tracking_samples_tpu_torch.data.synth import synth_camera
    from hand_tracking_samples_tpu_torch.fitting.cloud import fit_error
    from hand_tracking_samples_tpu_torch.ops import cloud_rows
    from hand_tracking_samples_tpu_torch.ops.cloud_kernel import (
        depth_tensor)
    from hand_tracking_samples_tpu_torch.parallel.tracks import (
        batched_tracker_state, batched_update)
    from hand_tracking_samples_tpu_torch.tracker.config import (
        TrackerConfig)
    from hand_tracking_samples_tpu_torch.tracker.runtime import (
        frame_cloud, physics_params, update_cnn_model)
    _, _, _, depth, poses = _inputs(hand_model)
    cfg = _config(TrackerConfig, "kernel", cloud, cnn=True)
    cam = synth_camera()
    cnn = load_cnnb(_cnnb(), "cpu")
    d = depth_tensor(depth, "cpu")
    st = batched_tracker_state(port, 2)
    st = st._replace(body=st.body._replace(pose=torch.tensor(poses)))
    # the CNN refit's cloud: the frame's cloud_from_depth, mirrored
    ph = frame_cloud(d, cam, dataclasses.replace(cfg, subsample_voxel=0))
    old = fit_error(st.body.pose, port, ph, d, cam,
                    cfg.bone_sum_error_scale).numpy()
    mid, _ = update_cnn_model(st, port, cnn, d, cam, cfg,
                              physics_params(cfg))
    calls = []
    plain = cloud_rows.cloud_rows_packed_plain
    monkeypatch.setattr(cloud_rows, "cloud_rows_packed_plain",
                        lambda *a: calls.append(1) or plain(*a))
    final, _ = batched_update(st, port, cnn, d, cam, cfg, run_cnn=True)
    assert len(calls) == 5               # 4 MultiStepSim steps + dynamics

    k = f"cnn_{cloud}_"
    np.testing.assert_allclose(old, ref[k + "olderror"], rtol=1e-6)
    assert (old > cfg.full_reset_on_error).tolist() == [False, True]
    assert ((ref[k + "olderror"] > cfg.full_reset_on_error).tolist()
            == [False, True])
    mine = mid.body.pose.numpy()
    take_j = (ref[k + "mid_pose"] != poses).any(axis=(1, 2))
    assert (mine != poses).any(axis=(1, 2)).tolist() == take_j.tolist()
    _close(mine, ref[k + "mid_pose"])
    _close(final.body.pose.numpy(), ref[k + "final_pose"])


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from hand_tracking_samples_tpu.model.bake import load_hand_model
    hm = jax.tree_util.tree_map(jnp.asarray, load_hand_model(
        MODEL_JSON, cache_dir=os.path.join(FIXTURES, "cache")))
    print({k: v.shape for k, v in jax_reference(hm).items()})
    curves = jax_voxel_curve(hm)
    # the port's plain path on the CPU on the same renders, against it
    from hand_tracking_samples_tpu.assets_paths import DEFAULT_ANIMBANK
    from hand_tracking_samples_tpu.data.animbank import load_animbank
    from hand_tracking_samples_tpu_torch.data.synth import (
        fake_depth, synth_camera)
    from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
    from hand_tracking_samples_tpu_torch.ops.cloud_kernel import (
        depth_tensor)
    from hand_tracking_samples_tpu_torch.parallel.tracks import (
        batched_tracker_state, batched_update)
    from hand_tracking_samples_tpu_torch.tracker.config import (
        TrackerConfig)
    bank = load_animbank(DEFAULT_ANIMBANK)
    model = from_numpy_model({k: np.asarray(v) for k, v in
                              vars(hm).items()}, "cpu")
    fake = fake_depth(torch.tensor(bank[30:60]), model, synth_camera(),
                      chunk=8)
    dyn = depth_tensor(cached_fake_depths(
        hm, np.asarray(bank[:30])[:, None], "dyn30")[:, 0], "cpu")
    for solver, curve in curves.items():
        cfg = _config(TrackerConfig, solver, "voxel")
        st = batched_tracker_state(model, 2)
        st = st._replace(body=st.body._replace(
            pose=torch.tensor(bank[[0, 30]])))
        gap = []
        for f in range(len(curve)):
            st, _ = batched_update(st, model, None,
                                   torch.stack([dyn[f], fake[f]]),
                                   synth_camera(), cfg)
            err = np.linalg.norm(st.body.pose[..., :3].numpy()
                                 - bank[[f, 30 + f]][:, :, :3],
                                 axis=-1).mean(-1) * 1e3
            gap.append(float(np.abs(err - np.asarray(curve[f])).max()))
        print(solver, "port CPU |gap| mm per frame",
              [round(g, 4) for g in gap], "max", max(gap))
