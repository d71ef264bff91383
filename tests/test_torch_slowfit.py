"""slowfit, the annotation-grade fit (handtrack.h:786-821), in the port
against the JAX package on the same inputs, T=2 tracks at full width:

  track 0, 1  the cached dyn30 renders of animbank frames 5 and 20, each
              started from the animbank pose of the frame before (a
              one-frame-old annotation, what the fixer refines); the cloud
              as the annotate CLI builds it (every 4th pixel of 0.1-0.6 m,
              compacted to 2048 points).

Settings: use_pallas False (the plane dots), use_pallas True (the
correspondence kernel; JAX in interpret mode), and use_pallas False with
seeded CNN landmark rays (crays), hold=2 toward the start pose and a nail
dragging bone 16 12 mm along x (as tests/test_annotate_edits.py does).
The JAX side runs one track at a time (as its annotate CLI does) and its
pose after each of the 6 solves is cached as JSON text in
tests/fixtures/cache/ (slowfit_*.json, keyed by a hash of the inputs);
`python -m tests.test_torch_slowfit` writes it.

Held: the two packages' clouds are the same bits; the poses agree to
1e-5 m and quat_err 1e-4 after every step; the rows of every solve fit the
row sweep's limits.  Also held: relative_angular_rows (the hold rows) and
the nail with a per-track world anchor against JAX's factories, every field
within 1e-6."""
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

FRAMES = (5, 20)
STEPS = 6
NAIL_BONE, NAIL_DX = 16, 0.012
SETTINGS = ["plain", "pallas", "extras"]


def _qrot(q, v):
    qv, w = q[:3], q[3]
    t = 2 * np.cross(qv, v)
    return v + w * t + np.cross(qv, t)


def _inputs(hand_model):
    """(depths (2, H, W) u16, start poses (2, 17, 7), crays (2, 8, 4),
    nail targets (2, 3)): the rays point from the world origin (the
    synthetic camera's centre) at the render's own landmarks, 3 mm of
    seeded noise added."""
    from hand_tracking_samples_tpu.assets_paths import DEFAULT_ANIMBANK
    from hand_tracking_samples_tpu.data.animbank import load_animbank
    from hand_tracking_samples_tpu_torch.model.bake import (FEATURE_BONES,
                                                           FEATURE_OFFSETS)
    bank = load_animbank(DEFAULT_ANIMBANK)
    dyn = cached_fake_depths(hand_model, np.asarray(bank[:30])[:, None],
                             "dyn30")[:, 0]
    depth = np.stack([dyn[f] for f in FRAMES]).astype(np.uint16)
    start = np.stack([bank[f - 1] for f in FRAMES]).astype(np.float32)
    rng = np.random.RandomState(3)
    crays = []
    for f in FRAMES:
        feat = np.stack([bank[f][b, :3] + _qrot(bank[f][b, 3:], o)
                         for b, o in zip(FEATURE_BONES, FEATURE_OFFSETS)])
        d = feat + rng.randn(8, 3) * 0.003
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        crays.append(np.concatenate([d, rng.rand(8, 1)], -1))
    spoint = start[:, NAIL_BONE, :3] + np.float32([NAIL_DX, 0, 0])
    return (depth, start, np.asarray(crays, np.float32),
            spoint.astype(np.float32))


def _cloud_hash(points, mask):
    return hashlib.sha1(np.ascontiguousarray(points, np.float32).tobytes()
                        + np.ascontiguousarray(mask, bool).tobytes()
                        ).hexdigest()


def jax_reference(hand_model):
    """The JAX package's slowfit on _inputs for each setting, one track at
    a time, cached: {setting: {"steps": (2, 6, 17, 7)}, "cloud": [hash of
    each track's cloud]}."""
    depth, start, crays, spoint = _inputs(hand_model)
    h = hashlib.sha1(depth.tobytes() + start.tobytes() + crays.tobytes()
                     + spoint.tobytes() + repr((SETTINGS, STEPS)).encode()
                     ).hexdigest()[:12]
    path = os.path.join(FIXTURES, "cache", f"slowfit_{h}.json")
    if os.path.exists(path):
        with open(path) as f:
            js = json.load(f)
        return {k: (v if k == "cloud" else
                    {"steps": np.asarray(v["steps"], np.float32)})
                for k, v in js.items()}
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from hand_tracking_samples_tpu.data.synth import synth_camera
    from hand_tracking_samples_tpu.imaging.image_ops import (compact_points,
                                                             point_cloud)
    import hand_tracking_samples_tpu.tracker.runtime as jrt
    from hand_tracking_samples_tpu.tracker.config import TrackerConfig
    cam = synth_camera()

    def points_of(d):                  # JAX apps/annotate.py points_of
        pts_all, mask_all = point_cloud(d, cam, 0.1, 0.6)
        sub = mask_all & ((jnp.cumsum(mask_all) - 1) % 4 == 0)
        return compact_points(pts_all, sub, 2048)
    clouds = [jax.jit(points_of)(jnp.asarray(d)) for d in depth]
    out = {"cloud": [_cloud_hash(np.asarray(p), np.asarray(m))
                     for p, m in clouds]}
    stash, real = [], jrt.fit_point_cloud

    def spy(*a, **k):                  # every solve's pose, as an output
        res = real(*a, **k)
        stash.append(res.pose)
        return res
    jrt.fit_point_cloud = spy
    try:
        for s in SETTINGS:
            cfg = TrackerConfig(point_budget=2048, solver="sequential",
                                use_pallas=s == "pallas")
            params = jrt.physics_params(cfg)

            def run(st, p, m, ref, cr, sp, cfg=cfg, params=params, s=s):
                stash.clear()
                kw = {}
                if s == "extras":
                    kw = dict(hold=2, refpose=ref, crays=cr,
                              select_bone=NAIL_BONE, spoint=sp,
                              rbpoint=jnp.zeros(3, jnp.float32))
                jrt.slowfit(st, hand_model, p, m, cfg, params, steps=STEPS,
                            **kw)
                return tuple(stash)
            f = jax.jit(run)
            steps = []
            for i in range(len(FRAMES)):        # one track at a time
                st = jrt.make_tracker_state(hand_model)
                st = st._replace(body=st.body._replace(
                    pose=jnp.asarray(start[i])))
                with pltpu.force_tpu_interpret_mode():
                    res = f(st, *clouds[i], jnp.asarray(start[i]),
                            jnp.asarray(crays[i]), jnp.asarray(spoint[i]))
                steps.append(np.stack([np.asarray(x) for x in res]))
            out[s] = {"steps": np.stack(steps)}
    finally:
        jrt.fit_point_cloud = real
    with open(path, "w") as f:       # text: float32 values round-trip
        json.dump({k: (v if k == "cloud" else
                       {"steps": v["steps"].tolist()})
                   for k, v in out.items()}, f)
    return out


@pytest.fixture(scope="module")
def port(hand_model):
    from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
    return from_numpy_model({k: np.asarray(v) for k, v in
                             vars(hand_model).items()}, "cpu")


def _port_slowfit(hand_model, model, setting, monkeypatch):
    """The port's slowfit on _inputs at T=2: (its cloud hashes, the pose
    after every solve (6, 2, 17, 7), the rows (linear, angular) of every
    solve's sweep)."""
    from hand_tracking_samples_tpu_torch.apps.annotate import points_of
    from hand_tracking_samples_tpu_torch.data.synth import synth_camera
    from hand_tracking_samples_tpu_torch.ops.cloud_kernel import (
        depth_tensor)
    from hand_tracking_samples_tpu_torch.parallel.tracks import (
        batched_tracker_state)
    from hand_tracking_samples_tpu_torch.physics import row_sweep
    from hand_tracking_samples_tpu_torch.tracker import runtime
    from hand_tracking_samples_tpu_torch.tracker.config import TrackerConfig
    depth, start, crays, spoint = _inputs(hand_model)
    pts, mask = points_of(depth_tensor(depth, "cpu"), synth_camera())
    cfg = TrackerConfig(point_budget=2048, solver="sequential",
                        use_pallas=setting == "pallas")
    poses, rows = [], []

    def rows_spy(body, *a, _real=runtime.slowfit_rows, **k):
        poses.append(body.pose.clone())   # the pose the solve before left
        return _real(body, *a, **k)

    def sweep_spy(mom0, massinv, r, *a, _real=row_sweep.row_sweep_waves):
        rows.append((r.lf.shape[1], r.af.shape[1]))
        return _real(mom0, massinv, r, *a)
    monkeypatch.setattr(runtime, "slowfit_rows", rows_spy)
    monkeypatch.setattr(row_sweep, "row_sweep_waves", sweep_spy)
    st = batched_tracker_state(model, 2)
    st = st._replace(body=st.body._replace(pose=torch.tensor(start)))
    kw = {}
    if setting == "extras":
        kw = dict(hold=2, refpose=torch.tensor(start),
                  crays=torch.tensor(crays), select_bone=NAIL_BONE,
                  spoint=torch.tensor(spoint), rbpoint=torch.zeros(2, 3))
    out = runtime.slowfit(st, model, pts, mask, cfg,
                          runtime.physics_params(cfg), steps=STEPS, **kw)
    assert torch.equal(poses[0], st.body.pose)
    poses = poses[1:] + [out.body.pose]
    clouds = [_cloud_hash(p.numpy(), m.numpy()) for p, m in zip(pts, mask)]
    return clouds, torch.stack(poses).numpy(), rows


@pytest.mark.parametrize("setting", SETTINGS)
def test_slowfit_matches_jax(hand_model, port, setting, monkeypatch):
    """After each of the 6 solves the port's poses are JAX's to 1e-5 m
    and quat_err 1e-4; the clouds are the same bits; every solve's rows
    fit the row sweep (MAX_LIN linear rows, MAX_ROWS in all) and the last
    solve has no cloud rows; the nail lands within 4 mm of its target."""
    from hand_tracking_samples_tpu_torch.physics.row_sweep import (MAX_LIN,
                                                                   MAX_ROWS)
    ref = jax_reference(hand_model)
    clouds, mine, rows = _port_slowfit(hand_model, port, setting,
                                       monkeypatch)
    assert clouds == ref["cloud"]
    want = ref[setting]["steps"]                   # (2, 6, 17, 7)
    assert mine.shape == (STEPS, 2, 17, 7)
    for s in range(STEPS):
        a, b = mine[s], want[:, s]
        assert np.abs(a[..., :3] - b[..., :3]).max() < 1e-5, s
        assert quat_err(a[..., 3:].reshape(-1, 4),
                        b[..., 3:].reshape(-1, 4)) < 1e-4, s
    assert len(rows) == STEPS
    assert all(lin <= MAX_LIN and lin + ang <= MAX_ROWS for lin, ang in rows)
    # the sweep holds the active rows: the last solve has no cloud rows
    # (the clouds hold 1,776 and 1,837 points)
    assert rows[-1][0] < 100 and rows[0][0] > 1700, rows
    if setting == "extras":
        _, _, _, spoint = _inputs(hand_model)
        d = np.linalg.norm(mine[-1][:, NAIL_BONE, :3] - spoint, axis=-1)
        assert (d < 0.004).all(), d


def _jax_body(pose):
    import jax.numpy as jnp
    from hand_tracking_samples_tpu.physics.solver import BodyState
    z = jnp.zeros((pose.shape[0], 3), jnp.float32)
    return BodyState(jnp.asarray(pose), z, z)


def _fields(rows):
    return {k: np.asarray(getattr(rows, k), np.float64)
            for k in rows._fields}


@pytest.mark.parametrize("joint", [0, 3, 4, 9, 15])
def test_relative_angular_rows_match_jax(hand_model, joint):
    """relative_angular_rows (physmodel.h:410-432) on seeded animbank pose
    pairs (half of them a near-identity relative rotation, as slowfit's
    hold rows see them): every field within 1e-6 of JAX's."""
    import jax
    from hand_tracking_samples_tpu.assets_paths import DEFAULT_ANIMBANK
    from hand_tracking_samples_tpu.data.animbank import load_animbank
    from hand_tracking_samples_tpu.physics.constraints import (
        relative_angular_rows as jrows)
    from hand_tracking_samples_tpu.tracker.config import TrackerConfig
    from hand_tracking_samples_tpu.tracker.runtime import physics_params
    from hand_tracking_samples_tpu_torch.physics.constraints import (
        relative_angular_rows)
    from hand_tracking_samples_tpu_torch.physics.solver import PhysicsParams
    bank = load_animbank(DEFAULT_ANIMBANK)
    rng = np.random.RandomState(joint)
    T = 8
    pose = bank[rng.randint(0, len(bank), T)].astype(np.float32)
    ref = bank[rng.randint(0, len(bank), T)].astype(np.float32)
    ref[:4] = pose[:4]
    ref[:4, :, 3:] += (rng.randn(4, 17, 4) * 1e-3).astype(np.float32)
    b0 = int(np.asarray(hand_model.joint_rbi0)[joint])
    b1 = int(np.asarray(hand_model.joint_rbi1)[joint])
    jp = physics_params(TrackerConfig())
    f = jax.jit(lambda p, r: jrows(_jax_body(p), r, b0, b1, jp))
    want = [_fields(f(pose[t], ref[t])) for t in range(T)]
    got = _fields(relative_angular_rows(torch.tensor(pose),
                                        torch.tensor(ref), b0, b1,
                                        PhysicsParams()))
    for k, v in got.items():
        w = np.stack([x[k] for x in want])
        assert v.shape == w.shape, k
        assert np.abs(v - w).max() <= 1e-6 * max(1.0, np.abs(w).max()), k


@pytest.mark.parametrize("bone", [0, 7, 16])
def test_world_nail_matches_jax(hand_model, bone):
    """The nail with a per-track world anchor (b0 = -1, spoint (T, 3))
    and a per-track local point on the dragged bone: every field within
    1e-6 of JAX's constrain_position_nailed, track by track."""
    import jax
    import jax.numpy as jnp
    from hand_tracking_samples_tpu.assets_paths import DEFAULT_ANIMBANK
    from hand_tracking_samples_tpu.data.animbank import load_animbank
    from hand_tracking_samples_tpu.physics.constraints import (
        constrain_position_nailed as jnail)
    from hand_tracking_samples_tpu_torch.physics.constraints import (
        constrain_position_nailed)
    bank = load_animbank(DEFAULT_ANIMBANK)
    rng = np.random.RandomState(bone)
    T = 4
    pose = bank[rng.randint(0, len(bank), T)].astype(np.float32)
    sp = (pose[:, bone, :3] + rng.randn(T, 3) * 0.01).astype(np.float32)
    rb = (rng.randn(T, 3) * 0.005).astype(np.float32)
    f = jax.jit(lambda p, s, r: jnail(_jax_body(p), jnp.int32(-1), s,
                                      jnp.int32(bone), r))
    want = [_fields(f(pose[t], sp[t], rb[t])) for t in range(T)]
    got = _fields(constrain_position_nailed(
        torch.tensor(pose), [-1], torch.tensor(sp)[:, None], [bone],
        torch.tensor(rb)[:, None]))
    for k, v in got.items():
        w = np.stack([x[k] for x in want])
        assert v.shape == w.shape, k
        assert np.abs(v - w).max() <= 1e-6 * max(1.0, np.abs(w).max()), k


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from hand_tracking_samples_tpu.model.bake import load_hand_model
    hm = jax.tree_util.tree_map(jnp.asarray, load_hand_model(
        MODEL_JSON, cache_dir=os.path.join(FIXTURES, "cache")))
    print({k: (v if k == "cloud" else v["steps"].shape)
           for k, v in jax_reference(hm).items()})
