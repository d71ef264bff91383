"""The synthetic-track CLI and the small pieces it and the tracker's users
call, in the port against the JAX package:

  the CLI        `apps.synthetic_track --tracks 2 --frames 2
                 --dynamics-only` on the CPU (colored solver, use_pallas
                 off, as the JAX CLI runs off the TPU): its per-frame mean
                 joint errors within 0.01 mm of the JAX CLI's lines;
  scale_tracker  the scaled model's arrays within 1e-7 relative, the
                 segmentation diameter equal;
  the pose API   generic_update, fix_orientations,
                 set_bone_pose_hierarchy_w, drive_pose_rows and
                 drive_base_pose_rows on two tracks (animbank poses with a
                 finger bent out of its joint range, so the repairs act):
                 1e-6 m or rad (a drive row's target spin as the angle of
                 one step), every track against JAX's one-track call;
  the meshes     load_display_meshes (model_hand.json, vanity_bones.json),
                 smooth_normals, pose_mesh and export_obj byte for byte;
                 skin_dualquat to 1e-6.

The JAX side is cached as JSON text in tests/fixtures/cache/
(synthtrack_*.json; the meshes and the OBJ as SHA-1 digests of their
bytes); `python -m tests.test_torch_synthetic_track` writes it."""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from tests.conftest import FIXTURES, MODEL_JSON, quat_err

# the port tests run small tensors: one intra-op thread each, so the
# suite's parallel workers do not oversubscribe the cores
torch.set_num_threads(1)

CLI_ARGS = ["--tracks", "2", "--frames", "2", "--dynamics-only"]
POSE_FRAMES = (100, 700)
SCALE = 1.1
BONE, BONE_Q = 6, (0.3, 0.1, -0.2, 0.93)   # set_bone_pose_hierarchy_w


def _poses():
    """Two animbank poses, the second with bone 9 turned 1.2 rad about x
    (past its joint range)."""
    from hand_tracking_samples_tpu.assets_paths import DEFAULT_ANIMBANK
    from hand_tracking_samples_tpu.data.animbank import load_animbank
    bank = load_animbank(DEFAULT_ANIMBANK)
    p = np.asarray(bank[list(POSE_FRAMES)], np.float32).copy()
    h = np.float32(0.6)
    turn = np.array([np.sin(h), 0, 0, np.cos(h)], np.float32)
    x, y, z, w = turn
    q = p[1, 9, 3:7]
    p[1, 9, 3:7] = [w * q[0] + x * q[3] + y * q[2] - z * q[1],
                    w * q[1] - x * q[2] + y * q[3] + z * q[0],
                    w * q[2] + x * q[1] - y * q[0] + z * q[3],
                    w * q[3] - x * q[0] - y * q[1] - z * q[2]]
    return p


def _skin_inputs():
    rng = np.random.default_rng(3)
    V, K = 40, 3
    verts = rng.standard_normal((V, 3)).astype(np.float32) * 0.05
    w = rng.random((V, K)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    ids = rng.integers(0, 17, (V, K))
    return verts, w, ids


def _sha(*arrays):
    h = hashlib.sha1()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _mesh_digests(meshes_mod, paths, poses_user, tmp):
    out = {}
    for name, path in paths.items():
        ms = meshes_mod.load_display_meshes(path)
        out[f"mesh_{name}"] = _sha(*[x for v, t in ms for x in (v, t)])
        out[f"normals_{name}"] = _sha(*[meshes_mod.smooth_normals(v, t)
                                        for v, t in ms])
        f = os.path.join(tmp, f"{name}.obj")
        meshes_mod.export_obj(f, ms[:len(poses_user)], poses_user)
        with open(f, "rb") as fh:
            out[f"obj_{name}"] = hashlib.sha1(fh.read()).hexdigest()
    return out


def _mesh_paths():
    assets = os.path.dirname(MODEL_JSON)       # the repo's assets/
    return {"model": os.path.join(assets, "model_hand.json"),
            "vanity": os.path.join(assets, "vanity_bones.json")}


def jax_reference(hand_model):
    """The JAX package's pieces and CLI lines, cached."""
    poses = _poses()
    with open(MODEL_JSON, "rb") as f:
        mh = hashlib.sha1(f.read()).hexdigest()
    h = hashlib.sha1(poses.tobytes() + mh.encode() + repr(CLI_ARGS).encode()
                     + b"synthtrack 2").hexdigest()[:12]
    path = os.path.join(FIXTURES, "cache", f"synthtrack_{h}.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    import contextlib
    import io
    import tempfile
    import jax
    import jax.numpy as jnp
    from hand_tracking_samples_tpu.apps import synthetic_track
    from hand_tracking_samples_tpu.model import hand, meshes
    from hand_tracking_samples_tpu.physics.solver import (BodyState,
                                                          PhysicsParams)
    from hand_tracking_samples_tpu.tracker.config import TrackerConfig
    from hand_tracking_samples_tpu.tracker.runtime import scale_tracker
    out = {}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        synthetic_track.main(CLI_ARGS)
    out["cli"] = buf.getvalue().splitlines()
    sm, cfg = scale_tracker(hand_model, TrackerConfig(), SCALE)
    out["scale_segment"] = cfg.segment_scale
    out["scale"] = {k: np.asarray(v).tolist() for k, v in vars(sm).items()}
    params = PhysicsParams()
    z = jnp.zeros((17, 3))
    rec = {k: [] for k in ("generic_update", "fix_orientations",
                           "set_bone_pose_hierarchy_w", "drive_pose_rows",
                           "drive_base_pose_rows")}
    target = jnp.asarray(poses[::-1].copy())
    for t in range(2):
        st = BodyState(jnp.asarray(poses[t]), z, z)
        rec["generic_update"].append(
            hand.generic_update(st, hand_model, params).pose)
        rec["fix_orientations"].append(
            hand.fix_orientations(st, hand_model, params).pose)
        rec["set_bone_pose_hierarchy_w"].append(
            hand.set_bone_pose_hierarchy_w(st, hand_model, params, BONE,
                                           np.asarray(BONE_Q, np.float32)
                                           ).pose)
        for name, rows in (
                ("drive_pose_rows", hand.drive_pose_rows(
                    st, hand_model, target[t], params)),
                ("drive_base_pose_rows", hand.drive_base_pose_rows(
                    st, hand_model, params))):
            rec[name].append(np.concatenate(
                [rows.axis, rows.targetspin[:, None],
                 rows.mintorque[:, None], rows.maxtorque[:, None]], -1))
    out.update({k: np.stack([np.asarray(x) for x in v]).tolist()
                for k, v in rec.items()})
    user = np.asarray(hand.get_pose_user(
        BodyState(jnp.asarray(poses[0]), z, z), hand_model))
    out["user"] = user.tolist()
    with tempfile.TemporaryDirectory() as tmp:
        out.update(_mesh_digests(meshes, _mesh_paths(), user, tmp))
    out["skin"] = np.asarray(meshes.skin_dualquat(
        *_skin_inputs(), jnp.asarray(poses[0]))).tolist()
    with open(path, "w") as f:
        json.dump(out, f)
    return out


@pytest.fixture(scope="module")
def port(hand_model):
    from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
    return from_numpy_model({k: np.asarray(v) for k, v in
                             vars(hand_model).items()}, "cpu")


def _frame_errors(lines):
    return [float(x.split("err")[1].split()[0]) for x in lines
            if x.startswith("frame")]


def test_synthetic_track_cli_matches_jax(hand_model, capsys):
    """The port CLI on the CPU prints the JAX CLI's frame lines: each
    frame's mean joint error within 0.01 mm."""
    from hand_tracking_samples_tpu_torch.apps import synthetic_track
    ref = jax_reference(hand_model)["cli"]
    assert synthetic_track.main(CLI_ARGS + ["--device", "cpu"]) is not None
    mine = capsys.readouterr().out.splitlines()
    want, got = _frame_errors(ref), _frame_errors(mine)
    assert len(want) == 2 and len(got) == 2
    assert np.abs(np.asarray(got) - np.asarray(want)).max() <= 0.01, (
        got, want)
    assert any(x.startswith("mean joint error") for x in mine)


def _rows(rows):
    return torch.cat([rows.axis, rows.targetspin[..., None],
                      rows.mintorque[..., None],
                      rows.maxtorque[..., None]], -1).numpy()


@pytest.mark.parametrize("piece", [
    "scale_tracker", "generic_update", "fix_orientations",
    "set_bone_pose_hierarchy_w", "drive_pose_rows", "drive_base_pose_rows",
    "meshes", "skin_dualquat"])
def test_pieces_match_jax(hand_model, port, piece, tmp_path):
    from hand_tracking_samples_tpu_torch.model import hand, meshes
    from hand_tracking_samples_tpu_torch.physics.solver import (
        BodyState, PhysicsParams)
    ref = jax_reference(hand_model)
    poses = _poses()
    z = torch.zeros(2, 17, 3)
    st = BodyState(torch.tensor(poses), z, z)
    params = PhysicsParams()
    if piece == "scale_tracker":
        from hand_tracking_samples_tpu_torch.tracker.config import (
            TrackerConfig)
        from hand_tracking_samples_tpu_torch.tracker.runtime import (
            scale_tracker)
        sm, cfg = scale_tracker(port, TrackerConfig(), SCALE)
        assert cfg.segment_scale == ref["scale_segment"]
        for k, v in ref["scale"].items():
            mine = sm.np[k].astype(np.float64)
            want = np.asarray(v, np.float64)
            np.testing.assert_allclose(mine, want, rtol=1e-7, atol=0,
                                       err_msg=k)
        return
    if piece == "meshes":
        # the OBJ of JAX's user poses of track 0 (the port's
        # get_pose_user is held to JAX by tolerance, not bit for bit)
        user = np.asarray(ref["user"], np.float32)
        assert np.abs(hand.get_pose_user(st, port)[0].numpy()
                      - user).max() < 1e-6
        got = _mesh_digests(meshes, _mesh_paths(), user, str(tmp_path))
        for k, v in got.items():
            assert v == ref[k], k
        return
    if piece == "skin_dualquat":
        got = meshes.skin_dualquat(*_skin_inputs(), poses[0])
        assert np.abs(got - np.asarray(ref["skin"])).max() < 1e-6
        return
    want = np.asarray(ref[piece], np.float32)
    if piece.startswith("drive"):
        rows = (hand.drive_pose_rows(st, port, torch.tensor(poses[::-1]
                                                            .copy()), params)
                if piece == "drive_pose_rows"
                else hand.drive_base_pose_rows(st, port, params))
        got = _rows(rows)
        assert np.abs(got[..., :3] - want[..., :3]).max() < 1e-6
        # the target spins (rad/s) as the angle of one step: 1e-6 rad
        assert np.abs(got[..., 3:] - want[..., 3:]).max() \
            * params.deltaT < 1e-6
        return
    if piece == "set_bone_pose_hierarchy_w":
        out = hand.set_bone_pose_hierarchy_w(st, port, params, BONE,
                                             np.asarray(BONE_Q, np.float32))
    else:
        out = getattr(hand, piece)(st, port, params)
    mine = out.pose.numpy()
    assert np.abs(mine[..., :3] - want[..., :3]).max() < 1e-6
    assert quat_err(mine[..., 3:].reshape(-1, 4),
                    want[..., 3:].reshape(-1, 4)) < 1e-6
    if piece == "fix_orientations":      # the bent finger was repaired
        assert np.abs(mine[1, 9, 3:] - poses[1, 9, 3:]).max() > 1e-3


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from hand_tracking_samples_tpu.model.bake import load_hand_model
    hm = jax.tree_util.tree_map(jnp.asarray, load_hand_model(
        MODEL_JSON, cache_dir=os.path.join(FIXTURES, "cache")))
    print(sorted(jax_reference(hm)))
