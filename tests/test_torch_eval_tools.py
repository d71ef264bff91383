"""The port's accuracy tools against the JAX package's tools, on the CPU at
a small size: each tool's per-frame mean joint errors within 0.01 mm of
the JAX tool's protocol run with the same arguments by the JAX package's
own functions (the tools' loops, cut to these frames; the CNN-frame cases
with JAX's unbatched frame, one track at a time, ONE_TRACK):

  eval_fastdrift        --tracks 2, the protocol's first 2 frames, the
                        kernel solver with use_pallas (cap 128, budget 2048)
  eval_coldstart        EVAL_TRACKS=2 EVAL_FRAMES=2, the CNN frame on the
                        kernel solver from the rest pose
  eval_accum_threshold  the first 2 frames of cnntrack_rec2 at k = 4, T=1,
                        the colored solver, each threshold of the grid
  eval_cap_recorded     the same 2 frames, kernel cap 128 and 256 with
                        use_pallas, colored cap 512 without
  dyn_colored_ctrl      the dyntrack protocol's first 3 frames, colored,
                        the plane dots

and check_pgs_kernel's OK line.  The cold start and the cap tool's cap
256 and 512 are held to SENSITIVE_MM instead (see there).  The JAX side is cached as JSON in
tests/fixtures/cache/ (evaltools_*.json, one file a tool); `python -m
tests.test_torch_eval_tools [tool ...]` writes it (JAX's kernel solver runs
in Pallas interpret mode, minutes a case)."""
import hashlib
import json
import os
import sys

import numpy as np
import torch

from tests.conftest import FIXTURES, MODEL_JSON

# the port tests run small tensors: one intra-op thread each, so the
# suite's parallel workers do not oversubscribe the cores
torch.set_num_threads(1)

GATE_MM = 0.01
# Three CNN-frame cases lie past GATE_MM because the reference amplifies
# differences far below the slices' 1e-5 m: cnntrack_rec2's first CNN
# frame at cap 256 (kernel) and 512 (colored) from the rest pose, where
# JAX's own dynamics pass fed the port's post-CNN pose (8.3e-7 m from
# JAX's) moves 2.0e-4 m and reproduces the port's error (18.1307 mm
# against JAX's 18.1504 mm; measured gap 0.057 mm on frame 1), and the
# cold start at T=2, where the port's net sums its batch of two in
# another order than one track (the batch changes the conv's sum
# order), which the reset amplifies to 0.033 mm by frame 1 (one track at
# a time the port lies 3e-7 m and 1e-4 mm from JAX).  Held to SENSITIVE_MM.
SENSITIVE = ("coldstart", "kernel 256", "colored 512")
SENSITIVE_MM = 0.1
CASES = {
    "fastdrift": dict(tracks=2, frames=2),
    "coldstart": dict(tracks=2, frames=2),
    "accum": dict(frames=2, k=4),
    "cap": dict(frames=2),
    "ctrl": dict(frames=3),
}
THRESHOLDS = [0.0, 0.005, 0.02, 0.05, 0.1]
# the CNN-frame cases run JAX's unbatched frame one track at a time: its
# vmapped frame lies up to 2e-4 m from it there (kernel cap 256 and colored
# cap 512 on cnntrack_rec2's first CNN frame; ROADMAP, "Behaviours of the
# reference"), and the port follows the unbatched frame
ONE_TRACK = ("coldstart", "accum", "cap")
CAPS = (("kernel", 128, 1), ("kernel", 256, 1), ("colored", 512, 0))


def _cache_path(tool):
    with open(MODEL_JSON, "rb") as f:
        h = hashlib.sha1(f.read())
    key = (tool, CASES[tool], THRESHOLDS, CAPS)
    if tool in ONE_TRACK:
        key += ("unbatched",)
    h.update(repr(key).encode())
    return os.path.join(FIXTURES, "cache",
                        f"evaltools_{tool}_{h.hexdigest()[:12]}.json")


# ---- the JAX side: the JAX tools' loops with the JAX package ------------
def _jax_setup(cnn=False):
    import jax.numpy as jnp
    import jax.tree_util as jtu
    from hand_tracking_samples_tpu.assets_paths import (DEFAULT_ANIMBANK,
                                                        DEFAULT_CNNB)
    from hand_tracking_samples_tpu.cnn.model import load_cnnb
    from hand_tracking_samples_tpu.data.animbank import load_animbank
    from hand_tracking_samples_tpu.data.synth import synth_camera
    from hand_tracking_samples_tpu.model.bake import load_hand_model
    model = jtu.tree_map(jnp.asarray, load_hand_model(
        MODEL_JSON, cache_dir=os.path.join(FIXTURES, "cache")))
    return (model, load_animbank(DEFAULT_ANIMBANK), synth_camera(),
            load_cnnb(DEFAULT_CNNB) if cnn else None)


def _jax_err(pose, gt):
    return np.linalg.norm(np.asarray(pose)[..., :3]
                          - np.asarray(gt)[..., :3], axis=-1).mean(-1)


def _jax_track(model, cnn, cam, depths, config, states, run_cnn=None):
    """Per-frame body poses of batched_update over depths (F, T, H, W)."""
    import jax
    from hand_tracking_samples_tpu.parallel.tracks import batched_update
    from hand_tracking_samples_tpu.tracker.runtime import physics_params
    params = physics_params(config)
    steps = {c: jax.jit(lambda s, d, c=c: batched_update(
        s, model, cnn, d, cam, config, params, run_cnn=c)[0])
        for c in {run_cnn(f) if run_cnn else None
                  for f in range(len(depths))}}
    out = []
    for f, d in enumerate(depths):
        states = steps[run_cnn(f) if run_cnn else None](states, d)
        out.append(np.asarray(states.body.pose))
    return np.stack(out)


def _jax_one_track(model, cnn, cam, depths, config, state, run_cnn):
    """Per-frame body poses (F, 17, 7) of JAX's unbatched frame
    (tracker.runtime.update, no vmap) on one track: depths (F, H, W)."""
    import jax
    from hand_tracking_samples_tpu.tracker import runtime as rt
    params = rt.physics_params(config)
    steps = {c: jax.jit(lambda s, d, c=c: rt.update(
        s, model, cnn, d, cam, config, params, run_cnn=c)[0])
        for c in {run_cnn(f) for f in range(len(depths))}}
    out = []
    for f, d in enumerate(depths):
        state = steps[run_cnn(f)](state, d)
        out.append(np.asarray(state.body.pose))
    return np.stack(out)


def _jax_state(model):
    from hand_tracking_samples_tpu.tracker.runtime import make_tracker_state
    return make_tracker_state(model)


def _jax_render(model, cam, poses):
    import jax
    import jax.numpy as jnp
    from hand_tracking_samples_tpu.data.synth import fake_depth
    r = jax.jit(jax.vmap(lambda p: fake_depth(p, model, cam)))
    return jnp.stack([r(jnp.asarray(p)) for p in poses])


def _jax_fastdrift():
    import jax.numpy as jnp
    from hand_tracking_samples_tpu.parallel.tracks import (
        batched_tracker_state)
    from hand_tracking_samples_tpu.tracker.config import TrackerConfig
    model, bank, cam, _ = _jax_setup()
    with open(os.path.join(FIXTURES, "fastdrift_ref.json")) as f:
        n = json.load(f)["n_frames"]
    T, F = CASES["fastdrift"]["tracks"], CASES["fastdrift"]["frames"]
    starts = (np.arange(T) * 37) % (len(bank) - n)
    poses = bank[starts[None, :] + np.arange(F)[:, None]]
    config = TrackerConfig(point_budget=2048, cnn_every_frame=False,
                           solver="kernel", cloud_rows_per_body=128,
                           use_pallas=True)
    st = batched_tracker_state(model, T)
    st = st._replace(body=st.body._replace(pose=jnp.asarray(poses[0])))
    out = _jax_track(model, None, cam, _jax_render(model, cam, poses),
                     config, st)
    return {"err": _jax_err(out, poses).tolist()}


def _jax_coldstart():
    import jax.numpy as jnp
    from hand_tracking_samples_tpu.tracker.config import TrackerConfig
    model, bank, cam, cnn = _jax_setup(cnn=True)
    T, F = CASES["coldstart"]["tracks"], CASES["coldstart"]["frames"]
    starts = (np.arange(T) * 211) % (len(bank) - F)
    poses = bank[starts[None, :] + np.arange(F)[:, None]]
    config = TrackerConfig(point_budget=2048, cnn_every_frame=True,
                           solver="kernel", use_pallas=True,
                           accum_error_threshold=0.0,
                           cloud_rows_per_body=128)
    depths = _jax_render(model, cam, poses)
    st = _jax_state(model)
    st = st._replace(initializing=jnp.int32(50))
    out = np.stack([_jax_one_track(model, cnn, cam, depths[:, t], config,
                                   st, lambda f: True) for t in range(T)],
                   1)
    return {"err": _jax_err(out, poses).tolist()}


def _jax_recording(config, k, F):
    import jax.numpy as jnp
    from hand_tracking_samples_tpu.data.dataset import load_dataset
    model, _, _, cnn = _jax_setup(cnn=True)
    ds = load_dataset(os.path.join(FIXTURES, "cnntrack_rec2"))
    out = _jax_one_track(model, cnn, ds.info.camera(),
                         jnp.asarray(ds.depth[:F]), config,
                         _jax_state(model), lambda f: f % k == 0)
    return _jax_err(out, ds.pose[:F]).tolist()


def _jax_accum():
    from hand_tracking_samples_tpu.tracker.config import TrackerConfig
    k, F = CASES["accum"]["k"], CASES["accum"]["frames"]
    return {str(t): _jax_recording(TrackerConfig(
        cnn_every_frame=True, cnn_every_k=k, solver="colored",
        accum_error_threshold=t), k, F) for t in THRESHOLDS}


def _jax_cap():
    from hand_tracking_samples_tpu.tracker.config import TrackerConfig
    with open(os.path.join(FIXTURES, "cnntrack_ref2_k4.json")) as f:
        k = json.load(f)["k"]
    F = CASES["cap"]["frames"]
    return {f"{s} {c}": _jax_recording(TrackerConfig(
        cnn_every_frame=True, cnn_every_k=k, solver=s,
        cloud_rows_per_body=c, use_pallas=bool(p)), k, F)
        for s, c, p in CAPS}


def _jax_ctrl():
    import jax.numpy as jnp
    from hand_tracking_samples_tpu.parallel.tracks import (
        batched_tracker_state)
    from hand_tracking_samples_tpu.tracker.config import TrackerConfig
    model, bank, cam, _ = _jax_setup()
    with open(os.path.join(FIXTURES, "golden.json")) as f:
        refp = np.asarray(json.load(f)["dyntrack_poses"],
                          np.float32).reshape(-1, 17, 7)
    F = CASES["ctrl"]["frames"]
    config = TrackerConfig(solver="colored", use_pallas=False,
                           cnn_every_frame=False)
    st = batched_tracker_state(model, 1)
    st = st._replace(body=st.body._replace(pose=jnp.asarray(bank[0])[None]))
    out = _jax_track(model, None, cam,
                     _jax_render(model, cam, bank[:F, None]), config, st)
    return {"devs": _jax_err(out[:, 0], refp[:F]).tolist()}


JAX = {"fastdrift": _jax_fastdrift, "coldstart": _jax_coldstart,
       "accum": _jax_accum, "cap": _jax_cap, "ctrl": _jax_ctrl}


def jax_reference(tool):
    path = _cache_path(tool)
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    out = JAX[tool]()
    with open(path, "w") as f:
        json.dump(out, f)
    return out


# ---- the port's tools -------------------------------------------------------
def _close(got_m, want_m, label, gate=GATE_MM):
    got, want = np.asarray(got_m) * 1e3, np.asarray(want_m) * 1e3
    assert got.shape == want.shape, (label, got.shape, want.shape)
    gap = np.abs(got - want).max()
    assert gap <= gate, f"{label}: {gap:.4f} mm ({got} vs {want})"


def test_fastdrift_matches_jax(tmp_path):
    from hand_tracking_samples_tpu_torch.tools import eval_fastdrift
    ref = jax_reference("fastdrift")
    c = CASES["fastdrift"]
    err = eval_fastdrift.main(["--tracks", str(c["tracks"]), "--frames",
                               str(c["frames"]), "--device", "cpu",
                               "--json", str(tmp_path / "fd.json")])
    _close(err.mean(1), np.asarray(ref["err"]).mean(1), "fast drift")
    _close(err, ref["err"], "fast drift, per track")
    with open(tmp_path / "fd.json") as f:
        out = json.load(f)
    assert len(out["mean_err_per_frame_mm"]) == c["frames"]


def test_coldstart_matches_jax(monkeypatch, tmp_path):
    from hand_tracking_samples_tpu_torch.tools import eval_coldstart
    ref = jax_reference("coldstart")
    c = CASES["coldstart"]
    monkeypatch.setenv("EVAL_TRACKS", str(c["tracks"]))
    monkeypatch.setenv("EVAL_FRAMES", str(c["frames"]))
    monkeypatch.setenv("EVAL_DUMP", "cold.npz")
    errs = eval_coldstart.main(["--device", "cpu", "--out",
                                str(tmp_path)])
    _close(errs.mean(1), np.asarray(ref["err"]).mean(1), "cold start",
           SENSITIVE_MM)
    z = np.load(tmp_path / "cold.npz")
    assert z["errs"].shape == (c["frames"], c["tracks"])


def test_accum_threshold_matches_jax(monkeypatch, tmp_path):
    from hand_tracking_samples_tpu_torch.tools import eval_accum_threshold
    ref = jax_reference("accum")
    monkeypatch.setenv("EVAL_FRAMES", str(CASES["accum"]["frames"]))
    curves = eval_accum_threshold.main(["--device", "cpu", "--out",
                                        str(tmp_path)])
    for t in THRESHOLDS:
        _close(curves[t], ref[str(t)], f"threshold {t}")
    with open(tmp_path / "accum_threshold_r04.json") as f:
        assert len(json.load(f)["grid"]) == len(THRESHOLDS)


def test_cap_recorded_matches_jax(monkeypatch):
    from hand_tracking_samples_tpu_torch.tools import eval_cap_recorded
    ref = jax_reference("cap")
    monkeypatch.setenv("EVAL_FRAMES", str(CASES["cap"]["frames"]))
    out = eval_cap_recorded.main(["--device", "cpu"])
    for s, c, _ in CAPS:
        _close(out[(s, c)], ref[f"{s} {c}"], f"{s} cap {c}",
               SENSITIVE_MM if f"{s} {c}" in SENSITIVE else GATE_MM)


def test_dyn_colored_ctrl_matches_jax(monkeypatch, capsys):
    from hand_tracking_samples_tpu_torch.tools import dyn_colored_ctrl
    ref = jax_reference("ctrl")
    monkeypatch.setenv("EVAL_FRAMES", str(CASES["ctrl"]["frames"]))
    devs = dyn_colored_ctrl.main(["--device", "cpu"])
    _close(devs, ref["devs"], "colored control")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == [round(d * 1000, 3) for d in devs]


def test_check_pgs_kernel_ok(capsys):
    """The solver equivalence check on the CPU: colored against kernel
    within its 2e-4."""
    from hand_tracking_samples_tpu_torch.tools import check_pgs_kernel
    outs = check_pgs_kernel.main(["--device", "cpu"])
    assert capsys.readouterr().out.strip().splitlines()[-1] == "OK"
    assert np.abs(outs["colored"] - outs["kernel"]).max() < 2e-4


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    for tool in sys.argv[1:] or list(JAX):
        path = _cache_path(tool)
        if os.path.exists(path):
            os.remove(path)
        jax_reference(tool)
        print("wrote", path, flush=True)
