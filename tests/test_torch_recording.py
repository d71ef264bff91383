"""The port's recording entry points on the CPU: the replay of the committed
recording against the C++ reference's track of it (golden.json's
replay_dyntrack_poses, as tests/test_replay_parity.py holds the JAX
package), the annotate CLI on tests/test_annotate_edits.py's edits and
recording with its assertions, and the replay CLI's .pose output read back
by the port's loader."""
import json
import os
import shutil

import numpy as np
import torch

from tests.conftest import FIXTURES

# the port tests run small tensors: one intra-op thread each, so the
# suite's parallel workers do not oversubscribe the cores
torch.set_num_threads(1)

REC = os.path.join(FIXTURES, "replay_rec")


def test_replay_recording_parity(golden):
    """The port's dynamics-only update (TrackerConfig(point_budget=2048):
    the sequential solver, the plane dots) on the port-loaded replay_rec
    from its first recorded pose: every frame's mean joint deviation from
    the C++ reference's track under 1.0 mm."""
    from hand_tracking_samples_tpu_torch.data.dataset import load_dataset
    from hand_tracking_samples_tpu_torch.model.bake import (
        bake_hand_model, from_numpy_model)
    from hand_tracking_samples_tpu_torch.assets_paths import (
        DEFAULT_MODEL_JSON)
    from hand_tracking_samples_tpu_torch.ops.cloud_kernel import (
        depth_tensor)
    from hand_tracking_samples_tpu_torch.parallel.tracks import (
        batched_tracker_state)
    from hand_tracking_samples_tpu_torch.tracker.config import TrackerConfig
    from hand_tracking_samples_tpu_torch.tracker.runtime import (
        physics_params, update)
    ds = load_dataset(REC)
    cam = ds.info.camera()
    n = int(golden["replay_n_frames"][0])
    assert n == len(ds.depth) == 6
    ref = np.array(golden["replay_dyntrack_poses"], np.float32).reshape(
        n, 17, 7)
    model = from_numpy_model(bake_hand_model(DEFAULT_MODEL_JSON), "cpu")
    config = TrackerConfig(point_budget=2048, cnn_every_frame=False)
    params = physics_params(config)
    state = batched_tracker_state(model, 1)
    state = state._replace(body=state.body._replace(
        pose=torch.tensor(ds.pose[0])[None]))
    devs = []
    for f in range(n):
        state, _, _ = update(state, model, depth_tensor(ds.depth[f][None],
                                                        "cpu"),
                             cam, config, params)
        mine = state.body.pose[0].numpy()
        devs.append(np.linalg.norm(mine[:, :3] - ref[f, :, :3],
                                   axis=1).mean())
    assert max(devs) < 1.0e-3, [f"{d * 1e3:.3f} mm" for d in devs]


def test_annotate_edit_refit_rerender_cycle(tmp_path):
    """tests/test_annotate_edits.py's round trip through the port's
    annotate CLI (--device cpu): frame 0 deleted, frame 1's bone 16 nailed
    12 mm off its annotation, frame 2 held; the nailed bone within 4 mm of
    its target and nearer to it than to the old label; the overlays, the
    bone origins and the editor page written."""
    from hand_tracking_samples_tpu_torch.apps.annotate import main
    from hand_tracking_samples_tpu_torch.data.dataset import load_dataset
    ds = load_dataset(REC)
    target = (ds.pose[1, 16, :3] + np.array([0.012, 0, 0],
                                            np.float32)).tolist()
    edits = {"edits": [{"frame": 1, "bone": 16, "nail": target},
                       {"frame": 2, "hold": 2},
                       {"frame": 0, "delete": True}]}
    epath = tmp_path / "edits.json"
    epath.write_text(json.dumps(edits))
    out = str(tmp_path / "rec_fixed")
    art = str(tmp_path / "artifacts")
    main([REC + ".rs", "--edits", str(epath), "--out", out,
          "--dump-artifacts", art, "--max-frames", "4", "--device", "cpu"])

    fixed = load_dataset(out)
    assert fixed.depth.shape[0] == 3          # frame 0 deleted
    np.testing.assert_array_equal(fixed.depth[0], ds.depth[1])
    d_target = np.linalg.norm(fixed.pose[0, 16, :3] - np.array(target))
    d_orig = np.linalg.norm(fixed.pose[0, 16, :3] - ds.pose[1, 16, :3])
    assert d_target < 0.004, f"nailed bone {d_target*1000:.1f}mm off target"
    assert d_target < d_orig

    names = os.listdir(art)
    assert "fit_0001.png" in names and "bones_0001.json" in names
    page = open(os.path.join(art, "index.html")).read()
    assert "editview(" in page and "annotation editor" in page
    assert "download edits.json" in page
    bones = json.load(open(os.path.join(art, "bones_0001.json")))
    assert np.asarray(bones["bones"]).shape == (17, 3)
    assert np.linalg.norm(np.asarray(bones["bones"][16]) -
                          np.array(target)) < 0.004


def test_replay_cli_writes_pose_file(tmp_path, capsys):
    """The replay CLI (--dynamics-only --max-frames 2 --device cpu, the
    colored solver) writes a .pose file that the port's loader reads back
    beside the recording's own depth and header: 2 tracked frames within
    3 mm of the recorded poses, the rest zero."""
    from hand_tracking_samples_tpu_torch.apps.replay_track import main
    from hand_tracking_samples_tpu_torch.data.dataset import load_dataset
    out = str(tmp_path / "tracked")
    main([REC + ".rs", "--dynamics-only", "--max-frames", "2", "--device",
          "cpu", "--out", out])
    assert "wrote " + out + ".pose" in capsys.readouterr().out
    for ext in (".json", ".rs"):
        shutil.copy(REC + ext, out + ext)
    ds, back = load_dataset(REC), load_dataset(out)
    assert back.pose.shape == ds.pose.shape
    dev = np.linalg.norm(back.pose[:2, :, :3] - ds.pose[:2, :, :3],
                         axis=-1).mean(-1)
    assert (dev < 3e-3).all(), dev
    assert np.abs(np.linalg.norm(back.pose[:2, :, 3:], axis=-1)
                  - 1).max() < 1e-4
    assert not back.pose[2:].any()
