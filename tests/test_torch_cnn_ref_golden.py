"""The port's CNN frame on the sequential solver (use_pallas=False: the JAX
package's default tracker) against the C++ reference's trajectory with the
same trained net (assets/handposedd_synth.cnnb) on the same synthetic
frames: golden.json's synctrack_atc (always_take_cnn, the animbank replayed
at stride 2, one track from the model's start pose, so the first frame
resets).  The first 3 frames at T=1, each within
tests/test_tracker_e2e.py:148's bound: the mean joint deviation from the
golden < 3 mm.  The renders are the cached dyn30 ones (bank frames 0, 2,
4); nothing of the JAX package runs."""
import os

import numpy as np
import torch

from tests.conftest import cached_fake_depths

# the port tests run small tensors: one intra-op thread each, so the
# suite's parallel workers do not oversubscribe the cores
torch.set_num_threads(1)

FRAMES = 3
NET = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "handposedd_synth.cnnb")


def test_sequential_cnn_frames_match_cpp_golden(golden, hand_model):
    from hand_tracking_samples_tpu.assets_paths import DEFAULT_ANIMBANK
    from hand_tracking_samples_tpu.data.animbank import load_animbank
    from hand_tracking_samples_tpu_torch.cnn.model import load_cnnb
    from hand_tracking_samples_tpu_torch.data.synth import synth_camera
    from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
    from hand_tracking_samples_tpu_torch.ops.cloud_kernel import (
        depth_tensor)
    from hand_tracking_samples_tpu_torch.parallel.tracks import (
        batched_tracker_state, batched_update)
    from hand_tracking_samples_tpu_torch.tracker.config import TrackerConfig
    assert os.path.exists(NET), NET
    bank = load_animbank(DEFAULT_ANIMBANK)
    dyn = cached_fake_depths(hand_model, np.asarray(bank[:30])[:, None],
                             "dyn30")[:, 0]
    model = from_numpy_model({k: np.asarray(v) for k, v in
                              vars(hand_model).items()}, "cpu")
    cnn = load_cnnb(NET, "cpu")
    cfg = TrackerConfig(point_budget=2048, always_take_cnn=True)
    assert (cfg.solver, cfg.use_pallas, cfg.cnn_every_frame) == (
        "sequential", False, True)
    ref = np.array(golden["synctrack_atc_poses"],
                   np.float32).reshape(12, 17, 7)
    st = batched_tracker_state(model, 1)
    for f in range(FRAMES):
        st, _ = batched_update(st, model, cnn,
                               depth_tensor(dyn[f * 2][None], "cpu"),
                               synth_camera(), cfg)
        dev = np.linalg.norm(st.body.pose[0, :, :3].numpy()
                             - ref[f, :, :3], axis=1)
        assert dev.mean() < 3e-3, (f, dev.mean())
