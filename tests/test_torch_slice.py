"""The whole dynamics-only kernel-solver slice of the port, on its plain
versions (CPU): the bench configuration tracked over the 30-frame dyn30
renders against the C++ reference's dyntrack golden, with the JAX suite's
band (test_bench_parity.py:53).  test_torch_slice_jax.py holds the same
slice against the JAX package's batched_update."""
import numpy as np
import torch

from hand_tracking_samples_tpu.assets_paths import DEFAULT_ANIMBANK
from hand_tracking_samples_tpu.data.animbank import load_animbank
from hand_tracking_samples_tpu_torch.data.synth import synth_camera
from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
from hand_tracking_samples_tpu_torch.ops.cloud_kernel import depth_tensor
from hand_tracking_samples_tpu_torch.parallel.tracks import (
    batched_tracker_state, batched_update)
from hand_tracking_samples_tpu_torch.tracker.config import TrackerConfig
from tests.conftest import cached_fake_depths

# the port tests run small tensors: one intra-op thread each, so the
# suite's parallel workers do not oversubscribe the cores
torch.set_num_threads(1)


def _config(cls, budget=2048, cap=128):
    return cls(point_budget=budget, cnn_every_frame=False,
               cloud_rows_per_body=cap, solver="kernel", use_pallas=True)


def _model(hand_model):
    return from_numpy_model({k: np.asarray(v) for k, v in
                             vars(hand_model).items()}, "cpu")


def test_slice_dyntrack_golden(golden, hand_model):
    """T=2 tracks, the 30 dyn30 frames: per frame < 1.2 mm mean joint
    deviation from the golden poses, <= 1.0 mm over the run, and the joint
    error within the JAX suite's 1.25x band of the golden's."""
    bank = load_animbank(DEFAULT_ANIMBANK)
    ref = np.array(golden["dyntrack_poses"],
                   np.float32).reshape(-1, 17, 7)[:30]
    depths = cached_fake_depths(hand_model, np.asarray(bank[:30])[:, None],
                                "dyn30")
    model = _model(hand_model)
    T = 2
    st = batched_tracker_state(model, T)
    st = st._replace(body=st.body._replace(
        pose=torch.tensor(np.stack([bank[0]] * T))))
    seqs = depth_tensor(np.repeat(depths, T, axis=1), "cpu")  # (30, T, H, W)
    devs = []
    for f in range(30):
        st, _ = batched_update(st, model, None, seqs[f], synth_camera(),
                               _config(TrackerConfig))
        mine = st.body.pose.numpy()
        dev = np.linalg.norm(mine[:, :, :3] - ref[f, :, :3], axis=-1).mean(-1)
        assert (dev < 1.2e-3).all(), (f, dev)
        je = np.linalg.norm(mine[:, :, :3] - bank[f][:, :3], axis=-1).mean(-1)
        assert (je < 1.25 * golden["dyntrack_joint_err"][f] + 5e-4).all(), f
        np.testing.assert_array_equal(mine[0], mine[1])  # tracks independent
        devs.append(dev.max())
    assert np.mean(devs) <= 1.0e-3
