"""The port's dynamics-only kernel-solver slice (plain versions, CPU)
against the JAX package's batched_update with the kernel solver (its Pallas
kernels in interpret mode) on the same renders, at the slice's full width
(point budget 2048, 128 cloud rows per body), T=2 tracks, 3 frames:

  track 0  the dyn30 renders of bank[0:3], started 3 mm off bank[0];
  track 1  the port's fake_depth renders of bank[37:40] (what the odd
           tracks of chip_smoke.py see), started at bank[37]: the fast
           motion into bank frame 38, where the tracker loses the hand for
           a while (the odd tracks meet it at their frame 8).

Tolerance 1e-5 m and quat_err 1e-4, the JAX suite's bound between its
kernel and colored solvers (test_pgs_kernel.py:47): the two packages' row
factories and solve prep agree to float32 rounding, not bit for bit (the
JAX CPU build contracts FMAs), and the 20-sweep solve carries that rounding
into the poses."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hand_tracking_samples_tpu.assets_paths import DEFAULT_ANIMBANK
from hand_tracking_samples_tpu.data.animbank import load_animbank
from hand_tracking_samples_tpu.data.synth import synth_camera as j_cam
from hand_tracking_samples_tpu.parallel.tracks import (
    batched_tracker_state as j_state, batched_update as j_update)
from hand_tracking_samples_tpu.tracker.config import TrackerConfig as JConfig
from hand_tracking_samples_tpu.tracker.runtime import (
    physics_params as j_params)
from hand_tracking_samples_tpu_torch.data.synth import (fake_depth,
                                                        synth_camera)
from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
from hand_tracking_samples_tpu_torch.ops.cloud_kernel import depth_tensor
from hand_tracking_samples_tpu_torch.parallel.tracks import (
    batched_tracker_state, batched_update)
from hand_tracking_samples_tpu_torch.tracker.config import TrackerConfig
from tests.conftest import cached_fake_depths, quat_err

# the port tests run small tensors: one intra-op thread each, so the
# suite's parallel workers do not oversubscribe the cores
torch.set_num_threads(1)

FRAMES = 3
FAST = 37          # track 1 starts at this bank frame


def _config(cls):
    return cls(point_budget=2048, cnn_every_frame=False,
               cloud_rows_per_body=128, solver="kernel", use_pallas=True)


@pytest.fixture(scope="module")
def runs(hand_model):
    """(bank, start poses, per-frame JAX poses, per-frame port poses),
    poses (F, T=2, 17, 7)."""
    bank = load_animbank(DEFAULT_ANIMBANK)
    dyn = cached_fake_depths(hand_model, np.asarray(bank[:30])[:, None],
                             "dyn30")[:FRAMES, 0]
    model = from_numpy_model({k: np.asarray(v) for k, v in
                              vars(hand_model).items()}, "cpu")
    fast = fake_depth(torch.tensor(bank[FAST:FAST + FRAMES]), model,
                      synth_camera()).numpy().view(np.uint16)
    seq = np.stack([dyn, fast], axis=1)                      # (F, T, H, W)
    poses = np.stack([bank[0], bank[FAST]])
    poses[0, :, 0] += 0.003

    jcfg = _config(JConfig)
    params = j_params(jcfg)
    js = j_state(hand_model, 2)
    js = js._replace(body=js.body._replace(pose=jnp.asarray(poses)))
    step = jax.jit(lambda s, d: j_update(s, hand_model, None, d, j_cam(),
                                         jcfg, params)[0])
    ref = []
    for f in range(FRAMES):
        js = step(js, jnp.asarray(seq[f]))
        ref.append(np.asarray(js.body.pose))

    st = batched_tracker_state(model, 2)
    st = st._replace(body=st.body._replace(pose=torch.tensor(poses)))
    cfg, mine = _config(TrackerConfig), []
    for f in range(FRAMES):
        st, _ = batched_update(st, model, None, depth_tensor(seq[f], "cpu"),
                               synth_camera(), cfg)
        mine.append(st.body.pose.numpy())
    return bank, poses, np.stack(ref), np.stack(mine)


def test_slice_matches_jax_kernel_solver(runs):
    """Both tracks, every frame: the port's poses equal the JAX package's
    to 1e-5 m and quat_err 1e-4 (measured: 2.4e-7 m, 5.6e-6)."""
    _, poses, ref, mine = runs
    assert mine.shape == (FRAMES, 2, 17, 7)
    assert np.abs(mine[..., :3] - ref[..., :3]).max() < 1e-5
    assert quat_err(mine[..., 3:].reshape(-1, 4),
                    ref[..., 3:].reshape(-1, 4)) < 1e-4
    assert np.abs(mine[-1, ..., :3] - poses[..., :3]).max() > 1e-3  # moved


def test_fast_motion_is_the_trackers_own(runs):
    """Track 1 through bank frame 38: the JAX package itself loses the hand
    there (mean joint error against the animbank above 30 mm; measured
    47.888 mm), and the port shows the same error to 0.01 mm (measured
    3e-5 mm).  So the odd
    tracks' large error in chip_smoke.py is the tracker's behaviour on that
    motion, not a fault of the port."""
    bank, _, ref, mine = runs

    def joint_err_mm(p):
        return np.linalg.norm(p[:, 1, :, :3] - bank[FAST:FAST + FRAMES, :, :3],
                              axis=-1).mean(-1) * 1e3
    je_ref, je_mine = joint_err_mm(ref), joint_err_mm(mine)
    assert je_ref[0] < 4.0                                # before the motion
    assert je_ref[1] > 30.0                               # bank frame 38
    assert np.abs(je_mine - je_ref).max() < 0.01, (je_mine, je_ref)
