"""Kernel 8's plain version (ops/correspondence.py, the CPU path of the
correspondence kernel) and its world planes against the JAX package's
`hull_reductions` and `world_planes`, the Pallas kernel run in interpret
mode as tests/test_colored_solver.py:76 runs it, jitted as the tracker
runs it.  T=2 tracks at the start pose and at animbank poses, N = 512 and
1024 points around the palm, the ray origin at the camera and off it.

Tolerance: bit-identical (every output of every (track, body, point)); the
port computes the plane dot as the JAX CPU build contracts its K=8 dot,
fma(z, pz, fma(y, py, x*px)) + w, and the world planes' rotation and offset
contracted as well (maths/fma.py)."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from hand_tracking_samples_tpu.assets_paths import DEFAULT_ANIMBANK
from hand_tracking_samples_tpu.data.animbank import load_animbank
from hand_tracking_samples_tpu.ops import correspondence as jc
from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
from hand_tracking_samples_tpu_torch.ops import correspondence as pc

# the port tests run small tensors: one intra-op thread each, so the
# suite's parallel workers do not oversubscribe the cores
torch.set_num_threads(1)

CASES = [(512, "start", 100, (0.0, 0.0, 0.0)),
         (1024, 400, "start", (0.01, -0.02, 0.03))]


@pytest.mark.parametrize("N,a,b,origin", CASES)
def test_hull_reductions_match_jax(hand_model, N, a, b, origin):
    bank = load_animbank(DEFAULT_ANIMBANK)
    start = np.asarray(hand_model.start_pose, np.float32)
    poses = np.stack([start if k == "start" else bank[k] for k in (a, b)])
    rng = np.random.RandomState(N)
    pts = np.stack([rng.uniform(-0.1, 0.1, (N, 3)).astype(np.float32)
                    + p[1, :3] for p in poses])
    o = np.asarray(origin, np.float32)
    with pltpu.force_tpu_interpret_mode():
        pw, ref = jax.jit(jax.vmap(lambda p, x: (
            jc.world_planes(p, hand_model),
            jc.hull_reductions(p, hand_model, x, jnp.asarray(o)))))(
            jnp.asarray(poses), jnp.asarray(pts))
    model = from_numpy_model({k: np.asarray(v) for k, v in
                              vars(hand_model).items()}, "cpu")
    tp = torch.tensor(poses)
    mine_pw = pc.world_planes(tp, model)
    np.testing.assert_array_equal(mine_pw.numpy(), np.asarray(pw))
    mine = pc.hull_reductions(tp, model, torch.tensor(pts), torch.tensor(o))
    names = ("hull_val", "pidx", "t_enter", "t_exit", "miss")
    for name, m, r in zip(names, mine, ref):
        assert m.shape == (2, 17, N), name
        np.testing.assert_array_equal(m.numpy(), np.asarray(r),
                                      err_msg=name)
    # the cases exercise both clip outcomes
    hit = (mine[4] == 0) & (mine[2] <= mine[3])
    assert 0 < int(hit.sum()) < hit.numel()


def test_block_size_is_enforced(hand_model):
    model = from_numpy_model({k: np.asarray(v) for k, v in
                              vars(hand_model).items()}, "cpu")
    pose = torch.tensor(np.asarray(hand_model.start_pose))[None]
    with pytest.raises(ValueError, match="multiple of 512"):
        pc.hull_reductions(pose, model, torch.zeros((1, 500, 3)),
                           (0.0, 0.0, 0.0))


def test_block_size_check_survives_optimize():
    """The wrapper's check is a ValueError, not an assert: `python -O`
    keeps it."""
    import subprocess
    import sys
    code = ("import torch\n"
            "from hand_tracking_samples_tpu_torch.ops import correspondence"
            " as pc\n"
            "try:\n"
            "    pc.correspondence_reductions(torch.zeros((1, 4, 500)),"
            " torch.zeros((1, 17, 96, 4)), torch.zeros((1, 17, 96)))\n"
            "except ValueError as e:\n"
            "    print('raised', e)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-O", "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-1000:]
    assert res.stdout.startswith("raised point budget 500"), res.stdout
