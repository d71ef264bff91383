"""The row sweep kernel's wavefront (physics.row_sweep.wave_schedule) is
exact: sweeping each track's rows in its level order gives the same
momenta, bit for bit, as sweeping them in row order.  Both runs go through
the unchanged plain version (row_sweep_plain), one track at a time, on

  * seeded synthetic rows (row_sweep.synthetic_rows): 17 bodies with ~27%
    of the rows on one body (as the dyn30 palm has), friction masters
    before and after their rows, inactive rows, world-only rows and
    -FLT_MAX angular targets;
  * the sequential and colored rows of tests/test_torch_solver.py's fits
    (the golden's solve2 cloud and pose, and its contact pose with the
    cloud moved onto the palm, contacts on);

and the levels and the order within a level of small hand-made cases are
asserted.  row_sweep_waves, the plain version the CPU runs (a level's rows
at once, all tracks together), gives row_sweep_plain's momenta bit for bit
on the same rows, signed zeros included."""
import numpy as np
import pytest
import torch

from hand_tracking_samples_tpu.assets_paths import DEFAULT_ANIMBANK
from hand_tracking_samples_tpu.data.animbank import load_animbank
from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
from hand_tracking_samples_tpu_torch.model.hand import body_params, fit_rows
from hand_tracking_samples_tpu_torch.physics import colored as pc
from hand_tracking_samples_tpu_torch.physics import solver as ps
from hand_tracking_samples_tpu_torch.physics.row_sweep import (
    NLF, SweepRows, row_sweep_plain, row_sweep_waves, synthetic_rows,
    wave_schedule)
from hand_tracking_samples_tpu_torch.physics.schedule import (
    build_hand_schedule)

torch.set_num_threads(1)
ITERS, POST = 3, 1        # sweeps: the order within a sweep is what counts


def _permuted(rows: SweepRows, ws, t):
    """Track t's rows in the schedule's order (the linear meta words with
    their master positions remapped)."""
    lf = rows.lf[t, ws.lin_perm[t]].clone()
    lf[:, NLF] = ws.lm[t].view(torch.float32)
    return SweepRows(lf[None], rows.af[t, ws.ang_perm[t]][None])


def _assert_waves_exact(mom0, massinv, rows: SweepRows):
    T = mom0.shape[0]
    ws = wave_schedule(rows.lm, rows.am)
    ref = row_sweep_plain(mom0, massinv, rows, ITERS, POST)
    for t in range(T):
        wave = row_sweep_plain(mom0[t:t + 1], massinv, _permuted(rows, ws, t),
                               ITERS, POST)
        assert torch.equal(wave[0], ref[t]), t
    waves = row_sweep_waves(mom0, massinv, rows, ITERS, POST)
    assert torch.equal(waves.view(torch.int32), ref.view(torch.int32))
    return ws


@pytest.mark.parametrize("seed", [0, 1])
def test_waves_exact_on_synthetic_rows(seed):
    mom0, massinv, rows = synthetic_rows(T=3, Rl=260, Ra=40, B=17,
                                         seed=seed)
    ws = _assert_waves_exact(mom0, massinv, rows)
    act = (rows.lm >> 16) & 1 == 1
    n_lev = ws.lin_level.amax(1)
    # the chain is shorter than the rows, and no shorter than the busiest
    # body's active rows
    assert (n_lev < act.sum(1)).all()
    assert ((ws.lin_level > 0) == act).all()


def test_wave_levels_small_case():
    """Rows on bodies (b0, b1), body -1 the world: levels by hand."""
    pairs = [(-1, 0), (-1, 0), (-1, 1), (0, 1), (-1, 2), (2, 3), (-1, 3),
             (-1, 0), (-1, -1)]
    act = [1, 1, 1, 1, 1, 1, 1, 0, 1]
    master = [-1, -1, -1, 2, -1, -1, 8, -1, -1]
    meta = [(b0 + 1) | ((b1 + 1) << 8) | (a << 16) | ((m + 1) << 17)
            for (b0, b1), a, m in zip(pairs, act, master)]
    lm = torch.tensor([meta], dtype=torch.int32)
    ws = wave_schedule(lm, torch.zeros((1, 0), dtype=torch.int32))
    # row 3 follows rows 1 and 2 (its bodies, and its master 2); row 6 reads
    # a later master (8), which is placed above it; row 7 is inactive
    assert ws.lin_level[0].tolist() == [1, 2, 1, 3, 1, 2, 3, 0, 4]
    assert ws.lin_perm[0].tolist() == [0, 2, 4, 1, 5, 3, 6, 8, 7]
    # masters remapped to the new order: row 3 (now 5) reads row 2 (now
    # 1), row 6 (now 6) reads row 8 (now 7)
    mp = ((ws.lm[0] >> 17) - 1).tolist()
    assert mp == [-1, -1, -1, -1, -1, 1, 7, -1, -1]


@pytest.mark.parametrize("pairs, perm", [
    ([(-1, 2), (-1, 0), (-1, 1)], [1, 2, 0]),   # single-body: body order
    ([(-1, 2), (0, 1), (-1, 3)], [0, 1, 2]),    # mixed: row order
])
def test_wave_order_within_a_level(pairs, perm):
    """The kernel runs a single-body level's rows on their bodies' lanes,
    in body order; any other level's rows in row order."""
    meta = [(b0 + 1) | ((b1 + 1) << 8) | (1 << 16) for b0, b1 in pairs]
    ws = wave_schedule(torch.tensor([meta], dtype=torch.int32),
                       torch.zeros((1, 0), dtype=torch.int32))
    assert ws.lin_level[0].tolist() == [1] * len(pairs)
    assert ws.lin_perm[0].tolist() == perm


@pytest.fixture(scope="module")
def fit_rows_both(golden, hand_model):
    """(sequential, colored) sweep inputs of tests/test_torch_solver.py's
    fits on two tracks: the solve2 cloud at solve2_pose_in, and at the
    contact pose with the cloud moved onto the palm and small momenta."""
    model = from_numpy_model({k: np.asarray(v) for k, v in
                              vars(hand_model).items()}, "cpu")
    pose = load_animbank(DEFAULT_ANIMBANK)[int(golden["contact_frame"][0])]
    p2 = np.array(golden["solve2_pose_in"], np.float32)
    pts = np.array(golden["solve2_points"], np.float32)
    pts2 = pts + (pose[1, :3] - p2[1, :3])
    rng = np.random.RandomState(0)
    lm = np.stack([np.zeros((17, 3)), rng.randn(17, 3) * 1e-3])
    am = np.stack([np.zeros((17, 3)), rng.randn(17, 3) * 1e-4])
    st = ps.BodyState(torch.tensor(np.stack([p2, pose])),
                      torch.tensor(lm.astype(np.float32)),
                      torch.tensor(am.astype(np.float32)))
    pts = torch.tensor(np.stack([pts, pts2]))
    mask = torch.ones(pts.shape[:2], dtype=torch.bool)
    params = ps.PhysicsParams()
    bp = body_params(model)
    lin, ang = fit_rows(st, model, params, pts, mask, contacts=True)
    seq = ps.sweep_inputs(st, bp, lin, ang, params)
    blocks, ablocks = fit_rows(st, model, params, pts, mask, contacts=True,
                               schedule=build_hand_schedule(model.np),
                               cloud_slots=512)
    col = pc.colored_sweep_inputs(st, bp, blocks, ablocks, params)
    return bp.massinv, seq, col


@pytest.mark.parametrize("order", ["sequential", "colored"])
def test_waves_exact_on_solver_rows(fit_rows_both, order):
    massinv, seq, col = fit_rows_both
    mom0, rows = seq if order == "sequential" else col
    assert int(((rows.lm >> 17) > 0).sum()) > 0      # friction rows in
    ws = _assert_waves_exact(mom0, massinv, rows)
    assert (ws.lin_level.amax(1) < ((rows.lm >> 16) & 1).sum(1)).all()
