"""The pack kernels' slot map (ops/cloud_rows.pack_slot_map), the plain
statement of how the redesigned kernels 2 and 2.5 fill their slots: the
winner scan gives each point its body and whether the hull won, the ranks
come from per-segment counts and their prefix, each kept point writes
(point << 1 | hull) into its body's slot, and the row pass then computes
every slot's channels from that table alone.  On

  * the cached dyn30 renders 3 and 12 at N=2048 (the dynamics pass's
    cloud, on which one body wins more than 128 points and is thinned),
  * MultiStepSim's cloud of the same renders (N=512, the camera off the
    origin),
  * seeded synthetic clouds (ops/cloud_rows.synthetic_cloud): N=2048 with
    a crowded, thinned body and a quarter of the points inactive, and
    N=32, the smallest N the kernel takes,

gathering point_rows_plain's per-point channels through the slot map,
zeros in the empty slots, gives cloud_rows_solve_plain's and
cloud_rows_packed_plain's output bit for bit, and every kept point sits
in the slot point_rows_plain gives it.  The winner value the row pass
recomputes from the hull bit (the winner hull's most-above plane by the
scan's max; the sphere's |p - pos| - radius, which wins only for points
deep inside a body: the synthetic clouds have them) equals the scan's bit
for bit."""
import numpy as np
import pytest
import torch

from hand_tracking_samples_tpu.assets_paths import DEFAULT_ANIMBANK
from hand_tracking_samples_tpu.data.animbank import load_animbank
from hand_tracking_samples_tpu_torch.data.synth import synth_camera
from hand_tracking_samples_tpu_torch.maths.fma import dot3, sqrt
from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
from hand_tracking_samples_tpu_torch.ops.cloud_kernel import (
    cloud_from_depth_planes, depth_tensor)
from hand_tracking_samples_tpu_torch.ops.cloud_rows import (
    BP, _kernel_inputs_ph, _winner_plain, cloud_rows_packed_plain,
    cloud_rows_solve_plain, pack_slot_map, point_rows_plain,
    synthetic_cloud)
from hand_tracking_samples_tpu_torch.tracker.config import TrackerConfig
from hand_tracking_samples_tpu_torch.tracker.runtime import multistep_cloud
from tests.conftest import cached_fake_depths

torch.set_num_threads(1)

SLOTS = 128
B = 17
DT = float(np.float32(1.0 / 60.0))
CASES = ["frames2048", "frames512", "synthetic2048", "synthetic32"]


@pytest.fixture(scope="module")
def port(hand_model):
    return from_numpy_model({k: np.asarray(v) for k, v in
                             vars(hand_model).items()}, "cpu")


@pytest.fixture(scope="module")
def frames(hand_model):
    """The dyn30 renders 3 and 12 with their poses (the second track 4 mm
    off its render): the depth (2, H, W) and the poses (2, 17, 7)."""
    bank = load_animbank(DEFAULT_ANIMBANK)
    dyn = cached_fake_depths(hand_model, np.asarray(bank[:30])[:, None],
                             "dyn30")[:, 0]
    poses = bank[[2, 11]].copy()
    poses[1, :, 0] += 0.004
    return depth_tensor(np.stack([dyn[3], dyn[12]]), "cpu"), \
        torch.tensor(poses)


def _inputs(case, port, frames):
    """The pack's inputs (pts_h, planes_t, body_sc, misc, slots), kernel
    2's dt in misc."""
    scale_b = torch.where(torch.arange(B) <= 2, 0.4, 1.0).float()
    depth, poses = frames
    if case.startswith("synthetic"):
        n = int(case[len("synthetic"):])
        bank = load_animbank(DEFAULT_ANIMBANK)
        pose = torch.tensor(bank[[0, 30, 11, 2]])
        ph = synthetic_cloud(pose, n, seed=n)
        return (ph,) + _kernel_inputs_ph(pose, port, (0.01, -0.02, 0.3),
                                         scale_b, DT) + (SLOTS,)
    ph = cloud_from_depth_planes(depth, synth_camera(), 0.1, 0.7, 4, 2048)
    if case == "frames2048":
        return (ph,) + _kernel_inputs_ph(poses, port, (0.0, 0.0, 0.0),
                                         scale_b, DT) + (SLOTS,)
    cfg = TrackerConfig(cnn_every_frame=True, solver="kernel",
                        use_pallas=True, point_budget=2048,
                        cloud_rows_per_body=SLOTS)
    cam = torch.zeros(2, 7)
    cam[:, :3] = torch.tensor([0.01, -0.02, 0.005])
    mph, origin, scale = multistep_cloud(ph, cam, cfg, B)
    return (mph.contiguous(),) + _kernel_inputs_ph(
        poses, port, origin, scale, DT) + (SLOTS,)


def _scan(args):
    """The winner scan's outputs: (best, wb, hull, active)."""
    pts_h, planes_t, body_sc = args[:3]
    best, widx, _ = _winner_plain(pts_h, planes_t, body_sc)
    hull = widx >= B
    return best, torch.where(hull, widx - B, widx), hull, pts_h[:, 4] > 0


@pytest.mark.parametrize("case", CASES)
def test_slot_map_gathers_the_pack(case, port, frames):
    args = _inputs(case, port, frames)
    pts_h = args[0]
    T, _, N = pts_h.shape
    assert N == int(case.replace("frames", "").replace("synthetic", ""))
    _, wb, hull, active = _scan(args)
    smap, counts = pack_slot_map(wb, hull, active, SLOTS)
    filled = smap >= 0
    assert int(filled.sum()) > 50 * T if N > 32 else int(filled.sum()) > 0
    if case in ("frames2048", "synthetic2048"):
        assert (counts > SLOTS).any()              # a body is thinned
    if case == "synthetic2048":
        assert 0.2 < 1.0 - active.float().mean().item() < 0.3
    # each body fills its first min(count, slots) slots (the kernel's
    # row pass walks them as one list)
    r = torch.arange(BP * SLOTS) % SLOTS
    fill = counts.clamp(max=SLOTS)[:, torch.arange(BP * SLOTS) // SLOTS]
    assert torch.equal(filled, r[None] < fill)
    pt = (smap >> 1).clamp(min=0)                  # the slot's point
    for parity, plain in ((False, cloud_rows_solve_plain),
                          (True, cloud_rows_packed_plain)):
        vals, col, counts_p = point_rows_plain(*args, parity=parity)
        assert torch.equal(counts, counts_p)
        ch = vals.shape[1]
        got = torch.where(filled[:, None],
                          torch.gather(vals, 2, pt[:, None].expand(
                              T, ch, BP * SLOTS)),
                          torch.zeros((), dtype=vals.dtype))
        packed, counts_f = plain(*args)
        assert torch.equal(got, packed), parity
        assert torch.equal(counts.to(torch.float32), counts_f)
    # every kept point in the slot point_rows_plain gives it, once
    tt, ss = torch.nonzero(filled, as_tuple=True)
    assert torch.equal(col[tt, pt[tt, ss]], ss)
    assert int((col >= 0).sum()) == len(ss)
    assert torch.equal((smap[tt, ss] & 1) == 1, hull[tt, pt[tt, ss]])


@pytest.mark.parametrize("case", CASES)
def test_row_pass_recomputes_the_winner_value(case, port, frames):
    args = _inputs(case, port, frames)
    pts_h, planes_t, body_sc = args[:3]
    P = planes_t.shape[1] // 5
    best, wb, hull, active = _scan(args)
    smap, _ = pack_slot_map(wb, hull, active, SLOTS)
    tt, ss = torch.nonzero(smap >= 0, as_tuple=True)
    p = smap[tt, ss] >> 1
    hb = (smap[tt, ss] & 1) == 1
    b = ss // SLOTS                                # the slot's body
    px, py, pz = (pts_h[tt, k, p][:, None] for k in range(3))
    sel = planes_t[tt, :, b]                       # (S, 5P)
    dmax = (dot3(sel[:, 0:P], sel[:, P:2 * P], sel[:, 2 * P:3 * P], px, py,
                 pz) + sel[:, 3 * P:4 * P]).amax(1)
    dx, dy, dz = (pts_h[tt, k, p] - body_sc[tt, k, b] for k in range(3))
    sphere = sqrt(dot3(dx, dy, dz, dx, dy, dz)) - body_sc[tt, 3, b]
    want = best[tt, p]
    assert hb.any()
    if case.startswith("synthetic"):            # points deep in a body
        assert (~hb).any()
    assert torch.equal(dmax[hb], want[hb])
    assert torch.equal(sphere[~hb], want[~hb])
