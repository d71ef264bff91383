"""Kernel 6's order (csrc/cloud_rows.cu cloud_rows_unpacked_kernel), stated
in PyTorch and held bit for bit to ops/cloud_rows.cloud_rows_unpacked_plain:
the vals kernel's blocked scan with one point a thread (UR_K; a warp's 32
points are one run of the cloud), the padded-P8 fmax chain and the warp
exit (tests/test_torch_vals_exit.blocked_vals), whose best is a hull
winner's most-above value, then the row pass on what the
scan kept: the sphere normal, the blend of the maximal planes (dw == best)
for hull winners only, the slab clip of origin->p only where the ray meets
the normal from the front (elsewhere te, tx and miss are never read), and
the row.  The sums and the clip run plane by plane, as the kernel's loops
do.  Inputs: UnibodyFit's stride-4 subsample (tracker.runtime._subsample4
and compact_planes, N=512) of a cached render's cloud, and seeded
synthetic clouds (ops/cloud_rows.synthetic_cloud) at N=512 and N=67.
About 6 s serially."""
import numpy as np
import pytest
import torch

from hand_tracking_samples_tpu.assets_paths import DEFAULT_ANIMBANK
from hand_tracking_samples_tpu.data.animbank import load_animbank
from hand_tracking_samples_tpu_torch.data.synth import synth_camera
from hand_tracking_samples_tpu_torch.imaging.image_ops import compact_planes
from hand_tracking_samples_tpu_torch.maths.fma import dot3, fma, sqrt
from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
from hand_tracking_samples_tpu_torch.ops.cloud_kernel import (
    cloud_from_depth_planes, depth_tensor)
from hand_tracking_samples_tpu_torch.ops.cloud_rows import (
    _kernel_inputs_ph, cloud_rows_unpacked_plain, synthetic_cloud)
from hand_tracking_samples_tpu_torch.tracker.runtime import _subsample4
from tests.conftest import cached_fake_depths
from tests.test_torch_vals_exit import blocked_vals

torch.set_num_threads(1)

UR_K = 1         # points a thread (csrc UR_K)


def blocked_rows(pts_h, planes_t, body_sc, misc):
    """Kernel 6's order: (T, 8, N) rows [n(3), w1(3), td, active], the share
    of hull planes the scan took, and the share of points that ran the
    blend and the clip."""
    T, _, N = pts_h.shape
    P, B = planes_t.shape[1] // 5, planes_t.shape[2]
    vals, scanned, full, widx = blocked_vals(pts_h, planes_t, body_sc,
                                             winners=True, k=UR_K)
    best = vals[:, 0]
    hull = widx >= B
    wb = torch.where(hull, widx - B, widx)
    px, py, pz = pts_h[:, 0], pts_h[:, 1], pts_h[:, 2]          # (T, N)
    centre = [torch.gather(body_sc[:, k, :B], 1, wb) for k in range(3)]
    dx, dy, dz = px - centre[0], py - centre[1], pz - centre[2]
    inv = 1.0 / torch.clamp(sqrt(dot3(dx, dy, dz, dx, dy, dz)), min=1e-20)
    wn = [dx * inv, dy * inv, dz * inv]
    sel = torch.gather(planes_t, 2, wb[:, None].expand(T, 5 * P, N))
    rows = [sel[:, k * P:(k + 1) * P] for k in range(5)]        # (T, P, N)

    def winner_planes(mask):
        """The winner's planes (n.x, n.y, n.z, d, d at origin) and plane
        values, (M, P) each, for the M points of mask."""
        tt, nn = torch.nonzero(mask, as_tuple=True)
        pl = [r[tt, :, nn] for r in rows]
        dw = dot3(pl[0], pl[1], pl[2], px[tt, nn][:, None],
                  py[tt, nn][:, None], pz[tt, nn][:, None]) + pl[3]
        return (tt, nn), pl, dw

    # the blend, for hull winners only: the maximal planes of the scan's best
    at, pl, dw = winner_planes(hull)
    top = dw == best[at][:, None]
    s = [torch.zeros(len(at[0])) for _ in range(3)]
    cnt = torch.zeros(len(at[0]))
    for q in range(P):
        m = top[:, q]
        s = [torch.where(m, s[k] + pl[k][:, q], s[k]) for k in range(3)]
        cnt = torch.where(m, cnt + 1.0, cnt)
    cnt = torch.clamp(cnt, min=1.0)
    for k in range(3):
        wn[k] = wn[k].index_put(at, s[k] / cnt)

    # the slab clip, only where the ray meets the normal from the front
    ox, oy, oz = misc[:, 0:1], misc[:, 1:2], misc[:, 2:3]
    rx, ry, rz = px - ox, py - oy, pz - oz
    front = dot3(rx, ry, rz, *wn) > 0
    at, pl, dw = winner_planes(front)
    miss = torch.zeros(len(at[0]), dtype=torch.bool)
    te_f = torch.zeros(len(at[0]))
    tx_f = torch.ones(len(at[0]))
    zero, one = torch.zeros(()), torch.ones(())
    for q in range(P):
        a, a0 = dw[:, q], pl[4][:, q]
        miss |= (a0 >= 0) & (a >= 0)
        den = a0 - a
        tt = torch.where(den != 0, a0 / torch.where(den == 0, one, den),
                         zero)
        te_f = torch.maximum(te_f, torch.where((a0 >= 0) & (a < 0), tt,
                                               zero))
        tx_f = torch.minimum(tx_f, torch.where((a0 <= 0) & (a > 0), tt,
                                               one))
    te = torch.zeros((T, N)).index_put(at, te_f)
    use_ray = torch.zeros((T, N), dtype=torch.bool).index_put(
        at, ~miss & (te_f <= tx_f))

    rinv = 1.0 / torch.clamp(sqrt(dot3(rx, ry, rz, rx, ry, rz)), min=1e-20)
    w1 = [torch.where(use_ray, fma(r, te, o), fma(-n, best, p))
          for r, o, n, p in zip((rx, ry, rz), (ox, oy, oz), wn,
                                (px, py, pz))]
    n = [torch.where(use_ray, r * rinv, w)
         for r, w in zip((rx, ry, rz), wn)]
    td = dot3(w1[0] - px, w1[1] - py, w1[2] - pz, *n)
    act = (pts_h[:, 4] > 0).to(torch.float32)
    out = torch.stack([*n, *w1, td, act], dim=1)
    return out, scanned / full, dict(hull=hull.float().mean().item(),
                                     front=front.float().mean().item())


@pytest.fixture(scope="module")
def port(hand_model):
    return from_numpy_model({k: np.asarray(v) for k, v in
                             vars(hand_model).items()}, "cpu")


@pytest.fixture(scope="module")
def bank():
    return load_animbank(DEFAULT_ANIMBANK)


def _inputs(port, pose, ph, origin=(0.0, 0.0, 0.0)):
    B = pose.shape[1]
    return (ph.contiguous(),) + _kernel_inputs_ph(pose, port, origin,
                                                  torch.zeros(B), 0.0)


def test_blocked_rows_equal_plain_render(port, bank, hand_model):
    """UnibodyFit's input: the stride-4 subsample of the cached dyn30 render
    12's cloud (N=512), against its own pose, the pose 2 cm off and another
    bank pose: the scan skips planes, and both the blend and the clip
    run."""
    dyn = cached_fake_depths(hand_model, np.asarray(bank[:30])[:, None],
                             "dyn30")[:, 0]
    ph = cloud_from_depth_planes(depth_tensor(dyn[[12, 12, 12]], "cpu"),
                                 synth_camera(), 0.1, 0.7, 4, 2048)
    keep, N = _subsample4(ph)
    uph = compact_planes(ph, keep, max(N // 4, 64))
    assert uph.shape[2] == 512
    pose = torch.tensor(bank[[12, 12, 200]])
    pose[1, :, 0] += 0.02
    args = _inputs(port, pose, uph)
    mine, share, used = blocked_rows(*args)
    assert torch.equal(mine, cloud_rows_unpacked_plain(*args))
    print(f"render: {share:.3f} of the planes scanned; {used}")
    assert share < 1
    assert 0 < used["hull"] and 0 < used["front"] < 1


@pytest.mark.parametrize("n", [512, 67])
def test_blocked_rows_equal_plain_synthetic(n, port, bank):
    """Seeded clouds around four bank poses (a crowded body, points on body
    centres where the inner sphere wins, a quarter inactive), the camera
    at the origin; N=67 leaves a warp's points partly past N."""
    pose = torch.tensor(bank[[0, 30, 11, 2]])
    args = _inputs(port, pose, synthetic_cloud(pose, n, seed=n))
    mine, share, used = blocked_rows(*args)
    assert torch.equal(mine, cloud_rows_unpacked_plain(*args))
    print(f"N={n}: {share:.3f} of the planes scanned; {used}")
    assert share < 1
    assert 0 < used["hull"] < 1 and 0 < used["front"] < 1
