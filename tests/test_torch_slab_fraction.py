"""The redesigned correspondence kernel's order (csrc/correspondence.cu),
stated in plain PyTorch and held bit for bit to
correspondence_reductions_plain: the planes in order, the max and its
first index by a strict compare; the slab clip split
by the side of each plane's origin dot a (a > 0: miss and the enter
candidates; a < 0: the exit candidates; a == 0: miss and the exit ones),
each clip bound carried as the fraction (a, a - d1) of its best candidate;
a candidate passes the filter fmaf(a, K, d1) * d1 <= 0 (enter) or
fmaf(a, L, d1) >= 0 (exit), with the least K and the largest L the kernel
can compute from the kept fraction (its reciprocal 2^-22 off, margins of
2^-20 in directed rounding), and a passing candidate replaces the fraction
where its quotient is exactly larger (enter) or smaller (exit): the two
cross products compared rounded, and in float64 (exact) where they round
equal; one division a (point, body, side) after the loop.  Rounding is
monotone, so that division gives the plain version's max and min of the
rounded quotients.  On

  * the port's clouds of the cached dyn30 renders 3 and 12 (N=2048) at the
    animbank poses 2 and 11, the ray origin at the camera and off it,
  * seeded synthetic inputs (ops/correspondence.synthetic_clip_inputs)
    whose quotients tie exactly and lie within an ulp of each other, with
    planes through the origin (a = +0) and masked planes,

every output of every (track, body, point) is the plain version's, the
filter never turns away a candidate that wins, and the synthetic inputs
take the float64 comparison (ties, and near-ties that it orders)."""
import numpy as np
import pytest
import torch

from hand_tracking_samples_tpu.assets_paths import DEFAULT_ANIMBANK
from hand_tracking_samples_tpu.data.animbank import load_animbank
from hand_tracking_samples_tpu_torch.data.synth import synth_camera
from hand_tracking_samples_tpu_torch.maths.fma import fma
from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
from hand_tracking_samples_tpu_torch.ops import correspondence as oc
from hand_tracking_samples_tpu_torch.ops.cloud_kernel import (
    cloud_from_depth_planes, depth_tensor, planes_points)
from hand_tracking_samples_tpu_torch.tracker.config import TrackerConfig
from tests.conftest import cached_fake_depths

torch.set_num_threads(1)

CASES = ["frames_origin", "frames_offset", "synthetic"]


def _less(x0, y0, x1, y1):
    """(x0*y0 < x1*y1 exactly, where the rounded products tie, where they
    tie but the exact ones differ)."""
    p0, p1 = x0 * y0, x1 * y1
    e0, e1 = x0.double() * y0.double(), x1.double() * y1.double()
    tie = p0 == p1
    return torch.where(tie, e0 < e1, p0 < p1), tie, tie & (e0 != e1)


def _rounded(x, up):
    """float64 x to float32, rounded up (or down)."""
    f = x.float()
    off = f.double() < x if up else f.double() > x
    return torch.where(off, torch.nextafter(
        f, torch.full_like(f, torch.inf if up else -torch.inf)), f)


def _slope(num, den, up):
    """The kernel's enter slope K (up) or exit slope L from the kept
    fraction's |den| / |a|: the least K or the largest L it can compute;
    |a| below 2^-100 gives an infinite K, and an L of -1 (infinite where
    a is 0)."""
    r = num.double() / den.double()
    m = (1 - 2.0 ** -22) * (1 + 2.0 ** -20) if up \
        else (1 + 2.0 ** -22) * (1 - 2.0 ** -20)
    tiny = torch.inf if up else torch.where(den == 0, torch.inf, -1.0)
    return torch.where(den < 2.0 ** -100, tiny, _rounded(r * m - 1, up))


def _filter(a, k, d1, enter):
    """The kernel's filter, k possibly infinite: fmaf(a, k, d1) * d1 <= 0
    (enter) or fmaf(a, k, d1) >= 0 (exit)."""
    g = torch.where(torch.isinf(k), a * k + d1,
                    fma(a, torch.where(torch.isinf(k), 0.0, k), d1))
    return g * d1 <= 0 if enter else g >= 0


def slab_fraction(pts_h, planes, d0):
    """The kernel's order: returns its five outputs and counts (filter
    passes, winning candidates the filter turned away, float64
    comparisons, near-ties they ordered)."""
    T, B, P = d0.shape
    N = pts_h.shape[2]
    px, py, pz = (pts_h[:, None, k] for k in range(3))       # (T, 1, N)
    shape = (T, B, N)
    best = torch.zeros(shape)
    bi = torch.zeros(shape, dtype=torch.int32)
    mp = torch.full(shape, -torch.inf)
    ae, de, ke = torch.zeros(shape), torch.ones(shape), \
        torch.full(shape, torch.inf)
    ax, dx = -torch.ones(shape), -torch.ones(shape)
    lx = _slope(dx.abs(), ax.abs(), False)
    n = dict(passes=0, turned_away=0, ties=0, near=0)
    for p in range(P):
        w = planes[:, :, p, :, None]                         # (T, B, 8, 1)
        d1 = fma(w[:, :, 2], pz, fma(w[:, :, 1], py, w[:, :, 0] * px)) \
            + w[:, :, 3]
        up = (d1 > best) | (p == 0)
        best = torch.where(up, d1, best)
        bi = torch.where(up, torch.full_like(bi, p), bi)
        a = d0[:, :, p, None].expand(shape)
        mp = torch.where(a >= 0, torch.fmax(mp, d1), mp)
        den = a - d1
        for side in ("enter", "exit"):
            if side == "enter":
                cand = (a > 0) & (d1 < 0)
                passed = (a > 0) & _filter(a, ke, d1, True)
                less, tie, near = _less(ae, den, a, de)
            else:
                cand = (a <= 0) & (d1 > 0)
                passed = (a <= 0) & _filter(a, lx, d1, False)
                less, tie, near = _less(a, dx, ax, den)
            n["turned_away"] += int((cand & less & ~passed).sum())
            rep = passed & cand & less
            n["passes"] += int(passed.sum())
            n["ties"] += int((passed & cand & tie).sum())
            n["near"] += int((passed & cand & near).sum())
            if side == "enter":
                ae, de = torch.where(rep, a, ae), torch.where(rep, den, de)
                ke = torch.where(rep, _slope(den, a, True), ke)
            else:
                ax, dx = torch.where(rep, a, ax), torch.where(rep, den, dx)
                lx = torch.where(rep, _slope(-den, a.abs(), False), lx)
    return (best, bi, ae / de, ax / dx, (mp >= 0).to(torch.int32)), n


@pytest.fixture(scope="module")
def port(hand_model):
    return from_numpy_model({k: np.asarray(v) for k, v in
                             vars(hand_model).items()}, "cpu")


def _inputs(case, hand_model, port):
    if case == "synthetic":
        return oc.synthetic_clip_inputs(4, 17, 96, 2048, seed=10)
    bank = load_animbank(DEFAULT_ANIMBANK)
    dyn = cached_fake_depths(hand_model, np.asarray(bank[:30])[:, None],
                             "dyn30")[:, 0]
    cfg = TrackerConfig(point_budget=2048)
    ph = cloud_from_depth_planes(
        depth_tensor(np.stack([dyn[3], dyn[12]]), "cpu"), synth_camera(),
        0.1, cfg.drangey, cfg.subsample_fraction, cfg.point_budget)
    pts, _ = planes_points(ph)
    pw = oc.world_planes(torch.tensor(bank[[2, 11]]), port)
    origin = (0.0, 0.0, 0.0) if case == "frames_origin" \
        else (0.01, -0.02, 0.03)
    return oc.points_h(pts), pw, oc.origin_dots(pw, port, origin)


@pytest.mark.parametrize("case", CASES)
def test_slab_fraction_matches_plain(case, hand_model, port):
    pts_h, planes, d0 = _inputs(case, hand_model, port)
    mine, n = slab_fraction(pts_h, planes, d0)
    ref = oc.correspondence_reductions_plain(pts_h, planes, d0)
    names = ("hull_val", "pidx", "t_enter", "t_exit", "miss")
    for name, m, r in zip(names, mine, ref):
        assert m.dtype == r.dtype, name
        assert torch.equal(m, r), name
    assert n["turned_away"] == 0, n
    # both bounds move off their start; the frames see both clip outcomes,
    # the synthetic inputs ties and near-ties
    assert (ref[2] > 0).any() and (ref[3] < 1).any()
    if case == "synthetic":
        assert n["ties"] > 100 and n["near"] > 0, n
    else:
        hit = (ref[4] == 0) & (ref[2] <= ref[3])
        assert 0 < int(hit.sum()) < hit.numel()
