"""The redesigned contact kernel's order (csrc/contact_kernel.cu), stated in
plain PyTorch and held bit for bit to contact_fields_plain: a warp of 32
lanes per pair; the face scans with the lanes owning the scanning hull's
planes (p = lane + 32 k), each plane's min folded with fmin in vertex
order; the support refinement and the manifold with the lanes owning the
vertices (v = lane, lane + 32); every arg-reduction first lane-local in
index order, then the butterfly of xor shuffles on (value, index) that
takes the lower index on a tie; the manifold's NPT rounds each masking
their winner.  On

  * animbank poses: the golden's contact pose and a spread of the bank, and
    the dyn30 poses (bank 0-29), with small random momenta,
  * seeded synthetic tracks (physics/contact_kernel.synthetic_contact_
    inputs): every collide pair near (bodies pulled together), and hulls
    whose second half of planes and of vertices copy their first half, so
    every reduction meets exact ties,

the whole output (T, NP, 12, NPT) equals the plain version's, skip rows and
inactive rows included."""
import json
import os

import numpy as np
import pytest
import torch

from hand_tracking_samples_tpu.assets_paths import DEFAULT_ANIMBANK
from hand_tracking_samples_tpu.data.animbank import load_animbank
from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
from hand_tracking_samples_tpu_torch.physics.contact_kernel import (
    contact_fields_plain, contact_inputs, synthetic_contact_inputs)
from hand_tracking_samples_tpu_torch.tracker.config import TrackerConfig
from hand_tracking_samples_tpu_torch.tracker.runtime import physics_params

torch.set_num_threads(1)

LANES = torch.arange(32)
CASES = ["bank", "dyn30", "synthetic"]
NPT, REFINE = 4, 3


def butterfly(v, i, better):
    """The warp's (value, index) reduction over the last axis (32 lanes):
    five rounds of xor shuffles, each lane taking its partner's pair where
    it is better, or equal with a lower index; every lane ends equal."""
    for o in (16, 8, 4, 2, 1):
        ov, oi = v[..., LANES ^ o], i[..., LANES ^ o]
        take = better(ov, v) | ((ov == v) & (oi < i))
        v, i = torch.where(take, ov, v), torch.where(take, oi, i)
    assert torch.equal(v, v[..., :1].expand_as(v))
    return v[..., 0], i[..., 0]


def lanes_of(x, per_lane, fill):
    """(..., n) -> (..., per_lane, 32): slot k of lane l is x[..., l + 32 k],
    `fill` where that index is past n; and the slot's index."""
    n = x.shape[-1]
    idx = LANES[None, :] + 32 * torch.arange(per_lane)[:, None]
    pad = torch.cat([x, torch.full(x.shape[:-1] + (32 * per_lane - n,),
                                   fill)], dim=-1)
    return pad[..., idx], torch.where(idx < n, idx, 1 << 20)


def dot(n, x):
    """n0*x + n1*y + n2*z, left to right: lists of 3 tensors."""
    return n[0] * x[0] + n[1] * x[1] + n[2] * x[2]


def face_scan(nh, dh, vo):
    """Hull h's planes (3 x (..., P), (..., P)) against hull o's vertices
    (3 x (..., V)): (sep, first), lanes over the planes."""
    m = dot(nh, [c[..., 0, None] for c in vo])         # (..., P)
    for v in range(1, vo[0].shape[-1]):
        m = torch.fmin(m, dot(nh, [c[..., v, None] for c in vo]))
    val, idx = lanes_of(m + dh, 3, -torch.inf)    # (..., 3, 32)
    sep = torch.full(val.shape[:-2] + (32,), -torch.inf)
    first = torch.full(sep.shape, 1 << 20)
    for k in range(3):
        up = (idx[k] < (1 << 20)) & ((first == 1 << 20)
                                     | (val[..., k, :] > sep))
        sep = torch.where(up, val[..., k, :], sep)
        first = torch.where(up, idx[k].expand_as(first), first)
    return butterfly(sep, first, torch.gt)


def first_arg(vals, idx, better, worst):
    """Lane-local first best over the slots (..., 2, 32) in slot order."""
    v = torch.full(vals.shape[:-2] + (32,), worst)
    i = torch.full(v.shape, 1 << 20)
    for k in range(vals.shape[-2]):
        up = (idx[k] < (1 << 20)) & ((i == 1 << 20)
                                     | better(vals[..., k, :], v))
        v = torch.where(up, vals[..., k, :], v)
        i = torch.where(up, idx[k].expand_as(i), i)
    return v, i


def take(x, i):
    return torch.gather(x, -1, i[..., None])[..., 0]


def contact_lanes(vw, nw, dw, aux, pairs, n_points, refine, driftmax):
    """The kernel's order for every pair; culled pairs get the skip rows."""
    a, b = pairs[:, 0], pairs[:, 1]
    va = [vw[:, c][:, a] for c in range(3)]            # (T, NP, V)
    vb = [vw[:, c][:, b] for c in range(3)]
    na = [nw[:, c][:, a] for c in range(3)]            # (T, NP, P)
    nb = [nw[:, c][:, b] for c in range(3)]
    da, db = dw[:, a], dw[:, b]
    auxa, auxb = aux[:, a], aux[:, b]
    dc = [auxa[..., 6 + c] - auxb[..., 6 + c] for c in range(3)]
    rsum = auxa[..., 9] + auxb[..., 9]
    near = dc[0] * dc[0] + dc[1] * dc[1] + dc[2] * dc[2] <= rsum * rsum

    sep_a, fa = face_scan(na, da, vb)
    sep_b, fb = face_scan(nb, db, va)
    use_a = sep_a >= sep_b
    nfa, nfb = [take(c, fa) for c in na], [take(c, fb) for c in nb]
    n = [torch.where(use_a, nfa[c], -nfb[c]) for c in range(3)]

    la = [lanes_of(c, 2, 0.0) for c in va]             # (..., 2, 32) each
    lb = [lanes_of(c, 2, 0.0) for c in vb]
    vidx = la[0][1]
    m, best = n, torch.full_like(sep_a, -3.0e38)
    for it in range(refine + 1):
        nm = [-c for c in m]
        mx = [c[..., None, None] for c in m]
        nmx = [c[..., None, None] for c in nm]
        _, ia = butterfly(*first_arg(dot([c[0] for c in la], mx), vidx,
                                     torch.gt, -torch.inf), torch.gt)
        _, ib = butterfly(*first_arg(dot([c[0] for c in lb], nmx), vidx,
                                     torch.gt, -torch.inf), torch.gt)
        d = [take(vb[c], ib) - take(va[c], ia) for c in range(3)]
        s = d[0] * m[0] + d[1] * m[1] + d[2] * m[2]
        if it == refine:
            break
        best = torch.fmax(best, s)
        norm = torch.fmax(torch.sqrt(d[0] * d[0] + d[1] * d[1]
                                     + d[2] * d[2]),
                          torch.tensor(1e-20))
        m = [c / norm for c in d]
    active_pair = torch.fmax(best, s) < driftmax

    nf = [torch.where(use_a, nfa[c], nfb[c]) for c in range(3)]
    df = torch.where(use_a, take(da, fa), take(db, fb))
    vo = [torch.where(use_a[..., None], vb[c], va[c]) for c in range(3)]
    dv = dot([c[..., None] for c in nf], vo) + df[..., None]
    dvl, _ = lanes_of(dv, 2, torch.inf)
    seps, fs = [], []
    for _ in range(n_points):
        mn, f = butterfly(*first_arg(dvl, vidx, torch.lt, torch.inf),
                          torch.lt)
        dvl = torch.where(vidx == f[..., None, None],
                          torch.full_like(dvl, 3.0e38), dvl)
        seps.append(mn)
        fs.append(f)
    sp = torch.stack(seps, dim=-1)                     # (T, NP, NPT)
    f = torch.stack(fs, dim=-1)
    deep = [torch.gather(c, -1, f) for c in vo]
    ua = use_a[..., None]
    shift = [n[c][..., None] * sp for c in range(3)]
    p1w = [torch.where(ua, deep[c], deep[c] + shift[c]) for c in range(3)]
    p0w = [torch.where(ua, deep[c] - shift[c], deep[c]) for c in range(3)]
    act = active_pair[..., None] & (sp < driftmax)

    def vel(ax, pw):
        r = [pw[c] - ax[..., 6 + c, None] for c in range(3)]
        s_ = [ax[..., c, None] for c in range(3)]
        return [s_[1] * r[2] - s_[2] * r[1] + ax[..., 3, None],
                s_[2] * r[0] - s_[0] * r[2] + ax[..., 4, None],
                s_[0] * r[1] - s_[1] * r[0] + ax[..., 5, None]], r

    v0, r0 = vel(auxa, p0w)
    v1, r1 = vel(auxb, p1w)
    vdotn = ((v0[0] - v1[0]) * (-n[0][..., None])
             + (v0[1] - v1[1]) * (-n[1][..., None])
             + (v0[2] - v1[2]) * (-n[2][..., None]))
    out = torch.stack([sp, vdotn, *r0, *r1, act.to(torch.float32),
                       *[c[..., None].expand_as(sp) for c in n]], dim=2)
    skip = torch.zeros((12, n_points))
    skip[11] = -1.0
    return torch.where(near[..., None, None], out, skip), near


@pytest.fixture(scope="module")
def port(hand_model):
    return from_numpy_model({k: np.asarray(v) for k, v in
                             vars(hand_model).items()}, "cpu")


def _inputs(case, port):
    bank = load_animbank(DEFAULT_ANIMBANK)
    if case == "synthetic":
        return synthetic_contact_inputs(torch.tensor(bank[[0, 30, 60, 90]]),
                                        port, seed=3)
    if case == "bank":
        with open(os.path.join(os.path.dirname(__file__), "fixtures",
                               "golden.json")) as fh:
            cf = int(json.load(fh)["contact_frame"][0])
        frames = [cf] + list(range(0, len(bank), len(bank) // 7))[:7]
    else:
        frames = list(range(0, 30, 4))
    rng = np.random.RandomState(3)
    f32 = lambda x: torch.tensor(x.astype(np.float32))
    return contact_inputs(f32(bank[frames]),
                          f32(rng.randn(len(frames), 17, 3) * 1e-3),
                          f32(rng.randn(len(frames), 17, 3) * 1e-4), port)


@pytest.mark.parametrize("case", CASES)
def test_contact_lanes_match_plain(case, port):
    vw, nw, dw, aux = _inputs(case, port)
    pairs = torch.as_tensor(np.asarray(port.np["collide_pairs"]))
    drift = physics_params(TrackerConfig()).driftmax
    mine, near = contact_lanes(vw, nw, dw, aux, pairs, NPT, REFINE, drift)
    ref = contact_fields_plain(vw, nw, dw, aux, pairs, NPT, REFINE, drift)
    assert torch.equal(mine, ref)
    assert near.any() and not near.all()
    if case != "dyn30":               # the dyn30 poses touch nowhere
        assert (ref[:, :, 8] > 0.5).any()
    if case == "synthetic":           # the pulled-together tracks: all near
        assert bool(near[:2].all()), near.sum(-1)
