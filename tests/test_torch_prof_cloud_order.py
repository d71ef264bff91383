"""Kernel 9's order (csrc/prof_cloud.cu cloud_stage_kernel), stated in
PyTorch and held bit for bit to tools/prof_cloud_kernel.stage_plain:

  * a cluster of C CTAs a track, CTA c owning the rows [c*R/C, (c+1)*R/C);
  * each slice's pass 1 (a valid mask byte a unit of 8 pixels) and its row
    scan (each row's 16 mask bytes counted; one warp, each lane a
    contiguous run of rows, a shuffle scan of the runs' totals);
  * the first exchange: the CTAs' valid totals added in rank order; the
    second: their integer sums (stage 0: their float64 partial sums)
    gathered in the last CTA, added in rank order, and the track filled
    there;
  * stage 2's pass over each unit's kept ranks [ceil(r0/frac),
    ceil((r0 + its valid count)/frac)), kept rank i its valid pixel
    i*frac - r0;
  * ranks in 32 bits: floor(n / frac) by frac_divisor's shift or
    multiply-high, the thinning map in 32 bits under the launcher's rule
    ceil(H*W/frac)*(S+1) <= 2^32, else a float64 estimate corrected by
    exact products, its inverse by a search of products;
  * slot ownership by kept-rank range, every slot owned by exactly one CTA
    (the last one writing the empty slots), and the slot-major pick: a
    binary search of the row ranks, a select over the row's 128 mask bits.

On ops/cloud_kernel.synthetic_depths and the cached renders of
test_torch_tools.py, at frac 1, 3, 4, 5 and 16, at budgets that give
K = 0, K < S (with a last row whose value counts once per empty slot),
K = S and K > S, at C = 1-8 (slices of unequal length, and empty ones on a
raster of fewer rows than CTAs).  The divisor is checked exhaustively over
every numerator the kernel forms, and the thinning map's 32-bit range over
every raster size the wrapper accepts."""
import numpy as np
import pytest
import torch

from hand_tracking_samples_tpu_torch.ops.cloud_kernel import (
    synthetic_depths)
from hand_tracking_samples_tpu_torch.tools.common import to_raster
from hand_tracking_samples_tpu_torch.tools.prof_cloud_kernel import (
    frac_divisor, scalars, stage_plain)
from tests.test_torch_tools import rasters

torch.set_num_threads(1)

M32 = (1 << 32) - 1


def _div(n, frac):
    """floor(n / frac) as the kernel computes it, n < 2^21."""
    mul, shift = frac_divisor(frac)
    assert int(n.max()) < 1 << 21 if n.numel() else True
    return n >> shift if mul == 0 else ((n * mul) >> 32) >> shift


def thin32(HW, frac, S):
    """The launcher's rule: the thinning map in 32 bits."""
    return -(-HW // frac) * (S + 1) <= 1 << 32


def _fwd(s, K, S, t32):
    """t_s = floor(s*K/S) for K > S: 32-bit, else the float64 estimate
    with 1/S and one correction by exact products."""
    if t32:
        assert int((s * K).max()) <= M32
        return ((s * K) & M32) // S
    n = s * K
    q = (n.double() * (1.0 / S)).to(torch.int64)
    q = torch.where(q * S > n, q - 1, torch.where((q + 1) * S <= n, q + 1, q))
    return q


def _inv(kb, K, S, t32):
    """ceil(kb*S/K), K > S: 32-bit, else the smallest s with s*K >= kb*S
    by a binary search of products."""
    if t32:
        assert int((kb * S + K - 1).max()) <= M32
        return ((kb * S + K - 1) & M32) // K
    n = kb * S
    lo, hi = torch.zeros_like(kb), torch.full_like(kb, S)
    while bool((lo < hi).any()):
        m = (lo + hi) >> 1
        up = m * K >= n
        lo, hi = torch.where(lo < hi, torch.where(up, lo, m + 1), lo), \
            torch.where(lo < hi, torch.where(up, m, hi), hi)
    return lo


_POPC8 = torch.tensor([bin(i).count("1") for i in range(256)])


def _popc(x):
    """Set bits of 32-bit values in int64 tensors."""
    return sum(_POPC8[(x >> (8 * i)) & 255] for i in range(4))


def _words(bytes_):
    """(..., 16) mask bytes -> (..., 4) 32-bit words, little-endian."""
    b = bytes_.reshape(*bytes_.shape[:-1], 4, 4)
    return (b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24)


def _prefix(w, u):
    """ps_prefix: set bits of the row's bytes before unit u."""
    i = u >> 2
    x = torch.gather(w, -1, i[..., None])[..., 0]
    p = _popc(x & ((1 << (8 * (u & 3))) - 1))
    for k in range(3):
        p = p + torch.where(i > k, _popc(w[..., k]), 0)
    return p


def _select(w, j):
    """ps_select: position of the j-th set bit of the row's 128 bits."""
    x, b = w[..., 0], torch.zeros_like(j)
    for k in range(1, 4):
        c = _popc(x)
        go = j >= c
        j = torch.where(go, j - c, j)
        x = torch.where(go, w[..., k], x)
        b = torch.where(go, 32 * k, b)     # once j < c, go stays false
    for h in (16, 8, 4, 2, 1):
        c = _popc(x & ((1 << h) - 1))
        go = j >= c
        j = torch.where(go, j - c, j)
        x = torch.where(go, x >> h, x)
        b = torch.where(go, b + h, b)
    return b


def _row_scan(counts):
    """The row pass's scan by one warp: (T, nr) -> exclusive ranks (T,
    nr), total (T,).  Lane i takes rows [i*run, (i+1)*run), run =
    ceil(nr/32): its run's total, the warp's scan of the totals, then its
    rows in order."""
    T, nr = counts.shape
    run = -(-nr // 32)
    c = torch.zeros((T, 32 * run), dtype=torch.int64)
    c[:, :nr] = counts
    lanes = c.reshape(T, 32, run)
    tot = lanes.sum(-1)
    inc = torch.cumsum(tot, -1)                     # the shuffle scan
    ex = (inc - tot)[..., None] + torch.cumsum(lanes, -1) - lanes
    return ex.reshape(T, 32 * run)[:, :nr], inc[:, -1]


def staged_order(draw, scal, stage, budget, frac, W, C):
    """cloud_stage_kernel<stage>'s order: draw (T, R, 128) f32 -> (T,
    budget, 8), and the number of writers of each slot (stages 3-4)."""
    lo, hi, scale = (float(np.float32(x)) for x in list(scal)[:3])
    T, R, _ = draw.shape
    S, f = budget, frac
    t32 = thin32(R * 128, frac, S)
    d = draw * torch.tensor(scale)
    valid = (d >= lo) & (d < hi)
    ubytes = (valid.reshape(T, R, 16, 8).to(torch.int64)
              << torch.arange(8)).sum(-1)                    # (T, R, 16)
    raw = draw.to(torch.int64)
    cuts = [c * R // C for c in range(C + 1)]
    # pass 1 and the row scan of each CTA; the first exchange
    sl = []
    for c in range(C):
        r0, r1 = cuts[c], cuts[c + 1]
        w = _words(ubytes[:, r0:r1])                         # (T, nr, 4)
        rrank, Vc = _row_scan(_popc(w).sum(-1))
        sl.append((r0, r1, w, rrank, Vc))
    Vs = torch.stack([x[4] for x in sl], 1)                  # (T, C)
    bases = torch.cumsum(Vs, 1) - Vs                         # rank order
    V = Vs.sum(1)
    K = _div(V + f - 1, f)
    out = torch.full((T, 2 * S, 4), float("nan"))
    writers = torch.zeros((T, S), dtype=torch.int64)
    if stage == 0:
        part = torch.stack([d[:, r0:r1].double().sum((1, 2))
                            for r0, r1, *_ in sl], 1)
        tot = part[:, 0]
        for c in range(1, C):              # rank order, in the last CTA
            tot = tot + part[:, c]
        return _fill(out, tot.to(torch.float32), S), writers
    sums = []
    for c, (r0, r1, w, rrank, Vc) in enumerate(sl):
        nr = r1 - r0
        base = bases[:, c]
        acc = torch.zeros(T, dtype=torch.int64)
        if nr == 0:
            sums.append(acc)
            continue
        u = torch.arange(16).expand(T, nr, 16)
        wu = w[:, :, None, :].expand(T, nr, 16, 4)
        rb = base[:, None] + rrank                           # (T, nr)
        r0u = rb[..., None] + _prefix(wu, u)                 # (T, nr, 16)
        m = ubytes[:, r0:r1]
        k = torch.arange(8)
        if stage == 1:
            incl = r0u[..., None] + _popc(m[..., None] & ((2 << k) - 1))
            kin = _div(incl + f - 1, f) - _div(rb + f - 1, f)[..., None,
                                                               None]
            acc = kin.sum((1, 2, 3))
        elif stage == 2:
            # kept rank i of [ceil(r0/f), ceil((r0 + popc(m))/f)): valid
            # pixel i*f - r0 of the unit, at most 8 a unit
            i0 = _div(r0u + f - 1, f)
            i1 = _div(r0u + _popc(m) + f - 1, f)
            i = i0[..., None] + k                           # (T,nr,16,8)
            take = i < i1[..., None]
            q = torch.where(take, i * f - r0u[..., None], 0)
            kk = _select(torch.stack([m[..., None].expand_as(q)] + [
                torch.zeros_like(q)] * 3, -1), q)           # the bit of m
            lane = (u * 8)[..., None] + kk
            val = torch.gather(raw[:, r0:r1].reshape(T, nr, 16, 8), -1,
                               kk.clamp(max=7)) + lane
            acc = torch.where(take, val, 0).sum((1, 2, 3))
        else:
            thin = K > S
            kb0 = _div(base + f - 1, f)
            kb1 = _div(base + Vc + f - 1, f)
            s0 = torch.where(thin, _inv(kb0, K.clamp(min=1), S, t32), kb0)
            s1 = torch.where(thin, _inv(kb1, K.clamp(min=1), S, t32), kb1)
            s = torch.arange(S).expand(T, S)
            own = (s >= s0[:, None]) & (s < s1[:, None])
            writers += own.to(torch.int64)
            ts = torch.where(thin[:, None], _fwd(
                s, K[:, None].clamp(min=1), S, t32), s)
            v = torch.where(own, ts * f - base[:, None], 0)  # local rank
            lo_, hi_ = torch.zeros_like(v), torch.full_like(v, nr - 1)
            while bool((lo_ < hi_).any()):                   # its row
                mid = (lo_ + hi_ + 1) >> 1
                le = torch.gather(rrank, 1, mid) <= v
                act = lo_ < hi_
                lo_ = torch.where(act & le, mid, lo_)
                hi_ = torch.where(act & ~le, mid - 1, hi_)
            wrow = torch.gather(w, 1, lo_[..., None].expand(T, S, 4))
            rr = torch.gather(rrank, 1, lo_)
            rows = raw[:, r0:r1].reshape(T, nr * 128)
            if stage == 3:
                rbs = base[:, None] + rr
                j = _div(rbs + f - 1, f) * f - rbs
                q = _select(wrow, torch.where(own, j, 0))
                val = torch.gather(rows, 1, lo_ * 128 + q) >> 8
                acc = torch.where(own, val, 0).sum(1)
            else:
                q = _select(wrow, torch.where(own, v - rr, 0))
                p = (r0 + lo_) * 128 + q
                z = torch.gather(draw[:, r0:r1].reshape(T, -1), 1,
                                 lo_ * 128 + q) * scale
                slot = torch.stack([(p % W).float(), (p // W).float(), z,
                                    torch.ones_like(z)], -1)
                out[:, 0::2] = torch.where(own[..., None], slot,
                                           out[:, 0::2])
                out[:, 1::2] = torch.where(own[..., None], 0.0,
                                           out[:, 1::2])
            if c == C - 1:                    # the empty slots s >= K
                empty = (s >= K[:, None]) & (K[:, None] < S)
                writers += empty.to(torch.int64)
                if stage == 3:
                    rbl = base + rrank[:, -1]
                    kr = _div(rbl + f - 1, f)
                    has = kr < K
                    ql = _select(w[:, -1], torch.where(has, kr * f - rbl, 0))
                    vl = torch.gather(rows, 1, ((nr - 1) * 128 + ql)[:, None])
                    acc = acc + torch.where(has & (K < S),
                                            (S - K) * (vl[:, 0] >> 8), 0)
                else:
                    pl = (R - 1) * 128
                    e = torch.tensor([pl % W, pl // W, 0.0, 0.0])
                    out[:, 0::2] = torch.where(empty[..., None], e,
                                               out[:, 0::2])
                    out[:, 1::2] = torch.where(empty[..., None], 0.0,
                                               out[:, 1::2])
        sums.append(acc)
    if stage == 4:
        return out.reshape(T, S, 8), writers
    tot = torch.stack(sums, 1).sum(1)      # gathered in the last CTA
    v = {1: 2 * K + tot, 2: K + tot, 3: tot}[stage]
    return _fill(out, v.to(torch.float32), S), writers


def _fill(out, v, S):
    """The last CTA's fill: v into every element of the track."""
    out[:] = v[:, None, None]
    return out.reshape(out.shape[0], S, 8)


def _check(draw, budget, frac, W, Cs=(4,), stages=range(5)):
    """Every stage at each C equal to stage_plain; every slot owned once.
    Returns the kept counts."""
    scal = scalars()
    for stage in stages:
        want = stage_plain(draw, scal, stage, budget, frac, W)
        for C in Cs:
            got, writers = staged_order(draw, scal, stage, budget, frac, W, C)
            assert torch.equal(got, want), (stage, C, frac, budget)
            if stage >= 3:
                assert bool((writers == 1).all()), (stage, C)
    v = (draw * torch.tensor(scal[2]) >= scal[0]) & (
        draw * torch.tensor(scal[2]) < scal[1])
    return -(-v.reshape(draw.shape[0], -1).sum(1) // frac)


@pytest.mark.parametrize("frac", [1, 3, 4, 5, 16])
def test_order_on_synthetic_depths(frac):
    """K = 0, K < S, K = S and K > S at C = 4 (the launcher's) and 3
    (slices of 200 rows)."""
    S = 2048
    draw = to_raster(torch.from_numpy(synthetic_depths(
        5, 240, 320, seed=20 + frac, frac=frac, budget=S).view(np.int16)))
    K = _check(draw, S, frac, 320, Cs=(4, 3))
    assert (K == 0).any() and (K == S).any()
    assert ((K > 0) & (K < S)).any() and (K > S).any()


def test_order_on_renders():
    """The cached dyn30 renders and seeded rasters of test_torch_tools at
    C = 1, 2, 4, 8 and the default budget, then budgets that make each K
    < S with a last row of value > 0 (the empty-slot trap)."""
    draw = to_raster(torch.from_numpy(rasters().view(np.int16)))
    _check(draw, 2048, 4, 320, Cs=(1, 2, 4, 8))
    K = _check(draw, 8192, 4, 320, Cs=(4,), stages=(3, 4))
    assert bool((K < 8192).all())


def test_empty_slot_trap():
    """K < S, and the last row holds a kept pixel of high byte > 0: its
    value counts once for each empty slot (stage_plain's searchsorted
    picks the last row for every t_s >= K); K = 0 gives 0."""
    d = np.zeros((2, 48, 64), np.uint16)
    d[0, -1, ::3] = 600                    # the last row: depth 0.6 m
    d[0, 10, :5] = 300
    draw = to_raster(torch.from_numpy(d.view(np.int16)))
    for frac in (1, 3, 16):
        K = _check(draw, 100, frac, 64, Cs=(1, 4, 7), stages=(3, 4))
        assert K[0] < 100 and K[1] == 0
        got = stage_plain(draw, scalars(), 3, 100, frac, 64)[:, 0, 0]
        assert got[0] >= (100 - K[0]) * (600 >> 8) and got[1] == 0


def test_order_more_ctas_than_rows():
    """A raster of 3 rows at C = 8: five CTAs own no rows and no slots;
    budgets 1 and 7."""
    draw = to_raster(torch.from_numpy(synthetic_depths(
        5, 8, 48, seed=5, frac=3, budget=7).view(np.int16)))
    for frac, budget in ((3, 7), (1, 1), (5, 7)):
        _check(draw, budget, frac, 48, Cs=(8, 5))


def test_order_past_the_32_bit_thinning_map():
    """A 1024 x 1024 raster, every pixel valid, frac 1, S = 5000: K =
    2^20 > S and K*(S+1) > 2^32, so the float64 estimate and the search
    of products take the thinning map."""
    rng = np.random.default_rng(3)
    d = rng.integers(101, 699, (1, 1024, 1024)).astype(np.uint16)
    draw = to_raster(torch.from_numpy(d.view(np.int16)))
    assert not thin32(1 << 20, 1, 5000)
    _check(draw, 5000, 1, 1024, Cs=(8,), stages=(3, 4))


def test_frac_divisor_exhaustive():
    """floor(n / frac) for every numerator below 2^21 (ranks below 2^20
    plus frac - 1) and every frac 1-16, with a 32-bit multiplier."""
    n = np.arange(1 << 21, dtype=np.uint64)
    for frac in range(1, 17):
        mul, shift = frac_divisor(frac)
        assert 0 <= mul <= M32
        q = (n >> np.uint64(shift) if mul == 0
             else ((n * np.uint64(mul)) >> np.uint64(32)) >> np.uint64(shift))
        assert np.array_equal(q, n // np.uint64(frac)), frac


def test_thinning_map_32_bit_range():
    """Over every raster size the wrapper accepts (H*W = 128..2^20 in
    steps of 128) and every frac: at the largest budget the launcher sends
    to 32 bits, s*K and kb*S + K - 1 stay below 2^32 for every s < S and
    kb <= K <= ceil(H*W/frac); one past it, they can pass it.  Then the
    32-bit map and its inverse against exact division, every s and kb, at
    the 32-bit limit of sampled sizes, and the float64 path past it."""
    HW = np.arange(128, (1 << 20) + 1, 128, dtype=np.uint64)
    for frac in range(1, 17):
        kmax = (HW + np.uint64(frac - 1)) // np.uint64(frac)
        smax = (np.uint64(1 << 32) // kmax) - np.uint64(1)   # thin32 holds
        assert np.all(kmax * (smax + np.uint64(1)) <= np.uint64(1 << 32))
        assert np.all((smax - np.uint64(1)) * kmax <= np.uint64(M32))
        assert np.all(kmax * smax + kmax - np.uint64(1) <= np.uint64(M32))
        over = kmax * (smax + np.uint64(2))
        assert np.all(over > np.uint64(1 << 32))
        assert all(thin32(int(h), frac, int(s)) and not thin32(
            int(h), frac, int(s) + 1) for h, s in zip(HW[::997], smax[::997]))
    rng = np.random.default_rng(0)
    for hw, frac in ((76800, 1), (1 << 20, 1), (1 << 20, 3),
                     (307200, 1), (1 << 20, 12)):
        kmax = -(-hw // frac)
        S = (1 << 32) // kmax - 1
        assert kmax > S >= 1          # the map is used: S < K <= kmax
        assert thin32(hw, frac, S) and not thin32(hw, frac, S + 1)
        for K in {S + 1, kmax, int(rng.integers(S + 1, kmax + 1))}:
            s = torch.arange(S)
            assert torch.equal(_fwd(s, K, S, True), (s * K) // S)
            kb = torch.arange(K + 1)
            assert torch.equal(_inv(kb, K, S, True), -(-(kb * S) // K))
        # past the limit: the float64 estimate and the search
        S2 = S + 1 + int(rng.integers(0, 1000))
        for K in (S2 + 1, max(S2 + 1, kmax)):
            s = torch.arange(S2)
            assert torch.equal(_fwd(s, K, S2, False), (s * K) // S2)
            kb = torch.arange(0, K + 1, max(1, K // 4096))
            assert torch.equal(_inv(kb, K, S2, False), -(-(kb * S2) // K))
