"""Kernel 1's order (csrc/cloud_kernel.cu), stated in PyTorch and held bit
for bit to ops/cloud_kernel.cloud_from_depth_planes_plain:

  * the valid depths as one integer interval [ulo, uhi) (valid_range);
  * the raster read as loads of 8 pixels in tiles of THREADS loads (load
    l = tile * THREADS + thread), each load's valid mask, the warps'
    exclusive prefixes of the valid counts and the tile-major scan of the
    (tile, warp) totals give every valid pixel its raster-order rank;
  * the kept ranks: arithmetic for a power-of-two frac (r % frac == 0,
    ceil(X / frac) kept below rank X), else the float rule per valid pixel
    and a second scan of the same shape over the kept counts;
  * each kept pixel writes its own slot by the inverse thinning map
    (K > S: slot ceil(k*S/K) when it is < S and floor(s*K/S) == k), then
    the constant rows and the empty slots.

On ops/cloud_kernel.synthetic_depths at frac 1, 3, 4 and 5 (K = 0, K < S,
K = S and K > S all occur), every slot is written exactly once and the
result equals the plain version's.  The inverse map is also checked
exhaustively in integers against floor(s*K/S)."""
import pytest
import torch

from hand_tracking_samples_tpu_torch.data.synth import synth_camera
from hand_tracking_samples_tpu_torch.ops.cloud_kernel import (
    _scalars, cloud_from_depth_planes_plain, depth_tensor, synthetic_depths,
    valid_range)

torch.set_num_threads(1)

THREADS = 512          # CK_THREADS of the kernel
H, W, S = 240, 320, 2048


def _tile_scan(counts):
    """counts (T, ntile, THREADS) per load -> the exclusive tile-major
    prefix of each load (T, ntile, THREADS) and the total (T,): the warps'
    inclusive scans (their exclusive prefix is the kernel's byte, at most
    248), then one scan over the (tile, warp) totals in order."""
    T, nt, _ = counts.shape
    c = counts.reshape(T, nt, THREADS // 32, 32)
    inc = torch.cumsum(c, dim=-1)
    pre = inc - c
    assert int(pre.max()) <= 248
    tot = inc[..., -1].reshape(T, -1)                       # (T, nt*NW)
    base = (torch.cumsum(tot, dim=1) - tot).reshape(T, nt, THREADS // 32, 1)
    return (base + pre).reshape(T, nt, THREADS), tot.sum(1)


def tile_order_cloud(depth, cam, lo, hi, frac, budget):
    """Kernel 1's order in PyTorch: depth (T, H, W) int16 ->
    (T, 8, budget)."""
    T, Hh, Ww = depth.shape
    HW = Hh * Ww
    k = _scalars(cam, lo, hi, frac)
    nl = -(-HW // 8)
    ntile = -(-nl // THREADS)
    raw = torch.zeros((T, ntile * THREADS * 8), dtype=torch.int64)
    raw[:, :HW] = depth.reshape(T, HW).to(torch.int64) & 0xFFFF
    # the range test in integers: [ulo, uhi) from all 65,536 depths
    ulo, uhi = valid_range(k["scale"], k["lo"], k["hi"])
    inside = torch.arange(raw.shape[1]) < HW
    valid = ((raw >= ulo) & (raw < uhi) & inside).reshape(
        T, ntile, THREADS, 8)
    vi = valid.to(torch.int64)
    # pass 1: the valid rank of each pixel
    vbase, V = _tile_scan(vi.sum(-1))
    rank = vbase[..., None] + torch.cumsum(vi, -1) - vi
    if frac & (frac - 1) == 0:
        kept = valid & (rank % frac == 0)
        krank = rank // frac
        K = -(-V // frac)
    else:
        rf = rank.to(torch.float32)
        kept = valid & (torch.floor(rf * k["inv_frac"]) * float(frac) == rf)
        ki = kept.to(torch.int64)
        kbase, K = _tile_scan(ki.sum(-1))
        krank = kbase[..., None] + torch.cumsum(ki, -1) - ki
    assert torch.equal(K, kept.reshape(T, -1).sum(1))
    # pass 3: each kept pixel into its slot (the inverse thinning map)
    Kc = K[:, None, None, None]
    thin = Kc > budget
    Kd = torch.clamp(Kc, min=1)               # where the map is not used
    s = torch.where(thin, (krank * budget + Kd - 1) // Kd, krank)
    take = kept & (s < budget) & (~thin | ((s * Kc) // budget == krank))
    tt, ti, th, tb = torch.nonzero(take, as_tuple=True)
    slot = s[tt, ti, th, tb]
    flat = (ti * THREADS + th) * 8 + tb
    out = torch.full((T, 8, budget), float("nan"))
    hits = torch.zeros((T, budget), dtype=torch.int64)
    hits.index_put_((tt, slot), torch.ones_like(slot), accumulate=True)
    z = raw[tt, flat].to(torch.float32) * k["scale"]
    px = (flat % Ww).to(torch.float32)
    py = (flat // Ww).to(torch.float32)
    out[tt, 0, slot] = (px - k["cx"]) * k["rfx"] * z
    out[tt, 1, slot] = (py - k["cy"]) * k["rfy"] * z
    out[tt, 2, slot] = z
    out[tt, 4, slot] = 1.0
    # the strided loop: rows 3, 5-7, and the empty slots (the last pixel)
    filled = torch.clamp(K, max=budget)
    empty = torch.arange(budget)[None, :] >= filled[:, None]
    assert torch.equal(hits, (~empty).to(torch.int64))   # each slot once
    zl = raw[:, HW - 1].to(torch.float32) * k["scale"]
    xl = (torch.tensor(float((HW - 1) % Ww)) - k["cx"]) * k["rfx"] * zl
    yl = (torch.tensor(float((HW - 1) // Ww)) - k["cy"]) * k["rfy"] * zl
    for row, val in ((0, xl), (1, yl), (2, zl), (4, torch.zeros(T))):
        out[:, row] = torch.where(empty, val[:, None], out[:, row])
    out[:, 3] = 1.0
    out[:, 5:8] = 0.0
    assert not torch.isnan(out).any()
    return out, K


@pytest.mark.parametrize("frac", [1, 3, 4, 5])
def test_tile_order_equals_plain(frac):
    cam = synth_camera()
    depth = depth_tensor(synthetic_depths(10, H, W, seed=frac, frac=frac,
                                          budget=S), "cpu")
    mine, K = tile_order_cloud(depth, cam, 0.1, 0.7, frac, S)
    assert (K == 0).any() and (K == S).any()
    assert ((K > 0) & (K < S)).any() and (K > S).any()
    plain = cloud_from_depth_planes_plain(depth, cam, 0.1, 0.7, frac, S)
    assert torch.equal(mine, plain)


def test_tile_order_small_budget_and_odd_width():
    """Budgets 1 and 7 on a small raster whose rows are not whole loads
    (W = 54: a load spans two rows) and whose last tile is partly empty."""
    cam = synth_camera()
    depth = depth_tensor(synthetic_depths(5, 40, 54, seed=7, frac=3,
                                          budget=7), "cpu")
    for frac, budget in ((3, 7), (4, 1)):
        mine, _ = tile_order_cloud(depth, cam, 0.1, 0.7, frac, budget)
        plain = cloud_from_depth_planes_plain(depth, cam, 0.1, 0.7, frac,
                                              budget)
        assert torch.equal(mine, plain)


@pytest.mark.parametrize("scale", [0.001, 0.000125, 0.0003, 1.7e-5])
def test_valid_range_is_the_float_rule(scale):
    """Every u16 depth: ulo <= u < uhi exactly where the plain version's
    float32 test holds, for depth scales of real cameras and odd ones."""
    k = _scalars(type("Cam", (), dict(depth_scale=scale, principal=(0, 0),
                                      focal=(1, 1)))(), 0.1, 0.7, 4)
    ulo, uhi = valid_range(k["scale"], k["lo"], k["hi"])
    u = torch.arange(65536)
    d = u.to(torch.float32) * k["scale"]
    assert torch.equal((d >= k["lo"]) & (d < k["hi"]),
                       (u >= ulo) & (u < uhi))
    assert uhi > ulo


def test_inverse_thinning_map_exhaustive():
    """S in 1..64, K in S+1..400: kept rank k takes slot ceil(k*S/K) when
    that slot is < S and maps back to k; every slot s then holds
    floor(s*K/S), and no two ranks share a slot."""
    for S_ in range(1, 65):
        Kv = torch.arange(S_ + 1, 401)[:, None]               # (nK, 1)
        k = torch.arange(400)[None, :]                        # (1, 400)
        s = (k * S_ + Kv - 1) // Kv
        ok = (k < Kv) & (s < S_) & ((s * Kv) // S_ == k)
        slot_of = torch.full((Kv.shape[0], S_), -1)
        rows, cols = torch.nonzero(ok, as_tuple=True)
        counts = torch.zeros((Kv.shape[0], S_), dtype=torch.int64)
        counts.index_put_((rows, s[rows, cols]), torch.ones_like(rows),
                          accumulate=True)
        assert int(counts.max()) == 1
        slot_of[rows, s[rows, cols]] = cols
        want = (torch.arange(S_)[None, :] * Kv) // S_
        assert torch.equal(slot_of, want)
