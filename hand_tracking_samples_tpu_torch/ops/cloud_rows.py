"""Cloud correspondence, row geometry and slot pack: four variants of one
TPU kernel (hand_tracking_samples_tpu/ops/cloud_rows.py:34), each a CUDA
kernel in csrc/cloud_rows.cu with its plain version here:

  cloud_rows_solve     the 12-channel solve-prep pack (kernel 2, the
                       dynamics and MultiStepSim fits on the planes carrier)
  cloud_rows_packed    the 16-channel parity pack (kernel 2.5, the fits on
                       an (N, 3) cloud: the voxel and mirror clouds)
  cloud_rows_unpacked  per-point directed rows without a pack (kernel 6,
                       UnibodyFit: cloud_rows_unibody)
  cloud_vals_k         the winner body and value per point (kernel 7,
                       FitError: cloud_vals_ph)

Per point (physmodel.h:137-181): the winner over 17 sphere and 17 hull
most-above candidates by the reference's strict-< scan order; the slab-clip
ConvexHitCheck of the camera ray against the winner's hull; the
CloudConstraint row; the solve prep of pgs_kernel._prep_singles
(J1 = r1 x n, K1 = Iinv_w J1, dinv, tsm = td/dt).  Per body: the stable rank
of its active points (slot order = point order, pgs_kernel.py:16-17 of the
JAX package), uniform thinning to `slots` with the force scale compensated
by count/slots.

`cloud_rows_solve` is kernel 2's wrapper: on CUDA tensors it launches the
kernel (which replaces the Pallas kernel with solve_ch=True, launched
through _cloud_rows_call_b at :387), on CPU tensors it runs
`cloud_rows_solve_plain`.  Output: packed (T, 12, BP*slots) channels
[n(3), J1(3), K1(3), dinv, tsm, scale], body-major slot blocks, and the
per-body active counts (T, BP).  `cloud_rows_packed` is kernel 2.5's
(pack=True, solve_ch=False; _cloud_rows_call :357 and _cloud_rows_call_b
:387): the same pack with the 16 parity channels
[n(3), J1(3), K1(3), dinv, r1(3), targetdist, scale, active], from which
`cloud_rows_packed_ph` rebuilds the reference-shaped SingleBodyLinear.
The plane values, the world planes and inertia and the row and prep
expressions are the JAX CPU build's contracted ones (maths/fma.py), so the
output equals the JAX package's bit for bit on the CPU.

Off the main path: `pack_slot_map` states in PyTorch how the pack kernels
fill their slots from their winner scan (the table their row pass walks),
and `synthetic_cloud` makes the seeded clouds with a thinned body,
inactive points and inner-sphere winners that the tests and
chip_smoke.py hold the pack kernels and the vals kernel to.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..maths.fma import dot3, fma, sqrt, sub_prod

BP = 24          # body slots (17 padded)
CH = 12          # kernel 2's solve-prep channels
PACK_CH = 16     # kernel 2.5's parity channels


def _origin(origin, T, dev):
    """origin: (3,) floats or a (T, 3) tensor -> (T, 3) tensor."""
    if torch.is_tensor(origin):
        return origin.to(device=dev, dtype=torch.float32).expand(T, 3)
    return torch.tensor(origin, dtype=torch.float32, device=dev).expand(T, 3)


def _kernel_inputs_ph(pose, model, origin, scale_b, dt):
    """The kernel's per-track inputs (JAX ops/cloud_rows.py:485), batched:
    pose (T, B, 7), origin (3,) floats or (T, 3), scale_b (B,) tensor,
    dt float.
    Returns planes_t (T, 5P, B) [world n.x | n.y | n.z | d | d at origin],
    body_sc (T, 16, BP) [pos(3), radius_inner, scale, massinv, iinv(9), 0]
    and misc (T, 8) [origin(3), dt, 0...]."""
    from ..physics.pgs_kernel import _batched_world_iinv
    T, B = pose.shape[0], pose.shape[1]
    dev = pose.device
    pl_c = model.planes                                    # (B, P, 4)
    nlx = pl_c[..., 0].T                                   # (P, B)
    nly = pl_c[..., 1].T
    nlz = pl_c[..., 2].T
    dl = pl_c[..., 3].T
    mask_t = model.plane_mask.T                            # (P, B)
    q = pose[..., 3:7]
    qx, qy, qz, qw = (q[..., 0][:, None], q[..., 1][:, None],
                      q[..., 2][:, None], q[..., 3][:, None])  # (T, 1, B)
    # the JAX package's qrot expansion, contracted as its CPU build runs it
    tx = 2.0 * sub_prod(qy, nlz, qz, nly)
    ty = 2.0 * sub_prod(qz, nlx, qx, nlz)
    tz = 2.0 * sub_prod(qx, nly, qy, nlx)
    wnx = fma(qw, tx, nlx) + sub_prod(qy, tz, qz, ty)
    wny = fma(qw, ty, nly) + sub_prod(qz, tx, qx, tz)
    wnz = fma(qw, tz, nlz) + sub_prod(qx, ty, qy, tx)
    px = pose[..., 0][:, None]
    py = pose[..., 1][:, None]
    pz = pose[..., 2][:, None]
    zero = torch.zeros((), device=dev)
    wnx = torch.where(mask_t, wnx, zero)
    wny = torch.where(mask_t, wny, zero)
    wnz = torch.where(mask_t, wnz, zero)
    ww = dl - dot3(px, py, pz, wnx, wny, wnz)
    ww = torch.where(mask_t, ww, torch.full((), -1e9, device=dev))
    o = _origin(origin, T, dev)
    d0 = dot3(o[:, 0:1, None], o[:, 1:2, None], o[:, 2:3, None],
              wnx, wny, wnz) + ww
    d0 = torch.where(mask_t, d0, torch.full((), -1.0, device=dev))
    planes_t = torch.cat([wnx, wny, wnz, ww, d0], dim=1)   # (T, 5P, B)
    iinv = _batched_world_iinv(q, model.tensorinv_massless, model.massinv)
    rows = [pose[..., 0], pose[..., 1], pose[..., 2],
            model.radius_inner.expand(T, B), scale_b.expand(T, B),
            model.massinv.expand(T, B)]
    rows += [iinv[..., i, j] for i in range(3) for j in range(3)]
    rows.append(torch.zeros((T, B), device=dev))
    body_sc = torch.zeros((T, 16, BP), device=dev)
    body_sc[:, :, :B] = torch.stack(rows, dim=1)
    misc = torch.zeros((T, 8), device=dev)
    misc[:, 0:3] = o
    misc[:, 3] = dt
    return planes_t.contiguous(), body_sc, misc


def _winner_plain(pts_h, planes_t, body_sc):
    """The strict-< winner scan over [17 sphere, 17 hull most-above]
    candidates: (best value, widx (T, N), dist/dxb/dyb/dzb (T, B, N))."""
    P, B = planes_t.shape[1] // 5, planes_t.shape[2]
    dev = pts_h.device
    px, py, pz = pts_h[:, 0:1], pts_h[:, 1:2], pts_h[:, 2:3]   # (T, 1, N)
    body = body_sc[:, :, :B]                                   # (T, 16, B)
    hv = []
    for b in range(B):
        c = lambda k: planes_t[:, k * P:(k + 1) * P, b:b + 1]  # (T, P, 1)
        hv.append((dot3(c(0), c(1), c(2), px, py, pz) + c(3)).amax(dim=1))
    hvals = torch.stack(hv, dim=1)                             # (T, B, N)
    posx, posy, posz = (body[:, k][..., None] for k in range(3))
    dxb = px - posx                                            # (T, B, N)
    dyb = py - posy
    dzb = pz - posz
    dist = sqrt(dot3(dxb, dyb, dzb, dxb, dyb, dzb))
    svals = dist - body[:, 3][..., None]
    vals2 = torch.cat([svals, hvals], dim=1)                   # (T, 2B, N)
    best = vals2.amin(dim=1)                                   # (T, N)
    iota = torch.arange(2 * B, device=dev)[None, :, None]
    widx = torch.where(vals2 == best[:, None], iota,
                       torch.full_like(iota, 2 * B)).amin(dim=1)
    return best, widx, (dist, dxb, dyb, dzb)


def _rows_plain(pts_h, planes_t, body_sc, misc):
    """Correspondence + CloudConstraint row of every point (directed): a
    dict with wb (T, N), n (3 x (T, N)), w1 (3 x (T, N)) and td."""
    T, _, N = pts_h.shape
    P, B = planes_t.shape[1] // 5, planes_t.shape[2]
    dev = pts_h.device
    px, py, pz = pts_h[:, 0:1], pts_h[:, 1:2], pts_h[:, 2:3]   # (T, 1, N)
    best, widx, (dist, dxb, dyb, dzb) = _winner_plain(pts_h, planes_t,
                                                      body_sc)
    use_hull = widx >= B
    wb = torch.where(use_hull, widx - B, widx)                 # (T, N)

    def pick(x):                                               # (T, B, N)
        return torch.gather(x, 1, wb[:, None]).squeeze(1)
    inv = 1.0 / torch.clamp(pick(dist), min=1e-20)
    wnx = pick(dxb) * inv
    wny = pick(dyb) * inv
    wnz = pick(dzb) * inv

    sel = torch.gather(planes_t, 2, wb[:, None].expand(T, 5 * P, N))
    pnx, pny, pnz = sel[:, 0:P], sel[:, P:2 * P], sel[:, 2 * P:3 * P]
    dw = dot3(pnx, pny, pnz, px, py, pz) + sel[:, 3 * P:4 * P]  # (T, P, N)
    dw0 = sel[:, 4 * P:5 * P]
    ohm = (dw == dw.amax(dim=1, keepdim=True)).to(torch.float32)
    cnt = torch.clamp(ohm.sum(1), min=1.0)
    wnx = torch.where(use_hull, (ohm * pnx).sum(1) / cnt, wnx)
    wny = torch.where(use_hull, (ohm * pny).sum(1) / cnt, wny)
    wnz = torch.where(use_hull, (ohm * pnz).sum(1) / cnt, wnz)

    one = torch.ones((), device=dev)
    zero = torch.zeros((), device=dev)
    miss = ((dw0 >= 0) & (dw >= 0)).any(dim=1)
    denom = dw0 - dw
    t = torch.where(denom != 0,
                    dw0 / torch.where(denom == 0, one, denom), zero)
    te = torch.where((dw0 >= 0) & (dw < 0), t, zero).amax(dim=1)
    tx = torch.where((dw0 <= 0) & (dw > 0), t, one).amin(dim=1)
    hit = (~miss) & (te <= tx)
    ox, oy, oz = misc[:, 0:1], misc[:, 1:2], misc[:, 2:3]
    px, py, pz = px[:, 0], py[:, 0], pz[:, 0]                  # (T, N)
    rx, ry, rz = px - ox, py - oy, pz - oz
    rinv = 1.0 / torch.clamp(sqrt(dot3(rx, ry, rz, rx, ry, rz)),
                             min=1e-20)
    front = dot3(rx, ry, rz, wnx, wny, wnz) > 0
    use_ray = front & hit
    w1x = torch.where(use_ray, fma(rx, te, ox), fma(-wnx, best, px))
    w1y = torch.where(use_ray, fma(ry, te, oy), fma(-wny, best, py))
    w1z = torch.where(use_ray, fma(rz, te, oz), fma(-wnz, best, pz))
    nxf = torch.where(use_ray, rx * rinv, wnx)
    nyf = torch.where(use_ray, ry * rinv, wny)
    nzf = torch.where(use_ray, rz * rinv, wnz)
    td = dot3(w1x - px, w1y - py, w1z - pz, nxf, nyf, nzf)
    return dict(wb=wb, n=(nxf, nyf, nzf), w1=(w1x, w1y, w1z), td=td)


def point_rows_plain(pts_h, planes_t, body_sc, misc, slots: int,
                     parity: bool = False):
    """The pack kernels' per-point half in plain PyTorch, the same float32
    operations in the same order.  pts_h (T, 8, N) [x, y, z, 1, mask, ...].
    Returns vals (T, CH, N) (the packed channels of every point: kernel 2's
    12 solve-prep channels, or with parity kernel 2.5's 16), col (T, N)
    (the slot column a point is packed into, -1 where it is not) and the
    per-body counts (T, BP) int32."""
    B = planes_t.shape[2]
    C = slots
    dev = pts_h.device
    one = torch.ones((), device=dev)
    zero = torch.zeros((), device=dev)
    body = body_sc[:, :, :B]                                   # (T, 16, B)
    r = _rows_plain(pts_h, planes_t, body_sc, misc)
    wb, (nxf, nyf, nzf), (w1x, w1y, w1z) = r["wb"], r["n"], r["w1"]
    td = r["td"]
    active = pts_h[:, 4] > 0

    def pick_b(k):                                             # body row k
        return torch.gather(body[:, k], 1, wb)

    r1x = w1x - pick_b(0)
    r1y = w1y - pick_b(1)
    r1z = w1z - pick_b(2)
    Jx = sub_prod(r1y, nzf, r1z, nyf)
    Jy = sub_prod(r1z, nxf, r1x, nzf)
    Jz = sub_prod(r1x, nyf, r1y, nxf)
    iw = [pick_b(6 + k) for k in range(9)]
    Kx = dot3(iw[0], iw[1], iw[2], Jx, Jy, Jz)
    Ky = dot3(iw[3], iw[4], iw[5], Jx, Jy, Jz)
    Kz = dot3(iw[6], iw[7], iw[8], Jx, Jy, Jz)
    ccx = sub_prod(Ky, r1z, Kz, r1y)
    ccy = sub_prod(Kz, r1x, Kx, r1z)
    ccz = sub_prod(Kx, r1y, Ky, r1x)
    den = pick_b(5) + dot3(ccx, ccy, ccz, nxf, nyf, nzf)
    dinv = torch.where(active & (den != 0),
                       1.0 / torch.where(den == 0, one, den), zero)

    oh = (wb[:, None] == torch.arange(BP, device=dev)[None, :, None]) \
        & active[:, None]                                      # (T, BP, N)
    cum = torch.cumsum(oh.to(torch.int32), dim=2)
    counts = cum[:, :, -1]                                     # (T, BP)
    rank = torch.gather(cum, 1, wb[:, None]).squeeze(1) - 1    # (T, N)
    cntp = torch.gather(counts, 1, wb)
    rankf = rank.to(torch.float32)
    cntf = cntp.to(torch.float32)
    thin = cntf > C
    safe = torch.clamp(cntf, min=1.0)
    nr = torch.where(thin, torch.floor(rankf * C / safe), rankf)
    prev = torch.floor((rankf - 1.0) * C / safe)
    keep = (~thin) | (rankf == 0) | (nr > prev)
    comp = torch.where(thin, cntf * (1.0 / C), one)
    wsc = pick_b(4) * comp
    if parity:
        tail = [r1x, r1y, r1z, td, wsc, active.to(torch.float32)]
    else:
        tail = [td / misc[:, 3:4], wsc]
    vals = torch.stack([nxf, nyf, nzf, Jx, Jy, Jz, Kx, Ky, Kz, dinv, *tail],
                       dim=1)                                  # (T, CH, N)

    ok = active & keep & (nr < C)
    col = torch.where(ok, wb * C + nr.to(torch.int64),
                      torch.full_like(wb, -1))
    return vals, col, counts


def pack_slot_map(wb, hull, active, slots: int):
    """The pack kernels' slot map in plain PyTorch, built as the kernel
    builds it from its winner scan: wb (T, N) winner body, hull (T, N)
    bool (the hull won), active (T, N) bool; N a multiple of 32.  Each
    32-point segment's active points are counted per body, the counts
    summed over the earlier segments (exclusive prefix), and a point's rank
    is its segment's prefix plus its rank among the segment's points of its
    body; the thinning keeps a point as point_rows_plain does.  Returns the
    slot map (T, BP*slots) int64 (point << 1 | hull in a filled slot, -1 in
    an empty one) and the per-body counts (T, BP) int32."""
    T, N = wb.shape
    C = slots
    dev = wb.device
    key = torch.where(active, wb, torch.full_like(wb, -1))
    oh = (key[:, :, None] == torch.arange(BP, device=dev)).to(torch.int32)
    seg = oh.reshape(T, N // 32, 32, BP)
    seg_n = seg.sum(2)                                        # (T, S, BP)
    prefix = torch.cumsum(seg_n, 1) - seg_n
    lrank = torch.cumsum(seg, 2) - seg                        # in-segment
    counts = seg_n.sum(1)                                     # (T, BP)
    rank_all = (prefix[:, :, None] + lrank).reshape(T, N, BP)
    wbc = wb.clamp(min=0)
    rankf = torch.gather(rank_all, 2, wbc[..., None])[..., 0].to(
        torch.float32)
    cntf = torch.gather(counts, 1, wbc).to(torch.float32)
    thin = cntf > C
    safe = torch.clamp(cntf, min=1.0)
    nr = torch.where(thin, torch.floor(rankf * C / safe), rankf)
    prev = torch.floor((rankf - 1.0) * C / safe)
    keep = (~thin) | (rankf == 0) | (nr > prev)
    ok = active & keep & (nr < C)
    tt, nn = torch.nonzero(ok, as_tuple=True)
    smap = torch.full((T, BP * C), -1, dtype=torch.int64, device=dev)
    smap[tt, wb[tt, nn] * C + nr[tt, nn].to(torch.int64)] = (
        nn * 2 + hull[tt, nn].to(torch.int64))
    return smap, counts


def synthetic_cloud(pose, n: int, seed: int, crowd: float = 0.5,
                    inactive: float = 0.25):
    """Seeded points for the pack kernels' checks, as the planes carrier
    (T, 8, n) on pose's device: around the hands of pose (T, B, 7), a
    `crowd` share within ~5 mm of body 0's centre (so that body wins more
    than 128 active points and its slots are thinned), the rest within
    ~3 cm of a random body's centre, and one point in 16 on a body's
    centre, where the body's inner sphere ties with or beats its hull and
    wins; an `inactive` share masked off."""
    rng = np.random.default_rng(seed)
    T, B = pose.shape[0], pose.shape[1]
    centres = pose[..., :3].detach().cpu().numpy()
    body = rng.integers(0, B, (T, n))
    crowded = rng.random((T, n)) < crowd
    body[crowded] = 0
    spread = np.where(crowded, 0.005, 0.03)
    spread = np.where(rng.random((T, n)) < 1 / 16, 0.0, spread)[..., None]
    pts = (centres[np.arange(T)[:, None], body]
           + rng.standard_normal((T, n, 3)) * spread).astype(np.float32)
    mask = rng.random((T, n)) >= inactive
    return points_planes(torch.tensor(pts, device=pose.device),
                         torch.tensor(mask, device=pose.device))


def _pack_plain(pts_h, planes_t, body_sc, misc, slots: int, parity: bool):
    vals, col, counts = point_rows_plain(pts_h, planes_t, body_sc, misc,
                                         slots, parity)
    T, ch = vals.shape[0], vals.shape[1]
    packed = torch.zeros((T, ch, BP * slots), device=pts_h.device)
    tt, nn = torch.nonzero(col >= 0, as_tuple=True)
    packed[tt, :, col[tt, nn]] = vals[tt, :, nn]
    return packed, counts.to(torch.float32)


def cloud_rows_solve_plain(pts_h, planes_t, body_sc, misc, slots: int):
    """Plain PyTorch version of kernel 2 (see point_rows_plain)."""
    return _pack_plain(pts_h, planes_t, body_sc, misc, slots, False)


def cloud_rows_packed_plain(pts_h, planes_t, body_sc, misc, slots: int):
    """Plain PyTorch version of kernel 2.5 (see point_rows_plain)."""
    return _pack_plain(pts_h, planes_t, body_sc, misc, slots, True)


def _pack_launch(pts_h, planes_t, body_sc, misc, slots: int, parity: bool):
    args = [x.contiguous() for x in (pts_h, planes_t, body_sc, misc)]
    dev = kernels.require_cuda(*args)
    T, _, N = pts_h.shape
    P, B = planes_t.shape[1] // 5, planes_t.shape[2]
    if N % 32 or N > 2048 or 5 * P * B > 8192 or B > BP:
        raise kernels.KernelLimit(
            f"cloud_rows kernel takes N % 32 == 0, N <= 2048, "
            f"5*P*B <= 8192: N={N} P={P} B={B}")
    packed = torch.empty((T, PACK_CH if parity else CH, BP * slots),
                         device=dev)
    counts = torch.empty((T, BP), device=dev)
    lib = kernels.library()
    entry = lib.hts_cloud_rows_packed if parity else lib.hts_cloud_rows_solve
    kernels.launch("cloud_rows_packed" if parity else "cloud_rows_solve",
                   entry, dev, *[a.data_ptr() for a in args],
                   packed.data_ptr(), counts.data_ptr(), T, N, P, B, slots,
                   BP)
    return packed, counts


@kernels.wrapper("cloud_rows_solve")
def cloud_rows_solve(pts_h, planes_t, body_sc, misc, slots: int):
    """Kernel 2's wrapper: see the module docstring for the layouts."""
    if pts_h.device.type == "cpu":
        return cloud_rows_solve_plain(pts_h, planes_t, body_sc, misc, slots)
    out = _pack_launch(pts_h, planes_t, body_sc, misc, slots, False)
    cloud_rows_solve.launches += 1
    return out


@kernels.wrapper("cloud_rows_packed")
def cloud_rows_packed(pts_h, planes_t, body_sc, misc, slots: int):
    """Kernel 2.5's wrapper (replaces hand_tracking_samples_tpu/ops/
    cloud_rows.py:34 with pack=True, solve_ch=False): packed
    (T, 16, BP*slots) parity channels and the counts (T, BP)."""
    if pts_h.device.type == "cpu":
        return cloud_rows_packed_plain(pts_h, planes_t, body_sc, misc, slots)
    out = _pack_launch(pts_h, planes_t, body_sc, misc, slots, True)
    cloud_rows_packed.launches += 1
    return out


def cloud_rows_solve_ph(pose, model, pts_h, origin, scale_per_body,
                        slots: int, dt):
    """The 12-channel solve-prep pack (JAX ops/cloud_rows.py:644), batched
    over the tracks of pose (T, B, 7) and pts_h (T, 8, N)."""
    planes_t, body_sc, misc = _kernel_inputs_ph(pose, model, origin,
                                                scale_per_body, dt)
    return cloud_rows_solve(pts_h.contiguous(), planes_t, body_sc, misc,
                            slots)


def points_planes(points, mask):
    """(T, N, 3) points and (T, N) mask -> the planes carrier (T, 8, N)
    [x, y, z, 1, mask, 0, 0, 0]."""
    T, N, _ = points.shape
    ph = torch.zeros((T, 8, N), device=points.device)
    ph[:, 0:3] = points.transpose(1, 2)
    ph[:, 3] = 1.0
    ph[:, 4] = mask.to(torch.float32)
    return ph


def cloud_rows_packed_planes_ph(pose, model, pts_h, origin, scale_per_body,
                                slots: int):
    """Kernel 2.5's raw output (JAX ops/cloud_rows.py:628), batched over
    the tracks of pose (T, B, 7) and pts_h (T, 8, N): packed
    (T, 16, BP*slots) [n(3), J1(3), K1(3), dinv, r1(3), targetdist, scale,
    active] in body-major slot blocks, and the counts (T, BP).
    scale_per_body (B,) or (T, B)."""
    planes_t, body_sc, misc = _kernel_inputs_ph(pose, model, origin,
                                                scale_per_body, 0.0)
    return cloud_rows_packed(pts_h.contiguous(), planes_t, body_sc, misc,
                               slots)


def cloud_rows_packed_ph(pose, model, pts_h, origin, scale_per_body,
                         slots: int):
    """CloudConstraints + per-body slot packing (JAX ops/cloud_rows.py:610):
    (SingleBodyLinear with (T, slots, B, ...) fields, dropped (T, B)).
    The block is the one pack_single_body_linear builds from the cloud
    rows: normal from channels 0-2, r1 from 10-12, targetdist from 13,
    force limits -+channel 14, active where channel 15 > 0.5; dropped
    counts the rows a body lost to the slot cap."""
    from ..physics.colored import SingleBodyLinear
    packed, counts = cloud_rows_packed_planes_ph(pose, model, pts_h, origin,
                                                 scale_per_body, slots)
    T, B = pose.shape[0], pose.shape[1]
    x = packed.reshape(T, PACK_CH, BP, slots).permute(0, 3, 2, 1)[:, :, :B]
    scale = x[..., 14]
    blk = SingleBodyLinear(
        normal=x[..., 0:3], r1=x[..., 10:13], targetdist=x[..., 13],
        targetspeednobias=torch.zeros_like(x[..., 13]), fmin=-scale,
        fmax=scale, active=x[..., 15] > 0.5)
    return blk, torch.clamp(counts[:, :B] - slots, min=0.0)


# ---------------------------------------------------------------------------
# kernels 6 and 7: per-point rows (UnibodyFit) and winner values (FitError)
# ---------------------------------------------------------------------------

def cloud_rows_unpacked_plain(pts_h, planes_t, body_sc, misc):
    """Plain version of the unpacked kernel: (T, 8, N) rows
    [n(3), w1(3) (world attach point), td, active] in point order."""
    r = _rows_plain(pts_h, planes_t, body_sc, misc)
    act = (pts_h[:, 4] > 0).to(torch.float32)
    return torch.stack([*r["n"], *r["w1"], r["td"], act], dim=1)


def cloud_vals_plain(pts_h, planes_t, body_sc):
    """Plain version of the vals kernel: (T, 2, N) [winner value, winner
    body (as float)]."""
    B = planes_t.shape[2]
    best, widx, _ = _winner_plain(pts_h, planes_t, body_sc)
    wb = torch.where(widx >= B, widx - B, widx)
    return torch.stack([best, wb.to(torch.float32)], dim=1)


def _unpacked_smem(P: int, B: int) -> int:
    """The shared memory kernel 6 stages a track in (csrc ur_smem): its
    planes as float4 records and d-at-origin values, bodies P8 + 1 apart
    (P8 = P rounded up to 8), and the sphere rows."""
    return B * (-(-P // 8) * 8 + 1) * 20 + 16 * B


def _evals_ok(evals, T, dev):
    if evals is not None and (evals.dtype != torch.int64
                              or evals.shape != (T,)
                              or evals.device != dev):
        raise ValueError("evals must be a (T,) int64 tensor on the card")


@kernels.wrapper("cloud_rows_unpacked")
def cloud_rows_unpacked(pts_h, planes_t, body_sc, misc, evals=None):
    """Kernel wrapper (replaces hand_tracking_samples_tpu/ops/
    cloud_rows.py:34 with pack=False, launched by
    _cloud_rows_unpacked_call_b at :430): per-point directed rows.
    evals: None, or a (T,) int64 tensor on the card to which the kernel
    adds the hull planes its warps scanned (a warp scans B * P8 planes
    without its exit, P8 = P rounded up to 8)."""
    if pts_h.device.type == "cpu":
        return cloud_rows_unpacked_plain(pts_h, planes_t, body_sc, misc)
    args = [x.contiguous() for x in (pts_h, planes_t, body_sc, misc)]
    dev = kernels.require_cuda(*args)
    T, _, N = pts_h.shape
    P, B = planes_t.shape[1] // 5, planes_t.shape[2]
    if (B > BP or body_sc.shape[1:] != (16, BP)
            or _unpacked_smem(P, B) > 227 * 1024):
        raise ValueError(f"cloud_rows_unpacked kernel takes B <= {BP} "
                         f"bodies, body_sc (T, 16, {BP}) and P, B whose "
                         f"planes fit 227 KB of shared memory: P={P} B={B}")
    _evals_ok(evals, T, dev)
    out = torch.empty((T, 8, N), device=dev)
    kernels.launch(
        "cloud_rows_unpacked", kernels.library().hts_cloud_rows_unpacked,
        dev, *[a.data_ptr() for a in args], out.data_ptr(),
        0 if evals is None else evals.data_ptr(), T, N, P, B)
    cloud_rows_unpacked.launches += 1
    return out


@kernels.wrapper("cloud_vals")
def cloud_vals_k(pts_h, planes_t, body_sc, misc, evals=None):
    """Kernel wrapper (replaces hand_tracking_samples_tpu/ops/
    cloud_rows.py:34 with vals_only=True, launched at :409 and :430):
    (T, 2, N) [winner value, winner body] per point.  misc is not read.
    evals: None, or a (T,) int64 tensor on the card to which the kernel
    adds the hull planes its warps scanned (a warp scans B * P8 planes
    without its exit, P8 = P rounded up to 8)."""
    if pts_h.device.type == "cpu":
        return cloud_vals_plain(pts_h, planes_t, body_sc)
    args = [x.contiguous() for x in (pts_h, planes_t, body_sc)]
    dev = kernels.require_cuda(*args)
    T, _, N = pts_h.shape
    P, B = planes_t.shape[1] // 5, planes_t.shape[2]
    if B > BP or body_sc.shape[1:] != (16, BP):
        raise ValueError(f"cloud_vals kernel takes B <= {BP} bodies and "
                         f"body_sc (T, 16, {BP}): B={B}")
    _evals_ok(evals, T, dev)
    out = torch.empty((T, 2, N), device=dev)
    kernels.launch(
        "cloud_vals", kernels.library().hts_cloud_vals, dev,
        *[a.data_ptr() for a in args], out.data_ptr(),
        0 if evals is None else evals.data_ptr(), T, N, P, B)
    cloud_vals_k.launches += 1
    return out


def cloud_vals_ph(pose, model, pts_h):
    """FitError's correspondence (JAX ops/cloud_rows.py:564), batched:
    pose (T, B, 7), pts_h (T, 8, N).  Returns (winner body (T, N) int64,
    winner value (T, N))."""
    B = pose.shape[1]
    planes_t, body_sc, misc = _kernel_inputs_ph(
        pose, model, (0.0, 0.0, 0.0), torch.zeros(B, device=pose.device),
        0.0)
    v = cloud_vals_k(pts_h.contiguous(), planes_t, body_sc, misc)
    return v[:, 1].to(torch.int64), v[:, 0]


def cloud_rows_unibody(pose, model, pts_h, origin, uni_pos, force: float):
    """CloudConstraints retargeted to the UnibodyFit free body
    (JAX ops/cloud_rows.py:573, handtrack.h:453-461), batched: the
    correspondence against the whole hand, rows in point order on one body
    with r1 measured from uni_pos (T, 3) and force limits +-force.
    pts_h (T, 8, N); origin (T, 3).  Returns a SingleBodyLinear with
    (T, N, 1, ...) fields."""
    from ..physics.colored import SingleBodyLinear
    B = pose.shape[1]
    planes_t, body_sc, misc = _kernel_inputs_ph(
        pose, model, origin, torch.zeros(B, device=pose.device), 0.0)
    x = cloud_rows_unpacked(pts_h.contiguous(), planes_t, body_sc, misc)
    T, _, N = x.shape
    n = x[:, 0:3].transpose(1, 2)                          # (T, N, 3)
    w1 = x[:, 3:6].transpose(1, 2)
    f = torch.full((T, N, 1), float(force), device=x.device)
    return SingleBodyLinear(
        normal=n[:, :, None], r1=(w1 - uni_pos[:, None])[:, :, None],
        targetdist=x[:, 6][..., None],
        targetspeednobias=torch.zeros((T, N, 1), device=x.device),
        fmin=-f, fmax=f, active=(x[:, 7] > 0.5)[..., None])
