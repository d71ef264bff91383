"""The yardstick's arithmetic: the card's peaks, and the bytes and float32
operations each port kernel's launch needs, counted from its inputs.

Copied from chip_smoke.py (`PEAK_BYTES_S`, `PEAK_F32_S`, `Smoke.work`,
`pgs_active`, `jacobi_active`, `pgs_row_bytes`, `near_pairs`) so that a
later change to the program cannot move it.  Each input is counted read
once and each output written once; the float32 operations are those the
algorithm needs on these inputs.  One departure: kernels 6 and 7
(`cloud_rows_unpacked`, `cloud_vals`) are counted without their
hull-plane evaluations, whose number only the kernel's own exit counter
gives; their bound is therefore a floor, and their share of it never
reads high.

The launches' arguments are the kernel wrappers' own (registered in the
port's `kernels.WRAPPERS`), as `record_launches` in portbench/trace.py
captures them.
"""
from __future__ import annotations

import torch

PEAK_BYTES_S = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_F32_S = 67e12        # H100 SXM float32 outside the tensor cores


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the card takes: max(bytes / peak bytes/s, float32
    operations / peak FLOP/s), in seconds."""
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_F32_S)


def near_pairs(args):
    """Kernel 3's cull on its inputs (vw, nw, dw, aux, pairs, ...): (T, NP)
    bool, the pairs whose bounding spheres meet."""
    aux, pairs = args[3], args[4]
    a, b = pairs[:, 0], pairs[:, 1]
    dc = [aux[:, a, 6 + c] - aux[:, b, 6 + c] for c in range(3)]
    rs = aux[:, a, 9] + aux[:, b, 9]
    return dc[0] * dc[0] + dc[1] * dc[1] + dc[2] * dc[2] <= rs * rs


def pgs_active(args):
    """The PGS inputs' active slots (summed over the tracks, each track's
    last active slot) and each linear class's active groups ((T, G) bool
    for a friction class, else None)."""
    plan, singles, lin_rows = args[0], args[5], args[6]
    act = singles[:, :, 9].abs().sum(-1) > 0              # (T, CS)
    idx = torch.arange(1, act.shape[1] + 1, device=act.device)
    g_acts = [rows[:, :, 15].abs().sum(-1).reshape(
                  rows.shape[0], cls.n_groups, cls.U).sum(-1) > 0
              if cls.friction else None
              for cls, rows in zip(plan.lin_classes, lin_rows)]
    return int((act * idx).amax(-1).sum()), g_acts


def jacobi_active(rows):
    """A jacobi class's active units and kept phases a track ((T,) each):
    a unit or a phase with a row whose dinv (channel 15) is not 0."""
    d = rows[:, :, 15] != 0                               # (T, U, W)
    return d.any(1).sum(-1), d.any(2).sum(-1)


def pgs_row_bytes(args):
    """The bytes of the row blocks a PGS sweep needs: the active slots,
    the active contact groups, every other class's rows; of a jacobi class
    the active units on the kept phases, without their dinv."""
    plan, mom0, lin_rows, ang_rows = args[0], args[3], args[6], args[7]
    nact, g_acts = pgs_active(args)
    n = nact * 14 * mom0.shape[2] * 4
    for cls, rows, g_act in zip(plan.lin_classes, lin_rows, g_acts):
        if cls.jacobi:
            units, kept = jacobi_active(rows)
            n += int((kept * units).sum()) * 22 * 4
        elif cls.friction:
            n += int(g_act.sum()) * cls.U * 23 * cls.W * 4
        else:
            n += rows.numel() * 4
    return n + sum(rows.numel() * 4 for rows in ang_rows)


def launch_work(name: str, args) -> tuple:
    """(bytes the launch must move, float32 operations it needs) for a
    call of the port kernel wrapper `name` with positional `args`."""
    if name == "cloud_from_depth":
        depth, budget = args[0], args[5]
        T, H, W = depth.shape
        return (T * H * W * 2 + T * 8 * budget * 4,
                T * (H * W * 3 + budget * 8))
    if name in ("cloud_rows_solve", "cloud_rows_packed"):
        pts, planes, body, misc, C = args[:5]
        T, _, N = pts.shape
        P, B = planes.shape[1] // 5, planes.shape[2]
        nin = sum(x.numel() * 4 for x in (pts, planes, body, misc))
        ch = 12 if name == "cloud_rows_solve" else 16
        nout = T * ch * 24 * C * 4 + T * 24 * 4
        # hull scan (3 mul, 3 add, 1 max a plane), the winner's planes
        # again (max, blend, slab clip), spheres, the row and its prep
        per_pt = B * P * 7 + P * 23 + B * 12 + 80
        return nin + nout, T * N * per_pt
    if name == "contact_fields":
        vw, nw, dw, aux, pairs, npt = args[:6]
        T, _, B, V = vw.shape
        P = nw.shape[-1]
        near = int(near_pairs(args).sum())
        NP = pairs.shape[0]
        nin = sum(x.numel() * 4 for x in (vw, nw, dw, aux))
        # two face scans (3 mul, 2 add, 1 min a vert-plane pair), support
        # refinement, manifold; a culled pair costs its cull
        ops = near * (2 * P * V * 6 + 4 * 2 * V * 7 + V * 15 + 200) \
            + (T * NP - near) * 10
        return nin + pairs.numel() * 4 + T * NP * 12 * npt * 4, ops
    if name in ("cloud_vals", "cloud_rows_unpacked"):
        pts, planes, body, misc = args[:4]
        T, _, N = pts.shape
        B = planes.shape[2]
        nin = sum(x.numel() * 4 for x in (pts, planes, body, misc))
        ops = T * N * B * 12                    # the spheres alone
        nout = T * (2 if name == "cloud_vals" else 8) * N * 4
        return nin + nout, ops
    if name == "pgs_solve":
        plan, it, ip, mom0, mi, singles, lin_rows, ang_rows = args[:8]
        T, _, bp = mom0.shape
        B = len(plan.massinv)                 # the real bodies
        nact, g_acts = pgs_active(args)
        nbytes = pgs_row_bytes(args) + mom0.numel() * 4 * 3
        sweeps = it + ip
        ops = nact * B * 32 * sweeps
        for cls, rows, g_act in zip(plan.lin_classes, lin_rows, g_acts):
            if cls.jacobi:        # the active units on the kept phases
                units, kept = jacobi_active(rows)
                nbytes += T * cls.n_phases * cls.W * 4        # every dinv
                ops += int((units * kept).sum()) * 60 * sweeps
            elif cls.friction:
                real = torch.tensor((cls.unit_b0 >= 0).sum(-1),
                                    device=rows.device)
                units = int((g_act * real).sum())
                nbytes += T * cls.n_phases * cls.W * 4
                ops += units * cls.U * 60 * sweeps
            else:
                units = int((cls.unit_b0 >= 0).sum())
                ops += T * units * cls.U * 60 * sweeps
        for cls, rows in zip(plan.ang_classes, ang_rows):
            units = int((cls.unit_b0 >= 0).sum())
            ops += T * units * cls.U * 30 * sweeps
        return nbytes, ops
    return None


def net_ops(params: dict, n: int, size: int) -> int:
    """Float32 operations of the pose net's forward pass (cnn/model.py
    `forward`: conv, tanh, 2x2 pool twice, conv, tanh, pool, two dense
    layers) on n (size, size) inputs: 2 a multiply-add of each
    convolution and dense layer, from the weights' shapes (conv weights
    HWIO, dense (in, out))."""
    kh, kw, cin, cout = params["conv1"]["w"].shape
    h = size - kh + 1
    ops = h * h * kh * kw * cin * cout
    h = h // 4
    kh, kw, cin, cout = params["conv2"]["w"].shape
    h = h - kh + 1
    ops += h * h * kh * kw * cin * cout
    for k in ("fc1", "fc2"):
        i, o = params[k]["w"].shape
        ops += i * o
    return 2 * ops * n
