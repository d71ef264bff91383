"""Kernel 7's order (csrc/cloud_rows.cu cloud_vals_kernel), stated in
PyTorch and held bit for bit to ops/cloud_rows.cloud_vals_plain: each
thread takes K consecutive points, a warp 32 threads; the spheres' strict-<
scan gives the first best; then body by body the hull's running max over
its planes, and after every CHUNK planes the warp leaves the body when each
of its points has a partial max >= its best (that body cannot win under
strict <, and its value is never read).  On seeded synthetic clouds
(ops/cloud_rows.synthetic_cloud: crowded bodies, centre points where the
inner sphere ties with or beats the hull, inactive points, N not a
multiple of a warp's points) and on a cached render's cloud, the winners
and values equal the plain version's, and the exit skips planes."""
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
    _kernel_inputs_ph, cloud_vals_plain, synthetic_cloud)
from tests.conftest import cached_fake_depths

torch.set_num_threads(1)

THREADS = 512    # CV_THREADS: threads a block
K = 4            # CV_K: consecutive points a thread
CHUNK = 8        # CV_CHUNK: planes between the warp's exit votes


def blocked_vals(pts_h, planes_t, body_sc, strided=False, winners=False,
                 k=K):
    """Kernel 7's order: (T, 2, N) [winner value, winner body], the planes
    the warps scanned, summed (the kernel's evals counter), and the planes
    a full scan takes; with winners, also the winner index (T, N) (widx <
    B: the sphere of body widx, else the hull of body widx - B).  k: the
    consecutive points a thread (kernel 6 takes 2).  strided: a thread's K
    points THREADS apart (p = j * THREADS + tid in a block of THREADS * K
    points) instead of consecutive, the layout the kernel does not take
    (for the share of planes each layout scans; N a multiple of
    THREADS * K)."""
    T, _, N = pts_h.shape
    P, B = planes_t.shape[1] // 5, planes_t.shape[2]
    P8 = -(-P // CHUNK) * CHUNK
    warp_pts = 32 * k
    nw = -(-N // warp_pts)
    Np = nw * warp_pts
    pts = torch.nn.functional.pad(pts_h[:, 0:3], (0, Np - N))  # (T, 3, Np)
    px, py, pz = pts[:, 0], pts[:, 1], pts[:, 2]              # (T, Np)
    inside = torch.arange(Np) < N
    idx = torch.arange(Np)
    if strided:
        assert N % (THREADS * K) == 0 and k == K
        warp = (idx // (THREADS * K)) * (THREADS // 32) \
            + (idx % THREADS) // 32
    else:
        warp = idx // warp_pts
    perm = torch.argsort(warp, stable=True)        # the warps' points, in turn
    best = torch.zeros_like(px)
    widx = torch.zeros(px.shape, dtype=torch.int64)
    for b in range(B):
        dx = px - body_sc[:, 0, b:b + 1]
        dy = py - body_sc[:, 1, b:b + 1]
        dz = pz - body_sc[:, 2, b:b + 1]
        sv = sqrt(dot3(dx, dy, dz, dx, dy, dz)) - body_sc[:, 3, b:b + 1]
        win = (sv < best) | (b == 0)
        best = torch.where(win, sv, best)
        widx = torch.where(win, torch.full_like(widx, b), widx)
    scanned = 0
    for b in range(B):
        c = lambda k: planes_t[:, k * P:(k + 1) * P, b:b + 1]    # (T, P, 1)
        v = dot3(c(0), c(1), c(2), px[:, None], py[:, None],
                 pz[:, None]) + c(3)                              # (T, P, Np)
        v = torch.nn.functional.pad(v, (0, 0, 0, P8 - P),
                                    value=-float("inf"))
        run = torch.cummax(v, dim=1).values                   # the fmax chain
        hv = run[:, -1]
        left = torch.zeros((T, nw), dtype=torch.bool)
        for q in range(CHUNK, P8 + 1, CHUNK):
            part = run[:, q - 1]
            lost = ((part >= best) | ~inside)[:, perm].reshape(
                T, nw, warp_pts).all(-1)
            leave = lost & ~left
            # a warp that leaves keeps its partial max (>= best, never read)
            at = torch.empty_like(inside.expand(T, Np))
            at[:, perm] = leave.repeat_interleave(warp_pts, 1)
            hv = torch.where(at, part, hv)
            scanned += int((~left).sum()) * CHUNK
            left |= leave
        win = hv < best
        best = torch.where(win, hv, best)
        widx = torch.where(win, torch.full_like(widx, B + b), widx)
    wb = torch.where(widx >= B, widx - B, widx)
    out = torch.stack([best, wb.to(torch.float32)], dim=1)[..., :N]
    if winners:
        return out, scanned, T * nw * B * P8, widx[..., :N]
    return out, scanned, T * nw * B * P8


@pytest.fixture(scope="module")
def port(hand_model):
    return from_numpy_model({k: np.asarray(v) for k, v in
                             vars(hand_model).items()}, "cpu")


@pytest.fixture(scope="module")
def bank():
    return load_animbank(DEFAULT_ANIMBANK)


def _inputs(port, pose, ph):
    B = pose.shape[1]
    planes_t, body_sc, _ = _kernel_inputs_ph(pose, port, (0.0, 0.0, 0.0),
                                             torch.zeros(B), 0.0)
    return ph.contiguous(), planes_t, body_sc


@pytest.mark.parametrize("n", [2048, 300, 32])
def test_blocked_exit_equals_plain_synthetic(n, port, bank):
    pose = torch.tensor(bank[[0, 30, 11, 2]])
    args = _inputs(port, pose, synthetic_cloud(pose, n, seed=n))
    mine, scanned, full = blocked_vals(*args)
    plain = cloud_vals_plain(*args)
    assert torch.equal(mine, plain)
    assert scanned <= full
    if n == 2048:
        # the inner sphere wins where a point sits on a body's centre
        assert (plain[:, 0] < 0).any()


def test_blocked_exit_equals_plain_render(port, bank, hand_model):
    """The cached dyn30 render 12's cloud (N=2048) against its own pose,
    the pose 2 cm off and another bank pose: the exit skips planes."""
    dyn = cached_fake_depths(hand_model, np.asarray(bank[:30])[:, None],
                             "dyn30")[:, 0]
    ph = cloud_from_depth_planes(depth_tensor(dyn[[12, 12, 12]], "cpu"),
                                 synth_camera(), 0.1, 0.7, 4, 2048)
    pose = torch.tensor(bank[[12, 12, 200]])
    pose[1, :, 0] += 0.02
    args = _inputs(port, pose, ph)
    mine, scanned, full = blocked_vals(*args)
    assert torch.equal(mine, cloud_vals_plain(*args))
    assert scanned < 0.8 * full
    strided, scanned_s, _ = blocked_vals(*args, strided=True)
    assert torch.equal(strided, mine)
    assert scanned < scanned_s


def scanned_shares():
    """The share of hull planes each layout scans on the dyn30 renders 0,
    10, 20 and 29 (N=2048) against their own poses, the poses 3 cm off in
    x and the bank poses 100-400: {(poses, layout): share}."""
    from tests.conftest import hand_model
    m = hand_model.__wrapped__()
    p = from_numpy_model({k: np.asarray(v) for k, v in vars(m).items()},
                         "cpu")
    bk = load_animbank(DEFAULT_ANIMBANK)
    dyn = cached_fake_depths(m, np.asarray(bk[:30])[:, None], "dyn30")
    fr = [0, 10, 20, 29]
    ph = cloud_from_depth_planes(depth_tensor(dyn[fr, 0], "cpu"),
                                 synth_camera(), 0.1, 0.7, 4, 2048)
    off = bk[fr].copy()
    off[:, :, 0] += 0.03
    out = {}
    for name, poses in (("own", bk[fr]), ("3 cm off", off),
                        ("bank 100-400", bk[[100, 200, 300, 400]])):
        args = _inputs(p, torch.tensor(poses), ph)
        for layout in ("consecutive", "strided"):
            _, n, full = blocked_vals(*args, strided=layout == "strided")
            out[(name, layout)] = n / full
    return out


if __name__ == "__main__":
    # python -m tests.test_torch_vals_exit
    for key, share in scanned_shares().items():
        print(f"{key[0]:>13} {key[1]:>11}: {share:.3f} of the planes scanned")
