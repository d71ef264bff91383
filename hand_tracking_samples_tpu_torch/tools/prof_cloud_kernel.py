"""Stage-cost attribution inside the point-cloud algorithm (the port's
counterpart of tools/prof_cloud_kernel.py).

Times the staged cloud kernel of csrc/prof_cloud.cu cut after each of its
passes (cloud_stage_kernel<STAGE>, a cluster of CTAs a track, each CTA's
slice of rows copied into shared memory once; each stage writes a value
that depends on everything before the cut) at T tracks over F frames of
the JAX tool's renders:
  stage 0: the copy into shared memory and one reduction: the read floor
  stage 1: + the valid masks, the row scan and the cluster's exchange of
           valid totals
  stage 2: + a pass over the kept pixels (the compaction's sum)
  stage 3: + the slot pick (the TPU's one-hot row pick), slot-major
  stage 4: the full output (px, py, z, ok) a slot, slot-major
  stage 5: the real path, ops.cloud_kernel.cloud_from_depth_planes with its
           deprojection (kernel 1, csrc/cloud_kernel.cu, one block a track)
Stages 0-4 thus attribute the staged design, not kernel 1's passes.  Each
frame converts its u16 rasters to f32 (T, 600, 128), as the JAX tool does
inside its scan.

    PROF_TRACKS=512 python -m hand_tracking_samples_tpu_torch.tools.prof_cloud_kernel [stage ...]
    PROF_TRACKS=2 PROF_FRAMES=1 python -m hand_tracking_samples_tpu_torch.tools.prof_cloud_kernel --device cpu

PROF_FRAMES (8), PROF_REPS (3) and PROF_BUDGET (2048) as in the JAX tool.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import kernels
from .common import (add_device, best_ms, env_int, protocol_frames,
                     render, setup, stage_args, to_raster, wanted)

FRAC = 4
BUDGET = 2048
WIDTH = 320
STAGES = ("0", "1", "2", "3", "4", "5")


def scalars(lo=0.1, hi=0.7, scale=0.001):
    """The JAX tool's scalar row: (lo, hi, scale, 0, 0, 0, 0, 0) as
    float32 values."""
    return [float(np.float32(x)) for x in (lo, hi, scale)] + [0.0] * 5


def frac_divisor(frac: int):
    """(mul, shift) with floor(n / frac) == n >> shift when mul == 0 (a
    power-of-two frac), else (n * mul) >> (32 + shift), for every
    0 <= n < 2^21 (ranks below 2^20 plus frac - 1): mul =
    ceil(2^(32+shift) / frac), shift = floor(log2 frac), a 32-bit
    multiply-high and a shift in the kernel (checked exhaustively by
    tests/test_torch_prof_cloud_order.py)."""
    shift = frac.bit_length() - 1
    if frac & (frac - 1) == 0:
        return 0, shift
    return -(-(1 << (32 + shift)) // frac), shift


def _ceil_div(x, f: int):
    return torch.div(x + (f - 1), f, rounding_mode="floor")


def _check(draw, scal, stage, budget, frac):
    if draw.dim() != 3 or draw.shape[2] != 128 or draw.dtype != torch.float32:
        raise ValueError("draw must be a (T, R, 128) float32 tensor")
    if not 0 <= stage <= 4:
        raise ValueError(f"no stage {stage} (0-4)")
    if not 1 <= frac <= 16 or budget < 1:
        raise ValueError(f"frac {frac} (1-16), budget {budget}")
    if draw.shape[1] * 128 > 1 << 20:
        raise ValueError("at most 2^20 pixels a raster (the integer kept "
                         "rule's checked range)")
    lo, hi, scale = (float(np.float32(x)) for x in list(scal)[:3])
    return lo, hi, scale


def stage_plain(draw, scal, stage: int, budget: int = BUDGET,
                frac: int = FRAC, W: int = WIDTH):
    """What each stage of the JAX tool's kernel writes, in plain PyTorch:
    draw (T, R, 128) f32 (integer u16 depths), scal the 8 scalars (lo, hi,
    scale first) -> (T, budget, 8) f32.  The kept rule and the rows' kept
    bases in their integer forms (csrc/prof_cloud.cu); stages 1-3 sum
    exactly in int64 and round once, stage 0 sums the float32 products in
    float64."""
    lo, hi, scale = _check(draw, scal, stage, budget, frac)
    T, R, _ = draw.shape
    HW, S, dev = R * 128, budget, draw.device
    d = draw * torch.tensor(scale, dtype=torch.float32, device=dev)

    def fill(v):
        return v.to(torch.float32)[:, None, None].expand(T, S, 8).contiguous()
    if stage == 0:
        return fill(d.double().sum((1, 2)))
    v = ((d >= lo) & (d < hi)).reshape(T, HW)
    vi = v.to(torch.int64)
    incl = torch.cumsum(vi, 1)                     # valid count up to p
    rank = incl - vi                               # a valid pixel's rank
    rowbase = incl.reshape(T, R, 128)[:, :, 0] - vi.reshape(T, R, 128)[
        :, :, 0]                                   # valid before a row
    K = _ceil_div(incl[:, -1], frac)               # kept count (total)
    if stage == 1:
        kin = _ceil_div(incl.reshape(T, R, 128), frac) - _ceil_div(
            rowbase, frac)[:, :, None]
        return fill(2 * K + kin.sum((1, 2)))
    kept = v & (rank % frac == 0)
    raw = draw.reshape(T, HW).to(torch.int64)
    pix = torch.arange(HW, device=dev)
    if stage == 2:
        return fill(K + torch.where(kept, raw + (pix & 127), 0).sum(1))
    # the kept pixels by kept rank
    ki = kept.to(torch.int64)
    maxk = -(-HW // frac)
    kpos = torch.where(kept, torch.cumsum(ki, 1) - 1, maxk)
    kidx = torch.zeros((T, maxk + 1), dtype=torch.int64, device=dev)
    kidx.scatter_(1, kpos, pix.expand(T, HW))
    s = torch.arange(S, device=dev)[None, :]
    ts = torch.where(K[:, None] > S, s * K[:, None] // S, s.expand(T, S))
    if stage == 3:
        kbase = _ceil_div(rowbase, frac)                   # (T, R)
        row = torch.searchsorted(kbase, ts, right=True) - 1
        kend = torch.cat([kbase[:, 1:], K[:, None]], 1)
        first = torch.gather(kidx, 1, torch.clamp(kbase, max=maxk))
        rowv = torch.where(kend > kbase, torch.gather(raw, 1, first) >> 8,
                           0)
        return fill(torch.gather(rowv, 1, row).sum(1))
    ok = ts < K[:, None]
    flat = torch.where(ok, torch.gather(kidx, 1, torch.clamp(ts, max=maxk)),
                       (R - 1) * 128)
    z = torch.where(ok, torch.gather(draw.reshape(T, HW), 1, flat) * scale,
                    0.0)
    zero = torch.zeros_like(z)
    return torch.stack([(flat % W).to(torch.float32),
                        (flat // W).to(torch.float32), z,
                        ok.to(torch.float32), zero, zero, zero, zero], -1)


@kernels.wrapper("cloud_stage")
def cloud_stage(draw, scal, stage: int, budget: int = BUDGET,
                frac: int = FRAC, W: int = WIDTH):
    """The stage kernel's wrapper: on a CUDA tensor one launch of
    cloud_stage_kernel<stage>, a cluster of 8 CTAs a track (each CTA's
    slice of R/8 rows copied into shared memory where it fits, up to 435
    rows, i.e. rasters up to 445,440 pixels, else read from device
    memory; past 2^20 pixels the wrapper raises), on a CPU tensor
    stage_plain.  `kinds` counts the launches by stage."""
    if draw.device.type == "cpu":
        return stage_plain(draw, scal, stage, budget, frac, W)
    lo, hi, scale = _check(draw, scal, stage, budget, frac)
    dev = kernels.require_cuda(draw)
    T, R, _ = draw.shape
    out = torch.empty((T, budget, 8), dtype=torch.float32, device=dev)
    kernels.launch("cloud_stage", kernels.library().hts_cloud_stage, dev,
                   draw.data_ptr(), out.data_ptr(), T, R * 128, W, frac,
                   *frac_divisor(frac), budget, stage, lo, hi, scale,
                   0, -1, 0)
    cloud_stage.launches += 1
    cloud_stage.kinds[stage] = cloud_stage.kinds.get(stage, 0) + 1
    return out


def main(argv=None):
    ap = stage_args(add_device(argparse.ArgumentParser(
        description=__doc__.split("\n")[0])), STAGES)
    args = ap.parse_args(argv)
    on = wanted(ap, args, STAGES)
    T, F = env_int("PROF_TRACKS", 512), env_int("PROF_FRAMES", 8)
    reps, budget = env_int("PROF_REPS", 3), env_int("PROF_BUDGET", BUDGET)
    from ..ops.cloud_kernel import cloud_from_depth_planes
    dev, model, bank, cam, _ = setup(args.device)
    _, fids = protocol_frames(bank, T, F)
    depths = render(model, cam, bank[fids])               # (F, T, H, W)
    scal = scalars(0.1, 0.7, cam.depth_scale)
    out = {}
    for stage in [int(s) for s in STAGES if on(s)]:
        def run():
            c = torch.zeros(T, device=dev)
            for f in range(F):
                if stage == 5:
                    ph = cloud_from_depth_planes(depths[f], cam, 0.1, 0.7,
                                                 FRAC, budget)
                    c = c + ph[:, 0:3].sum((1, 2)) + ph[:, 4].sum(1)
                else:
                    o = cloud_stage(to_raster(depths[f]), scal, stage, budget,
                                    FRAC, cam.dim[0])
                    c = c + o[:, 0, 0]
            return c
        ms = best_ms(run, dev, reps, F)
        out[stage] = ms
        print(f"stage {stage}: {ms:8.2f} ms/frame ({T} tracks)", flush=True)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
