"""Is the cloud kernel's stage-0 floor a per-block overhead?  The port's
counterpart of tools/prof_cloud_mt.py: times the sum-only kernel
(csrc/prof_cloud.cu group_sum_kernel) at 1, 2, 4, 8 and 16 tracks a block,
the same total work, over F frames of the JAX tool's renders; each frame
converts its rasters to f32 (G, trk*600, 128).

    PROF_TRACKS=512 python -m hand_tracking_samples_tpu_torch.tools.prof_cloud_mt
    PROF_TRACKS=2 PROF_FRAMES=1 python -m hand_tracking_samples_tpu_torch.tools.prof_cloud_mt --device cpu
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import kernels
from .common import (add_device, best_ms, env_int, protocol_frames,
                     render, setup, to_raster)

SCALE = float(np.float32(0.001))
TRACKS_A_BLOCK = (1, 2, 4, 8, 16)


def group_sum_plain(draw, scale: float = SCALE):
    """draw (G, ...) f32 -> (G, 8, 128): each group's sum of draw*scale
    (the float32 products summed in float64, rounded once), broadcast."""
    d = draw * torch.tensor(scale, dtype=torch.float32, device=draw.device)
    s = d.double().sum(tuple(range(1, draw.dim()))).to(torch.float32)
    return s[:, None, None].expand(draw.shape[0], 8, 128).contiguous()


def sum_launch(fn, name, draw, scale):
    """One launch of group_sum_kernel over draw's groups (its leading
    dim), counted on wrapper fn."""
    if draw.dtype != torch.float32 or draw[0].numel() % 4:
        raise ValueError("draw must be float32 with a multiple of 4 "
                         "elements a group")
    dev = kernels.require_cuda(draw)
    G = draw.shape[0]
    out = torch.empty((G, 8, 128), dtype=torch.float32, device=dev)
    kernels.launch(name, kernels.library().hts_group_sum, dev,
                   draw.data_ptr(), out.data_ptr(), G, draw[0].numel(),
                   scale)
    fn.launches += 1
    return out


@kernels.wrapper("group_sum")
def group_sum(draw, scale: float = SCALE):
    """The sum kernel over groups of tracks: draw (G, trk*600, 128) f32 ->
    (G, 8, 128), one block a group (the JAX tool's grid instance); on a
    CPU tensor group_sum_plain.  `kinds` counts the launches by tracks a
    block (600 rows a track)."""
    if draw.device.type == "cpu":
        return group_sum_plain(draw, scale)
    out = sum_launch(group_sum, "group_sum", draw, scale)
    trk = draw.shape[1] // 600
    group_sum.kinds[trk] = group_sum.kinds.get(trk, 0) + 1
    return out


def main(argv=None):
    ap = add_device(argparse.ArgumentParser(description=__doc__.split(
        "\n")[0]))
    args = ap.parse_args(argv)
    T, F = env_int("PROF_TRACKS", 512), env_int("PROF_FRAMES", 8)
    dev, model, bank, cam, _ = setup(args.device)
    _, fids = protocol_frames(bank, T, F)
    depths = render(model, cam, bank[fids])
    out = {}
    for trk in TRACKS_A_BLOCK:
        if T % trk:
            continue
        G = T // trk

        def run():
            c = torch.zeros(G, device=dev)
            for f in range(F):
                draw = to_raster(depths[f]).reshape(G, -1, 128)
                c = c + group_sum(draw)[:, 0, 0]
            return c
        out[trk] = best_ms(run, dev, 3, F)
        print(f"tracks/instance {trk:3d}: {out[trk]:8.2f} ms/frame",
              flush=True)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
