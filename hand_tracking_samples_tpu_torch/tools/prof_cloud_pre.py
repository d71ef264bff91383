"""Does converting the depths to the kernel's f32 (R, 128) raster once,
outside the frame loop, remove the per-frame conversion cost?  The port's
counterpart of tools/prof_cloud_pre.py: times the sum-only kernel (one
block a track, csrc/prof_cloud.cu group_sum_kernel) fed from (F, T, 600,
128) f32 converted once ("preconv") against rasters converted every frame
("current").

    PROF_TRACKS=512 python -m hand_tracking_samples_tpu_torch.tools.prof_cloud_pre
    PROF_TRACKS=2 PROF_FRAMES=1 python -m hand_tracking_samples_tpu_torch.tools.prof_cloud_pre --device cpu
"""
from __future__ import annotations

import argparse
import sys

import torch

from .. import kernels
from .common import (add_device, best_ms, env_int, protocol_frames,
                     render, setup, to_raster)
from .prof_cloud_mt import SCALE, group_sum_plain, sum_launch


@kernels.wrapper("track_sum")
def track_sum(draw, scale: float = SCALE):
    """The sum kernel a track: draw (T, 600, 128) f32 -> (T, 8, 128), one
    block a track; on a CPU tensor the plain sum."""
    if draw.device.type == "cpu":
        return group_sum_plain(draw, scale)
    return sum_launch(track_sum, "track_sum", draw, scale)


def main(argv=None):
    ap = add_device(argparse.ArgumentParser(description=__doc__.split(
        "\n")[0]))
    args = ap.parse_args(argv)
    T, F = env_int("PROF_TRACKS", 512), env_int("PROF_FRAMES", 8)
    dev, model, bank, cam, _ = setup(args.device)
    _, fids = protocol_frames(bank, T, F)
    depths = render(model, cam, bank[fids])

    def run_pre():
        pre = to_raster(depths)
        c = torch.zeros(T, device=dev)
        for f in range(F):
            c = c + track_sum(pre[f])[:, 0, 0]
        return c

    def run_cur():
        c = torch.zeros(T, device=dev)
        for f in range(F):
            c = c + track_sum(to_raster(depths[f]))[:, 0, 0]
        return c
    out = {}
    for name, fn in (("preconv", run_pre), ("current", run_cur)):
        out[name] = best_ms(fn, dev, 3, F)
        print(f"{name}: {out[name]:8.2f} ms/frame", flush=True)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
