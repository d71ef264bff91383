"""The cloud kernel's epilogue cost: the port's counterpart of
tools/prof_cloud_epi.py.  The same kernel (ops.cloud_kernel, whose output
is already deprojected) consumed three ways: a) the raw output's sum, b)
the sums of its x, y, z and mask rows, c) the points and mask as the
tracker takes them (ops.cloud_kernel.planes_points), summed.

    PROF_TRACKS=512 python -m hand_tracking_samples_tpu_torch.tools.prof_cloud_epi
    PROF_TRACKS=2 PROF_FRAMES=1 python -m hand_tracking_samples_tpu_torch.tools.prof_cloud_epi --device cpu
"""
from __future__ import annotations

import argparse
import sys

import torch

from .common import add_device, best_ms, env_int, protocol_frames, render, \
    setup

BUDGET = 2048


def main(argv=None):
    ap = add_device(argparse.ArgumentParser(description=__doc__.split(
        "\n")[0]))
    args = ap.parse_args(argv)
    T, F = env_int("PROF_TRACKS", 512), env_int("PROF_FRAMES", 8)
    from ..ops.cloud_kernel import cloud_from_depth_planes, planes_points
    dev, model, bank, cam, _ = setup(args.device)
    _, fids = protocol_frames(bank, T, F)
    depths = render(model, cam, bank[fids])

    def raw_out(d):
        return cloud_from_depth_planes(d, cam, 0.1, 0.7, 4, BUDGET)

    def deproject(d):
        pts, mask = planes_points(raw_out(d))
        return pts.sum((1, 2)) + mask.sum(1)
    variants = {
        "raw_sum": lambda d: raw_out(d).sum((1, 2)),
        "col_sums": lambda d: (lambda o: o[:, 0].sum(1) + o[:, 1].sum(1)
                               + o[:, 2].sum(1) + o[:, 4].sum(1))(raw_out(d)),
        "deproject": deproject,
    }
    out = {}
    for name, fn in variants.items():
        def run():
            c = torch.zeros(T, device=dev)
            for f in range(F):
                c = c + fn(depths[f])
            return c
        out[name] = best_ms(run, dev, 3, F)
        print(f"{name:10s}: {out[name]:8.2f} ms/frame", flush=True)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
