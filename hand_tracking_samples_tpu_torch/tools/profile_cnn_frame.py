"""Time the CNN frame's stages one at a time at BENCH_TRACKS tracks (the
port's counterpart of tools/profile_cnn_frame.py): the segmentation, the
net's input and forward pass, the decode, the cloud, FitError,
MultiStepSim, update_cnn_model and the whole CNN frame (update).  Seeded
random animbank poses, point budget 1024, the kernel solver with
use_pallas.  Each stage: one warm-up call, then the mean of three.
Stages may be named to time only those (all by default): segment cnn
analyze cloud fiterr msim ucm update.

    python -m hand_tracking_samples_tpu_torch.tools.profile_cnn_frame [stage ...]
    BENCH_TRACKS=2 python -m hand_tracking_samples_tpu_torch.tools.profile_cnn_frame --device cpu
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .common import add_device, env_int, render, setup, stage_args, wanted
from .profile_stages import bench

STAGES = ("segment", "cnn", "analyze", "cloud", "fiterr", "msim", "ucm",
          "update")


def main(argv=None):
    ap = stage_args(add_device(argparse.ArgumentParser(
        description=__doc__.split("\n")[0])), STAGES)
    args = ap.parse_args(argv)
    on = wanted(ap, args, STAGES)
    from ..cnn.labels import analyze_cnn_output
    from ..cnn.model import forward
    from ..fitting.cloud import fit_error
    from ..ops.cloud_kernel import cloud_from_depth_planes
    from ..parallel.tracks import batched_tracker_state
    from ..segment.handsegment import cnn_input_from_segment, \
        hand_segment_vr
    from ..tracker.config import TrackerConfig
    from ..tracker.runtime import (multi_step_sim, physics_params, update,
                                   update_cnn_model)
    T = env_int("BENCH_TRACKS", 512)
    dev, model, bank, cam, cnn = setup(args.device, cnn=True)
    config = TrackerConfig(point_budget=1024, cnn_every_frame=True,
                           solver="kernel", use_pallas=True)
    params = physics_params(config)
    rng = np.random.RandomState(0)
    poses = torch.tensor(bank[rng.randint(0, len(bank), T)], device=dev)
    depths = render(model, cam, poses)
    st = batched_tracker_state(model, T)
    states = st._replace(body=st.body._replace(pose=poses))
    drange = (0.1, config.drangey)
    out = {}

    def stage_seg(d):
        return hand_segment_vr(d, cam, 0xF, drange, config.segment_scale)

    def stage_cnn(seg):
        return forward(cnn, cnn_input_from_segment(seg.depth,
                                                   cam.depth_scale, drange))

    def stage_analyze(y, seg):
        return analyze_cnn_output(y, seg.cam.sub(4))

    def stage_cloud(d):
        return cloud_from_depth_planes(d, cam, drange[0], drange[1],
                                       config.subsample_fraction,
                                       config.point_budget)
    seg = stage_seg(depths)
    y = stage_cnn(seg)
    analysis = stage_analyze(y, seg)
    ph = stage_cloud(depths)
    table = {
        "segment": (stage_seg, (depths,), "hand_segment_vr"),
        "cnn": (stage_cnn, (seg,), "cnn_input + forward"),
        "analyze": (stage_analyze, (y, seg), "analyze_cnn_output"),
        "cloud": (stage_cloud, (depths,), "cloud_from_depth"),
        "fiterr": (lambda s, p, d: fit_error(
            s.body.pose, model, p, d, cam, config.bone_sum_error_scale,
            use_kernel=True), (states, ph, depths), "fit_error (x1)"),
        "msim": (lambda s, a, p, c: multi_step_sim(
            s.body, model, a, p, c, config, params),
            (states, analysis, ph, seg.cam.pose),
            f"multi_step_sim ({config.steps} steps)"),
        "ucm": (lambda s, d: update_cnn_model(
            s, model, cnn, d, cam, config, params), (states, depths),
            "update_cnn_model (whole)"),
        "update": (lambda s, d: update(
            s, model, d, cam, config, params, cnn_params=cnn),
            (states, depths), "update run_cnn=True (whole)"),
    }
    for name in STAGES:
        if on(name):
            fn, a, label = table[name]
            out[name] = bench(dev, fn, *a, label=label)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
