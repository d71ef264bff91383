"""The cap ablation on real-speed recorded data (the port's counterpart of
tools/eval_cap_recorded.py): the 128-frame cnntrack_rec2 fixture at the
golden's k = 4, one track, the kernel solver at its shipped cap of 128
cloud rows a body and at 256, and the colored solver at 512 (about
uncapped): each setting's mean joint error against the recording's poses
beside the C++ reference's (cnntrack_ref2_k4.json).  EVAL_FRAMES cuts the
recording.

    python -m hand_tracking_samples_tpu_torch.tools.eval_cap_recorded
    EVAL_FRAMES=2 python -m hand_tracking_samples_tpu_torch.tools.eval_cap_recorded --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from .common import (FIXTURES, add_device, env_int, joint_err,
                     load_recording, setup, track_recording)

SETTINGS = (("kernel", 128, 1), ("kernel", 256, 1), ("colored", 512, 0))


def main(argv=None):
    ap = add_device(argparse.ArgumentParser(description=__doc__.split(
        "\n")[0]))
    args = ap.parse_args(argv)
    from ..tracker.config import TrackerConfig
    dev, model, _, _, cnn = setup(args.device, cnn=True)
    ds, cam = load_recording("cnntrack_rec2")
    with open(os.path.join(FIXTURES, "cnntrack_ref2_k4.json")) as f:
        ref = json.load(f)
    k = ref["k"]
    F = min(env_int("EVAL_FRAMES", ref["n_frames"]), ref["n_frames"])
    ref_je = np.asarray(ref["cnntrack_joint_err"])[:F]
    out = {}
    for solver, cap, pallas in SETTINGS:
        config = TrackerConfig(cnn_every_frame=True, cnn_every_k=k,
                               solver=solver, cloud_rows_per_body=cap,
                               use_pallas=bool(pallas))
        poses = track_recording(ds, cam, model, cnn, config, k, F, dev)
        jes = joint_err(poses, ds.pose[:F])
        out[(solver, cap)] = jes
        print(f"{solver} cap={cap}: mean je {np.mean(jes) * 1000:.2f} mm "
              f"(ref {np.mean(ref_je) * 1000:.2f})", flush=True)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
