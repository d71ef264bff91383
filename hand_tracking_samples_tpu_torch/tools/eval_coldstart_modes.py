"""The cold-start accept-policy matrix (the port's counterpart of
tools/eval_coldstart_modes.py): the cold-start protocol (64 starts x 64
frames, the kernel solver) under MODE=ref (an unconditional take while
initializing, handtrack.h:714-726), gated (take only when the refit does
not worsen FitError), always (always_take_cnn) or notworse (the accum
threshold just below zero); the error every 16th frame, the final mean,
median and share under 8 mm, and the failing starts.  EVAL_TRACKS and
EVAL_FRAMES cut the protocol.

    MODE=gated python -m hand_tracking_samples_tpu_torch.tools.eval_coldstart_modes
    EVAL_TRACKS=2 EVAL_FRAMES=2 python -m hand_tracking_samples_tpu_torch.tools.eval_coldstart_modes --device cpu
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .common import add_device, env_int, setup
from .eval_coldstart import coldstart_errors

MODES = {"ref": {}, "gated": dict(init_take_gated=True),
         "always": dict(always_take_cnn=True),
         "notworse": dict(accum_error_threshold=-1e-9)}


def main(argv=None):
    ap = add_device(argparse.ArgumentParser(description=__doc__.split(
        "\n")[0]))
    args = ap.parse_args(argv)
    from ..tracker.config import TrackerConfig
    mode = os.environ.get("MODE", "ref")
    T, F = env_int("EVAL_TRACKS", 64), env_int("EVAL_FRAMES", 64)
    dev, model, bank, cam, cnn = setup(args.device, cnn=True)
    config = TrackerConfig(cnn_every_frame=True, solver="kernel",
                           use_pallas=True, **MODES[mode])

    def report(f, e):
        if f % 16 == 15:
            print(f"frame {f}: mean {e.mean() * 1000:.2f} mm  <8mm "
                  f"{(e < 0.008).mean() * 100:.0f}%", flush=True)
    errs, starts = coldstart_errors(config, dev, model, bank, cam, cnn, T,
                                    F, report=report)
    err = errs[-1]
    print(f"MODE={mode}: mean {err.mean() * 1000:.2f} median "
          f"{np.median(err) * 1000:.2f} <8mm {(err < 0.008).mean() * 100:.1f}%")
    fails = np.where(err > 0.008)[0]
    print("failing starts:", sorted(starts[fails].tolist()))
    return errs


if __name__ == "__main__":
    main()
    sys.exit(0)
