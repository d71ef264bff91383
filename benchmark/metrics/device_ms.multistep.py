"""Device time a CNN frame of MultiStepSim, ms, charged by launch stack
through layers/*.json."""


def read(run):
    if run.trace is None or run.trace.cnn_frames == 0:
        return None
    us = run.trace.layer_us.get("multistep", 0.0)
    return us / 1e3 / run.trace.cnn_frames if us > 0 else None
