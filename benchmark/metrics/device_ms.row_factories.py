"""Device time a frame of the row factories outside the CNN frame's stages
(the dynamics pass's cloud, chamber, joint, contact and angular rows), ms,
charged by launch stack through layers/*.json."""


def read(run):
    if run.trace is None or run.trace.frames == 0:
        return None
    us = run.trace.layer_us.get("row_factories", 0.0)
    return us / 1e3 / run.trace.frames if us > 0 else None
