"""Tracked frames a second: T times the frames completed in the window over
its seconds."""


def read(run):
    return run.T * run.frames / run.window_s if run.frames else None
