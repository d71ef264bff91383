"""Median latency of the window's CNN frames (host clock)."""


def read(run):
    lat = [s for s, c in zip(run.latency_s, run.cnn) if c]
    return run.median_ms(lat) if lat else None
