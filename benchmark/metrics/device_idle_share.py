"""Share of the frames' wall time in which no device operation ran, %:
the device time of the traced frames (the union of their operations)
over what the same mix of frames takes untraced, each kind of frame at
the median latency of its kind in the window.  The profiler's Python
stacks slow the host's issue, so the traced frames' own wall time would
overstate the idle share."""
import statistics


def read(run):
    if run.trace is None or run.trace.busy_us <= 0:
        return None
    wall = 0.0
    cnn = run.trace.cnn_frames
    for kind, n in ((True, cnn), (False, run.trace_frames - cnn)):
        lat = [s for s, c in zip(run.latency_s, run.cnn) if c == kind]
        if n and not lat:
            return None
        if n:
            wall += n * statistics.median(lat)
    return 100.0 * (1.0 - run.trace.busy_us / 1e6 / wall)
