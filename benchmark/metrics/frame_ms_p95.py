"""The 95th percentile of every frame's latency in the window (host clock,
from the call of batched_update to the poses on the host), over all frames."""
from portbench.runner import percentile


def read(run):
    return percentile(run.latency_s, 95) * 1e3 if run.frames else None
