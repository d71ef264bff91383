"""Device operations (kernels, copies, sets) a traced frame, from the
profiler."""


def read(run):
    return run.trace.device_ops / run.trace.frames if run.trace else None
