"""The PGS kernel (physics/pgs_kernel.py -> csrc/pgs_kernel.cu, every plan):
the sum of its launches' bounds (portbench/work.py) over the sum of its
device time on the traced frames, %."""
KERNELS = ("pgs_kernel",)
WRAPPERS = ("pgs_solve",)


def read(run):
    if run.trace is None:
        return None
    us = run.trace.kernels_us(*KERNELS)
    bound = run.launch_bound_s(*WRAPPERS)
    if us <= 0 or bound <= 0:
        return None
    return 100.0 * bound / (us / 1e6)
