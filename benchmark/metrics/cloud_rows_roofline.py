"""The cloud-rows kernels (ops/cloud_rows.py -> csrc/cloud_rows.cu: kernels 2,
6 and 7): the sum of their launches' bounds (portbench/work.py) over the
sum of their device time on the traced frames, %."""
KERNELS = ("cloud_rows_pack_kernel", "cloud_rows_unpacked_kernel",
           "cloud_vals_kernel")
WRAPPERS = ("cloud_rows_solve", "cloud_rows_packed", "cloud_rows_unpacked",
            "cloud_vals")


def read(run):
    if run.trace is None:
        return None
    us = run.trace.kernels_us(*KERNELS)
    bound = run.launch_bound_s(*WRAPPERS)
    if us <= 0 or bound <= 0:
        return None
    return 100.0 * bound / (us / 1e6)
