"""The set-up time: from the process's start to the window's, on the host
clock (imports, the card, the kernel library, the models, the pool, the
warm-up)."""


def read(run):
    return run.setup_s
