"""Host time from the call of batched_update to its return, median over the
window's frames."""


def read(run):
    return run.median_ms(run.issue_s) if run.frames else None
