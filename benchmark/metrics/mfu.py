"""Float32 operations the frames need (the net's convolutions and dense
layers, 2 a multiply-add, and every port kernel's counted operations on the
traced frames' inputs) at the window's frame rate, as a share of the card's
float32 peak, %."""
from portbench import work


def read(run):
    if run.trace is None or not run.frames:
        return None
    rate = run.frames / run.window_s
    return 100.0 * run.traced_ops_per_frame() * rate / work.PEAK_F32_S
