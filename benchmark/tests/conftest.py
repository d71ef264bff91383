"""Tests of the benchmark's harness.  Run from the repository root:

    python -m pytest benchmark/tests -q

Tests marked `card` need a CUDA device and skip without one (decided in
the `card` fixture, never at import)."""
import copy
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
for p in (BENCH, REPO):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def tiny(monkeypatch, tracks_per_check=2):
    """Shrink every cell's traffic and check to CPU size (2 segments of 4
    poses, 2 checked tracks, 4 traced frames)."""
    from portbench import runner
    orig = runner.cell_spec

    def small(name, man=None):
        w, c, m, s = orig(name, man)
        s = copy.deepcopy(s)
        s["check"].update(tracks=tracks_per_check, within=4)
        s["trace_frames"] = 4
        return w, c, dict(m, segments=2, segment_frames=4,
                          block_frames=64), s
    monkeypatch.setattr(runner, "cell_spec", small)
    return runner
