"""The yardstick's arithmetic (portbench/work.py) against chip_smoke.py's,
from which it was copied, on the kernel inputs of one tiny CPU frame, and
the net's count against torch's own flop counter."""
import importlib.util
import os
import types

import pytest
import torch

from conftest import REPO, tiny


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def smoke_self(mod):
    s = types.SimpleNamespace(torch=torch, results={})
    for name in ("pgs_active", "jacobi_active", "pgs_row_bytes"):
        setattr(s, name, types.MethodType(getattr(mod.Smoke, name), s))
    return s


@pytest.fixture(scope="module")
def launches():
    """The port kernel wrappers' calls of a CNN frame and a dynamics frame
    at T=2 on the CPU (the wrappers take their plain versions there)."""
    from portbench import trace
    mp = pytest.MonkeyPatch()
    try:
        runner = tiny(mp)
        cell = runner.Cell("cnn_kernel.synth", 3, "cpu", tracks=2)
        cell.setup()
        sink = []
        with trace.record_launches(sink):
            cell.step()
            cell.step()
        return sink, cell
    finally:
        mp.undo()


def test_peaks_equal_chip_smokes():
    from portbench import work
    mod = chip_smoke()
    assert work.PEAK_BYTES_S == mod.PEAK_BYTES_S
    assert work.PEAK_F32_S == mod.PEAK_F32_S


def test_launch_work_equals_chip_smokes(launches):
    from portbench import work
    sink, _ = launches
    mod = chip_smoke()
    me = smoke_self(mod)
    seen = set()
    for name, args in sink:
        mine = work.launch_work(name, args)
        if name in ("cloud_vals", "cloud_rows_unpacked"):
            # counted without the exit's hull-plane evaluations: a floor
            me.results[name] = {"hull_plane_evals": 0}
            theirs = mod.Smoke.work(me, name, args[:4])
            assert mine[0] == theirs[0] and mine[1] <= theirs[1]
            seen.add(name)
            continue
        theirs = mod.Smoke.work(me, name, args[:8] if name == "pgs_solve"
                                else args)
        assert tuple(mine) == tuple(theirs), name
        seen.add(name)
    assert {"cloud_from_depth", "cloud_rows_solve", "contact_fields",
            "pgs_solve", "cloud_vals"} <= seen


def test_net_ops_equal_the_flop_counter(launches):
    from torch.utils.flop_counter import FlopCounterMode
    from portbench import work
    _, cell = launches
    net = cell.program.net
    from hand_tracking_samples_tpu_torch.cnn.model import forward
    x = torch.zeros((3, 64, 64))
    with FlopCounterMode(display=False) as fc:
        forward(net, x)
    assert work.net_ops(net, 3, 64) == fc.get_total_flops()
