"""The control of `correct` (the reference in the configuration's control
precision put in the program's place) comes out not correct, at a size a
test run holds; the same frames judged from the program pass.  At the
cells' own sizes it runs on the card through benchmark/control.py."""
import json

import pytest

from conftest import tiny


@pytest.mark.parametrize("name", ["dyn_kernel.synth",
                                  "cnn_kernel.synth"])
def test_control_is_not_correct(monkeypatch, name):
    import control
    tiny(monkeypatch, tracks_per_check=4)
    from portbench.runner import cell_spec
    limits = cell_spec(name)[3]["check"]["limits"]
    (row,) = control.readings(name, [2**31 + 3], 2.0, 1, device="cpu",
                              tracks=8)
    assert all(row["sound"][k] <= limits[k] for k in limits), row
    assert any(row["control"][k] > limits[k] for k in limits), row
    json.dumps(row)
