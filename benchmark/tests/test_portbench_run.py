"""A whole run of a cell at CPU size (the port's plain paths stand in for
its kernels): the result line, the percentile, the refusal without a
card, what the run imports, and `correct` under broken timed paths."""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import BENCH, REPO, tiny


def run_tiny(monkeypatch, name, trace=False, seconds=2.0):
    runner = tiny(monkeypatch)
    return runner.execute(name, 2**31 + 11, seconds, trace,
                          time.perf_counter(), device="cpu", tracks=4)


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(monkeypatch, trace):
    out, run, _ = run_tiny(monkeypatch, "dyn_kernel.synth", trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[:5] == keys and list(out)[-1] == "checks"
    assert set(out) - set(keys) == {"checks"}     # no device: no breakdown
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] == run.frames * 4
    assert out["device"]["platform"] == "cpu"
    names = set(out["metrics"])
    if trace:   # host-clock layer metrics only: a CPU run has no device
        assert names == {"issue_ms"}
    else:
        assert names == {"track_frames_per_s", "frame_ms_p95", "setup_s"}
    for v in out["checks"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(out)


def test_percentile_over_all_frames():
    from portbench.runner import Run, reader
    run = Run()
    lat = np.full(100, 0.010)
    lat[5::20] = 1.0              # one slow frame in each chunk of 20
    run.latency_s = list(lat)
    p95 = reader("frame_ms_p95")(run)
    assert p95 == pytest.approx(np.percentile(lat, 95) * 1e3)
    chunked = np.percentile([np.median(c) for c in lat.reshape(5, 20)], 95)
    assert p95 > 5 * chunked * 1e3


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs none")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "dyn_kernel.synth", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_imports_neither_jax_nor_the_jax_package():
    """A CPU run at tiny T, in a fresh interpreter: no loaded module's
    top-level name is jax, jaxlib, flax or hand_tracking_samples_tpu
    (compared whole: the port's own name begins with the last)."""
    code = f"""
import sys, time, json
sys.path[:0] = [{BENCH!r}, {os.path.join(BENCH, 'tests')!r}, {REPO!r}]
import pytest
from conftest import tiny
mp = pytest.MonkeyPatch()
runner = tiny(mp)
runner.execute("cnn_kernel.synth", 5, 1.0, True, time.perf_counter(),
               device="cpu", tracks=2)
print(json.dumps([runner.forbidden_modules(),
                  "hand_tracking_samples_tpu_torch" in sys.modules]))
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    bad, port = json.loads(r.stdout.strip().splitlines()[-1])
    assert bad == [] and port is True


def _broken(monkeypatch, how):
    """Program.frame with its timed path broken in one way."""
    from portbench.system import Program
    real = Program.frame

    def frame(self, state, depth, run_cnn, fit=None):
        if how == "unchanged":
            _, poses, net = real(self, state, depth, run_cnn, fit)
            return state, poses, net
        if how in ("error_carry", "countdown"):
            st, poses, net = real(self, state, depth, run_cnn, fit)
            if run_cnn and how == "error_carry":
                st = st._replace(prev_frame_error=st.prev_frame_error
                                 + 1e-3)
            elif run_cnn:
                st = st._replace(initializing=st.initializing + 1)
            return st, poses, net
        if how == "half":
            T = depth.shape[0]
            h = T // 2
            part = type(state)(type(state.body)(*[x[:h] for x in state.body]),
                               state.prev_frame_error[:h],
                               state.initializing[:h])
            st, poses, net = real(self, part, depth[:h], run_cnn, fit)
            cat = lambda a, b: torch.cat([a, b[h:]])
            st = type(state)(type(state.body)(*[cat(a, b) for a, b in
                                                zip(st.body, state.body)]),
                             cat(st.prev_frame_error,
                                 state.prev_frame_error),
                             cat(st.initializing, state.initializing))
            return st, torch.cat([poses, poses[:T - h]]), net
        st, poses, net = real(self, state, depth, run_cnn, fit)
        poses = poses.clone()
        poses[:, :, 0] += 1e-3            # an answer altered: 1 mm in x
        return st, poses, net
    monkeypatch.setattr(Program, "frame", frame)


@pytest.mark.parametrize("how", ["unchanged", "half", "altered"])
def test_broken_timed_path_is_not_correct(monkeypatch, how):
    _broken(monkeypatch, how)
    out, _, _ = run_tiny(monkeypatch, "dyn_kernel.synth")
    assert out["correct"] is False, out["checks"]


def _kernel7_altered(monkeypatch):
    """The port's FitError correspondence (kernel 7, cloud_vals) with each
    point's value 10% high: both FitErrors of a CNN frame rise alike, so
    the reset and take decisions, and the poses, barely move."""
    from hand_tracking_samples_tpu_torch.ops import cloud_rows
    real = cloud_rows.cloud_vals_ph

    def vals(*args, **kwargs):
        body, val = real(*args, **kwargs)
        return body, val * 1.1
    monkeypatch.setattr(cloud_rows, "cloud_vals_ph", vals)


@pytest.mark.parametrize("how", ["kernel7", "error_carry", "countdown"])
def test_broken_cnn_frame_is_not_correct(monkeypatch, how):
    """Faults that only the CNN frame's own numbers see: FitError's
    kernel (fit_gap), the carried prev_frame_error (err_gap) and the
    carried re-initialisation countdown (init_gap)."""
    if how == "kernel7":
        _kernel7_altered(monkeypatch)
    else:
        _broken(monkeypatch, how)
    out, _, _ = run_tiny(monkeypatch, "cnn_kernel.synth")
    number = {"kernel7": "fit_gap", "error_carry": "err_gap",
              "countdown": "init_gap"}[how]
    assert out["correct"] is False, out["checks"]
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]
