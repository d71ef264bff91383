"""Attribution of device ops to the port's layers (portbench/trace.py) on
a hand-made Chrome trace, and the layer map's precedence."""
import json
import os

from portbench import trace

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = "/x/hand_tracking_samples_tpu_torch/"


def ev(cat, name, ts, dur, tid=1, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid}
    if args:
        e["args"] = args
    return e


def frames_trace():
    """One traced range [0, 100) us: update -> update_cnn_model ->
    multi_step_sim launches kernel A (corr 1, device 10-30); update ->
    fitting/cloud.py launches kernel B (corr 2, device 50-60); a copy
    launched outside the port (corr 3, device 80-85)."""
    return [
        ev("user_annotation", trace.MARK, 0, 100),
        ev("python_function", P + "tracker/runtime.py(883): update", 1, 90),
        ev("python_function",
           P + "tracker/runtime.py(755): update_cnn_model", 2, 30),
        ev("python_function",
           P + "tracker/runtime.py(481): multi_step_sim", 3, 20),
        ev("cuda_runtime", "cudaLaunchKernel", 4, 1, correlation=1),
        ev("python_function", P + "fitting/cloud.py(10): cloud_rows", 40, 10),
        ev("cpu_op", "aten::add", 41, 5),
        ev("cuda_runtime", "cudaLaunchKernel", 42, 1, correlation=2),
        ev("cuda_runtime", "cudaMemcpyAsync", 95, 2, correlation=3),
        ev("kernel", "void A<1>()", 10, 20, tid=7, correlation=1),
        ev("kernel", "B_kernel", 50, 10, tid=7, correlation=2),
        ev("gpu_memcpy", "Memcpy DtoH", 96, 3, tid=7, correlation=3),
    ]


def test_layers_busy_and_gaps():
    rules = trace.load_rules(os.path.join(BENCH, "layers"))
    t = trace.Trace(frames_trace(), rules, frames=2, cnn_frames=1)
    assert t.window_us == 100 and t.device_ops == 3
    assert t.layer_us == {"multistep": 20, "row_factories": 10,
                          "outside": 3}
    assert t.busy_us == 33
    assert t.kernels_us("A<", "B_") == 30
    assert sum(t.gaps.values()) == 100 - 33
    # the gap from 30 to 50 opens while update runs, after multi_step_sim
    assert t.gaps["tracker/runtime.py(883): update"] > 0
    b = t.breakdown()
    assert b["device_ops"][0] == ["void A<1>()", 20 / 1e6]
    json.dumps(b)


def test_later_layer_file_has_the_first_say(tmp_path):
    (tmp_path / "port.json").write_text(json.dumps({"rules": [
        {"layer": "entry", "module": "tracker/runtime.py"}]}))
    (tmp_path / "port_more.json").write_text(json.dumps({"rules": [
        {"layer": "ms", "module": "tracker/runtime.py",
         "functions": ["multi_step_sim"]}]}))
    rules = trace.load_rules(str(tmp_path))
    stack = [("tracker/runtime.py", "multi_step_sim"),
             ("tracker/runtime.py", "update")]
    assert trace.layer_of(stack, rules) == "ms"
    assert trace.layer_of(stack[1:], rules) == "entry"
    assert trace.layer_of([("x.py", "f")], rules) == "unmapped"
    assert trace.layer_of([], rules) == "outside"
