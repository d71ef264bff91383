"""One run of one cell: set-up, the measured window, the traced frames
(--trace 1), the comparison with the plain reference, the metrics, and
the result line.

The loop is closed: a batch of T depth frames (one gather from the
rendered pool) goes to the port's `runtime.update` (the call its
`batched_update` makes), the T poses come back to the host (`.cpu()`),
and only then is the next frame issued.  A frame's latency runs from the
call to its poses on the host.
On a configuration with the CNN, frame f is a CNN frame when f is a
multiple of its `cnn_every_k` (the static cadence of the port's
`parallel/tracks._cadence`); frames are counted from the first warm-up
frame, so the window continues the warm-up's sequences.
"""
from __future__ import annotations

import importlib.util
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

from . import check as checks
from . import trace as tracing
from . import work
from .system import Program
from .traffic import Traffic

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "hand_tracking_samples_tpu")


def load_json(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def manifest():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_spec(name: str, man=None):
    """(workload entry, configuration file, traffic mix, cell file) of
    workload `name`, found by the names in BENCHMARK.json."""
    man = man or manifest()
    wl = {w["name"]: w for w in man["workloads"]}
    if name not in wl:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = wl[name]
    cfg = {c["name"]: c for c in man["configs"]}[w["config"]]
    with open(os.path.join(REPO, cfg["file"])) as f:
        config = json.load(f)
    return (w, config, load_json("traffic", w["traffic"] + ".json"),
            load_json("cells", name + ".json"))


def metrics_for(name: str, trace: bool, man=None) -> list:
    """The cell's metric entries: end_to_end without --trace, per_layer
    with it, each kept where its `workloads` (if any) names the cell."""
    man = man or manifest()
    group = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def reader(metric: str):
    """metrics/<metric>.py's read(run)."""
    path = os.path.join(BENCH, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def percentile(values, q: float) -> float:
    """The q-th percentile of all values (linear between order
    statistics, numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


class Run:
    """Everything one run measured; the metric readers read it."""

    def __init__(self):
        self.setup_s = None
        self.window_s = None
        self.latency_s, self.issue_s, self.cnn = [], [], []
        self.trace = None
        self.trace_frames = self.trace_cnn_frames = 0
        self.launches = []         # (wrapper name, bytes, ops)
        self.net_ops_per_cnn_frame = 0
        self.T = 0

    @property
    def frames(self) -> int:
        return len(self.latency_s)

    def median_ms(self, values) -> float:
        return statistics.median(values) * 1e3

    def launch_bound_s(self, *names) -> float:
        return sum(work.bound_s(b, o) for n, b, o in self.launches
                   if n in names)

    def traced_ops_per_frame(self) -> float:
        ops = sum(o for _, _, o in self.launches) \
            + self.net_ops_per_cnn_frame * self.trace_cnn_frames
        return ops / self.trace_frames


class Cell:
    """Set-up and the timed loop of one cell."""

    def __init__(self, name: str, seed: int, device, tracks=None):
        self.name, self.seed = name, seed
        self.w, self.config, self.mix, self.spec = cell_spec(name)
        self.device = torch.device(device)
        self.T = int(tracks or self.spec["tracks"])
        tr = self.config["tracker"]
        self.k = int(tr.get("cnn_every_k", 1)) if (
            tr.get("cnn_every_frame") and self.config.get("net")) else 0
        self.warmup = max(2, 2 * self.k)

    def is_cnn(self, f: int) -> bool:
        return bool(self.k) and f % self.k == 0

    # ---- set-up ------------------------------------------------------------
    def setup(self, pool=None):
        """Everything before the window.  pool: a pool this process
        rendered already for the same mix (the T sweep reuses it)."""
        bench = BENCH
        if bench not in sys.path:
            sys.path.insert(0, bench)
        from plainref.data.animbank import load_animbank
        from plainref.data.synth import fake_depth
        from plainref.imaging.camera import DCamera
        dev = self.device
        self.program = Program(self.config, REPO, dev)
        bank = load_animbank(os.path.join(REPO, self.config["animbank"]))
        self.traffic = Traffic(self.mix, self.T, self.seed, len(bank))
        # the pool: rendered once by the frozen renderer, on the card
        self.ref_model = checks.bake(self.config, REPO, "cpu")
        cam = self.config["camera"]
        rcam = DCamera.make(dim=tuple(cam["dim"]), focal=tuple(cam["focal"]),
                            principal=tuple(cam["principal"]),
                            depth_scale=cam["depth_scale"])
        pool_poses = torch.as_tensor(bank[self.traffic.pool_bank_ids()],
                                     device=dev)
        self.pool_poses_cpu = pool_poses.cpu()
        self.pool = pool if pool is not None else fake_depth(
            pool_poses, self.ref_model.to(dev), rcam,
            chunk=int(self.mix.get("render_chunk", 64)))
        del pool_poses
        self._ids_dev = {}
        start = self.pool_poses_cpu[self.traffic.initial_pool_ids()]
        self.start_poses = start
        self.state = self.program.initial_state(start)
        self.f = 0
        self.keep, self.keep_set = {}, set()
        # warm-up: the sequences' first frames, every shape this cell uses
        for _ in range(self.warmup):
            self.step(keep_all=self.f == 0)
        if self.k:
            self._warm_reset()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _warm_reset(self):
        """One CNN frame from a copy of the state whose every 8th track is
        at the hand model's start pose, far from its hand, so the reset
        branch runs once in set-up; its result is dropped."""
        st = self.state
        pose = st.body.pose.clone()
        pose[::8] = self.ref_model.start_pose.to(pose.device, pose.dtype)
        st = st._replace(body=st.body._replace(pose=pose))
        self.program.frame(st, self.depth(self.f), True, [])

    def ids_dev(self, f: int):
        b = f // self.traffic.block
        if b not in self._ids_dev:
            self._ids_dev = {b: torch.as_tensor(
                self.traffic.block_of(b), device=self.device)}
        return self._ids_dev[b][f % self.traffic.block]

    def depth(self, f: int):
        return self.pool.index_select(0, self.ids_dev(f))

    def step(self, keep_all=False, run=None):
        """Frame self.f for every track; with `run`, a window frame: its
        latency and issue time go to `run`, its state to the checks."""
        f, cnn = self.f, self.is_cnn(self.f)
        depth = self.depth(f)
        fit = [] if cnn else None
        t0 = time.perf_counter()
        st, poses, net = self.program.frame(self.state, depth, cnn, fit)
        t1 = time.perf_counter()
        host = poses.cpu()
        t2 = time.perf_counter()
        bad = int((~torch.isfinite(host).all(-1).all(-1)).sum())
        if keep_all or f in self.keep_set:
            self.keep[f] = (self.state, st, host, net, fit)
        if run is not None:
            self.last[cnn] = (f, self.state, st, host, net, fit)
            run.latency_s.append(t2 - t0)
            run.issue_s.append(t1 - t0)
            run.cnn.append(cnn)
            self.failed += bad
        self.state = st
        self.f += 1

    # ---- the window --------------------------------------------------------
    def window(self, seconds: float, run: Run):
        rng = np.random.default_rng([self.seed, 1])
        within = int(self.spec["check"]["within"])
        per_kind = int(self.spec["check"]["frames"])
        w0 = self.f
        kinds = [self.is_cnn(w0 + i) for i in range(within)]
        self.keep_set = set()
        for kind in sorted(set(kinds)):
            cand = [w0 + i for i in range(within) if kinds[i] == kind]
            self.keep_set.update(int(x) for x in rng.choice(
                cand, min(per_kind, len(cand)), replace=False))
        self.last, self.failed = {}, 0
        self.traffic.ensure(w0 + 1)
        t_start = time.perf_counter()
        deadline = t_start + seconds
        t_last = t_start
        while t_last < deadline:
            self.step(run=run)
            t_last = time.perf_counter()
        run.window_s = t_last - t_start
        self.window_end = self.f

    def traced(self, run: Run, frames: int):
        """`frames` frames after the window under the profiler, with the
        port kernels' launches recorded; fills run.trace and run.launches."""
        rules = tracing.load_rules(os.path.join(BENCH, "layers"))
        sink = []
        cnn = sum(self.is_cnn(self.f + i) for i in range(frames))

        def go():
            for _ in range(frames):
                self.step()
        with tempfile.TemporaryDirectory() as tmp:
            with tracing.record_launches(sink):
                events = tracing.capture(go, tmp)
        run.trace = tracing.Trace(events, rules, frames, cnn)
        del events
        run.trace_frames, run.trace_cnn_frames = frames, cnn
        run.launches = []
        for name, args in sink:
            w = work.launch_work(name, args)
            if w is not None:
                run.launches.append((name,) + tuple(w))
        sink.clear()
        if self.program.net is not None:
            run.net_ops_per_cnn_frame = work.net_ops(
                self.program.net, self.T, int(self.config["net_input"]))

    # ---- the comparison ----------------------------------------------------
    def cases(self):
        """The checked frames on the CPU: the start (frame 0), the sampled
        window frames, and the window's last frame of each kind."""
        rng = np.random.default_rng([self.seed, 3])
        n = int(self.spec["check"]["tracks"])
        chosen = {0: self.keep[0]}
        for f, v in self.keep.items():
            if f != 0 and f < self.window_end:
                chosen[f] = v
        for f, *kept in self.last.values():
            chosen[f] = tuple(kept)
        out = []
        for f in sorted(chosen):
            before, after, host, net, fit = chosen[f]
            cnn = self.is_cnn(f)
            idx = self._sample(rng, f, n, cnn)
            it = torch.as_tensor(idx, device=self.device)
            out.append(checks.Case(
                f, cnn, idx, Program.leaves(before, it),
                Program.leaves(after, it), host[idx],
                self.depth(f)[it].cpu(), None if net is None else
                net[it].cpu(), start=(f == 0),
                fit=None if fit is None else tuple(x[it].cpu()
                                                   for x in fit)))
        return out

    def _sample(self, rng, f, n, cnn):
        """n tracks for frame f: on a CNN frame of a mix with cuts, half of
        them among the tracks that cut since the last CNN frame (the reset
        branch runs on those), the rest uniform."""
        T = self.T
        if cnn and f > 0 and self.traffic.q > 0:
            cut = np.zeros(T, bool)
            for g in range(max(1, f - self.k + 1), f + 1):
                cut |= self.traffic.cut(g)
            pool = np.flatnonzero(cut)
            a = rng.choice(pool, min(n // 2, len(pool)), replace=False)
            rest = np.setdiff1d(np.arange(T), a)
            b = rng.choice(rest, n - len(a), replace=False)
            return np.sort(np.concatenate([a, b]))
        return np.sort(rng.choice(T, min(n, T), replace=False))

    def free(self):
        """Drop the program's state and the pool (after the cases are on
        the CPU)."""
        self.state = self.keep = self.last = None
        self.pool = self._ids_dev = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def device_info(device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                device))}


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def execute(name: str, seed: int, seconds: float, trace: bool, t_proc0,
            device="cuda", tracks=None, control=None, log=sys.stderr):
    """One run of cell `name`: returns the result line's object (or raises).
    t_proc0: the process's start on the host clock (set-up is counted from
    it)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = Run()
    cell = Cell(name, seed, device, tracks)
    run.T = cell.T
    cell.setup()
    run.setup_s = time.perf_counter() - t_proc0
    print(f"# set-up {run.setup_s:.3f} s (T={cell.T}, pool "
          f"{tuple(cell.pool.shape)})", file=log, flush=True)
    Program.reset_launch_counts()
    cell.window(seconds, run)
    counts = Program.launch_counts()
    print(f"# window {run.window_s:.3f} s, {run.frames} frames "
          f"({sum(run.cnn)} CNN), launches {counts}", file=log, flush=True)
    if trace:
        cell.traced(run, int(cell.spec["trace_frames"]))
    if cell.device.type == "cuda":
        torch.cuda.synchronize(cell.device)
    else:
        run.trace = None        # no device: no device number
    dev = device_info(cell.device)
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_us / 1e6
        dev["window_s"] = run.trace.window_us / 1e6
    cases = cell.cases()
    failed, attempted = cell.failed, run.frames * cell.T
    ref = checks.Reference(cell.config, REPO, cell.ref_model)
    cell.free()
    t = time.perf_counter()
    limits = cell.spec["check"]["limits"]
    verdict = checks.judge(cases, ref, limits, cell.start_poses, control)
    print(f"# reference: {len(cases)} frames x "
          f"{len(cases[0].idx)} tracks in {time.perf_counter() - t:.1f} s",
          file=log, flush=True)
    metrics = {}
    for m in metrics_for(name, trace):
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": verdict["correct"] and failed == 0,
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": dev}
    if run.trace is not None:
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = {k: {"value": verdict["numbers"][k], "limit": limits[k]}
                     for k in limits}
    out["checks"]["start_gap"] = {"value": verdict["start_gap"],
                                  "limit": 0.0}
    out["checks"]["failed_frames"] = {"value": failed, "limit": 0}
    return out, run, counts
