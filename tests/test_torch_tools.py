"""The port's profiling tools (hand_tracking_samples_tpu_torch.tools) and
their kernels against the JAX package's tools, on the CPU:

  kernel 9   tools.prof_cloud_kernel.stage_plain (what cloud_stage_kernel
             computes) against the JAX tool's make_stage_kernel body under
             pl.pallas_call(..., interpret=True) with stage_call's specs,
             stages 0-4, on two cached renders (dyn30 frames 0 and 15) and
             two seeded rasters (ops.cloud_kernel.synthetic_depths' hand-like
             kinds, keeping about half and three times the budget): stage 4
             bit for bit; stages 1-3 equal (their integer sums lie below
             2^24 here); stage 0 within 1e-5 relative: JAX sums the float32
             products in float32 (XLA's 32x32 windows), up to 4.9e-6 from
             the exact sum on the renders, and the port sums them in float64
             and rounds once
  kernel 10  tools.prof_cloud_mt.group_sum_plain against the JAX tool's
             closure (:35-38, restated here: it cannot be imported) at 1, 2
             and 4 tracks a grid instance, within 1e-5 relative
  kernel 11  tools.prof_cloud_pre.track_sum's plain version against
             prof_cloud_pre.kernel, within 1e-5 relative

The JAX outputs are cached in tests/fixtures/cache/toolkernels_*.npz;
`python -m tests.test_torch_tools` writes them.  One stage runs live
against the JAX module too.  Then each profiling tool's main at T=2 and
one frame on the CPU with its stage lines; prof_full's stage names against
the JAX tool's; and the replacement of HTS_ZERO_PLANES: prof_full's
msim_s1_factories, msim_s1_prep and solve replay exactly the pair
factories, preps and PGS solve that msim_s1 runs."""
import hashlib
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from tests.conftest import FIXTURES

# the port tests run small tensors: one intra-op thread each, so the
# suite's parallel workers do not oversubscribe the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGE0_REL = 1e-5
RASTERS = ("dyn0", "dyn15", "blob_half", "blob_three")
TRACKS_A_BLOCK = (1, 2, 4)


def _jax_tool(name):
    """The JAX tool module tools/<name>.py (not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"jaxtool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rasters():
    """(4, 240, 320) u16: two cached renders, two seeded rasters."""
    import glob
    from hand_tracking_samples_tpu_torch.ops.cloud_kernel import (
        synthetic_depths)
    dyn = np.load(glob.glob(os.path.join(FIXTURES, "cache",
                                         "depths_dyn30_*.npz"))[0])["depths"]
    syn = synthetic_depths(5, 240, 320, seed=11)
    return np.stack([dyn[0, 0], dyn[15, 0], syn[3], syn[4]]).astype(
        np.uint16)


def _jax_stage(mod, depth, stage):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    H, W = depth.shape
    R = H * W // 128
    Rp = -(-R // 8) * 8
    draw = jnp.asarray(depth).astype(jnp.float32).reshape(R, 128)
    scal = jnp.stack([jnp.float32(0.1), jnp.float32(0.7),
                      jnp.float32(0.001)] + [jnp.float32(0)] * 5)
    kernel = mod.make_stage_kernel(R, Rp, mod.BUDGET, mod.FRAC, W, stage)
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((mod.BUDGET, 8), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.SMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True)(draw, scal))


def _jax_mt(draws, trk):
    """prof_cloud_mt's closure (tools/prof_cloud_mt.py:35-49) on (T, 600,
    128) f32 rasters, trk tracks a grid instance."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    T, R = draws.shape[0], draws.shape[1]
    G, RT = T // trk, trk * R

    def kernel(draw_ref, out_ref):
        out_ref[:] = jnp.broadcast_to(jnp.sum(draw_ref[:] * 0.001),
                                      (1, 8, 128))
    return np.asarray(pl.pallas_call(
        kernel, grid=(G,),
        in_specs=[pl.BlockSpec((1, RT, 128), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, 8, 128), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((G, 8, 128), jnp.float32),
        interpret=True)(jnp.asarray(draws).reshape(G, RT, 128)))


def _jax_pre_one(mod, draw):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    return np.asarray(pl.pallas_call(
        mod.kernel, out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True)(jnp.asarray(draw)))


def jax_reference():
    """The JAX tools' kernel outputs on rasters(), cached."""
    deps = rasters()
    h = hashlib.sha1(deps.tobytes())
    for name in ("prof_cloud_kernel", "prof_cloud_mt", "prof_cloud_pre"):
        with open(os.path.join(REPO, "tools", f"{name}.py"), "rb") as f:
            h.update(f.read())
    path = os.path.join(FIXTURES, "cache",
                        f"toolkernels_{h.hexdigest()[:12]}.npz")
    if os.path.exists(path):
        return dict(np.load(path))
    import jax
    jax.config.update("jax_platforms", "cpu")
    stage_mod, pre_mod = _jax_tool("prof_cloud_kernel"), _jax_tool(
        "prof_cloud_pre")
    out = {}
    for s in range(5):
        out[f"stage{s}"] = np.stack([_jax_stage(stage_mod, d, s)
                                     for d in deps])
    draws = deps.astype(np.float32).reshape(len(deps), -1, 128)
    for trk in TRACKS_A_BLOCK:
        out[f"mt{trk}"] = _jax_mt(draws, trk)
    out["pre"] = np.stack([_jax_pre_one(pre_mod, d) for d in draws])
    np.savez_compressed(path, **out)
    return out


@pytest.fixture(scope="module")
def ref():
    return jax_reference()


def _draws():
    from hand_tracking_samples_tpu_torch.tools.common import to_raster
    d = torch.from_numpy(rasters().view(np.int16))
    return to_raster(d)


def test_integer_kept_rule():
    """The TPU stage's float rules equal the integer forms the kernel uses
    (csrc/prof_cloud.cu) for frac <= 16 and every rank below 2^20."""
    r = np.arange(1 << 20, dtype=np.int64)
    rf = r.astype(np.float32)
    for f in range(1, 17):
        inv = np.float32(1.0 / f)
        kept = np.floor(rf * inv) * np.float32(f) == rf
        assert np.array_equal(kept, r % f == 0), f
        base = np.floor((rf + np.float32(f - 1)) * inv).astype(np.int64)
        assert np.array_equal(base, -(-r // f)), f


@pytest.mark.parametrize("stage", range(5))
def test_stage_plain_matches_jax(ref, stage):
    from hand_tracking_samples_tpu_torch.tools.prof_cloud_kernel import (
        cloud_stage, scalars)
    got = cloud_stage(_draws(), scalars(), stage).numpy()
    want = ref[f"stage{stage}"]
    assert got.shape == want.shape
    if stage == 4:
        assert np.array_equal(got, want), np.abs(got - want).max()
        assert (want[:, :, 3].sum(1) > 0).all()
        return
    for t, name in enumerate(RASTERS):
        g, w = got[t], want[t]
        assert (g == g[0, 0]).all() and (w == w[0, 0]).all(), name
        if stage == 0:
            assert abs(g[0, 0] - w[0, 0]) <= STAGE0_REL * abs(w[0, 0]), (
                name, g[0, 0], w[0, 0])
        else:
            assert abs(w[0, 0]) < 2 ** 24 and g[0, 0] == w[0, 0], (
                name, g[0, 0], w[0, 0])


def test_stage_live_against_jax_module():
    """Stages 1 and 4 on one render against the JAX tool's module as it
    stands (the cache above keys on its source)."""
    from hand_tracking_samples_tpu_torch.tools.prof_cloud_kernel import (
        stage_plain, scalars)
    mod = _jax_tool("prof_cloud_kernel")
    dep = rasters()[1]
    draw = _draws()[1:2]
    for s in (1, 4):
        assert np.array_equal(stage_plain(draw, scalars(), s)[0].numpy(),
                              _jax_stage(mod, dep, s))


@pytest.mark.parametrize("trk", TRACKS_A_BLOCK)
def test_group_sum_plain_matches_jax(ref, trk):
    from hand_tracking_samples_tpu_torch.tools.prof_cloud_mt import (
        group_sum)
    d = _draws()
    got = group_sum(d.reshape(d.shape[0] // trk, -1, 128)).numpy()
    want = ref[f"mt{trk}"]
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= STAGE0_REL * np.abs(want))


def test_track_sum_plain_matches_jax(ref):
    from hand_tracking_samples_tpu_torch.tools.common import to_raster
    from hand_tracking_samples_tpu_torch.tools.prof_cloud_pre import (
        track_sum)
    got = track_sum(to_raster(torch.from_numpy(rasters().view(
        np.int16)))).numpy()
    want = ref["pre"]
    assert got.shape == want.shape == (4, 8, 128)
    assert np.all(np.abs(got - want) <= STAGE0_REL * np.abs(want))


def test_tool_wrappers_plain_on_cpu_and_checked():
    """On CPU tensors the wrappers run the plain versions and count no
    launch; anywhere else they launch or raise."""
    from hand_tracking_samples_tpu_torch import kernels
    from hand_tracking_samples_tpu_torch.tools import (prof_cloud_kernel,
                                                       prof_cloud_mt,
                                                       prof_cloud_pre)
    kernels.reset_counts()
    d = _draws()[:2]
    for s in range(5):
        a = prof_cloud_kernel.cloud_stage(d, prof_cloud_kernel.scalars(), s)
        b = torch.cat([prof_cloud_kernel.stage_plain(
            d[t:t + 1], prof_cloud_kernel.scalars(), s) for t in range(2)])
        assert torch.equal(a, b), s        # tracks are independent
    prof_cloud_mt.group_sum(d)
    prof_cloud_pre.track_sum(d)
    assert all(n == 0 for n in kernels.counts().values())
    meta = torch.empty((2, 600, 128), device="meta")
    for fn in (lambda: prof_cloud_kernel.cloud_stage(
            meta, prof_cloud_kernel.scalars(), 4),
            lambda: prof_cloud_mt.group_sum(meta),
            lambda: prof_cloud_pre.track_sum(meta)):
        with pytest.raises(ValueError):
            fn()
    with pytest.raises(ValueError):
        prof_cloud_kernel.cloud_stage(d, prof_cloud_kernel.scalars(), 5)


# ---- the profiling tools' mains ---------------------------------------------
TOOLS = {
    "prof_cloud_kernel": ([], r"stage 5: +[\d.]+ ms/frame \(2 tracks\)", 6),
    "prof_cloud_mt": ([], r"tracks/instance +2: +[\d.]+ ms/frame", 2),
    "prof_cloud_pre": ([], r"current: +[\d.]+ ms/frame", 2),
    "prof_cloud_epi": ([], r"deproject +: +[\d.]+ ms/frame", 3),
    "prof_full": (["prologue", "cloud", "msim_s1_prep"],
                  r"msim_s1_prep +[\d.]+ ms/frame +\(2 tracks", 3),
    "prof_trace": (["cloud"], r"== cloud: host \(no device\) total", 1),
    "profile_frame": (["it11"], r"iters 1\+1 .* ms/frame", 1),
    "profile_stages": (["cloud", "pack", "joints"],
                       r"joint row factories +[\d.]+ ms", 3),
    "profile_cnn_frame": (["segment", "analyze"],
                          r"analyze_cnn_output +[\d.]+ ms", 2),
}


@pytest.mark.parametrize("tool", list(TOOLS))
def test_profiling_tool_main(tool, monkeypatch, capsys, tmp_path):
    import importlib
    argv, pattern, n_lines = TOOLS[tool]
    for k in ("PROF_TRACKS", "BENCH_TRACKS"):
        monkeypatch.setenv(k, "2")
    for k in ("PROF_FRAMES", "BENCH_FRAMES", "PROF_REPS"):
        monkeypatch.setenv(k, "1")
    mod = importlib.import_module(
        f"hand_tracking_samples_tpu_torch.tools.{tool}")
    extra = ["--out", str(tmp_path)] if tool == "prof_trace" else []
    out = mod.main([*argv, "--device", "cpu", *extra])
    text = capsys.readouterr().out
    assert re.search(pattern, text), text[-2000:]
    assert len(out if tool != "prof_trace" else out["ops"]) >= n_lines
    if tool == "prof_trace":
        assert os.path.exists(tmp_path / "trace_cloud.json")
        assert "ops/cloud_kernel.py" in text       # by source line


def test_prof_full_stage_names():
    """The JAX tool's stages (its docstring and its on(...) list) are the
    port's, less the two HTS_ZERO_PLANES stages, which the port replaces
    by timing the factories and preps they dropped."""
    from hand_tracking_samples_tpu_torch.tools.prof_full import STAGES
    src = open(os.path.join(REPO, "tools", "prof_full.py")).read()
    on = set(re.findall(r'on\("(\w+)"\)', src))
    doc = set(re.search(r"Stages: ([^\n]+\n[^\n]+)", src).group(1).split())
    zero = {"msim_s1_zero", "msim_zero"}
    assert zero <= on
    assert (on | doc) - zero <= set(STAGES), (on | doc) - zero - set(STAGES)
    assert not zero & set(STAGES)
    assert {"msim_s1_factories", "msim_s1_prep"} <= set(STAGES)


def test_zero_planes_replaced_by_stages(monkeypatch):
    """msim_s1 (one MultiStepSim step) runs one pair-factories call, one
    pair-preps call and one PGS solve a frame; prof_full's
    msim_s1_factories, msim_s1_prep and solve stages replay exactly those
    calls (the same outputs), the preps' planes are the solve's pair rows,
    and the factories' rows are the preps' input: the two stages cover the
    pair-row work the JAX tool's zero-plane stages dropped."""
    from hand_tracking_samples_tpu_torch.tools.prof_full import Profile
    prof = Profile("cpu", 2, 1)
    calls = prof.captured()
    assert [c[0] for c in calls] == ["pair_factories", "pair_preps",
                                     "pgs_solve"]
    (_, fa, fo), (_, pa, po), (_, sa, _) = calls
    assert pa[1] is fo[0] and pa[2] is fo[1]       # factories -> preps
    assert sa[6] is po[0] and sa[7] is po[1]       # preps -> the solve

    def same(a, b):
        if torch.is_tensor(a):
            return torch.equal(a, b)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        if isinstance(a, np.ndarray):
            return np.array_equal(a, b)
        return a == b
    for name, want in (("msim_s1_factories", fo), ("msim_s1_prep", po)):
        got = prof.replay_fn(name)()
        assert len(got) == 1 and same(got[0], want), name


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    out = jax_reference()
    print({k: v.shape for k, v in out.items()})
