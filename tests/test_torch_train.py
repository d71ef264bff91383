"""CNN training in the port against the JAX package and the C++ goldens:

  sgd_step       golden.json's cnn_train_mse within 1e-6 and
                 cnn_output_after_step within 1e-5 from golden_cnn_init.cnnb
                 (tests/test_cnn.py:25-38), on the fused model and on the
                 layer stack;
  .cnnb          save_cnnb/load_cnnb round trip bit for bit, the file
                 readable by the JAX package's load_cnnb, init_params'
                 shapes and Xavier ranges;
  layer stack    equal to the fused model to 1e-5 (and the golden output),
                 its .cnnb round trip to 1e-7, the pool variants, and a
                 small stack of every layer kind (ties in a max pool
                 included) against JAX's Stack: forward and one SGD step
                 within 1e-5;
  compress       compress_frame bit for bit with JAX's run one frame at a
                 time (inputs, labels, segment-frame poses), on 8 recorded
                 frames of cnntrack_rec and 2 synthetic renders;
  train_epoch    3 steps at batch 4 from JAX's init_params(PRNGKey(0)) on
                 those frames, the same RandomState draws: every parameter
                 within 1e-5 of JAX's, the epoch MSE and evaluate within
                 1e-6; train_epoch_scanned equal to train_epoch;
  augmentation   an augmented synthetic set differs from the plain one and
                 still holds the hand (tests/test_train_meshes.py:41);
  checkpoints    tracker state through .npz (read by the JAX package too)
                 and the training state through torch.save.

JAX's compressed frames are cached in tests/fixtures/cache/compress_*.npz
(`python -m tests.test_torch_train` writes them, ~10 s); the JAX training
steps (~10 s) run in the test: their 9.4M parameters are no cache entry."""
import glob
import hashlib
import os

import numpy as np
import pytest
import torch

from tests.conftest import DEFAULT_ANIMBANK, FIXTURES

torch.set_num_threads(1)

CNNB = os.path.join(FIXTURES, "golden_cnn_init.cnnb")
REC_FRAMES = 8
SYN_FRAMES = (0, 1)          # dyn30 renders of bank[0], bank[1]


def _golden_target():
    t = np.zeros(2304, np.float32)
    for i in range(8):
        t[i * 256 + 37] = 1.0
    for i in range(16):
        t[2048 + i * 16 + 5] = 1.0
    return t


def _inputs():
    """(recorded depth, poses, camera args), (synthetic depth, poses)."""
    from hand_tracking_samples_tpu_torch.data.animbank import load_animbank
    from hand_tracking_samples_tpu_torch.data.dataset import load_dataset
    ds = load_dataset(os.path.join(FIXTURES, "cnntrack_rec"))
    dyn = np.load(glob.glob(os.path.join(FIXTURES, "cache",
                                         "depths_dyn30_*.npz"))[0])["depths"]
    bank = load_animbank(DEFAULT_ANIMBANK)
    return ((ds.depth[:REC_FRAMES], ds.pose[:REC_FRAMES]),
            (dyn[list(SYN_FRAMES), 0], bank[list(SYN_FRAMES)]))


def jax_compressed():
    """JAX's compress_frame, one frame at a time, cached."""
    (rd, rp), (sd, sp) = _inputs()
    h = hashlib.sha1(b"".join(np.ascontiguousarray(a).tobytes()
                              for a in (rd, rp, sd, sp))
                     + b"compress 1").hexdigest()[:12]
    path = os.path.join(FIXTURES, "cache", f"compress_{h}.npz")
    if os.path.exists(path):
        return dict(np.load(path))
    import jax
    import jax.numpy as jnp
    from hand_tracking_samples_tpu.cnn.train import compress_frame
    from hand_tracking_samples_tpu.data.dataset import load_dataset
    from hand_tracking_samples_tpu.data.synth import synth_camera
    out = {}
    for name, d, p, cam in (
            ("rec", rd, rp, load_dataset(os.path.join(
                FIXTURES, "cnntrack_rec")).info.camera()),
            ("syn", sd, sp, synth_camera())):
        fn = jax.jit(lambda x, q: compress_frame(x, cam, q))
        res = [fn(jnp.asarray(d[i]), jnp.asarray(p[i])) for i in range(len(d))]
        for k, field in enumerate(("inputs", "labels", "poses")):
            out[f"{name}_{field}"] = np.stack([np.asarray(r[k])
                                               for r in res])
    np.savez_compressed(path, **out)
    return out


@pytest.fixture(scope="module")
def cached():
    return jax_compressed()


@pytest.fixture(scope="module")
def golden_in(golden):
    return (torch.tensor(np.asarray(golden["cnn_input"], np.float32))
            .reshape(1, 64, 64), torch.tensor(_golden_target())[None])


@pytest.mark.parametrize("path", ["fused", "stack"])
def test_sgd_step_golden(golden, golden_in, path):
    from hand_tracking_samples_tpu_torch.cnn import layers, model
    x, t = golden_in
    if path == "fused":
        p = model.load_cnnb(CNNB, "cpu")
        p2, mse = model.sgd_step(p, x, t, 0.001)
        y = model.forward(p2, x)[0]
    else:
        stack = layers.pose_initializer_stack()
        p2, mse = stack.sgd_step(stack.load_cnnb(CNNB, "cpu"), x, t, 0.001)
        y = stack.forward(p2, x)[0]
    assert abs(mse.item() - golden["cnn_train_mse"][0]) < 1e-6
    np.testing.assert_allclose(y.numpy(), golden["cnn_output_after_step"],
                               atol=1e-5)


def test_cnnb_roundtrip(tmp_path):
    from hand_tracking_samples_tpu.cnn.model import load_cnnb as jax_load
    from hand_tracking_samples_tpu_torch.cnn.model import (
        OUT, init_params, load_cnnb, save_cnnb, to_numpy)
    p = init_params(torch.Generator().manual_seed(0), "cpu")
    shapes = {"conv1": ((5, 5, 1, 16), 5 * 5 * 1, 5 * 5 * 16),
              "conv2": ((4, 4, 16, 64), 4 * 4 * 16, 4 * 4 * 64),
              "fc1": ((2304, 2048), 2304, 2048),
              "fc2": ((2048, OUT), 2048, OUT)}
    for k, (shape, fi, fo) in shapes.items():
        assert tuple(p[k]["w"].shape) == shape
        r = np.sqrt(6.0 / (fi + fo))
        assert p[k]["w"].abs().max().item() <= r
        assert p[k]["w"].abs().max().item() > 0.9 * r
        assert not p[k]["b"].any()
    f = str(tmp_path / "w.cnnb")
    save_cnnb(p, f)
    back, jax_back = load_cnnb(f, "cpu"), jax_load(f)
    for k in p:
        for kk in p[k]:
            np.testing.assert_array_equal(back[k][kk].numpy(),
                                          p[k][kk].numpy())
            np.testing.assert_array_equal(np.asarray(jax_back[k][kk]),
                                          to_numpy(p)[k][kk])


def test_stack_matches_fused(golden, golden_in):
    from hand_tracking_samples_tpu_torch.cnn import layers, model
    stack = layers.pose_initializer_stack()
    x = golden_in[0]
    y1 = stack.forward(stack.load_cnnb(CNNB, "cpu"), x)[0]
    np.testing.assert_allclose(y1.numpy(), golden["cnn_output"], atol=1e-5)
    y2 = model.forward(model.load_cnnb(CNNB, "cpu"), x)[0]
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-5)


def test_stack_roundtrip_and_pools(tmp_path):
    from hand_tracking_samples_tpu_torch.cnn.layers import (
        Activation, AvgPool, Full, MaxPool, SoftMax, SparsePool, Stack)
    stack = Stack([Full(8, 16), Activation(16, "relu"), Full(16, 4),
                   SoftMax(4)])
    p = stack.init(torch.Generator().manual_seed(1), "cpu")
    f = str(tmp_path / "s.cnnb")
    stack.save_cnnb(p, f)
    back = stack.load_cnnb(f, "cpu")
    x = torch.tensor(np.random.RandomState(0).rand(3, 8).astype(np.float32))
    np.testing.assert_allclose(stack.forward(p, x).numpy(),
                               stack.forward(back, x).numpy(), atol=1e-7)
    x = torch.arange(2 * 4 * 4, dtype=torch.float32).reshape(1, -1)
    img = x.numpy().reshape(2, 4, 4)[0]
    np.testing.assert_array_equal(
        MaxPool((4, 4, 2)).forward({}, x).reshape(2, 2, 2)[0].numpy(),
        img.reshape(2, 2, 2, 2).max(axis=(1, 3)))
    np.testing.assert_array_equal(
        AvgPool((4, 4, 2)).forward({}, x).reshape(2, 2, 2)[0].numpy(),
        img.reshape(2, 2, 2, 2).mean(axis=(1, 3)))
    np.testing.assert_array_equal(
        SparsePool((4, 4, 2)).forward({}, x).reshape(2, 2, 2)[0].numpy(),
        img[::2, ::2])


def _small_stacks(mod):
    """A stack of every layer kind, in either package's layer module."""
    return mod.Stack([
        mod.Conv((10, 10, 2), (3, 3, 2, 4), (8, 8, 4)),
        mod.Activation(8 * 8 * 4, "relu"),            # zeros tie in the pool
        mod.MaxPool((8, 8, 4)),
        mod.ConvS((4, 4), 4, 3, (1, 2), (2, 1)),
        mod.Activation(4 * 4 * 3, "leakyrelu"),
        mod.AvgPool((4, 4, 3)),
        mod.SparsePool((2, 2, 3)),
        mod.Full(3, 12),
        mod.Activation(12, "sigmoid"),
        mod.Full(12, 12),
        mod.Activation(12, "tanh"),
        mod.SoftMaxChunked((4, 8)),
        mod.Full(12, 6),
        mod.CrossEntropy(6),
    ])


def test_stack_matches_jax_stack(tmp_path):
    import jax
    import jax.numpy as jnp
    from hand_tracking_samples_tpu.cnn import layers as J
    from hand_tracking_samples_tpu_torch.cnn import layers as P
    mine, theirs = _small_stacks(P), _small_stacks(J)
    p = mine.init(torch.Generator().manual_seed(3), "cpu")
    f = str(tmp_path / "small.cnnb")
    mine.save_cnnb(p, f)
    jp = theirs.load_cnnb(f)
    rng = np.random.RandomState(4)
    x = rng.rand(5, 2 * 10 * 10).astype(np.float32) - 0.3
    t = rng.rand(5, 6).astype(np.float32)
    np.testing.assert_allclose(
        mine.forward(p, torch.tensor(x)).numpy(),
        np.asarray(theirs.forward(jp, jnp.asarray(x))), atol=1e-6)
    p2, mse = mine.sgd_step(p, torch.tensor(x), torch.tensor(t), 0.5)
    jp2, jmse = jax.jit(theirs.sgd_step)(jp, jnp.asarray(x),
                                         jnp.asarray(t), 0.5)
    assert abs(mse.item() - float(jmse)) < 1e-6
    for a, b in zip(p2, jp2):
        for k in a:
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                       atol=1e-5)


def _port_sets(cached):
    """The port's compressed frames: (recorded, synthetic) TrainingSets."""
    from hand_tracking_samples_tpu_torch.cnn.train import compress_dataset
    from hand_tracking_samples_tpu_torch.data.dataset import load_dataset
    from hand_tracking_samples_tpu_torch.data.synth import synth_camera
    (rd, rp), (sd, sp) = _inputs()
    cam = load_dataset(os.path.join(FIXTURES, "cnntrack_rec")).info.camera()
    return (compress_dataset(rd, cam, rp, chunk=4, device="cpu"),
            compress_dataset(sd, synth_camera(), sp, device="cpu"))


def test_compress_frame_matches_jax(cached):
    for name, data in zip(("rec", "syn"), _port_sets(cached)):
        for field in data._fields:
            np.testing.assert_array_equal(getattr(data, field).numpy(),
                                          cached[f"{name}_{field}"])
    # the crops hold the hand and the heatmaps have unit volume
    assert ((cached["rec_inputs"] > 0).mean((1, 2)) > 0.05).all()
    assert ((cached["syn_inputs"] > 0.3).mean((1, 2)) > 0.05).all()
    np.testing.assert_allclose(
        cached["syn_labels"][:, :2048].reshape(-1, 8, 256).sum(-1), 1.0,
        atol=0.05)


def test_train_epoch_matches_jax(cached):
    import jax
    import jax.numpy as jnp
    from hand_tracking_samples_tpu.cnn import model as JM
    from hand_tracking_samples_tpu.cnn import train as JT
    from hand_tracking_samples_tpu_torch.cnn import model as PM
    from hand_tracking_samples_tpu_torch.cnn import train as PT
    jdata = JT.TrainingSet(*[jnp.asarray(cached[f"rec_{f}"])
                             for f in ("inputs", "labels", "poses")])
    pdata = PT.TrainingSet(*[torch.tensor(cached[f"rec_{f}"])
                             for f in ("inputs", "labels", "poses")])
    jp = JM.init_params(jax.random.PRNGKey(0))
    pp = PM.from_numpy({k: {kk: np.asarray(vv) for kk, vv in v.items()}
                        for k, v in jp.items()}, "cpu")
    jp2, jmse = JT.train_epoch(jp, jdata, np.random.RandomState(0), 3,
                               batch_size=4)
    pp2, pmse = PT.train_epoch(pp, pdata, np.random.RandomState(0), 3,
                               batch_size=4)
    assert abs(pmse - jmse) < 1e-6
    for k in jp2:
        for kk in jp2[k]:
            np.testing.assert_allclose(pp2[k][kk].numpy(),
                                       np.asarray(jp2[k][kk]), atol=1e-5)
    assert abs(PT.evaluate(pp2, pdata) - JT.evaluate(jp2, jdata)) < 1e-6
    ps, smse = PT.train_epoch_scanned(pp, pdata, np.random.RandomState(0),
                                      3, batch_size=4)
    for k in ps:
        for kk in ps[k]:
            assert torch.equal(ps[k][kk], pp2[k][kk])
    assert abs(smse - pmse) < 1e-6


def test_augmented_set_differs():
    from hand_tracking_samples_tpu_torch.assets_paths import (
        DEFAULT_MODEL_JSON)
    from hand_tracking_samples_tpu_torch.cnn.train import (
        synthetic_training_set)
    from hand_tracking_samples_tpu_torch.data.animbank import load_animbank
    from hand_tracking_samples_tpu_torch.model.bake import (from_numpy_model,
                                                            load_hand_model)
    model = from_numpy_model(load_hand_model(
        DEFAULT_MODEL_JSON, cache_dir=os.path.join(FIXTURES, "cache")), "cpu")
    bank = load_animbank(DEFAULT_ANIMBANK)
    ids = np.arange(0, 8)
    a = synthetic_training_set(model, bank, ids, chunk=8, device="cpu")
    b = synthetic_training_set(model, bank, ids, chunk=8, augment=True,
                               device="cpu")
    assert (a.inputs - b.inputs).abs().mean().item() > 0.005
    assert (b.inputs > 0.3).float().mean().item() > 0.03
    c = synthetic_training_set(model, bank, ids, chunk=8, augment=True,
                               device="cpu")
    assert torch.equal(b.inputs, c.inputs)          # the seed decides


def test_checkpoints(tmp_path):
    import jax
    import jax.numpy as jnp
    from hand_tracking_samples_tpu.model.bake import load_hand_model as jlm
    from hand_tracking_samples_tpu.parallel.tracks import (
        batched_tracker_state as jax_state)
    from hand_tracking_samples_tpu.utils.checkpoint import (
        load_tracker_state as jax_load)
    from hand_tracking_samples_tpu_torch.cnn.model import init_params
    from hand_tracking_samples_tpu_torch.model.bake import (from_numpy_model,
                                                            load_hand_model)
    from hand_tracking_samples_tpu_torch.parallel.tracks import (
        batched_tracker_state)
    from hand_tracking_samples_tpu_torch.utils import checkpoint
    from tests.conftest import MODEL_JSON
    cache = os.path.join(FIXTURES, "cache")
    model = from_numpy_model(load_hand_model(MODEL_JSON, cache_dir=cache),
                             "cpu")
    st = batched_tracker_state(model, 3)
    st = st._replace(initializing=torch.tensor([0, 5, 50],
                                               dtype=torch.int32))
    f = str(tmp_path / "state.npz")
    checkpoint.save_tracker_state(f, st)
    back = checkpoint.load_tracker_state(f, st)
    assert type(back) is type(st)
    for a, b in zip(back.body + back[1:], st.body + st[1:]):
        assert torch.equal(a, b)
    jm = jax.tree_util.tree_map(jnp.asarray, jlm(MODEL_JSON, cache_dir=cache))
    theirs = jax_load(f, jax_state(jm, 3))
    np.testing.assert_array_equal(np.asarray(theirs.body.pose),
                                  st.body.pose.numpy())
    np.testing.assert_array_equal(np.asarray(theirs.initializing),
                                  st.initializing.numpy())
    p = init_params(torch.Generator().manual_seed(2), "cpu")
    f = str(tmp_path / "train.pt")
    checkpoint.save_training_state(f, p, 1234)
    q, step = checkpoint.load_training_state(f, "cpu")
    assert step == 1234
    assert all(torch.equal(p[k][kk], q[k][kk]) for k in p for kk in p[k])


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    print(sorted(jax_compressed()))
