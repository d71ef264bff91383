"""The port's host layer against the JAX package: the bake, the
carry-across of a JAX-baked model and state, and the quaternion maths."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from hand_tracking_samples_tpu.assets_paths import (DEFAULT_ANIMBANK,
                                                    DEFAULT_MODEL_JSON)
from hand_tracking_samples_tpu.data.animbank import load_animbank as jbank
from hand_tracking_samples_tpu.maths import quat as jq
from hand_tracking_samples_tpu.physics.solver import BodyState as JBody
from hand_tracking_samples_tpu.tracker.runtime import (
    make_tracker_state as j_make_state)
from hand_tracking_samples_tpu_torch.assets_paths import (
    DEFAULT_ANIMBANK as P_BANK, DEFAULT_MODEL_JSON as P_JSON)
from hand_tracking_samples_tpu_torch.data.animbank import load_animbank
from hand_tracking_samples_tpu_torch.maths import quat as pq
from hand_tracking_samples_tpu_torch.model.bake import (FIELDS,
                                                        bake_hand_model,
                                                        from_numpy_model)
from hand_tracking_samples_tpu_torch.tracker.runtime import state_from_numpy

# the port tests run small tensors: one intra-op thread each, so the
# suite's parallel workers do not oversubscribe the cores
torch.set_num_threads(1)


def _np_fields(m):
    return {f.name: np.asarray(getattr(m, f.name))
            for f in dataclasses.fields(m)}


def test_port_bake_equals_jax_bake(hand_model):
    """Baked from the same JSON, the port's NumPy bake is the JAX
    package's, field for field and bit for bit."""
    assert P_JSON == DEFAULT_MODEL_JSON and P_BANK == DEFAULT_ANIMBANK
    mine = bake_hand_model(P_JSON).fields()
    ref = _np_fields(hand_model)
    assert set(mine) == set(ref) == set(FIELDS)
    for k in FIELDS:
        assert mine[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)


def test_from_numpy_model_round_trips(hand_model):
    ref = _np_fields(hand_model)
    m = from_numpy_model(ref, "cpu")
    for k in FIELDS:
        got = getattr(m, k).numpy()
        np.testing.assert_array_equal(got, ref[k], err_msg=k)
        np.testing.assert_array_equal(m.np[k], ref[k], err_msg=k)
    assert m.n_bodies == 17 and m.planes.dtype == torch.float32


def test_state_from_numpy(hand_model):
    js = j_make_state(hand_model)
    st = state_from_numpy(type(js)(*[
        JBody(*[np.asarray(x) for x in js.body]) if i == 0 else
        np.asarray(v) for i, v in enumerate(js)]), "cpu")
    np.testing.assert_array_equal(st.body.pose.numpy(),
                                  np.asarray(js.body.pose))
    assert st.initializing.dtype == torch.int32
    b = state_from_numpy(js.body, "cpu")
    np.testing.assert_array_equal(b.angular_momentum.numpy(),
                                  np.asarray(js.body.angular_momentum))


def test_animbank_equal():
    np.testing.assert_array_equal(load_animbank(P_BANK),
                                  jbank(DEFAULT_ANIMBANK))


def test_quat_maths_match_jax():
    rng = np.random.RandomState(0)
    q = rng.randn(64, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v = rng.randn(64, 3).astype(np.float32)
    w = rng.randn(64, 3).astype(np.float32)
    tq, tv, tw = (torch.from_numpy(x) for x in (q, v, w))
    pairs = [(pq.qrot(tq, tv), jq.qrot(q, v)),
             (pq.qmul(tq, tq.flip(0)), jq.qmul(q, q[::-1])),
             (pq.qconj(tq), jq.qconj(q)), (pq.qxdir(tq), jq.qxdir(q)),
             (pq.qydir(tq), jq.qydir(q)), (pq.qzdir(tq), jq.qzdir(q)),
             (pq.qmat(tq), jq.qmat(q)), (pq.orth(tv), jq.orth(v)),
             (pq.safenormalize(tv), jq.safenormalize(v)),
             (pq.quat_from_to(tv, tw), jq.quat_from_to(v, w)),
             (pq.qnormalize(tq * 2), jq.qnormalize(q * 2)),
             (pq.cross(tv, tw), jnp.cross(v, w))]
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-6)


def test_world_iinv_and_rkupdateq_match_jax(hand_model):
    """The solver's world inverse inertia (relative 1e-6 of its scale) and
    RK4 quaternion step (5e-6: spins up to ~30 rad/s through R tinv R^T
    matmuls that the two frameworks associate differently) against the JAX
    package's."""
    from hand_tracking_samples_tpu.physics.solver import (
        _world_iinv as j_iinv, rkupdateq as j_rk)
    from hand_tracking_samples_tpu_torch.physics.pgs_kernel import (
        _batched_world_iinv)
    from hand_tracking_samples_tpu_torch.physics.solver import (_world_iinv,
                                                                rkupdateq)
    q = jbank(DEFAULT_ANIMBANK)[[5, 600]][..., 3:7]             # (2, 17, 4)
    tinv = np.asarray(hand_model.tensorinv_massless)
    mi = np.asarray(hand_model.massinv)
    ref = np.asarray(jax.vmap(jax.vmap(j_iinv))(
        jnp.asarray(q), jnp.broadcast_to(tinv, (2,) + tinv.shape),
        jnp.broadcast_to(mi, (2, 17))))
    tq, tt, tm = torch.tensor(q), torch.tensor(tinv), torch.tensor(mi)
    for got in (_world_iinv(tq, tt, tm), _batched_world_iinv(tq, tt, tm)):
        assert np.abs(got.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()
    ang = np.random.RandomState(0).randn(2, 17, 3).astype(np.float32) * 1e-2
    tmi = tinv * mi[:, None, None]
    ref = np.asarray(jax.vmap(jax.vmap(j_rk, in_axes=(0, 0, 0, None)),
                              in_axes=(0, None, 0, None))(
        jnp.asarray(q), jnp.asarray(tmi), jnp.asarray(ang),
        jnp.float32(1 / 60)))
    got = rkupdateq(tq, torch.tensor(tmi), torch.tensor(ang),
                    float(np.float32(1 / 60)))
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-6)
