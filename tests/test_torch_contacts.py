"""Kernel 3's plain version (physics/contact_kernel.contact_fields_plain)
against the JAX package's contact_fields (its Pallas kernel in interpret
mode) on bank poses with random momenta: active masks equal, every field
within 2e-5 where active (the JAX suite's batched-vs-unbatched bound,
test_contact_batched.py:89)."""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from hand_tracking_samples_tpu.assets_paths import DEFAULT_ANIMBANK
from hand_tracking_samples_tpu.data.animbank import load_animbank
from hand_tracking_samples_tpu.physics.contact_kernel import (
    contact_fields as j_fields)
from hand_tracking_samples_tpu.tracker.config import TrackerConfig
from hand_tracking_samples_tpu.tracker.runtime import (
    physics_params as j_params)
from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
from hand_tracking_samples_tpu_torch.physics.contact_kernel import (
    contact_fields)
from hand_tracking_samples_tpu_torch.tracker.runtime import physics_params

# the port tests run small tensors: one intra-op thread each, so the
# suite's parallel workers do not oversubscribe the cores
torch.set_num_threads(1)


def test_contact_fields_match_jax(golden, hand_model):
    bank = load_animbank(DEFAULT_ANIMBANK)
    frames = [int(golden["contact_frame"][0])] + list(
        range(0, len(bank), len(bank) // 7))[:7]
    rng = np.random.RandomState(3)
    pose = bank[frames].astype(np.float32)
    lin = (rng.randn(len(frames), 17, 3) * 1e-3).astype(np.float32)
    ang = (rng.randn(len(frames), 17, 3) * 1e-4).astype(np.float32)
    jp = j_params(TrackerConfig())
    ref = jax.jit(lambda p, l, a: j_fields(p, l, a, hand_model, jp, 4))(
        jnp.asarray(pose), jnp.asarray(lin), jnp.asarray(ang))
    model = from_numpy_model({k: np.asarray(v) for k, v in
                              vars(hand_model).items()}, "cpu")
    mine = contact_fields(torch.tensor(pose), torch.tensor(lin),
                          torch.tensor(ang), model,
                          physics_params(TrackerConfig()), 4)
    (jn, js, jv, jr0, jr1, ja), (n, s, v, r0, r1, a) = ref, mine
    ja = np.asarray(ja)
    np.testing.assert_array_equal(a.numpy(), ja)
    assert ja.sum() > 50
    act = ja                                        # (NP, Pt, T)
    pair_act = ja.any(1)                            # (NP, T)
    for c in range(3):
        np.testing.assert_allclose(n[c].numpy()[pair_act],
                                   np.asarray(jn[c])[pair_act], atol=2e-5)
        np.testing.assert_allclose(r0[c].numpy()[act],
                                   np.asarray(jr0[c])[act], atol=2e-5)
        np.testing.assert_allclose(r1[c].numpy()[act],
                                   np.asarray(jr1[c])[act], atol=2e-5)
    np.testing.assert_allclose(s.numpy()[act], np.asarray(js)[act],
                               atol=2e-5)
    np.testing.assert_allclose(v.numpy()[act], np.asarray(jv)[act],
                               atol=2e-5)
