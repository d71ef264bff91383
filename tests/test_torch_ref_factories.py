"""The row factories of the CNN frame on the reference solvers, held to the
JAX package's on the same seeded inputs at T=4 (the JAX functions through
jax.vmap):

  * physics.constraints: constrain_angular_drive, constrain_cone_angle and
    constrain_cone_angle_batch (world and body pairs, limits 0, 10, 70);
  * tracker.runtime: apply_angles (the palm drive and the nine finger
    cones) and hand_model_enhancements' three cone kinds (armdir,
    tiepinkyringmid, fingerhold), with its ranges;
  * fitting.cloud: closest_vals and fit_error(use_kernel=False).

Angular rows: bodies and masks equal; axes and torque limits within 1e-6;
target spins within 1e-6 once multiplied by deltaT (the angle each drives
out; the spins carry the 1/deltaT = 60 factor).  closest_vals: the winning
bodies equal, the values within 1e-6; fit_error within 1e-6 relative.

The JAX side is cached as JSON text in tests/fixtures/cache/
(reffactories_*.json) under a hash of the inputs; `python -m
tests.test_torch_ref_factories` writes it."""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from tests.conftest import FIXTURES, MODEL_JSON, cached_fake_depths

# the port tests run small tensors: one intra-op thread each, so the
# suite's parallel workers do not oversubscribe the cores
torch.set_num_threads(1)

T = 4
DRIVES = ((-1, 1, 10000.0), (2, 5, 37.5))          # (b0, b1, maxtorque)
CONE_B0 = (-1, 1, 1, 4, 7, -1, 3)
CONE_B1 = (0, 4, 6, 9, 12, 1, 6)
CONE_LIM = (70.0, 10.0, 10.0, 0.0, 25.0, 10.0, 0.0)
ROW_KINDS = ("drive", "cone", "cone_batch", "apply_angles", "enh")


def _inputs():
    """Seeded inputs: poses (bank frames with rotated quats), drive
    targets, cone axes, a CNN analysis, a camera pose, a cloud."""
    from hand_tracking_samples_tpu_torch.assets_paths import DEFAULT_ANIMBANK
    from hand_tracking_samples_tpu_torch.data.animbank import load_animbank
    bank = load_animbank(DEFAULT_ANIMBANK)
    rng = np.random.default_rng(13)

    def unit(*shape):
        v = rng.standard_normal(shape).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)
    pose = bank[[0, 9, 18, 27]].astype(np.float32).copy()
    q = pose[..., 3:7] + 0.2 * rng.standard_normal((T, 17, 4))
    pose[..., 3:7] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    K = len(CONE_B0)
    return dict(
        pose=pose.astype(np.float32),
        target=unit(T, 4),
        n0=unit(T, K, 3), n1=unit(K, 3),
        palmq=unit(T, 4), camq=unit(T, 4),
        cam_t=(rng.standard_normal((T, 3)) * 0.1).astype(np.float32),
        clenched=rng.uniform(0.0, 1.5, (T, 5)).astype(np.float32),
        armdir=unit(T, 3),
        points=(pose[:, None, 1, :3]
                + rng.standard_normal((T, 300, 3)) * 0.05)
        .astype(np.float32),
        mask=rng.random((T, 300)) < 0.9)


def _depth(hand_model):
    """The cached dyn30 renders of the bank frames the poses start from."""
    from hand_tracking_samples_tpu_torch.assets_paths import DEFAULT_ANIMBANK
    from hand_tracking_samples_tpu_torch.data.animbank import load_animbank
    bank = load_animbank(DEFAULT_ANIMBANK)
    dyn = cached_fake_depths(hand_model, np.asarray(bank[:30])[:, None],
                             "dyn30")[:, 0]
    return dyn[[0, 9, 18, 27]].astype(np.uint16)


def _angular(rows):
    return {f: np.asarray(getattr(rows, f)) for f in rows._fields}


def jax_reference(hand_model):
    """The JAX factories on _inputs, cached."""
    x = _inputs()
    h = hashlib.sha1(b"".join(np.ascontiguousarray(v).tobytes()
                              for v in x.values())
                     + repr((DRIVES, CONE_B0, CONE_B1, CONE_LIM)).encode()
                     ).hexdigest()[:12]
    path = os.path.join(FIXTURES, "cache", f"reffactories_{h}.json")
    if os.path.exists(path):
        with open(path) as f:
            return {k: {f: np.asarray(v) for f, v in d.items()}
                    for k, d in json.load(f).items()}
    import jax
    import jax.numpy as jnp
    from hand_tracking_samples_tpu.cnn.labels import CNNAnalysis
    from hand_tracking_samples_tpu.fitting.cloud import (closest_vals,
                                                         fit_error)
    from hand_tracking_samples_tpu.physics import constraints as jc
    from hand_tracking_samples_tpu.physics.solver import (BodyState,
                                                          concat_angular)
    from hand_tracking_samples_tpu.tracker.runtime import (
        apply_angles, hand_model_enhancements, physics_params)
    from hand_tracking_samples_tpu.tracker.config import TrackerConfig
    from hand_tracking_samples_tpu.data.synth import synth_camera
    params = physics_params(TrackerConfig())
    j = {k: jnp.asarray(v) for k, v in x.items()}
    zb = jnp.zeros((17, 3), jnp.float32)
    st = lambda p: BodyState(pose=p, linear_momentum=zb,
                             angular_momentum=zb)
    i32 = jnp.int32
    out = {}

    def drive(p, tq):
        return concat_angular(*[jc.constrain_angular_drive(
            st(p), i32(b0), i32(b1), tq, mt, params)
            for b0, b1, mt in DRIVES])
    out["drive"] = _angular(jax.vmap(drive)(j["pose"], j["target"]))

    def cone(p, n0):
        return concat_angular(*[jc.constrain_cone_angle(
            st(p), i32(CONE_B0[k]), n0[k], i32(CONE_B1[k]), x["n1"][k],
            CONE_LIM[k], params) for k in range(len(CONE_B0))])
    out["cone"] = _angular(jax.vmap(cone)(j["pose"], j["n0"]))
    out["cone_batch"] = _angular(jax.vmap(
        lambda p, n0: jc.constrain_cone_angle_batch(
            st(p), jnp.asarray(CONE_B0), n0, jnp.asarray(CONE_B1),
            j["n1"], jnp.asarray(CONE_LIM, jnp.float32), params))(
        j["pose"], j["n0"]))

    def aa(p, palmq, camq, ct, cl):
        an = CNNAnalysis(*[None] * len(CNNAnalysis._fields))._replace(
            palmq=palmq, finger_clenched=cl)
        return apply_angles(st(p), hand_model, an,
                            jnp.concatenate([ct, camq]), params, 10000.0)
    out["apply_angles"] = _angular(jax.vmap(aa)(
        j["pose"], j["palmq"], j["camq"], j["cam_t"], j["clenched"]))

    def enh(p, armdir):
        rows, rmin, rmax = hand_model_enhancements(
            st(p), hand_model, params, armdir=armdir, tiepinkyringmid=True,
            fingerhold=0b11111)
        return rows, rmin, rmax
    rows, rmin, rmax = jax.vmap(enh)(j["pose"], j["armdir"])
    out["enh"] = _angular(rows)
    out["enh_ranges"] = {"rmin": np.asarray(rmin), "rmax": np.asarray(rmax)}
    body, val = jax.vmap(lambda p, pts: closest_vals(st(p), hand_model,
                                                     pts))(
        j["pose"], j["points"])
    out["closest_vals"] = {"body": np.asarray(body), "val": np.asarray(val)}
    depth = _depth(hand_model)
    cam = synth_camera()
    out["fit_error"] = {"err": np.asarray(jax.vmap(
        lambda p, pts, m, d: fit_error(st(p), hand_model, pts, m, d, cam,
                                       4.0, use_kernel=False))(
        j["pose"], j["points"], j["mask"], jnp.asarray(depth)))}
    with open(path, "w") as f:       # text: float32 values round-trip
        json.dump({k: {f: v.tolist() for f, v in d.items()}
                   for k, d in out.items()}, f)
    return {k: {f: np.asarray(v.tolist()) for f, v in d.items()}
            for k, d in out.items()}


@pytest.fixture(scope="module")
def port(hand_model):
    """The port's factories on _inputs: the same keys as jax_reference."""
    from hand_tracking_samples_tpu_torch.cnn.labels import CNNAnalysis
    from hand_tracking_samples_tpu_torch.data.synth import synth_camera
    from hand_tracking_samples_tpu_torch.fitting.cloud import (closest_vals,
                                                               fit_error)
    from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
    from hand_tracking_samples_tpu_torch.ops.cloud_kernel import (
        depth_tensor)
    from hand_tracking_samples_tpu_torch.ops.cloud_rows import points_planes
    from hand_tracking_samples_tpu_torch.physics import constraints as pc
    from hand_tracking_samples_tpu_torch.physics.solver import (
        BodyState, concat_angular)
    from hand_tracking_samples_tpu_torch.tracker.config import TrackerConfig
    from hand_tracking_samples_tpu_torch.tracker.runtime import (
        apply_angles, hand_model_enhancements, physics_params)
    model = from_numpy_model({k: np.asarray(v) for k, v in
                              vars(hand_model).items()}, "cpu")
    params = physics_params(TrackerConfig())
    x = {k: torch.tensor(v) for k, v in _inputs().items()}
    pose = x["pose"]
    z = torch.zeros((T, 17, 3))
    body = BodyState(pose, z, z)
    out = {"drive": _angular(concat_angular(*[pc.constrain_angular_drive(
        pose, b0, b1, x["target"], mt, params) for b0, b1, mt in DRIVES]))}
    out["cone"] = _angular(concat_angular(*[pc.constrain_cone_angle(
        pose, CONE_B0[k], x["n0"][:, k], CONE_B1[k], x["n1"][k],
        CONE_LIM[k], params) for k in range(len(CONE_B0))]))
    out["cone_batch"] = _angular(pc.constrain_cone_angle_batch(
        pose, CONE_B0, x["n0"], CONE_B1, x["n1"], CONE_LIM, params))
    an = CNNAnalysis(*[None] * len(CNNAnalysis._fields))._replace(
        palmq=x["palmq"], finger_clenched=x["clenched"])
    out["apply_angles"] = _angular(apply_angles(
        body, model, an, torch.cat([x["cam_t"], x["camq"]], -1), params,
        10000.0))
    rows, rmin, rmax = hand_model_enhancements(
        body, model, params, armdir=x["armdir"], tiepinkyringmid=True,
        fingerhold=0b11111)
    out["enh"] = _angular(rows)
    out["enh_ranges"] = {"rmin": rmin.numpy(), "rmax": rmax.numpy()}
    b, v = closest_vals(pose, model, x["points"])
    out["closest_vals"] = {"body": b.numpy(), "val": v.numpy()}
    depth = _depth(hand_model)
    out["fit_error"] = {"err": fit_error(
        pose, model, points_planes(x["points"], x["mask"]),
        depth_tensor(depth, "cpu"), synth_camera(), 4.0,
        use_kernel=False).numpy()}
    return params, out


@pytest.mark.parametrize("kind", ROW_KINDS)
def test_angular_rows_match_jax(hand_model, port, kind):
    params, mine = port
    ref = jax_reference(hand_model)[kind]
    mine = mine[kind]
    for f in ("b0", "b1", "active"):
        np.testing.assert_array_equal(mine[f], ref[f], err_msg=f)
    for f in ("axis", "mintorque", "maxtorque"):
        np.testing.assert_allclose(mine[f], ref[f], rtol=0, atol=1e-6,
                                   err_msg=f)
    np.testing.assert_allclose(mine["targetspin"] * params.deltaT,
                               ref["targetspin"] * params.deltaT, rtol=0,
                               atol=1e-6)
    if kind == "enh":
        r = jax_reference(hand_model)["enh_ranges"]
        for f in ("rmin", "rmax"):
            np.testing.assert_allclose(port[1]["enh_ranges"][f], r[f],
                                       rtol=0, atol=1e-6, err_msg=f)


def test_closest_vals_and_fit_error_match_jax(hand_model, port):
    mine, ref = port[1], jax_reference(hand_model)
    np.testing.assert_array_equal(mine["closest_vals"]["body"],
                                  ref["closest_vals"]["body"])
    np.testing.assert_allclose(mine["closest_vals"]["val"],
                               ref["closest_vals"]["val"], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(mine["fit_error"]["err"],
                               ref["fit_error"]["err"], rtol=1e-6)


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from hand_tracking_samples_tpu.model.bake import load_hand_model
    hm = jax.tree_util.tree_map(jnp.asarray, load_hand_model(
        MODEL_JSON, cache_dir=os.path.join(FIXTURES, "cache")))
    print({k: list(v) for k, v in jax_reference(hm).items()})
