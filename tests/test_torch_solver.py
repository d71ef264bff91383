"""The port's reference-shaped solvers (physics.solver.physics_update, the
sequential solve, and physics.colored.physics_update_colored), run through
the plain row sweep on the CPU:

  * against the C++ goldens of tests/fixtures/golden.json at the JAX
    suite's own bounds: the joint solve (test_solver.py:21, 5e-4 m and
    quat 5e-3), FitPointCloud x4 (test_solver.py:68, 5e-4 m and quat 1e-2)
    and the joint + contact solve (test_contacts_golden.py:68, mean < 1 mm,
    max < 3 mm);
  * against the JAX package's solves on the same rows (its rows, converted):
    physics_update and physics_update_colored within 1e-6 m;
  * the port's colored fit against its sequential fit within 1e-5 m and
    quat 1e-5 (test_colored_solver.py:38)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hand_tracking_samples_tpu.assets_paths import DEFAULT_ANIMBANK
from hand_tracking_samples_tpu.data.animbank import load_animbank
from hand_tracking_samples_tpu.fitting.cloud import (
    cloud_constraint_rows as j_cloud, scale_cloud_forces as j_scale)
from hand_tracking_samples_tpu.model import hand as jh
from hand_tracking_samples_tpu.physics import colored as jc
from hand_tracking_samples_tpu.physics import solver as js
from hand_tracking_samples_tpu.physics.contacts import (
    contact_rows as j_contacts)
from hand_tracking_samples_tpu.physics.schedule import (
    build_hand_schedule as j_schedule, pair_angular as j_pair_ang,
    pair_linear as j_pair_lin)
from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
from hand_tracking_samples_tpu_torch.model.hand import (
    body_params, fit_point_cloud, joint_angular_rows, joint_linear_rows)
from hand_tracking_samples_tpu_torch.physics import colored as pc
from hand_tracking_samples_tpu_torch.physics import solver as ps
from hand_tracking_samples_tpu_torch.physics.schedule import (
    build_hand_schedule)
from tests.conftest import quat_err

# the port tests run small tensors: one intra-op thread each, so the
# suite's parallel workers do not oversubscribe the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def model(hand_model):
    return from_numpy_model({k: np.asarray(v) for k, v in
                             vars(hand_model).items()}, "cpu")


def _state(pose, T=1):
    pose = torch.tensor(np.asarray(pose, np.float32))
    pose = pose.expand((T,) + pose.shape[-2:]).contiguous()
    z = torch.zeros(pose.shape[:-1] + (3,))
    return ps.BodyState(pose, z, z.clone())


def test_joint_solve_golden(golden, model):
    params = ps.PhysicsParams()
    st = _state(golden["solve1_pose_in"])
    bp = body_params(model)
    for _ in range(3):
        st = ps.physics_update(st, bp, joint_linear_rows(st, model),
                               joint_angular_rows(st, model, params), params)
    out = st.pose[0].numpy()
    ref = np.array(golden["solve1_pose_out"], np.float32)
    assert np.abs(out[:, :3] - ref[:, :3]).max() < 5e-4
    assert quat_err(out[:, 3:], ref[:, 3:]) < 5e-3


def test_fit_point_cloud_golden(golden, model):
    """4x FitPointCloud (sequential) against the reference."""
    params = ps.PhysicsParams()
    pts = torch.tensor(np.array(golden["solve2_points"], np.float32))[None]
    mask = torch.ones(pts.shape[:2], dtype=torch.bool)
    st = _state(golden["solve2_pose_in"])
    for it in range(4):
        st = fit_point_cloud(st, model, params, pts, mask)
        ref = np.array(golden[f"solve2_pose_it{it}"], np.float32)
        mine = st.pose[0].numpy()
        assert np.abs(mine[:, :3] - ref[:, :3]).max() < 5e-4, it
        assert quat_err(mine[:, 3:], ref[:, 3:]) < 1e-2, it


def test_contact_solve_golden(golden, model):
    """3 joint + contact updates from the golden's clenched pose."""
    bank = load_animbank(DEFAULT_ANIMBANK)
    frame = int(golden["contact_frame"][0])
    np.testing.assert_allclose(bank[frame], np.array(
        golden["contact_pose_in"], np.float32), atol=1e-5)
    params = ps.PhysicsParams()
    st = _state(bank[frame])
    for _ in range(3):
        st = fit_point_cloud(st, model, params, torch.zeros((1, 0, 3)),
                             torch.zeros((1, 0), dtype=torch.bool),
                             contacts=True)
    ref = np.array(golden["contact_pose_out"], np.float32)
    dev = np.linalg.norm(st.pose[0, :, :3].numpy() - ref[:, :3], axis=1)
    assert dev.mean() < 1.0e-3 and dev.max() < 3.0e-3, dev


def _rows(r, cls):
    return cls(*[torch.tensor(np.asarray(x))[None] for x in r])


def _block(b):
    """A JAX colored block as the port's."""
    if isinstance(b, jc.SingleBodyLinear):
        return pc.SingleBodyLinear(*[torch.tensor(np.asarray(x))[None]
                                     for x in b])
    cls = ps.LinearRows if isinstance(b, jc.StaticPairLinear) \
        else ps.AngularRows
    out = pc.StaticPairLinear if cls is ps.LinearRows \
        else pc.StaticPairAngular
    return out(_rows(b.rows, cls), np.asarray(b.gidx), np.asarray(b.gmask))


@pytest.fixture(scope="module")
def jax_solves(golden, hand_model):
    """One solve of each JAX solver on its own rows (cloud, joints,
    contacts) at the golden's clenched contact pose with small momenta, the
    solve2 cloud moved onto its palm: (state, rows, blocks, sequential
    result, colored result)."""
    m = hand_model
    pose = load_animbank(DEFAULT_ANIMBANK)[int(golden["contact_frame"][0])]
    shift = pose[1, :3] - np.array(golden["solve2_pose_in"], np.float32)[1,
                                                                         :3]
    pts = jnp.asarray(np.array(golden["solve2_points"], np.float32) + shift)
    mask = jnp.ones(len(pts), bool)
    rng = np.random.RandomState(0)
    st = js.BodyState(
        jnp.asarray(pose),
        jnp.asarray(rng.randn(17, 3).astype(np.float32) * 1e-3),
        jnp.asarray(rng.randn(17, 3).astype(np.float32) * 1e-4))
    params = js.PhysicsParams()
    bp = jh.body_params(m)
    sched = j_schedule(m)

    @jax.jit
    def run(st):
        c = j_cloud(st, m, pts, mask)
        weak = (c.b1 <= 2).astype(jnp.float32)
        c = j_scale(c, weak * 0.4 + (1 - weak))
        nailed = jh.joint_linear_rows(st, m)
        con = j_contacts(st, m, params)
        ang = jh.joint_angular_rows(st, m, params)
        lin = js.concat_linear(c, nailed, con)
        blocks = [jc.pack_single_body_linear(c, 17, 128),
                  j_pair_lin(nailed, sched.joint_lin),
                  j_pair_lin(con, sched.contact)]
        ablocks = [j_pair_ang(ang, sched.joint_ang)]
        return (lin, ang, blocks, ablocks,
                js.physics_update(st, bp, lin, ang, params),
                jc.physics_update_colored(st, bp, blocks, ablocks, params))
    return (st,) + run(st)


def test_physics_update_matches_jax(jax_solves, model):
    st, lin, ang, _, _, ref, _ = jax_solves
    assert int(np.asarray(lin.active)[-1044:].sum()) > 0   # contacts on
    pst = ps.BodyState(*[torch.tensor(np.asarray(x))[None] for x in st])
    out = ps.physics_update(pst, body_params(model), _rows(lin,
                            ps.LinearRows), _rows(ang, ps.AngularRows),
                            ps.PhysicsParams())
    assert np.abs(out.pose[0].numpy() - np.asarray(ref.pose)).max() < 1e-6
    for a, b in zip(out[1:], ref[1:]):
        assert np.abs(a[0].numpy() - np.asarray(b)).max() < 1e-5


def test_physics_update_colored_matches_jax(jax_solves, model):
    st, _, _, blocks, ablocks, _, ref = jax_solves
    pst = ps.BodyState(*[torch.tensor(np.asarray(x))[None] for x in st])
    out = pc.physics_update_colored(
        pst, body_params(model), [_block(b) for b in blocks],
        [_block(b) for b in ablocks], ps.PhysicsParams())
    assert np.abs(out.pose[0].numpy() - np.asarray(ref.pose)).max() < 1e-6
    for a, b in zip(out[1:], ref[1:]):
        assert np.abs(a[0].numpy() - np.asarray(b)).max() < 1e-5


def test_colored_blocks_match_jax(hand_model):
    """The colored solver's host schedules and slot packs against the JAX
    package's: make_static_pair_linear/angular's groups (pad_groups) and
    pack_single_body_angular's slots, on seeded rows."""
    rng = np.random.RandomState(4)
    R, B = 40, 17
    b0 = rng.randint(-1, B, R)
    b1 = rng.randint(0, B, R)
    for jmake, pmake, jr, pr in (
            (jc.make_static_pair_linear, pc.make_static_pair_linear,
             js.LinearRows.empty(R), None),
            (jc.make_static_pair_angular, pc.make_static_pair_angular,
             js.AngularRows.empty(R), None)):
        ref = jmake(jr, b0, b1, B)
        mine = pmake(pr, b0, b1)
        np.testing.assert_array_equal(mine.gidx, np.asarray(ref.gidx))
        np.testing.assert_array_equal(mine.gmask, np.asarray(ref.gmask))
    rows = js.AngularRows(
        b0=jnp.full(R, -1, jnp.int32), b1=jnp.asarray(b1, jnp.int32),
        axis=jnp.asarray(rng.randn(R, 3).astype(np.float32)),
        targetspin=jnp.asarray(rng.randn(R).astype(np.float32)),
        mintorque=jnp.asarray(-rng.rand(R).astype(np.float32)),
        maxtorque=jnp.asarray(rng.rand(R).astype(np.float32)),
        active=jnp.asarray(rng.rand(R) < 0.8))
    ref = jc.pack_single_body_angular(rows, B, 2)
    mine = pc.pack_single_body_angular(_rows(rows, ps.AngularRows), B, 2)
    for f in ref._fields:
        np.testing.assert_array_equal(getattr(mine, f)[0].numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)


def test_colored_matches_sequential(golden, model):
    """The port's two solvers on the port's own rows, 3 fits with
    contacts; 512 cloud slots a body, so no row is thinned."""
    params = ps.PhysicsParams()
    sched = build_hand_schedule(model.np)
    pts = torch.tensor(np.array(golden["solve2_points"], np.float32))[None]
    mask = torch.ones(pts.shape[:2], dtype=torch.bool)
    seq = col = _state(golden["solve2_pose_in"])
    for _ in range(3):
        seq = fit_point_cloud(seq, model, params, pts, mask, contacts=True)
        col = fit_point_cloud(col, model, params, pts, mask, contacts=True,
                              schedule=sched, cloud_slots=512)
    a, b = seq.pose[0].numpy(), col.pose[0].numpy()
    assert np.abs(a[:, :3] - b[:, :3]).max() < 1e-5
    assert quat_err(a[:, 3:], b[:, 3:]) < 1e-5
