"""Jacobi contacts (contacts_mode="jacobi") in the port against the JAX
package, T=2 at full width (17 bones, 87 collide pairs, point budget 2048):

  colored   the colored fit with the jacobi contact phases, 3 fits, in the
            setting of tests/test_colored_solver.py (the golden's solve2
            cloud and pose) and on a contact pose (the golden's
            contact_frame, its own render's cloud: the cloud kernel's,
            bit for bit in both packages), against the JAX
            package's colored jacobi fit: < 1e-5 m; the port's jacobi fit
            stays < 3e-4 m from its exact one (test_colored_solver.py's
            bound);
  frames    one dynamics frame on the kernel solver (use_pallas, the PGS
            kernel's jacobi contact class on CPU tensors: pgs_solve_plain)
            and one on the colored solver (the row sweep's jacobi levels)
            on the renders of two contact poses started at their ground
            truth, against the JAX package's batched_update (its Pallas
            kernels in interpret mode): < 1e-5 m and quat_err 1e-4; the
            two solvers' jacobi frames lie millimetres apart there, in
            both packages.

The two JAX jacobi paths differ from each other by ~1e-4 m a solve
(hand_tracking_samples_tpu/tracker/config.py): the port's kernel solver is
held to JAX's kernel path and its colored solver to JAX's colored one.
Every case asserts that contact rows are active (with none, jacobi and
exact agree trivially).  The JAX side is cached as JSON text in
tests/fixtures/cache/ (jacobi_*.json); `python -m tests.test_torch_jacobi`
writes it.

The row sweep's jacobi levels and the PGS kernel's jacobi class are held
to their plain versions here as the CPU can: row_sweep_waves (the kernel's
wavefront order) equals row_sweep_plain (row order) bit for bit on jacobi
rows, and the jacobi plan's per-body lists cover every (unit, side)
once."""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from tests.conftest import FIXTURES, MODEL_JSON, cached_fake_depths, quat_err

# the port tests run small tensors: one intra-op thread each, so the
# suite's parallel workers do not oversubscribe the cores
torch.set_num_threads(1)

CONTACT_FRAMES = (1175, 333)   # the golden's contact_frame; a fist
FITS = 3


def _contact_inputs(hand_model):
    from hand_tracking_samples_tpu.assets_paths import DEFAULT_ANIMBANK
    from hand_tracking_samples_tpu.data.animbank import load_animbank
    bank = load_animbank(DEFAULT_ANIMBANK)
    poses = np.asarray(bank[list(CONTACT_FRAMES)], np.float32)
    depth = cached_fake_depths(hand_model, poses[:, None], "jac2")[:, 0]
    return poses, depth.astype(np.uint16)


def _golden():
    with open(os.path.join(FIXTURES, "golden.json")) as f:
        g = json.load(f)
    return (np.asarray(g["solve2_points"], np.float32),
            np.asarray(g["solve2_pose_in"], np.float32))


def _frame_cfg(cls, solver):
    return cls(point_budget=2048, cnn_every_frame=False,
               cloud_rows_per_body=128, solver=solver, use_pallas=True,
               contacts_mode="jacobi")


def jax_reference(hand_model):
    """{"colored_solve2", "colored_contact": poses after FITS colored
    jacobi fits (17, 7); "colored_contact_exact": after FITS exact ones;
    "kernel_frame", "colored_frame": (2, 17, 7)}, cached."""
    poses, depth = _contact_inputs(hand_model)
    pts, pose_in = _golden()
    h = hashlib.sha1(poses.tobytes() + depth.tobytes() + pts.tobytes()
                     + pose_in.tobytes() + b"jacobi 4").hexdigest()[:12]
    path = os.path.join(FIXTURES, "cache", f"jacobi_{h}.json")
    if os.path.exists(path):
        with open(path) as f:
            return {k: np.asarray(v, np.float32)
                    for k, v in json.load(f).items()}
    import jax
    import jax.numpy as jnp
    from hand_tracking_samples_tpu.data.synth import synth_camera
    from hand_tracking_samples_tpu.imaging.image_ops import (
        cloud_from_depth_planes)
    from hand_tracking_samples_tpu.model.hand import fit_point_cloud
    from hand_tracking_samples_tpu.ops.cloud_kernel import planes_points
    from hand_tracking_samples_tpu.parallel.tracks import (
        batched_tracker_state, batched_update)
    from hand_tracking_samples_tpu.physics.schedule import (
        build_hand_schedule)
    from hand_tracking_samples_tpu.physics.solver import (BodyState,
                                                          PhysicsParams)
    from hand_tracking_samples_tpu.tracker.config import TrackerConfig
    from hand_tracking_samples_tpu.tracker.runtime import physics_params
    cam = synth_camera()
    params = PhysicsParams()
    jac = build_hand_schedule(hand_model, "jacobi")
    out = {}

    def colored(pose, p, m, sched=jac):
        fit = jax.jit(lambda s: fit_point_cloud(
            s, hand_model, params, p, m, schedule=sched,
            contacts_fn=lambda x: x))
        s = BodyState(pose=jnp.asarray(pose), linear_momentum=jnp.zeros(
            (17, 3)), angular_momentum=jnp.zeros((17, 3)))
        for _ in range(FITS):
            s = fit(s)
        return np.asarray(s.pose)
    out["colored_solve2"] = colored(pose_in, jnp.asarray(pts),
                                    jnp.ones(len(pts), bool))
    p, m = planes_points(cloud_from_depth_planes(
        jnp.asarray(depth[0]), cam, 0.1, 0.7, 4, 2048))
    out["colored_contact"] = colored(poses[0], p, m)
    out["colored_contact_exact"] = colored(
        poses[0], p, m, build_hand_schedule(hand_model, "exact"))
    st = batched_tracker_state(hand_model, 2)
    st = st._replace(body=st.body._replace(pose=jnp.asarray(poses)))
    for solver in ("kernel", "colored"):
        cfg = _frame_cfg(TrackerConfig, solver)
        new = jax.jit(lambda s, d, cfg=cfg: batched_update(
            s, hand_model, None, d, cam, cfg, physics_params(cfg))[0])(
                st, jnp.asarray(depth))
        out[f"{solver}_frame"] = np.asarray(new.body.pose)
    with open(path, "w") as f:       # text: float32 values round-trip
        json.dump({k: v.tolist() for k, v in out.items()}, f)
    return out


@pytest.fixture(scope="module")
def port(hand_model):
    from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
    return from_numpy_model({k: np.asarray(v) for k, v in
                             vars(hand_model).items()}, "cpu")


def _active_contacts(model, pose):
    from hand_tracking_samples_tpu_torch.physics.contacts import contact_rows
    from hand_tracking_samples_tpu_torch.physics.solver import (
        BodyState, PhysicsParams)
    pose = torch.as_tensor(pose).reshape(-1, 17, 7)
    z = torch.zeros(pose.shape[0], 17, 3)
    return int(contact_rows(BodyState(pose, z, z), model,
                            PhysicsParams()).active.sum())


@pytest.mark.parametrize("case", ["solve2", "contact"])
def test_colored_jacobi_matches_jax(hand_model, port, case):
    """The port's colored jacobi fit follows JAX's colored jacobi fit to
    1e-5 m / quat_err 1e-5 after 3 fits.  solve2's fits have no contact
    row active (its open hand): there the jacobi fit equals the exact one
    bit for bit, inside test_colored_solver.py's 3e-4 m.  On the contact
    pose contact rows are active, jacobi moves the fit by ~0.3 mm from the
    exact one in both packages, and the port's exact fit follows JAX's
    exact fit to 1e-5 m as well."""
    from hand_tracking_samples_tpu_torch.data.synth import synth_camera
    from hand_tracking_samples_tpu_torch.imaging.image_ops import (
        cloud_from_depth)
    from hand_tracking_samples_tpu_torch.model.hand import fit_point_cloud
    from hand_tracking_samples_tpu_torch.ops.cloud_kernel import (
        depth_tensor)
    from hand_tracking_samples_tpu_torch.physics.schedule import (
        build_hand_schedule)
    from hand_tracking_samples_tpu_torch.physics.solver import (
        BodyState, PhysicsParams)
    ref = jax_reference(hand_model)[f"colored_{case}"]
    model = port
    if case == "solve2":
        p, pose = _golden()
        pts, mask = torch.tensor(p)[None], torch.ones(1, len(p), dtype=bool)
    else:
        poses, depth = _contact_inputs(hand_model)
        pts, mask = cloud_from_depth(depth_tensor(depth[:1], "cpu"),
                                     synth_camera(), 0.1, 0.7, 4, 2048)
        pose = poses[0]
    params = PhysicsParams()
    res, active = {}, 0
    for mode in ("jacobi", "exact"):
        sched = build_hand_schedule(model.np, mode)
        z = torch.zeros(1, 17, 3)
        s = BodyState(torch.tensor(pose)[None], z, z)
        for _ in range(FITS):
            active = max(active, _active_contacts(model, s.pose))
            s = fit_point_cloud(s, model, params, pts, mask, contacts=True,
                                schedule=sched)
        res[mode] = s.pose[0].numpy()
    a = res["jacobi"]
    assert np.abs(a[:, :3] - ref[:, :3]).max() < 1e-5
    assert quat_err(a[:, 3:], ref[:, 3:]) < 1e-5
    if case == "solve2":
        assert active == 0
        assert np.array_equal(a, res["exact"])
    else:
        assert active > 0
        ex = jax_reference(hand_model)["colored_contact_exact"]
        assert np.abs(res["exact"][:, :3] - ex[:, :3]).max() < 1e-5
        assert np.abs(a[:, :3] - res["exact"][:, :3]).max() > 1e-4


@pytest.mark.parametrize("solver", ["kernel", "colored"])
def test_jacobi_frame_matches_jax(hand_model, port, solver):
    """One dynamics frame with jacobi contacts on two contact poses with
    active contact rows, against JAX's batched frame: 1e-5 m, quat_err
    1e-4.  The kernel solver (the PGS kernel's jacobi class, plain
    version) is held to JAX's Pallas kernel in interpret mode, the colored
    one (the row sweep's jacobi levels) to JAX's colored solve; the two
    lie over a millimetre apart (their jacobi orders differ: a unit's rows
    against a phase's), in both packages."""
    from hand_tracking_samples_tpu_torch.data.synth import synth_camera
    from hand_tracking_samples_tpu_torch.ops.cloud_kernel import (
        depth_tensor)
    from hand_tracking_samples_tpu_torch.parallel.tracks import (
        batched_tracker_state, batched_update)
    from hand_tracking_samples_tpu_torch.tracker.config import TrackerConfig
    refs = jax_reference(hand_model)
    ref = refs[f"{solver}_frame"]
    poses, depth = _contact_inputs(hand_model)
    assert _active_contacts(port, poses) > 0
    st = batched_tracker_state(port, 2)
    st = st._replace(body=st.body._replace(pose=torch.tensor(poses)))
    new, _ = batched_update(st, port, None, depth_tensor(depth, "cpu"),
                            synth_camera(), _frame_cfg(TrackerConfig,
                                                       solver))
    mine = new.body.pose.numpy()
    assert np.abs(mine[..., :3] - ref[..., :3]).max() < 1e-5
    assert quat_err(mine[..., 3:].reshape(-1, 4),
                    ref[..., 3:].reshape(-1, 4)) < 1e-4
    gap = refs["kernel_frame"][..., :3] - refs["colored_frame"][..., :3]
    assert np.abs(gap).max() > 1e-3


def _colored_jacobi_rows(model, poses):
    """The colored solve's (mom0, massinv, rows) of one dynamics pass on
    the contact poses with the jacobi schedule (no cloud)."""
    from hand_tracking_samples_tpu_torch.model.hand import (body_params,
                                                            fit_rows)
    from hand_tracking_samples_tpu_torch.physics.colored import (
        colored_sweep_inputs)
    from hand_tracking_samples_tpu_torch.physics.schedule import (
        build_hand_schedule)
    from hand_tracking_samples_tpu_torch.physics.solver import (
        BodyState, PhysicsParams)
    params = PhysicsParams()
    T = poses.shape[0]
    z = torch.zeros(T, 17, 3)
    st = BodyState(torch.tensor(poses), z, z)
    empty = torch.zeros(T, 0, 3)
    lin, ang = fit_rows(st, model, params, empty, empty[..., 0] > 0,
                        contacts=True,
                        schedule=build_hand_schedule(model.np, "jacobi"))
    bp = body_params(model)
    mom0, rows = colored_sweep_inputs(st, bp, lin, ang, params)
    return mom0, bp.massinv, rows


def test_row_sweep_jacobi_waves_exact(hand_model, port):
    """row_sweep_waves (the kernel's order: a jacobi phase one level, every
    row of it on the momenta at the level's start, each body's deltas
    added in row order) equals row_sweep_plain (row order) bit for bit, on
    the colored jacobi rows of the contact poses and on seeded synthetic
    jacobi rows (row_sweep.synthetic_rows with jacobi units: pairs sharing
    bodies, world sides, friction masters in earlier phases, inactive
    rows)."""
    from hand_tracking_samples_tpu_torch.physics.row_sweep import (
        jacobi_phases, row_sweep_plain, row_sweep_waves, synthetic_rows,
        wave_schedule)
    poses, _ = _contact_inputs(hand_model)
    cases = [_colored_jacobi_rows(port, poses)]
    cases += [synthetic_rows(3, 120, 20, 17, k, jacobi=24) for k in (0, 1)]
    for mom0, mi, rows in cases:
        ph = jacobi_phases(rows.lm)
        act = ((rows.lm >> 16) & 1) == 1
        assert bool((act & (ph >= 0)).any())        # active jacobi rows
        ws = wave_schedule(rows.lm, rows.am)
        # a jacobi phase's active rows share one level, and no other row
        for t in range(rows.lm.shape[0]):
            lv = ws.lin_level[t]
            for p in ph[t][ph[t] >= 0].unique():
                sel = (ph[t] == p) & act[t]
                if sel.any():
                    lp = lv[sel].unique()
                    assert len(lp) == 1
                    assert bool(((lv == lp) == sel).all())
        a = row_sweep_plain(mom0, mi, rows, 5, 2)
        b = row_sweep_waves(mom0, mi, rows, 5, 2)
        assert torch.equal(a, b)
        assert not torch.equal(a[:, 1], mom0)


def test_pgs_jacobi_plan_body_lists():
    """The jacobi contact class of the dynamics and multistep plans: one
    group of every collide pair (W=88), and per-body lists that name
    every (unit, side) on a body once, in unit order."""
    from hand_tracking_samples_tpu_torch.assets_paths import (
        DEFAULT_MODEL_JSON)
    from hand_tracking_samples_tpu_torch.model.bake import load_hand_model
    from hand_tracking_samples_tpu_torch.physics.pgs_kernel import (
        build_dynamics_plan, build_multistep_plan)
    m = load_hand_model(DEFAULT_MODEL_JSON,
                        cache_dir=os.path.join(FIXTURES, "cache")).fields()
    pairs = np.asarray(m["collide_pairs"])
    for plan in (build_dynamics_plan(m, 133, "jacobi"),
                 build_multistep_plan(m, 20, True, "jacobi")):
        cls = plan.lin_classes[1]
        assert cls.jacobi and cls.n_groups == 1 and cls.W == 88
        assert not plan.lin_classes[0].jacobi
        seen = []
        for b in range(17):
            ent = cls.body_ent[cls.body_off[b]:cls.body_off[b + 1]]
            units = [int(e) >> 1 for e in ent]
            assert units == sorted(units)
            for e in ent:
                u, side = int(e) >> 1, int(e) & 1
                assert (cls.unit_b1 if side else cls.unit_b0)[0, u] == b
                seen.append((u, side))
        want = [(u, s) for u in range(len(pairs)) for s in (0, 1)]
        assert sorted(seen) == want
        assert cls.body_off[-1] == len(want)


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from hand_tracking_samples_tpu.model.bake import load_hand_model
    hm = jax.tree_util.tree_map(jnp.asarray, load_hand_model(
        MODEL_JSON, cache_dir=os.path.join(FIXTURES, "cache")))
    print({k: v.shape for k, v in jax_reference(hm).items()})
