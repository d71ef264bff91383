"""Kernel 4's plain version (physics/pgs_kernel.pgs_solve_plain) on
identical rows against the JAX package's colored solver: the JAX row
factories build one FitPointCloud's rows (boundary chamber + packed cloud
singles, joints, contacts, joint ranges) for a track; the JAX colored
solver (the unbatched rule of its fused_fit) solves them, and the port
preps the same rows into its planes with the main path's prep
(row_planes.prep_lin_channels / prep_ang_channels / phase_planes_t), runs
its 16+4 sweeps and integrates.
Positions agree to < 1e-5 m and quaternions to quat_err < 1e-5
(test_pgs_kernel.py:47)."""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from hand_tracking_samples_tpu.assets_paths import DEFAULT_ANIMBANK
from hand_tracking_samples_tpu.data.animbank import load_animbank
from hand_tracking_samples_tpu.data.synth import synth_camera as j_cam
from hand_tracking_samples_tpu.fitting.cloud import (
    cloud_chamber_rows as j_chamber, rows_to_single_block as j_block)
from hand_tracking_samples_tpu.imaging.image_ops import (
    cloud_from_depth_planes as j_planes)
from hand_tracking_samples_tpu.model.hand import body_params as j_bodies
from hand_tracking_samples_tpu.ops.cloud_kernel import planes_points
from hand_tracking_samples_tpu.ops.cloud_rows import cloud_rows_packed_ph
from hand_tracking_samples_tpu.physics.fused_fit import (_unbatched_rows,
                                                         fused_fit as j_fit)
from hand_tracking_samples_tpu.physics.pgs_kernel import (
    build_dynamics_plan as j_plan)
from hand_tracking_samples_tpu.physics.solver import BodyState as JBody
from hand_tracking_samples_tpu.tracker.config import TrackerConfig
from hand_tracking_samples_tpu.tracker.runtime import (
    BOUNDARY_OUTDIRS, physics_params as j_params)
from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
from hand_tracking_samples_tpu_torch.model.hand import body_params
from hand_tracking_samples_tpu_torch.physics import row_planes as rp
from hand_tracking_samples_tpu_torch.physics.colored import SingleBodyLinear
from hand_tracking_samples_tpu_torch.physics.fused_fit import (
    initial_momenta, integrate)
from hand_tracking_samples_tpu_torch.physics.pgs_kernel import (
    _batched_world_iinv, _prep_singles, build_dynamics_plan, pgs_solve)
from hand_tracking_samples_tpu_torch.physics.solver import BodyState
from hand_tracking_samples_tpu_torch.tracker.runtime import physics_params
from tests.conftest import cached_fake_depths, quat_err

# the port tests run small tensors: one intra-op thread each, so the
# suite's parallel workers do not oversubscribe the cores
torch.set_num_threads(1)

CS = 133


def _t(tree, cls):
    return cls(*[torch.tensor(np.asarray(x))[None] for x in tree])


def _plane(x):
    """One track's (R,) row field -> the (R, T=1) plane."""
    return torch.tensor(np.asarray(x))[:, None]


def _vec(x):
    """One track's (R, 3) row field -> three (R, 1) planes."""
    return [_plane(np.asarray(x)[:, c]) for c in range(3)]


def _lin_planes(P, rows, cls, massinv, dt):
    """The JAX package's LinearRows of one class through the main path's
    prep (row_planes.prep_lin_channels, phase_planes_t)."""
    assert np.array_equal(np.asarray(rows.b0), cls.b0)
    assert np.array_equal(np.asarray(rows.b1), cls.b1)
    act = _plane(np.asarray(rows.active).astype(np.float32))
    ch = rp.prep_lin_channels(
        P, cls.b0, cls.b1, massinv, dt, _vec(rows.normal), _vec(rows.r0),
        _vec(rows.r1), _plane(rows.targetdist),
        _plane(rows.targetspeednobias), _plane(rows.fmin),
        _plane(rows.fmax), _plane(rows.friction_coef), act)
    return rp.phase_planes_t(ch, cls)


def _ang_planes(P, rows, cls, dt):
    """The JAX package's AngularRows of one class through the main path's
    prep (row_planes.prep_ang_channels, phase_planes_t)."""
    assert np.array_equal(np.asarray(rows.b0), cls.b0)
    assert np.array_equal(np.asarray(rows.b1), cls.b1)
    ch = rp.prep_ang_channels(
        P, cls.b0, cls.b1, dt, _vec(rows.axis), _plane(rows.targetspin),
        _plane(rows.mintorque), _plane(rows.maxtorque),
        _plane(np.asarray(rows.active)))
    return rp.phase_planes_t(ch, cls)


def test_pgs_solve_matches_jax_colored(hand_model):
    bank = load_animbank(DEFAULT_ANIMBANK)
    depths = cached_fake_depths(hand_model, np.asarray(bank[[10, 400]]),
                                "pgs2")
    jparams = j_params(TrackerConfig())
    plan_j = j_plan(hand_model, CS, "exact", True)
    scale_b = jnp.where(jnp.arange(17) <= 2, 0.4, 1.0)
    rng = np.random.RandomState(5)

    @jax.jit
    def jax_side(state, depth):
        ph = j_planes(depth, j_cam(), 0.1, 0.7, 4, 2048)
        pts, mask = planes_points(ph)
        ch = j_chamber(state, hand_model, pts, mask, BOUNDARY_OUTDIRS,
                       jnp.zeros(3), jnp.asarray([0.0, 0, 1]), 10.0,
                       active=mask.sum() > 400)
        cb = j_block(ch, (5, 17))
        sb, _ = cloud_rows_packed_ph(state, hand_model, ph, jnp.zeros(3),
                                     scale_b, 128)
        single = jax.tree.map(lambda a, b: jnp.concatenate([a, b]), cb, sb)
        lin, ang = _unbatched_rows(state, hand_model, jparams, "dyn", 0.0,
                                   None, True)
        new = j_fit(state, j_bodies(hand_model), cb, None, plan_j, jparams,
                    16, 4, "dyn", 0.0, hand_model,
                    cloud=(ph, jnp.zeros(3), scale_b), cloud_slots=128)
        return single, lin, ang, new

    model = from_numpy_model({k: np.asarray(v) for k, v in
                              vars(hand_model).items()}, "cpu")
    params = physics_params(TrackerConfig())
    bodies = body_params(model)
    plan = build_dynamics_plan(model.np, CS)
    for t in range(2):
        pose = bank[[10, 400][t]].copy()
        pose[:, 0] += 0.003                           # the fit does work
        lm = (rng.randn(17, 3) * 1e-3).astype(np.float32)
        am = (rng.randn(17, 3) * 1e-4).astype(np.float32)
        js = JBody(jnp.asarray(pose), jnp.asarray(lm), jnp.asarray(am))
        single, lin, ang, new = jax_side(js, jnp.asarray(depths[t]))

        st = BodyState(*[torch.tensor(np.asarray(x))[None] for x in js])
        iinv = _batched_world_iinv(st.pose[..., 3:7],
                                   bodies.tensorinv_massless, bodies.massinv)
        sb = _t(single, SingleBodyLinear)
        s_all = _prep_singles(sb, iinv, bodies.massinv, params.deltaT)
        P = rp.pose_planes(st.pose, bodies.tensorinv_massless,
                           bodies.massinv, iinv_tb=iinv)
        hmi = np.asarray(model.np["massinv"], np.float32)
        lin_p = [_lin_planes(P, r, c, hmi, params.deltaT)
                 for r, c in zip(lin, plan.lin_classes)]
        ang_p = [_ang_planes(P, r, c, params.deltaT)
                 for r, c in zip(ang, plan.ang_classes)]
        mom0, mi = initial_momenta(st, bodies, params)
        out = pgs_solve(plan, 16, 4, mom0, mi, s_all, lin_p, ang_p)
        mine = integrate(out, P, model.np, params.deltaT).pose[0].numpy()
        ref = np.asarray(new.pose)
        assert np.abs(mine[:, :3] - ref[:, :3]).max() < 1e-5, t
        assert quat_err(mine[:, 3:], ref[:, 3:]) < 1e-5, t
        assert np.abs(mine[:, :3] - pose[:, :3]).max() > 1e-4  # it moved
        assert int(np.asarray(single.active).sum()) > 200
