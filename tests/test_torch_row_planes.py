"""The port's tracks-last row factories and class prep
(physics/row_planes.py, pgs_kernel._prep_singles / pack and the chamber
rows) against the JAX package's on the same poses: every channel the solve
reads agrees to float32 rounding."""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from hand_tracking_samples_tpu.assets_paths import DEFAULT_ANIMBANK
from hand_tracking_samples_tpu.data.animbank import load_animbank
from hand_tracking_samples_tpu.physics import row_planes as jrp
from hand_tracking_samples_tpu.physics.colored import (
    pack_single_body_linear as j_pack)
from hand_tracking_samples_tpu.physics.pgs_kernel import (
    build_dynamics_plan as j_plan)
from hand_tracking_samples_tpu.physics.solver import LinearRows as JRows
from hand_tracking_samples_tpu.tracker.config import TrackerConfig
from hand_tracking_samples_tpu.tracker.runtime import (
    physics_params as j_params)
from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
from hand_tracking_samples_tpu_torch.physics import row_planes as rp
from hand_tracking_samples_tpu_torch.physics.colored import (
    pack_single_body_linear)
from hand_tracking_samples_tpu_torch.physics.pgs_kernel import (
    build_dynamics_plan)
from hand_tracking_samples_tpu_torch.physics.solver import LinearRows
from hand_tracking_samples_tpu_torch.tracker.runtime import physics_params

# the port tests run small tensors: one intra-op thread each, so the
# suite's parallel workers do not oversubscribe the cores
torch.set_num_threads(1)


def _close(mine, ref, name, rel=1e-5):
    mine = [m.numpy() for m in mine]
    ref = [np.asarray(r) for r in ref]
    assert len(mine) == len(ref), name
    for i, (a, b) in enumerate(zip(mine, ref)):
        a = np.broadcast_to(a, b.shape)
        scale = max(1.0, float(np.abs(b[np.isfinite(b)]).max()
                               if np.isfinite(b).any() else 1.0))
        fin = np.isfinite(b)
        np.testing.assert_array_equal(np.isfinite(a), fin, err_msg=name)
        assert np.abs(a[fin] - b[fin]).max() <= rel * scale, (name, i)


def test_row_planes_match_jax(hand_model):
    bank = load_animbank(DEFAULT_ANIMBANK)
    pose = bank[[3, 250, 977]].astype(np.float32)              # (T, B, 7)
    model = from_numpy_model({k: np.asarray(v) for k, v in
                              vars(hand_model).items()}, "cpu")
    mnp = model.np
    tinv, mi = hand_model.tensorinv_massless, hand_model.massinv
    jparams, params = j_params(TrackerConfig()), physics_params(
        TrackerConfig())
    dt = params.deltaT
    jplan, plan = j_plan(hand_model, 133), build_dynamics_plan(mnp, 133)
    for jc, c in zip(jplan.lin_classes + jplan.ang_classes,
                     plan.lin_classes + plan.ang_classes):
        np.testing.assert_array_equal(c.row_index, jc.row_index)

    # contact rows from the same (random) kernel fields
    rng = np.random.RandomState(1)
    NP, Pt, T = len(mnp["collide_pairs"]), 4, 3
    n = rng.randn(3, NP, T).astype(np.float32)
    n /= np.linalg.norm(n, axis=0, keepdims=True)
    fields = ([x for x in n], rng.randn(NP, Pt, T).astype(np.float32) * 1e-3,
              rng.randn(NP, Pt, T).astype(np.float32) * 1e-2,
              [x for x in rng.randn(3, NP, Pt, T).astype(np.float32) * 1e-2],
              [x for x in rng.randn(3, NP, Pt, T).astype(np.float32) * 1e-2],
              rng.rand(NP, Pt, T) > 0.5)
    ang = [rng.randn(17, T).astype(np.float32) * 1e-2 for _ in range(3)]

    @jax.jit
    def jax_side(pose, fields, ang):
        JP = jrp.pose_planes(pose, tinv, mi)
        jg = jrp.joint_lin_geometry(JP, mnp)
        jch = jrp.prep_lin_channels(JP, *jg[:2], mnp["massinv"],
                                    jparams.deltaT, *jg[2:])
        jrmin, jrmax = jrp.enhancement_ranges(JP, mnp)
        ja = jrp.joint_ang_geometry(JP, mnp, jparams, jrmin, jrmax)
        jach = jrp.prep_ang_channels(JP, *ja[:2], jparams.deltaT, *ja[2:])
        jph = jrp.phase_planes_t(jach, jplan.ang_classes[0], 3)
        jcg = jrp.contact_geometry(fields, mnp["collide_pairs"], jparams,
                                   0.6, Pt)
        jcch = jrp.prep_lin_channels(JP, *jcg[:2], mnp["massinv"],
                                     jparams.deltaT, *jcg[2:])
        jq = jrp.rkupdateq_planes(JP.q, np.asarray(tinv) * np.asarray(mi)[
            :, None, None], ang, jparams.deltaT)
        iinv = [JP.iinv[i][j] for i in range(3) for j in range(3)]
        return iinv, jch, jrmin + jrmax, jach, jph, jcch, jq

    (jiinv, jch, jranges, jach, jph, jcch, jq) = jax_side(
        jnp.asarray(pose), fields, ang)

    P = rp.pose_planes(torch.tensor(pose), model.tensorinv_massless,
                       model.massinv)
    _close([P.iinv[i][j] for i in range(3) for j in range(3)], jiinv,
           "iinv")
    g = rp.joint_lin_geometry(P, mnp)
    ch = rp.prep_lin_channels(P, *g[:2], mnp["massinv"], dt, *g[2:])
    _close(ch, jch, "joint lin")
    rmin, rmax = rp.enhancement_ranges(P, mnp)
    _close(rmin + rmax, jranges, "ranges")
    a = rp.joint_ang_geometry(P, mnp, params, rmin, rmax)
    ach = rp.prep_ang_channels(P, *a[:2], dt, *a[2:])
    _close(ach, jach, "joint ang")
    mine = rp.phase_planes_t(ach, plan.ang_classes[0])        # (T,P,14,W)
    c0 = plan.ang_classes[0]
    ref = np.asarray(jph).reshape(c0.n_phases, 14, c0.W, 3).transpose(
        3, 0, 1, 2)
    assert np.abs(mine.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    tf = ([torch.tensor(x) for x in fields[0]], torch.tensor(fields[1]),
          torch.tensor(fields[2]), [torch.tensor(x) for x in fields[3]],
          [torch.tensor(x) for x in fields[4]], torch.tensor(fields[5]))
    cg = rp.contact_geometry(tf, mnp["collide_pairs"], params, 0.6, Pt)
    cch = rp.prep_lin_channels(P, *cg[:2], mnp["massinv"], dt, *cg[2:])
    _close(cch, jcch, "contacts")
    tq = rp.rkupdateq_planes(P.q, model.tensorinv_massless * model.massinv[
        :, None, None], [torch.tensor(x) for x in ang], dt)
    _close(tq, jq, "rkupdateq", rel=2e-6)


def test_pack_single_body_linear_matches_jax():
    """The slot pack with uniform thinning and force compensation, on the
    same rows: identical blocks."""
    rng = np.random.RandomState(2)
    R, B, C = 400, 17, 16
    b1 = rng.randint(-1, B, R).astype(np.int32)
    b1[:120] = 3                                     # an over-cap body
    rows = dict(b0=np.full(R, -1, np.int32), b1=b1,
                normal=rng.randn(R, 3).astype(np.float32),
                r0=rng.randn(R, 3).astype(np.float32),
                r1=rng.randn(R, 3).astype(np.float32),
                targetdist=rng.randn(R).astype(np.float32),
                targetspeednobias=rng.randn(R).astype(np.float32),
                fmin=-rng.rand(R).astype(np.float32),
                fmax=rng.rand(R).astype(np.float32),
                friction_master=np.zeros(R, np.int32),
                friction_coef=np.zeros(R, np.float32),
                active=rng.rand(R) > 0.2)
    ref = jax.jit(lambda r: j_pack(r, B, C))(
        JRows(**{k: jnp.asarray(v) for k, v in rows.items()}))
    mine = pack_single_body_linear(LinearRows(**{
        k: torch.tensor(v.astype(np.int64) if v.dtype == np.int32 else v)[
            None] for k, v in rows.items()}), B, C)
    for name, a, b in zip(ref._fields, mine, ref):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b),
                                      err_msg=name)
    assert np.asarray(ref.active)[:, 3].all()
