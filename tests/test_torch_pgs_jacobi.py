"""The PGS kernel's jacobi contact class in its order (csrc/pgs_kernel.cu):
each track solved on its active units only (the units with an active
row, compacted in unit order and padded to a multiple of 4), on the phases
with an active row only (a friction row whose normal phase is dropped
reads an impulse of 0), each body adding its active units' deltas in
unit order.  physics.pgs_kernel.jacobi_order_plain states that order in
plain PyTorch (compact_jacobi_class builds each track's class and rows as
the kernel's prologue does, but keeps a contact point's three phases
together, so that the plain solve finds each friction row's normal row;
the phases this adds have no active row); it must equal
pgs_solve_plain on the full class bit for bit (torch.equal: every term
it drops is an exact zero), on

  * the contact poses' rows (tests/test_torch_jacobi.py's two poses with
    active contact rows), through the dynamics plan and the multistep
    plan with angles (fused_fit.solve_inputs, no cloud);
  * seeded synthetic rows (pgs_kernel.synthetic_jacobi_inputs): no active
    unit, more than 32 active units (two a lane in the kernel), all 88
    units active, phases in which no row is active (normal phases whose
    friction phases are active; a whole contact point), and 96 units all
    active (the kernel's largest class: three a lane).

No JAX: the port's own model and animbank."""
import os

import numpy as np
import pytest
import torch

from tests.conftest import FIXTURES

# the port tests run small tensors: one intra-op thread each, so the
# suite's parallel workers do not oversubscribe the cores
torch.set_num_threads(1)

CONTACT_FRAMES = (1175, 333)   # as tests/test_torch_jacobi.py


@pytest.fixture(scope="module")
def model():
    from hand_tracking_samples_tpu_torch.assets_paths import (
        DEFAULT_MODEL_JSON)
    from hand_tracking_samples_tpu_torch.model.bake import (from_numpy_model,
                                                            load_hand_model)
    m = load_hand_model(DEFAULT_MODEL_JSON,
                        cache_dir=os.path.join(FIXTURES, "cache"))
    return from_numpy_model(m.fields(), "cpu")


def _contact_solve(model, kind):
    """pgs_solve's arguments of one solve at the contact poses (T=2) with
    jacobi contacts: the dynamics plan ("dyn") or the multistep plan with
    angles ("ms"), no cloud, seeded momenta."""
    from hand_tracking_samples_tpu_torch.assets_paths import DEFAULT_ANIMBANK
    from hand_tracking_samples_tpu_torch.data.animbank import load_animbank
    from hand_tracking_samples_tpu_torch.model.hand import body_params
    from hand_tracking_samples_tpu_torch.physics.fused_fit import (
        solve_inputs)
    from hand_tracking_samples_tpu_torch.physics.pgs_kernel import (
        build_dynamics_plan, build_multistep_plan)
    from hand_tracking_samples_tpu_torch.physics.solver import (
        BodyState, PhysicsParams)
    bank = load_animbank(DEFAULT_ANIMBANK)
    pose = torch.tensor(np.asarray(bank[list(CONTACT_FRAMES)], np.float32))
    T = pose.shape[0]
    rng = np.random.default_rng(7)
    mom = [torch.tensor(rng.standard_normal((T, 17, 3)).astype(np.float32)
                        * 0.05) for _ in range(2)]
    st = BodyState(pose, *mom)
    if kind == "dyn":
        plan, mode, aa = build_dynamics_plan(model.np, 0, "jacobi"), "dyn", \
            None
    else:
        plan = build_multistep_plan(model.np, 0, True, "jacobi")
        ident = torch.tensor([[1.0, 0.0, 0.0, 0.0]]).expand(T, 4)
        mode, aa = "ms_angles", (pose[:, 1, 3:7], torch.full((T, 5), 0.3),
                                 ident)
    x = solve_inputs(st, body_params(model), None, plan, PhysicsParams(),
                     model, mode=mode, aa=aa, drive_force=0.5)
    return (plan, 16, 4, x["mom0"], x["mi"], x["singles"], x["lin_rows"],
            x["ang_rows"])


# (T, units, active units a track, seed, phases with no active row)
SYNTHETIC = {"none active": (3, 88, 0, 0, ()),
             "40 active": (3, 88, 40, 1, ()),
             "all 88 active": (3, 88, 88, 2, ()),
             "dead phases": (3, 88, 10, 3, (1, 2, 3, 7, 11)),
             "a dead point": (3, 88, 10, 5, (6, 7, 8, 10)),
             "96 units": (2, 96, 96, 4, ())}


@pytest.mark.parametrize("case", ["dyn", "ms"] + list(SYNTHETIC))
def test_jacobi_order_equals_plain(model, case):
    from hand_tracking_samples_tpu_torch.physics.pgs_kernel import (
        compact_jacobi_class, jacobi_order_plain, pgs_solve_plain)
    if case in SYNTHETIC:
        from hand_tracking_samples_tpu_torch.physics.pgs_kernel import (
            synthetic_jacobi_inputs)
        T, n, na, seed, dead = SYNTHETIC[case]
        args = synthetic_jacobi_inputs(T, n, na, seed, dead, 6, 2)
    else:
        args = _contact_solve(model, case)
    plan, lin = args[0], args[6]
    k = [i for i, c in enumerate(plan.lin_classes) if c.jacobi]
    assert len(k) == 1
    cls, rows = plan.lin_classes[k[0]], lin[k[0]]
    T = rows.shape[0]
    # what each track's compaction keeps
    got = [compact_jacobi_class(cls, rows[t:t + 1]) for t in range(T)]
    act = (rows[:, :, 15].abs() > 0)                      # (T, U, W)
    for t, g in enumerate(got):
        units = act[t].any(0).nonzero()[:, 0].tolist()
        if not units:
            assert g is None
            continue
        c, r = g
        assert c.W % 4 == 0 and c.W - 4 < len(units) <= c.W
        points = int(act[t].any(1).reshape(-1, 3).any(1).sum())
        assert c.U == 3 * points and r.shape[1] == c.U
        assert (c.unit_b0[0, :len(units)] == cls.unit_b0[0, units]).all()
        assert (c.unit_b0[0, len(units):] == -1).all()
        assert not bool(r[..., len(units):].any())
        assert c.body_off[-1] == len(c.body_ent)
    if case == "none active":
        assert all(g is None for g in got)
    elif case == "40 active":
        assert all(g[0].W == 40 for g in got)
    elif case in ("all 88 active", "96 units"):
        assert all(g[0].W == cls.W for g in got)
    elif case == "dead phases":
        # the kernel drops phases 1-3, 7 and 11; here a point with an
        # active friction row keeps its idle normal phase 3 (impulse 0)
        assert all(int(act[t].any(1).sum()) <= cls.U - 5 for t in range(T))
        assert any(bool(act[t, 4:6].any()) and g[0].U > int(
            act[t].any(1).sum()) for t, g in enumerate(got))
    elif case == "a dead point":
        assert all(g[0].U <= cls.U - 3 for g in got)
    else:
        assert bool(act.any())                    # active contact rows
    a = pgs_solve_plain(*args)
    b = jacobi_order_plain(*args)
    assert torch.equal(a, b)
    assert not torch.equal(a[:, 1], args[3])
