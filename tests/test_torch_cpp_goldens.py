"""The contact sweep golden (tests/test_contact_sweep.py,
contact_sweep_ref.json) through the port on the CPU, at that file's gates:

  pairs and depths  the reference-layout contact rows (physics/contacts.py
                    contact_rows, the contact kernel's plain version) of
                    the 20 sweep poses, one batch: at most 3 missing and 9
                    extra pairs a frame, at most 1/20 of the reference's
                    pairs missing overall, the deepest contact's target
                    distance within 1.6 mm on average and 6 mm at most;
  solve             3 joint-and-contact updates from each pose on the
                    sequential solver with no cloud (model/hand.py
                    fit_point_cloud): mean position deviation from the
                    reference's pose3 < 1.0 mm, every bone < 9 mm.

The other three goldens of the JAX suite that the port's tracker reaches
(the recorded CNN cadence, cold-start acquisition, the fast-drift golden)
take minutes on the CPU; chip_smoke.py phase 19 holds them on the card.
No JAX call: the reference is the C++ fixture."""
import json
import os

import numpy as np
import pytest
import torch

from tests.conftest import DEFAULT_ANIMBANK, FIXTURES, MODEL_JSON

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sweep():
    from hand_tracking_samples_tpu_torch.data.animbank import load_animbank
    from hand_tracking_samples_tpu_torch.model.bake import (from_numpy_model,
                                                            load_hand_model)
    from hand_tracking_samples_tpu_torch.physics.solver import BodyState
    from hand_tracking_samples_tpu_torch.tracker.config import TrackerConfig
    from hand_tracking_samples_tpu_torch.tracker.runtime import (
        physics_params)
    with open(os.path.join(FIXTURES, "contact_sweep_ref.json")) as f:
        frames = json.load(f)["frames"]
    bank = load_animbank(DEFAULT_ANIMBANK)
    model = from_numpy_model(load_hand_model(
        MODEL_JSON, cache_dir=os.path.join(FIXTURES, "cache")), "cpu")
    T = len(frames)
    state = BodyState(torch.tensor(bank[[e["frame"] for e in frames]]),
                      torch.zeros((T, 17, 3)), torch.zeros((T, 17, 3)))
    return frames, model, physics_params(TrackerConfig()), state


def test_contact_sweep_pairs_and_depths(sweep):
    from hand_tracking_samples_tpu_torch.physics.contacts import contact_rows
    frames, model, params, state = sweep
    rows = contact_rows(state, model, params)
    act = (rows.active & (rows.friction_master == 0)).numpy()
    b0, b1, td = rows.b0.numpy(), rows.b1.numpy(), rows.targetdist.numpy()
    total = missing = 0
    depth_err = []
    for t, entry in enumerate(frames):
        mine = {}
        for a, b, d in zip(b0[t][act[t]], b1[t][act[t]], td[t][act[t]]):
            k = (int(a), int(b))
            mine[k] = min(mine.get(k, np.inf), float(d))
        ref = {(int(p[0]), int(p[1])): float(p[2]) for p in entry["pairs"]}
        total += len(ref)
        missing += len(set(ref) - set(mine))
        depth_err += [abs(ref[k] - mine[k]) for k in set(ref) & set(mine)]
        assert len(set(ref) - set(mine)) <= 3, (entry["frame"],
                                                set(ref) - set(mine))
        assert len(set(mine) - set(ref)) <= 9, (entry["frame"],
                                                set(mine) - set(ref))
    depth_err = np.asarray(depth_err)
    assert missing <= total // 20, (missing, total)
    assert depth_err.mean() < 1.6e-3, depth_err.mean()
    assert depth_err.max() < 6e-3, depth_err.max()


def test_contact_sweep_solve(sweep):
    from hand_tracking_samples_tpu_torch.model.hand import fit_point_cloud
    frames, model, params, state = sweep
    T = len(frames)
    for _ in range(3):
        state = fit_point_cloud(state, model, params, torch.zeros((T, 0, 3)),
                                torch.zeros((T, 0), dtype=torch.bool),
                                contacts=True)
    ref = np.asarray([e["pose3"] for e in frames], np.float32)
    dev = np.linalg.norm(state.pose.numpy()[..., :3] - ref[..., :3], axis=-1)
    assert dev.mean(1).mean() < 1.0e-3, f"sweep mean {dev.mean() * 1e3} mm"
    assert dev.max() < 9.0e-3, f"sweep max {dev.max() * 1e3} mm"
