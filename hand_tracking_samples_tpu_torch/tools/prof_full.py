"""Stage-cost attribution for the full CNN-guided pipeline (the port's
counterpart of tools/prof_full.py, BASELINE config 3).

Times each stage of the heavy frame at T tracks over F frames of different
renders (the JAX tool's protocol: track t starts at bank frame t*37), best
of PROF_REPS runs after a warm-up.  In eager PyTorch there is no XLA fusion
to distort a stage timed on its own, so every stage is timed directly (CUDA
events around its F frames on the card):

  update_full update_dyn prologue segment cnn analyze fiterr msim_i21
  msim_s1 msim_s1_nocol msim_s1_nocloud msim_s1_i21 msim_s1_factories
  msim_s1_prep solve msubrows msim contacts cloudrows cloud cloud_legacy

The JAX tool's msim_s1_zero and msim_zero (HTS_ZERO_PLANES: the pair-row
planes zeroed so that XLA drops their factories and preps, their cost found
by subtraction) have no counterpart: zeroing planes drops no work in eager
PyTorch.  msim_s1_factories, msim_s1_prep and solve time instead the pair
factories, the preps and the PGS kernel of msim_s1's one solve, replayed on
the inputs msim_s1 gave them (physics.fused_fit.pair_factories, pair_preps,
pgs_kernel.pgs_solve; capture_solve records them).

    PROF_TRACKS=512 python -m hand_tracking_samples_tpu_torch.tools.prof_full [stage ...] [--json PATH]
    PROF_TRACKS=2 PROF_FRAMES=1 python -m hand_tracking_samples_tpu_torch.tools.prof_full --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys

import torch

from .common import (add_device, best_ms, env_int, protocol_frames,
                     render, setup, stage_args, wanted)

STAGES = ("update_full", "update_dyn", "prologue", "segment", "cnn",
          "analyze", "fiterr", "msim_i21", "msim_s1", "msim_s1_nocol",
          "msim_s1_nocloud", "msim_s1_i21", "msim_s1_factories",
          "msim_s1_prep", "solve", "msubrows", "msim", "contacts",
          "cloudrows", "cloud", "cloud_legacy")
LABELS = {"cnn": "cnn(+seg)", "analyze": "analyze(+cnn)",
          "fiterr": "fiterr(+cloud)", "msim_i21": "msim_i21(+pro)",
          "msim_s1": "msim_s1(+pro)", "msim_s1_nocloud": "msim_s1_nocld",
          "msim_s1_factories": "msim_s1_fact", "msubrows": "msubrows(+cld)",
          "msim": "msim(+prologue)", "contacts": "contacts x1",
          "cloudrows": "cloudrows(+cloud)", "cloud": "cloud(planes)",
          "cloud_legacy": "cloud(N,3)"}


@contextlib.contextmanager
def capture_solve():
    """Record, while the context is open, every call of the fused fit's
    pair factories, pair preps and PGS solve as (name, args, output)."""
    from ..physics import fused_fit as ff
    calls = []
    orig = {n: getattr(ff, n) for n in ("pair_factories", "pair_preps",
                                        "pgs_solve")}

    def hook(name):
        def fn(*args):
            out = orig[name](*args)
            calls.append((name, args, out))
            return out
        return fn
    for n in orig:
        setattr(ff, n, hook(n))
    try:
        yield calls
    finally:
        for n, f in orig.items():
            setattr(ff, n, f)


class Profile:
    """The JAX tool's setup on the port: the CNN frame on the kernel solver
    with use_pallas, the trained net, T tracks starting on the hand."""

    def __init__(self, device, T: int, F: int):
        from ..parallel.tracks import batched_tracker_state
        from ..tracker.config import TrackerConfig
        from ..tracker.runtime import physics_params
        self.dev, self.model, bank, self.cam, self.cnn = setup(device,
                                                               cnn=True)
        self.T, self.F = T, F
        self.config = TrackerConfig(cnn_every_frame=True, solver="kernel",
                                    use_pallas=True)
        self.params = physics_params(self.config)
        _, fids = protocol_frames(bank, T, F)
        self.depths = render(self.model, self.cam, bank[fids])
        st = batched_tracker_state(self.model, T)
        self.states = st._replace(body=st.body._replace(pose=torch.tensor(
            bank[fids[0]], device=self.dev)))
        self.cpose = torch.zeros((T, 7), device=self.dev)
        self.cpose[:, 6] = 1.0
        self.drange = (0.1, self.config.drangey)

    # ---- per-frame functions: (states, depth) -> states -----------------
    def add(self, s, *xs):
        e = s.prev_frame_error
        for x in xs:
            e = e + x.to(torch.float32).reshape(self.T, -1).sum(1)
        return s._replace(prev_frame_error=e)

    def ph(self, d):
        from ..ops.cloud_kernel import cloud_from_depth_planes
        c = self.config
        return cloud_from_depth_planes(d, self.cam, 0.1, c.drangey,
                                       c.subsample_fraction, c.point_budget)

    def seg(self, d):
        from ..segment.handsegment import (cnn_input_from_segment,
                                           hand_segment_vr)
        seg = hand_segment_vr(d, self.cam, 0xF, self.drange,
                              self.config.segment_scale)
        return seg, cnn_input_from_segment(seg.depth, self.cam.depth_scale,
                                           self.drange)

    def msim_fn(self, cfg):
        from ..tracker import runtime as rt

        def fn(s, d):
            _, a, _, _, ph = rt._cnn_frame_inputs(self.cnn, d, self.cam, cfg)
            return s._replace(body=rt.multi_step_sim(
                s.body, self.model, a, ph, self.cpose, cfg, self.params))
        return fn

    def stage_fn(self, name):
        from ..tracker import runtime as rt
        m, cam, cfg = self.model, self.cam, self.config
        if name in ("update_full", "update_dyn"):
            cnn = name == "update_full"
            return lambda s, d: rt.update(s, m, d, cam, cfg, self.params,
                                          cnn_params=self.cnn,
                                          run_cnn=cnn)[0]
        if name == "prologue":
            def fn(s, d):
                seg, a, _, co, ph = rt._cnn_frame_inputs(self.cnn, d, cam,
                                                         cfg)
                return self.add(s, co, ph, seg.cam.pose, a.palmq)
            return fn
        if name in ("segment", "cnn", "analyze"):
            from ..cnn.labels import analyze_cnn_output
            from ..cnn.model import forward

            def fn(s, d):
                seg, ci = self.seg(d)
                if name == "segment":
                    return self.add(s, ci, seg.cam.pose)
                y = forward(self.cnn, ci)
                if name == "cnn":
                    return self.add(s, y)
                return self.add(s, analyze_cnn_output(
                    y, seg.cam.sub(4)).palmq)
            return fn
        if name == "fiterr":
            from ..fitting.cloud import fit_error
            return lambda s, d: self.add(s, fit_error(
                s.body.pose, m, self.ph(d), d, cam, cfg.bone_sum_error_scale,
                use_kernel=True))
        variants = {
            "msim": {}, "msim_s1": dict(steps=1),
            "msim_i21": dict(physics_iterations=2, physics_iterations_post=1),
            "msim_s1_nocol": dict(steps=1, physics_use_collision=0),
            "msim_s1_nocloud": dict(steps=1, steps_cloudstart=99),
            "msim_s1_i21": dict(steps=1, physics_iterations=2,
                                physics_iterations_post=1)}
        if name in variants:
            return self.msim_fn(dataclasses.replace(cfg, **variants[name]))
        if name in ("msubrows", "cloudrows"):
            from ..ops.cloud_rows import cloud_rows_packed_ph
            zero = torch.zeros((self.T, 3), device=self.dev)
            one = torch.ones((self.T, m.n_bodies), device=self.dev)

            def fn(s, d):
                ph = self.ph(d)
                if name == "msubrows":
                    ph = rt.multistep_cloud(ph, self.cpose, cfg,
                                            m.n_bodies)[0]
                blk, _ = cloud_rows_packed_ph(s.body.pose, m, ph, zero, one,
                                              cfg.cloud_rows_per_body)
                return self.add(s, blk.targetdist)
            return fn
        if name == "contacts":
            from ..physics.contacts import contact_rows
            return lambda s, d: self.add(s, contact_rows(
                s.body, m, self.params).targetdist, d[:, 0, 0])
        if name == "cloud":
            return lambda s, d: self.add(s, self.ph(d))
        if name == "cloud_legacy":
            from ..imaging.image_ops import cloud_from_depth

            def fn(s, d):
                pts, mask = cloud_from_depth(d, cam, 0.1, cfg.drangey,
                                             cfg.subsample_fraction,
                                             cfg.point_budget)
                return self.add(s, pts, mask)
            return fn
        raise KeyError(name)

    def run_frames(self, fn):
        s = self.states
        for f in range(self.F):
            s = fn(s, self.depths[f])
        return s

    def captured(self):
        """msim_s1's calls of the pair factories, preps and PGS solve, one
        frame after another (capture_solve)."""
        if not hasattr(self, "_calls"):
            with capture_solve() as calls:
                self.run_frames(self.stage_fn("msim_s1"))
            self._calls = calls
        return self._calls

    def replay_fn(self, name):
        """The replayed stage: each frame's captured call again."""
        from ..physics import fused_fit as ff
        key = {"msim_s1_factories": "pair_factories",
               "msim_s1_prep": "pair_preps", "solve": "pgs_solve"}[name]
        calls = [(getattr(ff, key), args) for n, args, _ in self.captured()
                 if n == key]

        def run():
            return [fn(*args) for fn, args in calls]
        return run

    def runner(self, name):
        """A call that runs stage `name` over the F frames."""
        if name in ("msim_s1_factories", "msim_s1_prep", "solve"):
            return self.replay_fn(name)
        fn = self.stage_fn(name)
        return lambda: self.run_frames(fn)

    def time(self, name, reps):
        return best_ms(self.runner(name), self.dev, reps, self.F)


def main(argv=None):
    ap = stage_args(add_device(argparse.ArgumentParser(
        description=__doc__.split("\n")[0])), STAGES)
    ap.add_argument("--json", default="", help="also write the stages' ms "
                    "a frame to this file")
    args = ap.parse_args(argv)
    on = wanted(ap, args, STAGES, "msim_s1_zero and msim_zero are "
                "msim_s1_factories and msim_s1_prep here")
    T, F = env_int("PROF_TRACKS", 512), env_int("PROF_FRAMES", 8)
    reps = env_int("PROF_REPS", 3)
    prof = Profile(args.device, T, F)
    out = {}
    for name in filter(on, STAGES):
        out[name] = prof.time(name, reps)
        print(f"{LABELS.get(name, name):18s} {out[name]:8.2f} ms/frame   "
              f"({T} tracks, best of {reps})", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(dict(tracks=T, frames=F, reps=reps,
                           device=str(prof.dev), ms_per_frame=out), f,
                      indent=1)
        print("wrote", args.json)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
