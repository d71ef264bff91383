#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (hand_tracking_samples_tpu_torch) on
one NVIDIA GPU.  Run from the repository root:

    python3 chip_smoke.py

Phases, each printing one line with its elapsed seconds:
  1. build (or reuse) the CUDA kernel library: one nvcc call into build/
  2. the card's name and power limit, as nvidia-smi reports them
  3. each of the four kernels against its plain PyTorch version at T=4
     tracks, one frame, full width (the cloud kernel bit-identical)
  4. the dynamics-only tracking slice at T=512 tracks for 30 frames: even
     tracks see the cached dyn30 renders and are held to golden.json's
     dyntrack poses; odd tracks see the port's own fake_depth renders of
     bank[30:60] and are held to the band of the tracker's own error there
     (ODD_BAND_MM); 8 tracks re-run as a T=8 batch must agree to 1e-5 m;
     two tracks re-run through the plain versions on the CPU must agree to
     1e-4 m over the first frames; every kernel must have launched
  5. timing: 30 frames at T=512, and each kernel's time (CUDA events) at the
     last frame's shapes beside its plain version's time and its bound; the
     timed kernel and plain outputs are held to each other under phase 3's
     tolerances, so every kernel is also checked at the main path's shapes
  6. the CNN frame's kernels against their plain versions at T=4: the
     unpacked-rows and vals variants of the cloud-rows kernel, and the PGS
     kernel on a multistep plan and on the unibody plan; and the card forms
     of the contracted arithmetic (maths/fma.py) against its CPU forms
  7. the CNN frame (segmentation, net, FitError, reset with UnibodyFit,
     MultiStepSim, then the dynamics pass) at T=512 for 8 frames on the
     port's fake_depth renders of bank[30:38], with the trained net
     (DEFAULT_CNNB): a quarter of the tracks (every 4th) start from
     initial_state, so the reset fires and the unibody kernel launches; the
     rest start at bank[30].  Each group's per-frame joint error is held to
     CNN_BAND_MM; two tracks (one of each kind) re-run through the plain
     versions on the CPU must agree to 1e-4 m; every kernel and both new
     PGS plans must have launched
  8. the CNN frame's timing, its device-time split, and the new kernels
     and plans timed at its T=512 shapes, each held to its plain version
     again under phase 6's tolerances

Each phase drives its path with the launch counts set to 0 just before it
and reads them just after.  The line before the last is the kernels' JSON
record (launches: the dynamics path's for the first four kernels, the CNN
frame's for the rest); the last line is
{"ok": true, "device": {...}}.  Exits non-zero, printing no result, when a
phase fails, when there is no CUDA device, or when run outside the
repository.  --json PATH writes every measured number to PATH.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_S = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_F32_S = 67e12        # H100 SXM float32 outside the tensor cores
CPU_FRAMES = 5            # frames of the CPU plain-version reference
TRACKS, FRAMES = 512, 30  # the main path: bench.py's track count, dyn30
# Odd tracks (fake_depth of bank[30:60]), mean joint error against the
# animbank in mm.  The tracker itself loses the hand at the fast motion into
# bank frame 38 (frame 8 here) and recovers over about 15 frames: the JAX
# package does the same on the same renders (tests/test_torch_slice_jax.py).
# Bands from that behaviour: before the motion, at its peak, the last five
# frames, and the 30-frame mean.
ODD_BAND_MM = dict(before=4.0, peak=60.0, last5=4.0, mean=12.0)
PORT, JAXPKG = "hand_tracking_samples_tpu_torch", "hand_tracking_samples_tpu"
CNN_TRACKS, CNN_FRAMES = 512, 8   # the CNN frame: T=512, bank[30:38]
CNN_CPU_FRAMES = 2                # frames of its CPU plain-version reference
# The CNN frame's per-frame joint error against the animbank (a track's
# mean over its joints, the largest over the group's tracks), in mm: tracks
# started on the hand (gt) and tracks started from initial_state (reset;
# their first frame is the reset itself).  Set from the measured curve
# (PERF.md): gt 0.39-3.15, reset 18.72 on frame 0 and 4.64 on frame 7 on an
# H100.
CNN_BAND_MM = dict(gt=6.0, reset_first=30.0, reset_last=8.0)
KERNELS = {   # name: (source, the TPU kernel it replaces)
    "cloud_from_depth": (f"{PORT}/csrc/cloud_kernel.cu",
                         f"{JAXPKG}/ops/cloud_kernel.py:26"),
    "cloud_rows_solve": (f"{PORT}/csrc/cloud_rows.cu",
                         f"{JAXPKG}/ops/cloud_rows.py:34"),
    "contact_fields": (f"{PORT}/csrc/contact_kernel.cu",
                       f"{JAXPKG}/physics/contact_kernel.py:46"),
    "pgs_solve": (f"{PORT}/csrc/pgs_kernel.cu",
                  f"{JAXPKG}/physics/pgs_kernel.py:185"),
    "cloud_rows_unpacked": (f"{PORT}/csrc/cloud_rows.cu",
                            f"{JAXPKG}/ops/cloud_rows.py:34"),
    "cloud_vals": (f"{PORT}/csrc/cloud_rows.cu",
                   f"{JAXPKG}/ops/cloud_rows.py:34"),
}
FIRST = ("cloud_from_depth", "cloud_rows_solve", "contact_fields",
         "pgs_solve")            # the dynamics path's kernels (phases 3-5)
# the PGS kernel's plans that the CNN frame adds: row name -> plan kind
PLANS = {"pgs_solve[multistep]": "ms", "pgs_solve[unibody]": "uni"}
NEW = ("cloud_rows_unpacked", "cloud_vals") + tuple(PLANS)


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def quat_err(a, b):
    """Sign-invariant max quaternion component error."""
    import torch
    sign = torch.sign((a * b).sum(-1, keepdim=True))
    return (a - b * sign).abs().max().item()


class Smoke:
    def __init__(self):
        import numpy as np
        import torch
        from hand_tracking_samples_tpu_torch.assets_paths import (
            DEFAULT_ANIMBANK, DEFAULT_MODEL_JSON)
        from hand_tracking_samples_tpu_torch.data.animbank import load_animbank
        from hand_tracking_samples_tpu_torch.data.synth import synth_camera
        from hand_tracking_samples_tpu_torch.device import resolve_device
        from hand_tracking_samples_tpu_torch.model.bake import (
            from_numpy_model, load_hand_model)
        from hand_tracking_samples_tpu_torch.tracker.config import (
            TrackerConfig)
        from hand_tracking_samples_tpu_torch.tracker.runtime import (
            physics_params)
        self.np, self.torch = np, torch
        self.dev = resolve_device("cuda")
        self.model = from_numpy_model(load_hand_model(DEFAULT_MODEL_JSON),
                                      self.dev)
        self.bank = load_animbank(DEFAULT_ANIMBANK)
        self.cfg = TrackerConfig(cnn_every_frame=False, solver="kernel",
                                 use_pallas=True, point_budget=2048,
                                 cloud_rows_per_body=128)
        self.params = physics_params(self.cfg)
        self.cam = synth_camera()
        cache = glob.glob(os.path.join(REPO, "tests", "fixtures", "cache",
                                       "depths_dyn30_*.npz"))
        check(len(cache) == 1, "the cached dyn30 renders are missing")
        from hand_tracking_samples_tpu_torch.ops.cloud_kernel import (
            depth_tensor)
        self.dyn = depth_tensor(np.load(cache[0])["depths"][:, 0], self.dev)
        with open(os.path.join(REPO, "tests", "fixtures", "golden.json")) as f:
            g = json.load(f)
        self.ref = torch.tensor(np.asarray(g["dyntrack_poses"], np.float32)
                                .reshape(-1, 17, 7)[:30], device=self.dev)
        from hand_tracking_samples_tpu_torch.data.synth import fake_depth
        self.fake = fake_depth(torch.tensor(self.bank[30:60], device=self.dev),
                               self.model, self.cam, chunk=8)
        self.results = {k: {} for k in (*KERNELS, *PLANS)}
        self.cnn_cfg = TrackerConfig(cnn_every_frame=True, cnn_every_k=1,
                                     solver="kernel", use_pallas=True,
                                     point_budget=2048,
                                     cloud_rows_per_body=128)

    # ---- inputs -----------------------------------------------------------
    def depth_frame(self, f, T):
        """(T, H, W): even tracks the dyn30 render f, odd ones fake f."""
        torch = self.torch
        even = torch.arange(T, device=self.dev) % 2 == 0
        return torch.where(even[:, None, None], self.dyn[f], self.fake[f])

    def init_state(self, T):
        from hand_tracking_samples_tpu_torch.parallel.tracks import (
            batched_tracker_state)
        torch = self.torch
        st = batched_tracker_state(self.model, T)
        b = torch.tensor(self.bank[[0, 30]], device=self.dev)
        pose = b[torch.arange(T, device=self.dev) % 2]
        return st._replace(body=st.body._replace(pose=pose))

    def run(self, st, frames, T, idx=None, keep=None):
        from hand_tracking_samples_tpu_torch.parallel.tracks import (
            batched_update)
        hist = []
        for f in range(frames):
            d = self.depth_frame(f, T)
            if idx is not None:
                d = d[idx]
            st, _ = batched_update(st, self.model, None, d, self.cam,
                                   self.cfg, self.params)
            if keep is not None:
                hist.append(keep(st))
        return st, hist

    def kernel_inputs(self, st, depth):
        """The four kernels' inputs for one frame of state st."""
        torch = self.torch
        from hand_tracking_samples_tpu_torch.fitting.cloud import (
            cloud_chamber_rows, rows_to_single_block)
        from hand_tracking_samples_tpu_torch.model.hand import (
            PHYSICS_WEAK_FORCE, body_params)
        from hand_tracking_samples_tpu_torch.ops.cloud_kernel import (
            cloud_from_depth_planes, planes_points)
        from hand_tracking_samples_tpu_torch.ops.cloud_rows import (
            _kernel_inputs_ph)
        from hand_tracking_samples_tpu_torch.physics.contact_kernel import (
            contact_inputs)
        from hand_tracking_samples_tpu_torch.physics.fused_fit import (
            solve_inputs)
        from hand_tracking_samples_tpu_torch.physics.pgs_kernel import (
            build_dynamics_plan)
        from hand_tracking_samples_tpu_torch.tracker.runtime import (
            BOUNDARY_OUTDIRS, CHAMBER_MAXFORCE)
        cfg, m, body = self.cfg, self.model, st.body
        B = m.n_bodies
        cloud_args = (depth, self.cam, 0.1, cfg.drangey,
                      cfg.subsample_fraction, cfg.point_budget)
        ph = cloud_from_depth_planes(*cloud_args)
        scale_b = torch.where(torch.arange(B, device=self.dev) <= 2,
                              PHYSICS_WEAK_FORCE, 1.0).float()
        rows_args = (ph,) + _kernel_inputs_ph(
            body.pose, m, (0.0, 0.0, 0.0), scale_b, self.params.deltaT) + (
            cfg.cloud_rows_per_body,)
        pairs = torch.as_tensor(m.np["collide_pairs"], device=self.dev)
        contact_args = contact_inputs(body.pose, body.linear_momentum,
                                      body.angular_momentum, m) + (
            pairs, 4, 3, self.params.driftmax)
        points, mask = planes_points(ph)
        chamber = cloud_chamber_rows(body.pose, m, points, mask,
                                     BOUNDARY_OUTDIRS, (0.0, 0.0, 0.0),
                                     (0.0, 0.0, 1.0), CHAMBER_MAXFORCE,
                                     active=mask.sum(-1) > cfg.min_point_num)
        plan = build_dynamics_plan(m.np, cfg.cloud_rows_per_body + 5)
        x = solve_inputs(body, body_params(m),
                         rows_to_single_block(chamber, (5, B)), plan,
                         self.params, m, (ph, (0.0, 0.0, 0.0), scale_b),
                         cfg.cloud_rows_per_body)
        pgs_args = (plan, cfg.physics_iterations, cfg.physics_iterations_post,
                    x["mom0"], x["mi"], x["singles"], x["lin_rows"],
                    x["ang_rows"])
        return dict(cloud_from_depth=cloud_args, cloud_rows_solve=rows_args,
                    contact_fields=contact_args, pgs_solve=pgs_args, P=x["P"])

    def pairs_of(self):
        from hand_tracking_samples_tpu_torch.ops.cloud_kernel import (
            cloud_from_depth_planes, cloud_from_depth_planes_plain)
        from hand_tracking_samples_tpu_torch.ops.cloud_rows import (
            cloud_rows_solve, cloud_rows_solve_plain, cloud_rows_unpacked,
            cloud_rows_unpacked_plain, cloud_vals_k, cloud_vals_plain)
        from hand_tracking_samples_tpu_torch.physics.contact_kernel import (
            contact_fields_plain, contact_fields_raw)
        from hand_tracking_samples_tpu_torch.physics.pgs_kernel import (
            pgs_solve, pgs_solve_plain)
        return dict(cloud_from_depth=(cloud_from_depth_planes,
                                      cloud_from_depth_planes_plain),
                    cloud_rows_solve=(cloud_rows_solve,
                                      cloud_rows_solve_plain),
                    contact_fields=(contact_fields_raw, contact_fields_plain),
                    pgs_solve=(pgs_solve, pgs_solve_plain),
                    cloud_rows_unpacked=(cloud_rows_unpacked,
                                         cloud_rows_unpacked_plain),
                    cloud_vals=(cloud_vals_k,
                                lambda pts, pl, body, misc:
                                cloud_vals_plain(pts, pl, body)),
                    **{k: (pgs_solve, pgs_solve_plain) for k in PLANS})

    # ---- kernel against plain: phases 3 and 5 ------------------------------
    def hold(self, name, k, p, P=None):
        """Check kernel output k against plain output p of kernel `name`
        under its tolerance; returns (max_abs_err, a short note).  P: the
        pose planes the PGS output is integrated with."""
        torch = self.torch
        if name == "cloud_from_depth":       # bit-identical
            err = (k - p).abs().max().item()
            check(torch.equal(k, p), f"cloud kernel not bit-identical ({err})")
            return err, f"cloud {err:.3g} (bit-identical)"
        if name == "cloud_rows_solve":
            # same winners/slots and counts, channels < 1e-6 (relative to
            # the channel's scale: K1 runs to ~1e3)
            (kp, kc), (pp, pc) = k, p
            check(torch.equal(kc, pc), "cloud rows: per-body counts differ")
            check(torch.equal(kp[:, 9] != 0, pp[:, 9] != 0),
                  "cloud rows: slot occupancy differs")
            scale = pp.abs().amax(dim=(0, 2)).clamp(min=1.0)
            rel = ((kp - pp).abs().amax(dim=(0, 2)) / scale).max().item()
            err = (kp - pp).abs().max().item()
            check(rel < 1e-6, f"cloud rows channels differ: {rel}")
            return err, f"rows {err:.3g} ({int(pc.sum())} slots)"
        if name == "contact_fields":
            # active masks equal, values <= 2e-5 where active; the error
            # reported is over every row, inactive ones too
            ka, pa = k[:, :, 8] > 0.5, p[:, :, 8] > 0.5
            check(torch.equal(ka, pa), "contacts: active masks differ")
            act = pa[:, :, None, :].expand_as(p)
            aerr = (k - p).abs()[act].max().item() if act.any() else 0.0
            check(aerr <= 2e-5, f"contacts differ: {aerr}")
            err = (k - p).abs().max().item()
            return err, (f"contacts {err:.3g} ({int(pa.sum())} active "
                         f"rows)")
        if name == "cloud_vals":
            # equal winners, values < 1e-6 (the same fused multiply-adds
            # on both sides: bit-identical expected)
            check(torch.equal(k[:, 1], p[:, 1]), "vals: winners differ")
            err = (k - p).abs().max().item()
            check(err < 1e-6, f"vals differ: {err}")
            return err, f"vals {err:.3g} ({k.shape[2]} points a track)"
        if name == "cloud_rows_unpacked":
            # every row field < 1e-6 of its channel's scale
            scale = p.abs().amax(dim=(0, 2)).clamp(min=1.0)
            rel = ((k - p).abs().amax(dim=(0, 2)) / scale).max().item()
            err = (k - p).abs().max().item()
            check(rel < 1e-6, f"unpacked rows differ: {rel}")
            return err, (f"unibody rows {err:.3g} "
                         f"({int((p[:, 7] > 0.5).sum())} active)")
        if name == "pgs_solve[unibody]":
            # the free body's motion: positions < 1e-5 m, quats < 1e-5
            from hand_tracking_samples_tpu_torch.tracker.runtime import (
                unibody_pose)
            x, body = P
            dt = self.params.deltaT
            sk = unibody_pose(x, k, body, self.model, dt)
            sp = unibody_pose(x, p, body, self.model, dt)
            perr = (sk.pose[..., :3] - sp.pose[..., :3]).abs().max().item()
            qerr = quat_err(sk.pose[..., 3:], sp.pose[..., 3:])
            check(perr < 1e-5 and qerr < 1e-5,
                  f"unibody pgs differs: {perr} {qerr}")
            err = (k - p).abs().max().item()
            return err, (f"unibody pgs momenta {err:.3g}, pos {perr:.3g} m, "
                         f"quat {qerr:.3g}")
        # PGS on identical planes: positions < 1e-5 m, quats < 1e-5
        from hand_tracking_samples_tpu_torch.physics.fused_fit import integrate
        sk = integrate(k, P, self.model.np, self.params.deltaT)
        sp = integrate(p, P, self.model.np, self.params.deltaT)
        perr = (sk.pose[..., :3] - sp.pose[..., :3]).abs().max().item()
        qerr = quat_err(sk.pose[..., 3:], sp.pose[..., 3:])
        check(perr < 1e-5 and qerr < 1e-5, f"pgs differs: {perr} {qerr}")
        err = (k - p).abs().max().item()
        return err, (f"pgs momenta {err:.3g}, pos {perr:.3g} m, quat "
                     f"{qerr:.3g}")

    # ---- phase 3 ------------------------------------------------------------
    def compare(self):
        T = 4
        st, _ = self.run(self.init_state(T), 3, T)
        inp = self.kernel_inputs(st, self.depth_frame(3, T))
        fns = self.pairs_of()
        lines = []
        for name in FIRST:
            kfn, pfn = fns[name]
            err, note = self.hold(name, kfn(*inp[name]), pfn(*inp[name]),
                                  inp["P"])
            self.results[name]["max_abs_err_t4"] = err
            lines.append(note)
        lines[2] += "; " + self.contacts_at_bank_poses(inp, fns)
        return "; ".join(lines)

    def contacts_at_bank_poses(self, inp, fns):
        """Contacts at poses with contacts (golden contact frame and a
        spread of bank frames) and random momenta, as the JAX suite checks
        them."""
        torch = self.torch
        with open(os.path.join(REPO, "tests", "fixtures", "golden.json")) as f:
            cf = int(json.load(f)["contact_frame"][0])
        frames = [cf] + list(range(0, len(self.bank), len(self.bank) // 7))[:7]
        rng = self.np.random.RandomState(3)
        from hand_tracking_samples_tpu_torch.physics.contact_kernel import (
            contact_inputs)
        f32 = lambda a: torch.tensor(a.astype(self.np.float32),
                                     device=self.dev)
        cin = contact_inputs(f32(self.bank[frames]),
                             f32(rng.randn(len(frames), 17, 3) * 1e-3),
                             f32(rng.randn(len(frames), 17, 3) * 1e-4),
                             self.model) + inp["contact_fields"][4:]
        k2 = fns["contact_fields"][0](*cin)
        p2 = fns["contact_fields"][1](*cin)
        check(int((p2[:, :, 8] > 0.5).sum()) > 0,
              "contacts: no active row to compare")
        err, note = self.hold("contact_fields", k2, p2)
        self.results["contact_fields"]["max_abs_err_bank_poses"] = err
        return f"at bank poses: {note}"

    # ---- phase 4 ------------------------------------------------------------
    def slice_run(self):
        torch = self.torch
        from hand_tracking_samples_tpu_torch import kernels
        T, F = TRACKS, FRAMES
        even = torch.arange(0, T, 2, device=self.dev)
        odd = torch.arange(1, T, 2, device=self.dev)
        sel = torch.tensor(sorted({0, 1, 2, 3, T // 2 - 2, T // 2 - 1,
                                   T - 2, T - 1}), device=self.dev)
        ref, bank = self.ref, torch.tensor(self.bank, device=self.dev)

        def keep(st):
            pose = st.body.pose
            dev = (pose[even, :, :3] - ref[len(hist_box)][:, :3]).norm(
                dim=-1).mean(-1)
            je = (pose[odd, :, :3] - bank[30 + len(hist_box)][:, :3]).norm(
                dim=-1).mean(-1)
            hist_box.append(0)
            return (dev.max(), dev.min(), je.mean(), pose[sel].clone(),
                    je.max(), je.min())
        hist_box = []
        kernels.reset_counts()
        st, hist = self.run(self.init_state(T), F, T, keep=keep)
        counts = {k: n for k, n in kernels.counts().items() if k in FIRST}
        torch.cuda.synchronize()
        for name, n in counts.items():
            self.results[name]["launches"] = n
        check(all(counts[n] > 0 for n in FIRST),
              f"a kernel did not launch on the main path: {counts}")
        dmax = torch.stack([h[0] for h in hist]).cpu().numpy()
        dmin = torch.stack([h[1] for h in hist]).cpu().numpy()
        je = torch.stack([h[2] for h in hist]).cpu().numpy() * 1e3
        je_spread = (torch.stack([h[4] for h in hist])
                     - torch.stack([h[5] for h in hist])).max().item() * 1e3
        check(bool(torch.isfinite(st.body.pose).all()), "non-finite poses")
        check((dmax < 1.2e-3).all(),
              f"dyn30 tracks: frame dev {dmax.max() * 1e3:.3f} mm >= 1.2 mm")
        check(dmax.mean() <= 1.0e-3,
              f"dyn30 tracks: mean dev {dmax.mean() * 1e3:.3f} mm > 1.0 mm")
        curve = " ".join(f"{e:.2f}" for e in je)
        band = ODD_BAND_MM
        check(je[:8].max() < band["before"] and je.max() < band["peak"]
              and je[-5:].max() < band["last5"] and je.mean() <= band["mean"],
              f"odd tracks outside {band}: per-frame mm {curve}")
        # tracks 0 and 1 (one of each kind) through the plain versions on
        # the CPU for the first frames: the same trajectory to 1e-4 m (two
        # devices' float32 rounding, carried by the solve)
        cerr = self.cpu_reference([h[3][:2] for h in hist][:CPU_FRAMES])
        # re-run 8 tracks as their own batch: cross-track indexing faults
        full = self.init_state(T)
        st8 = type(full)(type(full.body)(*[x[sel] for x in full.body]),
                         full.prev_frame_error[sel], full.initializing[sel])
        st8, hist8 = self.run(st8, F, T, idx=sel,
                              keep=lambda s: s.body.pose.clone())
        rerr = max((a[3][..., :3] - b[..., :3]).abs().max().item()
                   for a, b in zip(hist, hist8))
        check(rerr < 1e-5, f"T=8 re-run differs from T={T}: {rerr} m")
        self.slice_stats = dict(
            dyn30_dev_mm_max=float(dmax.max() * 1e3),
            dyn30_dev_mm_mean=float(dmax.mean() * 1e3),
            dyn30_spread_mm=float((dmax - dmin).max() * 1e3),
            fake_joint_err_mm=float(je.mean()),
            fake_joint_err_mm_per_frame=[float(e) for e in je],
            fake_spread_mm=je_spread, rerun_err_m=rerr,
            cpu_reference_err_m=cerr,
            launches=counts)
        self.final_state = st
        return (f"T={T} F={F}: dyn30 dev max {dmax.max() * 1e3:.3f} mm mean "
                f"{dmax.mean() * 1e3:.3f} mm; odd tracks joint err mean "
                f"{je.mean():.3f} mm, per frame [{curve}] mm, spread "
                f"{je_spread:.3g} mm; T=8 re-run {rerr:.2g} m; CPU "
                f"plain reference ({min(F, CPU_FRAMES)} frames) {cerr:.2g} "
                f"m; "
                f"launches {counts}")

    def cpu_reference(self, poses):
        """Tracks 0 and 1 through the plain versions on the CPU; returns
        the largest position difference from `poses` (per-frame (2, B, 7)
        card results)."""
        torch = self.torch
        from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
        from hand_tracking_samples_tpu_torch.parallel.tracks import (
            batched_tracker_state, batched_update)
        model = from_numpy_model(self.model.np, "cpu")
        st = batched_tracker_state(model, 2)
        st = st._replace(body=st.body._replace(
            pose=torch.tensor(self.bank[[0, 30]])))
        err = 0.0
        for f, ref in enumerate(poses):
            st, _ = batched_update(st, model, None,
                                   self.depth_frame(f, 2).cpu(), self.cam,
                                   self.cfg, self.params)
            err = max(err, (st.body.pose[..., :3]
                            - ref[..., :3].cpu()).abs().max().item())
        check(err < 1e-4, f"CPU plain reference differs: {err} m")
        return err

    # ---- phase 5 ------------------------------------------------------------
    def timing(self):
        torch = self.torch
        T, F = TRACKS, FRAMES
        st = self.init_state(T)
        st, _ = self.run(st, 2, T)                       # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st2, _ = self.run(self.init_state(T), F, T)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        fps = T * F / dt
        self.fps = dict(tracks=T, frames=F, seconds=dt, tracked_fps=fps)
        prof = self.profile(T, 3)
        self.fps.update(prof)
        busy = (f"; device busy {prof['device_ms_per_frame']:.2f} of "
                f"{dt / F * 1e3:.2f} ms a frame (port kernels "
                f"{prof['port_kernels_ms_per_frame']:.2f}, "
                f"{prof['torch_launches_per_frame']:.0f} PyTorch launches "
                f"{prof['torch_ops_ms_per_frame']:.2f})"
                if "device_ms_per_frame" in prof
                else f"; profile not measured ({prof['profile_error']})")
        inp = self.kernel_inputs(self.final_state, self.depth_frame(F - 1, T))
        fns = self.pairs_of()
        parts = []
        for name in FIRST:
            kfn, pfn = fns[name]
            args = inp[name]
            ms, k = self.event_ms(kfn, args, warm=2, reps=10)
            plain_ms, p = self.event_ms(pfn, args, warm=1, reps=1)
            err, note = self.hold(name, k, p, inp["P"])
            nbytes, ops = self.work(name, args)
            tb, to = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_S * 1e3
            self.results[name].update(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(tb, to),
                bound_by="bytes" if tb >= to else "operations",
                library_ms=None, bytes=nbytes, operations=ops)
            parts.append(f"{name} {ms:.4f} ms (plain {plain_ms:.2f}; "
                         f"{note})")
        return (f"T={T}: {fps:.1f} tracked frames/s{busy}; "
                + "; ".join(parts))

    def profile(self, T, frames, run=None, state=None):
        """Device time and kernel launches per frame, from torch.profiler
        over `frames` frames of `run` (default the dynamics frame; a
        measurement only: a profiler that records nothing is reported, not
        fatal)."""
        torch = self.torch
        run = run or self.run
        try:
            from torch.profiler import ProfilerActivity, profile
            st, _ = run(self.init_state(T) if state is None else state, 1, T)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as p:
                run(st, frames, T)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            dev = [e for e in p.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
            def us(e):
                return getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
            ours = ("cloud_from_depth_kernel", "cloud_rows_solve_kernel",
                    "cloud_rows_unpacked_kernel", "contact_fields_kernel",
                    "pgs_kernel")
            own = [e for e in dev if e.key.startswith(ours)]
            total = sum(us(e) for e in dev)
            check(total > 0, "the profiler recorded no device time")
            return dict(
                profiled_wall_ms_per_frame=wall * 1e3 / frames,
                device_ms_per_frame=total / 1e3 / frames,
                launches_per_frame=sum(e.count for e in dev) / frames,
                port_kernels_ms_per_frame=sum(us(e) for e in own)
                / 1e3 / frames,
                torch_ops_ms_per_frame=(total - sum(us(e) for e in own))
                / 1e3 / frames,
                torch_launches_per_frame=(sum(e.count for e in dev)
                                          - sum(e.count for e in own))
                / frames)
        except Exception as e:  # measurement only
            return dict(profile_error=f"{type(e).__name__}: {e}"[:200])

    def event_ms(self, fn, args, warm, reps):
        """(ms a call from CUDA events, the last call's output)."""
        torch = self.torch
        for _ in range(warm):
            fn(*args)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            out = fn(*args)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps, out

    def work(self, name, args):
        """(bytes the function must move, float32 operations it does) on
        these inputs: each input read once, each output written once."""
        torch = self.torch
        if name == "cloud_from_depth":
            depth, budget = args[0], args[5]
            T, H, W = depth.shape
            return T * H * W * 2 + T * 8 * budget * 4, T * (H * W * 3
                                                          + budget * 8)
        if name == "cloud_rows_solve":
            pts, planes, body, misc, C = args
            T, _, N = pts.shape
            P, B = planes.shape[1] // 5, planes.shape[2]
            nin = sum(x.numel() * 4 for x in (pts, planes, body, misc))
            nout = T * 12 * 24 * C * 4 + T * 24 * 4
            # hull scan (3 mul, 3 add, 1 max a plane), the winner's planes
            # again (max, blend, slab clip), spheres, the row and its prep
            per_pt = B * P * 7 + P * 23 + B * 12 + 80
            return nin + nout, T * N * per_pt
        if name == "contact_fields":
            vw, nw, dw, aux, pairs, npt = args[:6]
            T, _, B, V = vw.shape
            P = nw.shape[-1]
            a, b = pairs[:, 0], pairs[:, 1]
            dc = aux[:, a, 6:9] - aux[:, b, 6:9]
            rs = aux[:, a, 9] + aux[:, b, 9]
            near = int(((dc * dc).sum(-1) <= rs * rs).sum())
            NP = pairs.shape[0]
            nin = sum(x.numel() * 4 for x in (vw, nw, dw, aux))
            # two face scans (3 mul, 2 add, 1 min a vert-plane pair),
            # support refinement, manifold; a culled pair costs its cull
            ops = near * (2 * P * V * 6 + 4 * 2 * V * 7 + V * 15 + 200) \
                + (T * NP - near) * 10
            return nin + pairs.numel() * 4 + T * NP * 12 * npt * 4, ops
        if name in ("cloud_vals", "cloud_rows_unpacked"):
            pts, planes, body, misc = args
            T, _, N = pts.shape
            P, B = planes.shape[1] // 5, planes.shape[2]
            nin = sum(x.numel() * 4 for x in (pts, planes, body, misc))
            # the winner scan (hull planes: 3 mul, 3 add, 1 max; spheres);
            # the rows add the winner's planes again and the row itself
            per_pt = B * P * 7 + B * 12
            if name == "cloud_vals":
                return nin + T * 2 * N * 4, T * N * per_pt
            return nin + T * 8 * N * 4, T * N * (per_pt + P * 23 + 60)
        plan, it, ip, mom0, mi, singles, lin_rows, ang_rows = args
        T, _, bp = mom0.shape
        B = len(plan.massinv)                 # the real bodies
        act = singles[:, :, 9].abs().sum(-1) > 0              # (T, CS)
        idx = torch.arange(1, act.shape[1] + 1, device=act.device)
        nact = int((act * idx).amax(-1).sum())
        nbytes = nact * 14 * bp * 4 + mom0.numel() * 4 * 3
        sweeps = it + ip
        ops = nact * B * 32 * sweeps
        for cls, rows in zip(plan.lin_classes, lin_rows):
            if cls.friction:
                g_act = rows[:, :, 15].abs().sum(-1).reshape(
                    T, cls.n_groups, cls.U).sum(-1) > 0        # (T, G)
                real = torch.tensor((cls.unit_b0 >= 0).sum(-1),
                                    device=rows.device)
                units = int((g_act * real).sum())
                nbytes += int(g_act.sum()) * cls.U * 23 * cls.W * 4 \
                    + T * cls.n_phases * cls.W * 4
                ops += units * cls.U * 60 * sweeps
            else:
                units = int((cls.unit_b0 >= 0).sum())
                nbytes += rows.numel() * 4
                ops += T * units * cls.U * 60 * sweeps
        for cls, rows in zip(plan.ang_classes, ang_rows):
            units = int((cls.unit_b0 >= 0).sum())
            nbytes += rows.numel() * 4
            ops += T * units * cls.U * 30 * sweeps
        return nbytes, ops


    # ---- the CNN frame: phases 6-8 -----------------------------------------
    def cnn_setup(self):
        from hand_tracking_samples_tpu_torch.assets_paths import DEFAULT_CNNB
        from hand_tracking_samples_tpu_torch.cnn.model import load_cnnb
        check(os.path.exists(DEFAULT_CNNB),
              f"the trained net {DEFAULT_CNNB} is missing")
        self.cnn = load_cnnb(DEFAULT_CNNB, self.dev)
        return os.path.relpath(DEFAULT_CNNB, REPO)

    def cnn_state(self, T):
        """Every 4th track from initial_state (the reset fires), the rest
        at bank[30]."""
        from hand_tracking_samples_tpu_torch.parallel.tracks import (
            batched_tracker_state)
        torch = self.torch
        st = batched_tracker_state(self.model, T)
        gt = torch.tensor(self.bank[30], device=self.dev).expand(T, 17, 7)
        pose = torch.where(self.reset_group(T)[:, None, None],
                           st.body.pose, gt).contiguous()
        return st._replace(body=st.body._replace(pose=pose))

    def reset_group(self, T):
        return self.torch.arange(T, device=self.dev) % 4 == 3

    def cnn_depth(self, f, T):
        return self.fake[f].expand(T, -1, -1).contiguous()

    def cnn_run(self, st, frames, T, idx=None, keep=None, dev=None):
        from hand_tracking_samples_tpu_torch.parallel.tracks import (
            batched_update)
        model, cnn = self.model, self.cnn
        if dev is not None:                  # the CPU plain reference
            from hand_tracking_samples_tpu_torch.cnn.model import from_numpy
            from hand_tracking_samples_tpu_torch.model.bake import (
                from_numpy_model)
            model = from_numpy_model(self.model.np, dev)
            cnn = from_numpy({k: {kk: vv.cpu().numpy()
                                  for kk, vv in v.items()}
                              for k, v in cnn.items()}, dev)
        hist = []
        for f in range(frames):
            d = self.cnn_depth(f, T)
            if idx is not None:
                d = d[idx]
            if dev is not None:
                d = d.to(dev)
            st, _ = batched_update(st, model, cnn, d, self.cam,
                                   self.cnn_cfg, self.params)
            if keep is not None:
                hist.append(keep(st))
        return st, hist

    def cnn_kernel_inputs(self, st, depth):
        """The CNN frame's kernel inputs for state st and depth (T, H, W):
        vals (FitError at st), unpacked rows and the unibody solve (at the
        PoseFromScratch pose, as the reset runs them), and the multistep
        step with keypoints, cloud and angles (step 1)."""
        torch = self.torch
        from hand_tracking_samples_tpu_torch.imaging.image_ops import (
            compact_planes)
        from hand_tracking_samples_tpu_torch.model.hand import body_params
        from hand_tracking_samples_tpu_torch.ops.cloud_rows import (
            _kernel_inputs_ph)
        from hand_tracking_samples_tpu_torch.physics.fused_fit import (
            solve_inputs)
        from hand_tracking_samples_tpu_torch.physics.pgs_kernel import (
            build_multistep_plan)
        from hand_tracking_samples_tpu_torch.tracker import runtime as rt
        cfg, m, body = self.cnn_cfg, self.model, st.body
        B, it, ip = m.n_bodies, cfg.physics_iterations, \
            cfg.physics_iterations_post
        seg, an, _, _, ph = rt._cnn_frame_inputs(self.cnn, depth, self.cam,
                                                 cfg)
        cam = seg.cam.pose
        zb = torch.zeros(B, device=self.dev)
        vals = (ph,) + _kernel_inputs_ph(body.pose, m, (0.0, 0.0, 0.0), zb,
                                         0.0)
        b0 = rt.pose_from_scratch(body, m, an, ph, cam)
        keep, N = rt._subsample4(ph)
        uph = compact_planes(ph, keep, max(N // 4, 64))
        rows = (uph,) + _kernel_inputs_ph(b0.pose, m, cam[:, :3], zb, 0.0)
        x = rt.unibody_inputs(b0, m, self.params, ph, cam[:, :3],
                              cfg.unibody_force)
        uni = (x["plan"], it, ip, x["mom0"], x["mi"], x["singles"], [], [])
        blk = rt._keypoint_block(body, m, an, cam, cfg)
        plan = build_multistep_plan(m.np, 4 + cfg.cloud_rows_per_body, True)
        xs = solve_inputs(body, body_params(m), blk, plan, self.params, m,
                          rt.multistep_cloud(ph, cam, cfg, B),
                          cfg.cloud_rows_per_body, "ms_angles",
                          (an.palmq, an.finger_clenched, cam[:, 3:7]),
                          10000.0)
        ms = (plan, it, ip, xs["mom0"], xs["mi"], xs["singles"],
              xs["lin_rows"], xs["ang_rows"])
        return {"cloud_vals": vals, "cloud_rows_unpacked": rows,
                "pgs_solve[multistep]": ms, "pgs_solve[unibody]": uni,
                "P": {"pgs_solve[multistep]": xs["P"],
                      "pgs_solve[unibody]": (x, b0)}}

    def contracted_ops(self):
        """maths.fma's card forms (addcmul, sqrt) equal its exact CPU forms
        bit for bit: the plain versions' contracted expressions then equal
        the kernels' fmaf/sqrtf."""
        torch = self.torch
        from hand_tracking_samples_tpu_torch.maths import fma as fq
        rng = self.np.random.default_rng(11)
        n = 1 << 20
        a, b, c = (rng.standard_normal(n).astype(self.np.float32)
                   for _ in range(3))
        c[: n // 2] = -(a[: n // 2].astype(self.np.float64)
                        * b[: n // 2]).astype(self.np.float32)  # near ties
        x = self.np.float32(1 + 2 ** -12)          # a double-rounding case
        a[0], b[0], c[0] = x, x, self.np.float32(2 ** -70)
        cpu = fq.fma(*(torch.tensor(v) for v in (a, b, c)))
        card = fq.fma(*(torch.tensor(v, device=self.dev)
                        for v in (a, b, c))).cpu()
        check(torch.equal(cpu, card), "addcmul on the card is not one fused "
              f"multiply-add: {int((cpu != card).sum())} of {n} differ")
        r = torch.tensor(self.np.abs(a) * 1e3)
        check(torch.equal(fq.sqrt(r), fq.sqrt(r.to(self.dev)).cpu()),
              "sqrt on the card is not correctly rounded")
        return f"fma and sqrt card forms equal the CPU forms ({n} values)"

    def compare_cnn(self):
        T = 4
        inp = self.cnn_kernel_inputs(self.cnn_state(T), self.cnn_depth(0, T))
        fns = self.pairs_of()
        lines = [self.contracted_ops()]
        for name in NEW:
            kfn, pfn = fns[name]
            err, note = self.hold(name, kfn(*inp[name]), pfn(*inp[name]),
                                  inp["P"].get(name))
            self.results[name]["max_abs_err_t4"] = err
            lines.append(note)
        return "; ".join(lines)

    def cnn_slice(self):
        torch = self.torch
        from hand_tracking_samples_tpu_torch import kernels
        from hand_tracking_samples_tpu_torch.physics.pgs_kernel import (
            pgs_solve)
        T, F = CNN_TRACKS, CNN_FRAMES
        grp = self.reset_group(T)
        bank = torch.tensor(self.bank, device=self.dev)
        box = []

        def keep(st):
            pose = st.body.pose
            je = (pose[..., :3] - bank[30 + len(box)][:, :3]).norm(
                dim=-1).mean(-1)
            box.append(0)
            return (je[~grp].mean(), je[~grp].max(), je[grp].mean(),
                    je[grp].max(), pose[[0, 3]].clone())
        st0 = self.cnn_state(T)
        kernels.reset_counts()
        st, hist = self.cnn_run(st0, F, T, keep=keep)
        counts = kernels.counts()
        kinds = dict(pgs_solve.kinds)
        torch.cuda.synchronize()
        for name in ("cloud_rows_unpacked", "cloud_vals"):
            self.results[name]["launches"] = counts[name]
        for name, kind in PLANS.items():
            self.results[name]["launches"] = kinds.get(kind, 0)
        for name in FIRST:
            self.results[name]["launches_cnn_frame"] = counts[name]
        check(all(n > 0 for n in counts.values()),
              f"a kernel did not launch on the CNN frame: {counts}")
        check(all(kinds.get(k, 0) > 0 for k in ("dyn", "ms", "uni")),
              f"a PGS plan did not launch on the CNN frame: {kinds}")
        check(bool(torch.isfinite(st.body.pose).all()), "non-finite poses")
        h = [torch.stack([x[i] for x in hist]).cpu().numpy() * 1e3
             for i in range(4)]
        gt_mean, gt_max, rs_mean, rs_max = h
        band = CNN_BAND_MM
        curve = lambda v: " ".join(f"{e:.2f}" for e in v)
        check(gt_max.max() < band["gt"] and rs_max[0] < band["reset_first"]
              and rs_max[-1] < band["reset_last"],
              f"CNN frame outside {band}: on-hand tracks per frame "
              f"[{curve(gt_max)}] mm, reset tracks [{curve(rs_max)}] mm")
        cerr = self.cnn_cpu_reference([x[4] for x in hist][:CNN_CPU_FRAMES])
        self.cnn_stats = dict(
            gt_joint_err_mm_per_frame=gt_mean.tolist(),
            gt_joint_err_mm_max_per_frame=gt_max.tolist(),
            reset_joint_err_mm_per_frame=rs_mean.tolist(),
            reset_joint_err_mm_max_per_frame=rs_max.tolist(),
            cpu_reference_err_m=cerr, launches=counts, pgs_plans=kinds)
        self.cnn_final = st
        return (f"T={T} F={F}: joint err on-hand tracks [{curve(gt_mean)}] "
                f"mm, reset tracks (every 4th, from initial_state) "
                f"[{curve(rs_mean)}] mm; CPU plain reference "
                f"({CNN_CPU_FRAMES} frames) {cerr:.2g} m; launches {counts}, "
                f"PGS plans {kinds}")

    def cnn_cpu_reference(self, poses):
        """Tracks 0 (on the hand) and 3 (reset) through the plain versions
        on the CPU; the largest position difference from the card's."""
        torch = self.torch
        idx = torch.tensor([0, 3], device=self.dev)
        full = self.cnn_state(4)
        st = type(full)(type(full.body)(*[x[idx].cpu() for x in full.body]),
                        full.prev_frame_error[idx].cpu(),
                        full.initializing[idx].cpu())
        err = 0.0
        _, hist = self.cnn_run(st, len(poses), 4, idx=idx,
                               keep=lambda s: s.body.pose.clone(),
                               dev="cpu")
        for mine, ref in zip(hist, poses):
            err = max(err, (mine[..., :3] - ref[..., :3].cpu()).abs().max()
                      .item())
        check(err < 1e-4, f"CNN frame: CPU plain reference differs: {err} m")
        return err

    def cnn_timing(self):
        torch = self.torch
        T, F = CNN_TRACKS, CNN_FRAMES
        st, _ = self.cnn_run(self.cnn_state(T), 1, T)           # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.cnn_run(self.cnn_state(T), F, T)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        prof = self.profile(T, 2, run=self.cnn_run,
                            state=self.cnn_state(T))
        self.cnn_speed = dict(tracks=T, frames=F, seconds=dt,
                              ms_per_frame=dt / F * 1e3,
                              tracked_fps=T * F / dt, **prof)
        busy = (f"; device busy {prof['device_ms_per_frame']:.2f} ms a frame "
                f"(port kernels {prof['port_kernels_ms_per_frame']:.2f}, "
                f"{prof['torch_launches_per_frame']:.0f} PyTorch launches "
                f"{prof['torch_ops_ms_per_frame']:.2f})"
                if "device_ms_per_frame" in prof
                else f"; profile not measured ({prof['profile_error']})")
        inp = self.cnn_kernel_inputs(self.cnn_final,
                                     self.cnn_depth(F - 1, T))
        fns = self.pairs_of()
        parts = []
        for name in NEW:
            kfn, pfn = fns[name]
            args = inp[name]
            ms, k = self.event_ms(kfn, args, warm=2, reps=10)
            plain_ms, p = self.event_ms(pfn, args, warm=0, reps=1)
            err, note = self.hold(name, k, p, inp["P"].get(name))
            nbytes, ops = self.work(name, args)
            tb, to = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_S * 1e3
            self.results[name].update(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(tb, to),
                bound_by="bytes" if tb >= to else "operations",
                library_ms=None, bytes=nbytes, operations=ops)
            parts.append(f"{name} {ms:.4f} ms (plain {plain_ms:.2f}; "
                         f"{note})")
        return (f"T={T}: {dt / F * 1e3:.1f} ms a CNN frame, "
                f"{T * F / dt:.1f} tracked frames/s{busy}; "
                + "; ".join(parts))

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", help="also write every measured number to "
                    "this file")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from hand_tracking_samples_tpu_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 3
    t_all = time.perf_counter()
    record = {}

    def phase(n, title, fn):
        t0 = time.perf_counter()
        try:
            msg = fn()
        except Exception as e:  # every phase failure ends the run
            print(f"phase {n} {title}: FAILED after "
                  f"{time.perf_counter() - t0:.1f} s: {e}", flush=True)
            raise SystemExit(1)
        dt = time.perf_counter() - t0
        record[f"phase{n}_s"] = dt
        print(f"phase {n} {title}: {dt:.1f} s: {msg}", flush=True)

    def build():
        kernels.build()
        kernels.library()
        info = kernels.BUILD_INFO
        record["build"] = {k: v for k, v in info.items() if k != "log"}
        return (f"{'built' if info['built'] else 'reused'} "
                f"{os.path.relpath(info['path'], REPO)} in "
                f"{info['seconds']:.1f} s")
    phase(1, "build", build)

    smi = {}

    def device():
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        smi["line"] = out.stdout.strip().splitlines()[0]
        return (f"{torch.cuda.get_device_name(0)}, "
                f"{torch.cuda.device_count()} card(s)")
    phase(2, "device", device)
    print(smi["line"], flush=True)

    state = {}

    def setup_and_compare():
        state["s"] = Smoke()
        return state["s"].compare()
    phase(3, "kernels vs plain (T=4)", setup_and_compare)
    s = state["s"]
    phase(4, "slice", s.slice_run)
    phase(5, "timing and kernels vs plain (T=512)", s.timing)

    def setup_and_compare_cnn():
        net = s.cnn_setup()
        return f"net {net}; " + s.compare_cnn()
    phase(6, "CNN-frame kernels vs plain (T=4)", setup_and_compare_cnn)
    phase(7, "CNN frame", s.cnn_slice)
    phase(8, "CNN-frame timing and kernels vs plain (T=512)", s.cnn_timing)
    record["total_s"] = time.perf_counter() - t_all
    rows = []
    src_of = dict(KERNELS, **{k: KERNELS["pgs_solve"] for k in PLANS})
    for name, (src, rep) in src_of.items():
        r = s.results[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": r["launches"],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": None})
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(dict(record, device=smi["line"], kernels=s.results,
                           slice=s.slice_stats, speed=s.fps,
                           cnn_frame=s.cnn_stats, cnn_speed=s.cnn_speed),
                      f, indent=1, default=str)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
