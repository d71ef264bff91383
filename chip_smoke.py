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
  9. the reference solvers' kernels against their plain versions, bit for
     bit, at T=4 and at T=512 (the T=512 ones timed): the correspondence
     kernel and the row sweep on a sequential and on a colored solve's
     rows; and the reference-layout contact rows at T=512 on poses with
     active contacts (the golden's contact pose and animbank poses)
 10. the sequential frame (use_pallas=True) at T=512 for 30 frames on
     phase 4's renders: even tracks held to golden.json's dyntrack poses
     (per frame < 1.5 mm, mean <= 1.0 mm, tests/test_tracker_e2e.py:39),
     odd tracks to the JAX package's curve on the same renders
     (SEQ_ODD_BAND_MM); the colored frame against the sequential one at
     2048 cloud rows a body (no body thinned) over 3 frames (COLORED_M,
     COLORED_QUAT); two tracks through the plain versions on the CPU
     (< 1e-4 m); the sequential frame with use_pallas=False on two tracks
     against the CPU (< 1e-4 m) and its peak memory at T=64; the new
     kernels launched every frame
 11. both reference solvers' frame time at T=512, their device-time split
     and the launch counts of the timed frames
 12. kernel 2.5 (the 16-channel cloud-rows pack) against its plain version
     at T=4 and at T=512, on the dynamics pass's cloud (N=2048, the mirror
     split by the cutting plane) and on MultiStepSim's (N=512): every
     channel equal and the counts equal
 13. the voxel and mirror clouds at T=512 on the kernel solver: the far
     mirror plane (a no-op on these renders) for 30 frames on phase 4's
     renders, held to phase 4's gates (dyn30 golden, ODD_BAND_MM); the
     voxel cloud for 30 frames, held to the JAX package's voxel curve on
     the same renders (VOXEL_BAND_MM); the CNN frame with the far plane for
     8 frames on phase 7's renders (CNN_BAND_MM); the sequential frame with
     the voxel cloud (VOXEL_BAND_MM) and with the far plane (phase 10's
     gates: the dyn30 golden and SEQ_ODD_BAND_MM) for 10 frames; a 2-track CPU re-run of each (the CNN frame's
     first frame, with the reset) and the cutting plane's frames (dynamics,
     sequential, colored and sequential with use_pallas=False 2 frames,
     CNN its first) on 2 tracks against the CPU
     (< 1e-4 m); the voxel cloud the same bits on two runs, and its counts
     and mask equal to the CPU's; kernel 2.5 launched once a dynamics pass
     and five times a CNN frame, kernel 2 not at all
 14. those frames' time at T=512, their device-time split, and kernel 2.5
     timed at both N beside its plain version and its bound, held to the
     plain version again at the timed shapes

Each phase drives its path with the launch counts set to 0 just before it
and reads them just after.  The line before the last is the kernels' JSON
record (launches: the dynamics path's for the first four kernels, the CNN
frame's for kernels 6-7 and the plans, the sequential frame's (phase 10)
for the correspondence kernel and the row sweep, the colored frame's
(phase 11) for the row sweep on colored rows, the far-mirror dynamics
frame's (phase 13) for kernel 2.5); the last line is
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
    "correspondence": (f"{PORT}/csrc/correspondence.cu",
                       f"{JAXPKG}/ops/correspondence.py:32"),
    # no Pallas kernel: the JAX package's sequential solve is a lax.scan
    "row_sweep": (f"{PORT}/csrc/row_sweep.cu",
                  f"{JAXPKG}/physics/solver.py:223"),
    "cloud_rows_packed": (f"{PORT}/csrc/cloud_rows.cu",
                          f"{JAXPKG}/ops/cloud_rows.py:34"),
}
FIRST = ("cloud_from_depth", "cloud_rows_solve", "contact_fields",
         "pgs_solve")            # the dynamics path's kernels (phases 3-5)
# the PGS kernel's plans that the CNN frame adds: row name -> plan kind
PLANS = {"pgs_solve[multistep]": "ms", "pgs_solve[unibody]": "uni"}
NEW = ("cloud_rows_unpacked", "cloud_vals") + tuple(PLANS)
# the row sweep on the colored solver's rows: the JAX colored solve's
# fori_loops (physics/colored.py:300)
REF_ROWS = {"row_sweep[colored]": (f"{PORT}/csrc/row_sweep.cu",
                                   f"{JAXPKG}/physics/colored.py:300")}
REF_CPU_FRAMES = 2        # frames of the reference solvers' CPU re-run
REF_TIMED_FRAMES = 10     # frames timed per reference solver (phase 11)
# The odd tracks on the sequential solver against the JAX package's curve
# on the same renders (tests/test_torch_seq_frame.jax_odd_curve), |port -
# JAX| of the per-frame mean joint error in mm: before the fast motion
# (frames 0-7), on any frame, and on the last five.  Set from the measured
# gaps (PERF.md: on an H100 at most 0.002, 0.384 and 0.044 mm; on the CPU
# 0.032 mm over all frames).
SEQ_ODD_BAND_MM = dict(before=0.02, any=2.0, last5=0.5)
# Colored against sequential over 3 frames with no cloud row thinned:
# position in m (tests/test_colored_solver.py:38) and quat_err.  Measured
# 0 and 0 on an H100 (PERF.md), as on the CPU.
COLORED_M, COLORED_QUAT = 1e-5, 1e-5
NOPALLAS_MEM_TRACKS = 64  # tracks of the use_pallas=False memory reading
# The voxel and mirror clouds (phases 12-14).  The far plane lies beyond
# every valid depth of the renders (0.343-0.512 m), so its split is a no-op
# there and the tracks meet the gates of the plain cloud; the cutting plane
# (a tilted unit normal through the median valid point of dyn30 render 0)
# reflects, drops and keeps points, and is held to the CPU only.
FAR_PLANE = (0.0, 0.0, -1.0, 0.60)
CUT_PLANE = (0.3007679283618927, -0.20051196217536926, -0.9323806166648865,
             0.370469868183136)
VOXEL_SIZE = 0.005        # m; ~470-650 voxels on the dyn30 renders
CLOUD_CPU_FRAMES = 2      # frames of each cloud's CPU plain-version re-run
CLOUD_SEQ_FRAMES = 10     # sequential frames with each cloud (phase 13)
CLOUD_TIMED_FRAMES = dict(dyn=5, cnn=2, seq=5)    # frames timed (phase 14)
# The voxel tracks against the JAX package's voxel curve on the same renders
# (tests/test_torch_cloud_frames.jax_voxel_curve), |port - JAX| of the
# per-frame mean joint error in mm: before the fast motion (frames 0-7) and
# on any frame.  In both packages the dyn30 track loses the hand under the
# voxel cloud (0.66 mm on frame 0, 41 mm on frame 29), and the gap grows
# with it.  Set from the measured gaps (PERF.md: on an H100 at most 0.0014
# and 0.563 mm on the kernel solver, 0.0027 and 0.0065 mm on the sequential
# one; on the CPU 0.070 mm over all frames).
VOXEL_BAND_MM = dict(before=0.02, any=2.0)


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
        self.results = {k: {} for k in (*KERNELS, *PLANS, *REF_ROWS)}
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

    def run(self, st, frames, T, idx=None, keep=None, cfg=None):
        from hand_tracking_samples_tpu_torch.parallel.tracks import (
            batched_update)
        hist = []
        for f in range(frames):
            d = self.depth_frame(f, T)
            if idx is not None:
                d = d[idx]
            st, _ = batched_update(st, self.model, None, d, self.cam,
                                   cfg or self.cfg, self.params)
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

    def cpu_reference(self, poses, cfg=None):
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
                                   cfg or self.cfg, self.params)
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
            ours = ("cloud_from_depth_kernel", "cloud_rows_pack_kernel",
                    "cloud_rows_unpacked_kernel", "cloud_vals_kernel",
                    "contact_fields_kernel", "pgs_kernel",
                    "correspondence_kernel", "row_sweep_kernel")
            own = [e for e in dev if any(o in e.key for o in ours)]
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
        if name in ("cloud_rows_solve", "cloud_rows_packed"):
            pts, planes, body, misc, C = args
            T, _, N = pts.shape
            P, B = planes.shape[1] // 5, planes.shape[2]
            nin = sum(x.numel() * 4 for x in (pts, planes, body, misc))
            ch = 12 if name == "cloud_rows_solve" else 16
            nout = T * ch * 24 * C * 4 + T * 24 * 4
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

    def cnn_run(self, st, frames, T, idx=None, keep=None, dev=None,
                cfg=None):
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
                                   cfg or self.cnn_cfg, self.params)
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
        off_path = ("cloud_rows_packed", "correspondence", "row_sweep")
        check(all(n > 0 for k, n in counts.items() if k not in off_path),
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

    def cnn_cpu_reference(self, poses, cfg=None):
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
                               dev="cpu", cfg=cfg)
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

    # ---- the reference solvers: phases 9-11 --------------------------------
    def ref_cfg(self, solver, use_pallas=True, **kw):
        from hand_tracking_samples_tpu_torch.tracker.config import (
            TrackerConfig)
        return TrackerConfig(cnn_every_frame=False, solver=solver,
                             use_pallas=use_pallas, point_budget=2048, **kw)

    def ref_inputs(self, st, depth):
        """The new kernels' inputs for one reference frame of state st:
        the correspondence kernel's, and the row sweep's for one sequential
        and one colored solve (the frame's rows: chamber, cloud, joints,
        contacts, ranges)."""
        from hand_tracking_samples_tpu_torch.model.hand import body_params
        from hand_tracking_samples_tpu_torch.ops import correspondence as oc
        from hand_tracking_samples_tpu_torch.ops.cloud_kernel import (
            cloud_from_depth_planes, planes_points)
        from hand_tracking_samples_tpu_torch.physics.colored import (
            colored_sweep_inputs)
        from hand_tracking_samples_tpu_torch.physics.schedule import (
            build_hand_schedule)
        from hand_tracking_samples_tpu_torch.physics.solver import (
            sweep_inputs)
        from hand_tracking_samples_tpu_torch.tracker.runtime import (
            reference_frame_rows)
        cfg, m, body = self.ref_cfg("sequential"), self.model, st.body
        ph = cloud_from_depth_planes(depth, self.cam, 0.1, cfg.drangey,
                                     cfg.subsample_fraction,
                                     cfg.point_budget)
        pts, mask = planes_points(ph)
        pw = oc.world_planes(body.pose, m)
        out = {"correspondence": (oc.points_h(pts), pw,
                                  oc.origin_dots(pw, m, (0.0, 0.0, 0.0)))}
        it, ip = cfg.physics_iterations, cfg.physics_iterations_post
        for name, sched, fn in (
                ("row_sweep", None, sweep_inputs),
                ("row_sweep[colored]", build_hand_schedule(m.np),
                 colored_sweep_inputs)):
            lin, ang = reference_frame_rows(body, m, self.params, pts, mask,
                                            cfg, sched)
            mom0, rows = fn(body, body_params(m), lin, ang, self.params)
            out[name] = (mom0, m.massinv, rows, it, ip)
        return out

    def hold_ref(self, name, k, p):
        """The new kernels equal their plain versions bit for bit."""
        torch = self.torch
        if name == "correspondence":
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(k, p))
            check(all(torch.equal(a, b) for a, b in zip(k, p)),
                  f"correspondence differs from its plain version: {err}")
            hit = ((p[4] == 0) & (p[2] <= p[3])).float().mean().item()
            return err, f"correspondence {err:.3g} (ray hits {hit:.3f})"
        err = (k - p).abs().max().item()
        check(err == 0.0, f"{name} differs from its plain version: {err}")
        return err, f"{name} momenta {err:.3g}"

    def work_ref(self, name, args):
        """(bytes, float32 operations) of one call on these inputs."""
        torch = self.torch
        if name == "correspondence":
            pts_h, planes, d0 = args
            T, B, P = d0.shape
            N = pts_h.shape[2]
            # slab divisions: where an origin-side plane is crossed
            ndiv = 0
            for i in range(0, T, 16):
                pl, dd, ph = planes[i:i + 16], d0[i:i + 16], pts_h[i:i + 16]
                d1 = torch.einsum("tbpk,tkn->tbpn", pl[..., :4],
                                  ph[:, :4])
                a = dd[..., None]
                ndiv += int((((a >= 0) & (d1 < 0)) | ((a <= 0) & (d1 > 0)))
                            .sum())
            nbytes = T * N * 3 * 4 + T * B * P * 5 * 4 + 5 * T * B * N * 4
            return nbytes, T * B * P * N * 12 + ndiv * 2
        mom0, mi, rows, it, ip = args
        T = mom0.shape[0]
        al = int(((rows.lm >> 16) & 1).sum())
        aa = int(((rows.am >> 16) & 1).sum())
        nbytes = (al * 21 + aa * 14 + rows.lm.numel() + rows.am.numel()
                  + mom0.numel() * 3) * 4
        return nbytes, (al * 43 + aa * 20) * (it + ip)

    def compare_ref(self):
        """Phase 9: kernel 8 and the row sweep (a sequential and a colored
        solve) against their plain versions at T=4 and T=512, bit for bit;
        at T=512 timed (kernel: CUDA events over repeated launches; plain:
        once) beside their bounds and the batched matmul of the dots alone;
        and the reference-layout contact rows at T=512 on poses with
        active contacts."""
        torch = self.torch
        from hand_tracking_samples_tpu_torch.ops.correspondence import (
            correspondence_reductions, correspondence_reductions_plain)
        from hand_tracking_samples_tpu_torch.physics.row_sweep import (
            row_sweep, row_sweep_plain)
        fns = {"correspondence": (correspondence_reductions,
                                  correspondence_reductions_plain),
               "row_sweep": (row_sweep, row_sweep_plain),
               "row_sweep[colored]": (row_sweep, row_sweep_plain)}
        lines = []
        for T in (4, TRACKS):
            st = self.init_state(T)
            if T == TRACKS:                  # one frame in: momenta non-zero
                st, _ = self.run(st, 1, T, cfg=self.ref_cfg("sequential"))
            inp = self.ref_inputs(st, self.depth_frame(1, T))
            for name, (kfn, pfn) in fns.items():
                args = inp[name]
                if T == 4:
                    err, note = self.hold_ref(name, kfn(*args), pfn(*args))
                    self.results[name]["max_abs_err_t4"] = err
                    lines.append(f"T=4 {note}")
                    continue
                ms, k = self.event_ms(kfn, args, warm=2, reps=5)
                plain_ms, p = self.event_ms(pfn, args, warm=0, reps=1)
                err, note = self.hold_ref(name, k, p)
                nbytes, ops = self.work_ref(name, args)
                tb, to = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_S * 1e3
                self.results[name].update(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=max(tb, to),
                    bound_by="bytes" if tb >= to else "operations",
                    library_ms=None, bytes=nbytes, operations=ops)
                if name == "correspondence":
                    pts_h, planes, _ = args
                    dots_ms, _ = self.event_ms(
                        lambda a, b: torch.matmul(
                            a.reshape(T, -1, 8), b), (planes, pts_h),
                        warm=2, reps=5)
                    self.results[name]["dots_only_matmul_ms"] = dots_ms
                    note += f"; dots-only matmul {dots_ms:.4f} ms"
                lines.append(f"T={T} {name} {ms:.4f} ms (plain "
                             f"{plain_ms:.1f} ms, bound {max(tb, to):.4f} "
                             f"ms; {note})")
        lines.append(self.contacts_active_t512())
        return "; ".join(lines)

    def contacts_active_t512(self):
        """The reference-layout contact rows (contacts.contact_rows_from_
        fields) at T=512 on the golden's contact pose and a spread of
        animbank poses, tiled, with small random momenta: the kernel's
        fields and rows against the plain version's."""
        torch, np = self.torch, self.np
        from hand_tracking_samples_tpu_torch.physics.contact_kernel import (
            contact_fields_plain, contact_fields_raw, contact_inputs,
            fields_of)
        from hand_tracking_samples_tpu_torch.physics.contacts import (
            contact_rows_from_fields)
        with open(os.path.join(REPO, "tests", "fixtures", "golden.json")) as f:
            cf = int(json.load(f)["contact_frame"][0])
        frames = [cf] + list(range(0, len(self.bank),
                                   len(self.bank) // 63))[:63]
        frames = (frames * (TRACKS // len(frames) + 1))[:TRACKS]
        rng = np.random.RandomState(5)
        f32 = lambda a: torch.tensor(a.astype(np.float32), device=self.dev)
        cin = contact_inputs(f32(self.bank[frames]),
                             f32(rng.randn(TRACKS, 17, 3) * 1e-3),
                             f32(rng.randn(TRACKS, 17, 3) * 1e-4),
                             self.model)
        pairs = torch.as_tensor(self.model.np["collide_pairs"],
                                device=self.dev)
        args = cin + (pairs, 4, 3, self.params.driftmax)
        k, p = contact_fields_raw(*args), contact_fields_plain(*args)
        err, note = self.hold("contact_fields", k, p)
        rk = contact_rows_from_fields(fields_of(k), self.model, self.params)
        rp = contact_rows_from_fields(fields_of(p), self.model, self.params)
        check(torch.equal(rk.active, rp.active),
              "contact rows: active masks differ")
        act = rp.active
        nact = int(act.sum())
        check(nact > 0, "contact rows: no active row at T=512")
        rerr = max((getattr(rk, f) - getattr(rp, f))[act].abs().max().item()
                   for f in ("normal", "r0", "r1", "targetdist",
                             "targetspeednobias"))
        check(rerr <= 2e-5, f"contact rows differ: {rerr}")
        self.results["contact_fields"]["t512_active_rows"] = nact
        self.results["contact_fields"]["t512_active_rows_err"] = rerr
        return (f"T={TRACKS} contact poses: {note}; reference rows "
                f"{nact} active compared, max err {rerr:.3g}")

    def ref_slice(self):
        """Phase 10: the sequential frame (use_pallas=True) at T=512 x 30
        frames on phase 4's renders; the colored frame against it with no
        body thinned; two tracks through the plain versions on the CPU;
        use_pallas=False on the card against the CPU."""
        torch = self.torch
        from hand_tracking_samples_tpu_torch import kernels
        T, F = TRACKS, FRAMES
        cfg = self.ref_cfg("sequential")
        even = torch.arange(0, T, 2, device=self.dev)
        odd = torch.arange(1, T, 2, device=self.dev)
        ref, bank = self.ref, torch.tensor(self.bank, device=self.dev)
        box = []

        def keep(st):
            pose = st.body.pose
            dev = (pose[even, :, :3] - ref[len(box)][:, :3]).norm(
                dim=-1).mean(-1)
            je = (pose[odd, :, :3] - bank[30 + len(box)][:, :3]).norm(
                dim=-1).mean(-1)
            box.append(0)
            return dev.max(), je.max(), je.min(), pose[:2].clone()
        kernels.reset_counts()
        st, hist = self.run(self.init_state(T), F, T, keep=keep, cfg=cfg)
        counts = kernels.counts()
        torch.cuda.synchronize()
        for name in ("correspondence", "row_sweep"):
            self.results[name]["launches"] = counts[name]
        need = ("cloud_from_depth", "correspondence", "contact_fields",
                "row_sweep")
        check(all(counts[n] >= F for n in need),
              f"a kernel did not launch every frame: {counts}")
        check(bool(torch.isfinite(st.body.pose).all()), "non-finite poses")
        dmax = torch.stack([h[0] for h in hist]).cpu().numpy()
        je = torch.stack([h[1] for h in hist]).cpu().numpy() * 1e3
        spread = (torch.stack([h[1] for h in hist])
                  - torch.stack([h[2] for h in hist])).max().item() * 1e3
        check((dmax < 1.5e-3).all() and dmax.mean() <= 1.0e-3,
              f"sequential dyn30 tracks: per frame max "
              f"{dmax.max() * 1e3:.3f} mm, mean {dmax.mean() * 1e3:.3f} mm")
        gap, jc = self.seq_odd_gap(je, "odd tracks")
        fmt = lambda v: " ".join(f"{x:.2f}" for x in v)
        # colored against sequential with as many cloud rows a body as
        # there are points, so that the colored pack thins no body
        cmp = []
        for solver in ("sequential", "colored"):
            c = self.ref_cfg(solver, cloud_rows_per_body=cfg.point_budget)
            cmp.append(self.run(self.init_state(T), 3, T, cfg=c)[0])
        cerr = (cmp[0].body.pose[..., :3]
                - cmp[1].body.pose[..., :3]).abs().max().item()
        qerr = quat_err(cmp[0].body.pose[..., 3:], cmp[1].body.pose[..., 3:])
        check(cerr < COLORED_M and qerr < COLORED_QUAT,
              f"colored differs from sequential: {cerr} m, quat {qerr}")
        perr = self.cpu_reference([h[3] for h in hist][:REF_CPU_FRAMES],
                                  cfg)
        # use_pallas=False (the plain correspondence over the (T, B, N, P)
        # plane dots) on the card: two tracks held against the CPU, and the
        # peak memory of one frame at NOPALLAS_MEM_TRACKS tracks
        nop = self.ref_cfg("sequential", use_pallas=False)
        kernels.reset_counts()
        _, nh = self.run(self.init_state(2), REF_CPU_FRAMES, 2, cfg=nop,
                         keep=lambda s: s.body.pose.clone())
        check(kernels.counts()["correspondence"] == 0,
              "use_pallas=False launched the correspondence kernel")
        nerr = self.cpu_reference(nh, nop)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m0 = torch.cuda.memory_allocated()
        self.run(self.init_state(NOPALLAS_MEM_TRACKS), 1,
                 NOPALLAS_MEM_TRACKS, cfg=nop)
        torch.cuda.synchronize()
        npeak = (torch.cuda.max_memory_allocated() - m0) / 2**30
        self.ref_stats = dict(
            dyn30_dev_mm_max_per_frame=(dmax * 1e3).tolist(),
            dyn30_dev_mm_mean=float(dmax.mean() * 1e3),
            odd_joint_err_mm_per_frame=je.tolist(),
            jax_joint_err_mm_per_frame=jc.tolist(),
            odd_gap_mm_max=float(gap.max()), odd_spread_mm=spread,
            colored_vs_sequential_m=cerr, colored_vs_sequential_quat=qerr,
            cpu_reference_err_m=perr, nopallas_cpu_reference_err_m=nerr,
            nopallas_peak_gib=npeak, nopallas_peak_tracks=NOPALLAS_MEM_TRACKS,
            launches=counts)
        self.ref_final = st
        return (f"T={T} F={F}: dyn30 dev max {dmax.max() * 1e3:.3f} mm mean "
                f"{dmax.mean() * 1e3:.3f} mm; odd tracks [{fmt(je)}] mm, "
                f"JAX gap max {gap.max():.3f} mm (spread {spread:.3g}); "
                f"colored vs sequential ({cfg.point_budget} rows a body, 3 "
                f"frames) {cerr:.3g} m, quat {qerr:.3g}; CPU plain reference "
                f"({REF_CPU_FRAMES} frames) {perr:.2g} m; use_pallas=False "
                f"vs CPU {nerr:.2g} m, its peak at T={NOPALLAS_MEM_TRACKS} "
                f"{npeak:.3f} GiB; launches {counts}")

    def ref_timing(self):
        """Phase 11: frame time and device split of both solvers at T=512,
        with the launch counts of the timed frames."""
        torch = self.torch
        from hand_tracking_samples_tpu_torch import kernels
        T, F = TRACKS, REF_TIMED_FRAMES
        self.ref_speed = {}
        parts = []
        for solver in ("sequential", "colored"):
            cfg = self.ref_cfg(solver)
            run = lambda st, fr, t: self.run(st, fr, t, cfg=cfg)
            st, _ = run(self.init_state(T), 1, T)                 # warm
            torch.cuda.synchronize()
            kernels.reset_counts()
            t0 = time.perf_counter()
            run(self.init_state(T), F, T)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = {k: v for k, v in kernels.counts().items() if v}
            check(counts.get("correspondence", 0) >= F
                  and counts.get("row_sweep", 0) >= F,
                  f"{solver}: the new kernels did not run every frame: "
                  f"{counts}")
            prof = self.profile(T, 2, run=run)
            self.ref_speed[solver] = dict(
                tracks=T, frames=F, seconds=dt, ms_per_frame=dt / F * 1e3,
                tracked_fps=T * F / dt, launches=counts, **prof)
            busy = (f"device busy {prof['device_ms_per_frame']:.2f} ms "
                    f"(port kernels {prof['port_kernels_ms_per_frame']:.2f}"
                    f", {prof['torch_launches_per_frame']:.0f} PyTorch "
                    f"launches {prof['torch_ops_ms_per_frame']:.2f})"
                    if "device_ms_per_frame" in prof
                    else f"profile not measured ({prof['profile_error']})")
            parts.append(f"{solver} {dt / F * 1e3:.1f} ms a frame, "
                         f"{T * F / dt:.1f} tracked frames/s, {busy}, "
                         f"launches {counts}")
        return f"T={T}: " + "; ".join(parts)
    # ---- the voxel and mirror clouds: phases 12-14 -------------------------
    def cloud_cfg(self, cloud, solver="kernel", plane=FAR_PLANE, cnn=False,
                  use_pallas=True):
        """The frame's config with the cloud "voxel", "mirror" or both
        ("voxel_mirror"): the parity defaults otherwise."""
        from hand_tracking_samples_tpu_torch.tracker.config import (
            TrackerConfig)
        kw = {}
        if "voxel" in cloud:
            kw.update(subsample_voxel=1, subsample_size=VOXEL_SIZE)
        if "mirror" in cloud:
            kw.update(mirror_plane=plane)
        return TrackerConfig(cnn_every_frame=cnn, cnn_every_k=1,
                             solver=solver, use_pallas=use_pallas,
                             point_budget=2048, cloud_rows_per_body=128, **kw)

    def pack_inputs(self, st, depth):
        """Kernel 2.5's inputs for state st and depth (T, H, W): the
        dynamics pass's (the frame's cloud split by the cutting plane,
        N=2048) and the first MultiStepSim cloud step's (the CNN frame's
        cloud, its stride-4 subsample compacted to N=512, the
        segmentation's camera as the ray origin)."""
        torch = self.torch
        from hand_tracking_samples_tpu_torch.model.hand import (
            PHYSICS_WEAK_FORCE)
        from hand_tracking_samples_tpu_torch.ops.cloud_rows import (
            _kernel_inputs_ph)
        from hand_tracking_samples_tpu_torch.tracker import runtime as rt
        m, pose = self.model, st.body.pose
        B, C = m.n_bodies, 128
        cfg = self.cloud_cfg("mirror", plane=CUT_PLANE, cnn=True)
        ph = rt.frame_cloud(depth, self.cam, cfg)
        scale_b = torch.where(torch.arange(B, device=self.dev) <= 2,
                              PHYSICS_WEAK_FORCE, 1.0).float()
        dyn = (ph,) + _kernel_inputs_ph(pose, m, (0.0, 0.0, 0.0), scale_b,
                                        0.0) + (C,)
        seg, _, _, _, cph = rt._cnn_frame_inputs(self.cnn, depth, self.cam,
                                                 cfg, ph)
        mph, origin, scale = rt.multistep_cloud(cph, seg.cam.pose, cfg, B)
        ms = (mph,) + _kernel_inputs_ph(pose, m, origin, scale, 0.0) + (C,)
        return {2048: dyn, 512: ms}

    def hold_pack(self, k, p):
        """Kernel 2.5 equals its plain version: counts and every channel."""
        torch = self.torch
        (kp, kc), (pp, pc) = k, p
        check(torch.equal(kc, pc), "cloud_rows_packed: counts differ")
        err = (kp - pp).abs().max().item()
        check(err == 0.0, f"cloud_rows_packed differs from its plain "
              f"version: {err}")
        slots = int((pp[:, 15] > 0.5).sum())
        thinned = int((pc > pp.shape[2] // 24).sum())
        return err, (f"packed {err:.3g} ({slots} slots, {thinned} bodies "
                     f"thinned)")

    def compare_pack(self):
        """Phase 12: kernel 2.5 against its plain version at T=4 and at
        T=512 (one cutting-plane frame in), N=2048 and N=512."""
        from hand_tracking_samples_tpu_torch.ops.cloud_rows import (
            cloud_rows_packed, cloud_rows_packed_plain)
        lines = []
        self.pack_err = {}
        for T in (4, TRACKS):
            st = self.init_state(T)
            if T == TRACKS:
                st, _ = self.run(st, 1, T,
                                 cfg=self.cloud_cfg("mirror", plane=CUT_PLANE))
            inp = self.pack_inputs(st, self.depth_frame(1, T))
            for n, args in inp.items():
                err, note = self.hold_pack(cloud_rows_packed(*args),
                                           cloud_rows_packed_plain(*args))
                self.pack_err[f"T{T}_N{n}"] = err
                lines.append(f"T={T} N={n} {note}")
        self.results["cloud_rows_packed"]["max_abs_err_t4"] = max(
            self.pack_err["T4_N2048"], self.pack_err["T4_N512"])
        return "; ".join(lines)

    def seq_odd_gap(self, je, label):
        """Hold the sequential frame's odd tracks (per-frame mean joint
        error je in mm, from frame 0) to the JAX package's curve on the
        same renders (SEQ_ODD_BAND_MM); returns the per-frame gap and the
        JAX curve."""
        np = self.np
        curve = glob.glob(os.path.join(REPO, "tests", "fixtures", "cache",
                                       "seqcurve_*.json"))
        check(len(curve) == 1, "the JAX sequential curve is missing")
        with open(curve[0]) as f:
            jc = np.asarray(json.load(f)["joint_err_mm"])[:len(je)]
        gap = np.abs(je - jc)
        fmt = lambda v: " ".join(f"{x:.2f}" for x in v)
        band = SEQ_ODD_BAND_MM
        check(gap[:8].max() <= band["before"] and gap.max() <= band["any"]
              and gap[-5:].max() <= band["last5"],
              f"{label} off the JAX curve beyond {band}: port "
              f"[{fmt(je)}] mm, JAX [{fmt(jc)}] mm")
        return gap, jc

    def voxel_curve(self):
        curve = glob.glob(os.path.join(REPO, "tests", "fixtures", "cache",
                                       "voxcurve_*.json"))
        check(len(curve) == 1, "the JAX voxel curve is missing")
        with open(curve[0]) as f:
            return {k: self.np.asarray(v) for k, v in json.load(f).items()}

    def track_errors(self, cfg, frames, T):
        """Run `frames` frames of phase 4's renders under cfg; returns the
        per-frame (dyn30 dev from the golden, max over even tracks), (even
        tracks' joint error against the animbank, mean), (odd tracks',
        mean); the poses of tracks 0-1 per frame; and the launch counts."""
        torch = self.torch
        from hand_tracking_samples_tpu_torch import kernels
        even = torch.arange(0, T, 2, device=self.dev)
        odd = torch.arange(1, T, 2, device=self.dev)
        ref, bank = self.ref, torch.tensor(self.bank, device=self.dev)
        box = []

        def keep(st):
            pose, f = st.body.pose, len(box)
            box.append(0)
            dev = (pose[even, :, :3] - ref[f][:, :3]).norm(dim=-1).mean(-1)
            je0 = (pose[even, :, :3] - bank[f][:, :3]).norm(dim=-1).mean(-1)
            je1 = (pose[odd, :, :3] - bank[30 + f][:, :3]).norm(
                dim=-1).mean(-1)
            return dev.max(), je0.mean(), je1.mean(), pose[:2].clone()
        kernels.reset_counts()
        st, hist = self.run(self.init_state(T), frames, T, keep=keep,
                            cfg=cfg)
        counts = kernels.counts()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(st.body.pose).all()), "non-finite poses")
        cols = [torch.stack([h[i] for h in hist]).cpu().numpy()
                for i in range(3)]
        return cols, [h[3] for h in hist], counts

    def cloud_slice(self):
        """Phase 13 (see the module docstring)."""
        torch, np = self.torch, self.np
        from hand_tracking_samples_tpu_torch import kernels
        from hand_tracking_samples_tpu_torch.imaging.image_ops import (
            point_cloud, voxel_buckets)
        from hand_tracking_samples_tpu_torch.tracker.runtime import (
            frame_cloud)
        T, F = TRACKS, FRAMES
        fmt = lambda v: " ".join(f"{x:.2f}" for x in v)
        out, lines = {}, []
        jc = self.voxel_curve()

        def gate_launches(counts, n_pack, kernel2=0):
            check(counts["cloud_rows_packed"] == n_pack
                  and counts["cloud_rows_solve"] == kernel2,
                  f"kernel 2.5 launched {counts['cloud_rows_packed']} times "
                  f"(want {n_pack}), kernel 2 {counts['cloud_rows_solve']}")

        def voxel_gap(je0, je1, curve, label):
            n = len(je0)
            gap = np.maximum(np.abs(je0 * 1e3 - curve[:n, 0]),
                             np.abs(je1 * 1e3 - curve[:n, 1]))
            band = VOXEL_BAND_MM
            check(gap[:8].max() <= band["before"] and gap.max() <= band["any"],
                  f"{label}: voxel tracks off the JAX curve beyond {band}: "
                  f"gap [{fmt(gap)}] mm, port even [{fmt(je0 * 1e3)}] odd "
                  f"[{fmt(je1 * 1e3)}] mm, JAX even [{fmt(curve[:n, 0])}] "
                  f"odd [{fmt(curve[:n, 1])}] mm")
            return gap

        # the far plane on the kernel solver: phase 4's gates
        cfg = self.cloud_cfg("mirror")
        (dmax, _, je1), p2, counts = self.track_errors(cfg, F, T)
        gate_launches(counts, F)
        check(counts["cloud_from_depth"] == F, f"cloud kernel: {counts}")
        self.results["cloud_rows_packed"]["launches"] = counts[
            "cloud_rows_packed"]
        je1 = je1 * 1e3
        band = ODD_BAND_MM
        check((dmax < 1.2e-3).all() and dmax.mean() <= 1.0e-3,
              f"far mirror: dyn30 dev per frame max {dmax.max() * 1e3:.3f} "
              f"mm, mean {dmax.mean() * 1e3:.3f} mm")
        check(je1[:8].max() < band["before"] and je1.max() < band["peak"]
              and je1[-5:].max() < band["last5"]
              and je1.mean() <= band["mean"],
              f"far mirror: odd tracks outside {band}: [{fmt(je1)}] mm")
        cerr = self.cpu_reference(p2[:CLOUD_CPU_FRAMES], cfg)
        out["far_mirror"] = dict(
            dyn30_dev_mm_max=float(dmax.max() * 1e3),
            dyn30_dev_mm_mean=float(dmax.mean() * 1e3),
            odd_joint_err_mm_per_frame=je1.tolist(), cpu_reference_err_m=cerr,
            launches=counts)
        lines.append(f"far mirror: dyn30 dev max {dmax.max() * 1e3:.3f} mm "
                     f"mean {dmax.mean() * 1e3:.3f} mm, odd [{fmt(je1)}] mm, "
                     f"CPU {cerr:.2g} m, launches {counts}")

        # the voxel cloud on the kernel solver: the JAX curve
        cfg = self.cloud_cfg("voxel")
        (dmax, je0, je1), p2, counts = self.track_errors(cfg, F, T)
        gate_launches(counts, F)
        check(counts["cloud_from_depth"] == 0, f"voxel frame: {counts}")
        gap = voxel_gap(je0, je1, jc["kernel"], "kernel solver")
        cerr = self.cpu_reference(p2[:CLOUD_CPU_FRAMES], cfg)
        # the voxel cloud: the same bits on two runs; counts and mask equal
        # to the CPU's, centroids within VOXEL_CPU_M of them
        d = self.depth_frame(0, T)
        a, b = frame_cloud(d, self.cam, cfg), frame_cloud(d, self.cam, cfg)
        check(torch.equal(a, b), "the voxel cloud differs between two runs")
        pts, mask = point_cloud(d[:2], self.cam, 0.1, cfg.drangey)
        sk, ck = voxel_buckets(pts, mask, VOXEL_SIZE)
        sp, cp = voxel_buckets(pts.cpu(), mask.cpu(), VOXEL_SIZE)
        check(torch.equal(ck.cpu(), cp), "voxel counts differ from the CPU")
        verr = (sk.cpu() - sp).abs().max().item()
        check(verr <= 1e-6, f"voxel sums differ from the CPU: {verr}")
        nvox = (a[:, 4] > 0.5).sum(1)
        out["voxel"] = dict(
            dyn30_dev_mm_max=float(dmax.max() * 1e3),
            even_joint_err_mm_per_frame=(je0 * 1e3).tolist(),
            odd_joint_err_mm_per_frame=(je1 * 1e3).tolist(),
            jax_gap_mm_per_frame=gap.tolist(), cpu_reference_err_m=cerr,
            voxel_sums_cpu_err=verr, voxels_min=int(nvox.min()),
            voxels_max=int(nvox.max()), launches=counts)
        lines.append(f"voxel: even [{fmt(je0 * 1e3)}] odd [{fmt(je1 * 1e3)}]"
                     f" mm, JAX gap max {gap.max():.3f} mm, CPU {cerr:.2g} m,"
                     f" cloud equal on two runs, {int(nvox.min())}-"
                     f"{int(nvox.max())} voxels, sums vs CPU {verr:.2g}, "
                     f"launches {counts}")

        # the CNN frame with the far plane: phase 7's band
        cfg = self.cloud_cfg("mirror", cnn=True)
        grp = self.reset_group(CNN_TRACKS)
        bank = torch.tensor(self.bank, device=self.dev)
        box = []

        def keep(st):
            je = (st.body.pose[..., :3] - bank[30 + len(box)][:, :3]).norm(
                dim=-1).mean(-1)
            box.append(0)
            return je[~grp].max(), je[grp].max(), st.body.pose[[0, 3]].clone()
        kernels.reset_counts()
        st, hist = self.cnn_run(self.cnn_state(CNN_TRACKS), CNN_FRAMES,
                                CNN_TRACKS, keep=keep, cfg=cfg)
        counts = kernels.counts()
        gate_launches(counts, 5 * CNN_FRAMES)
        check(bool(torch.isfinite(st.body.pose).all()), "non-finite poses")
        gt_max, rs_max = (torch.stack([x[i] for x in hist]).cpu().numpy()
                          * 1e3 for i in range(2))
        band = CNN_BAND_MM
        check(gt_max.max() < band["gt"] and rs_max[0] < band["reset_first"]
              and rs_max[-1] < band["reset_last"],
              f"far-mirror CNN frame outside {band}: on-hand "
              f"[{fmt(gt_max)}] mm, reset [{fmt(rs_max)}] mm")
        cerr = self.cnn_cpu_reference([x[2] for x in hist][:1], cfg)
        out["cnn_far_mirror"] = dict(
            gt_joint_err_mm_max_per_frame=gt_max.tolist(),
            reset_joint_err_mm_max_per_frame=rs_max.tolist(),
            cpu_reference_err_m=cerr, launches=counts)
        lines.append(f"far-mirror CNN frame: on-hand [{fmt(gt_max)}] mm, "
                     f"reset [{fmt(rs_max)}] mm, CPU {cerr:.2g} m, launches "
                     f"{counts}")

        # the sequential frame with each cloud
        Fs = CLOUD_SEQ_FRAMES
        cfg = self.cloud_cfg("voxel", "sequential")
        (_, je0, je1), p2, counts = self.track_errors(cfg, Fs, T)
        gate_launches(counts, 0)
        check(counts["correspondence"] == Fs and counts["row_sweep"] == Fs,
              f"sequential voxel frame: {counts}")
        gap = voxel_gap(je0, je1, jc["sequential"], "sequential solver")
        cerr = self.cpu_reference(p2[:CLOUD_CPU_FRAMES], cfg)
        out["seq_voxel"] = dict(
            even_joint_err_mm_per_frame=(je0 * 1e3).tolist(),
            odd_joint_err_mm_per_frame=(je1 * 1e3).tolist(),
            jax_gap_mm_per_frame=gap.tolist(), cpu_reference_err_m=cerr,
            launches=counts)
        lines.append(f"sequential voxel: JAX gap max {gap.max():.3f} mm, "
                     f"CPU {cerr:.2g} m")
        cfg = self.cloud_cfg("mirror", "sequential")
        (dmax, _, je1), p2, counts = self.track_errors(cfg, Fs, T)
        gate_launches(counts, 0)
        check(counts["correspondence"] == Fs and counts["row_sweep"] == Fs,
              f"sequential mirror frame: {counts}")
        check((dmax < 1.5e-3).all() and dmax.mean() <= 1.0e-3,
              f"sequential far mirror: dyn30 dev per frame max "
              f"{dmax.max() * 1e3:.3f} mm, mean {dmax.mean() * 1e3:.3f} mm")
        gap, _ = self.seq_odd_gap(je1 * 1e3,
                                  "sequential far mirror odd tracks")
        cerr = self.cpu_reference(p2[:CLOUD_CPU_FRAMES], cfg)
        out["seq_far_mirror"] = dict(
            dyn30_dev_mm_max_per_frame=(dmax * 1e3).tolist(),
            odd_joint_err_mm_per_frame=(je1 * 1e3).tolist(),
            jax_gap_mm_per_frame=gap.tolist(), cpu_reference_err_m=cerr,
            launches=counts)
        lines.append(f"sequential far mirror: dyn30 dev max "
                     f"{dmax.max() * 1e3:.3f} mm, JAX gap max "
                     f"{gap.max():.3f} mm, CPU {cerr:.2g} m")

        # the cutting plane on 2 tracks against the CPU
        cut = {}
        for label, cfg in (("dynamics", self.cloud_cfg("mirror",
                                                       plane=CUT_PLANE)),
                           ("sequential", self.cloud_cfg(
                               "voxel_mirror", "sequential",
                               plane=CUT_PLANE)),
                           ("colored", self.cloud_cfg(
                               "voxel_mirror", "colored", plane=CUT_PLANE)),
                           ("sequential_nopallas", self.cloud_cfg(
                               "mirror", "sequential", plane=CUT_PLANE,
                               use_pallas=False))):
            _, h = self.run(self.init_state(2), CLOUD_CPU_FRAMES, 2,
                            cfg=cfg, keep=lambda s: s.body.pose.clone())
            cut[label] = self.cpu_reference(h, cfg)
        cfg = self.cloud_cfg("mirror", plane=CUT_PLANE, cnn=True)
        idx = torch.tensor([0, 3], device=self.dev)
        full = self.cnn_state(4)
        st2 = type(full)(type(full.body)(*[x[idx] for x in full.body]),
                         full.prev_frame_error[idx], full.initializing[idx])
        _, h = self.cnn_run(st2, 1, 4, idx=idx, cfg=cfg,     # the reset
                            keep=lambda s: s.body.pose.clone())
        cut["cnn"] = self.cnn_cpu_reference(h, cfg)
        out["cutting_plane_cpu_err_m"] = cut
        lines.append("cutting plane vs CPU " + ", ".join(
            f"{k} {v:.2g} m" for k, v in cut.items()))
        self.cloud_stats = out
        return "; ".join(lines)

    def cloud_timing(self):
        """Phase 14: the new frames' time at T=512 with their device split
        and launch counts, and kernel 2.5 at both N (CUDA events) beside
        its plain version and its bound."""
        torch = self.torch
        from hand_tracking_samples_tpu_torch import kernels
        from hand_tracking_samples_tpu_torch.ops.cloud_rows import (
            cloud_rows_packed, cloud_rows_packed_plain)
        T = TRACKS
        self.cloud_speed = {}
        parts = []
        frames = (("dynamics far mirror", self.cloud_cfg("mirror"), "dyn"),
                  ("dynamics voxel", self.cloud_cfg("voxel"), "dyn"),
                  ("CNN far mirror", self.cloud_cfg("mirror", cnn=True),
                   "cnn"),
                  ("sequential voxel", self.cloud_cfg("voxel", "sequential"),
                   "seq"),
                  ("sequential far mirror",
                   self.cloud_cfg("mirror", "sequential"), "seq"))
        for label, cfg, kind in frames:
            F = CLOUD_TIMED_FRAMES[kind]
            if kind == "cnn":
                run = lambda st, fr, t, cfg=cfg: self.cnn_run(st, fr, t,
                                                              cfg=cfg)
                start = lambda: self.cnn_state(T)
            else:
                run = lambda st, fr, t, cfg=cfg: self.run(st, fr, t, cfg=cfg)
                start = lambda: self.init_state(T)
            run(start(), 1, T)                                    # warm
            torch.cuda.synchronize()
            kernels.reset_counts()
            t0 = time.perf_counter()
            run(start(), F, T)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = {k: v for k, v in kernels.counts().items() if v}
            prof = self.profile(T, 2, run=run, state=start())
            self.cloud_speed[label] = dict(
                tracks=T, frames=F, seconds=dt, ms_per_frame=dt / F * 1e3,
                tracked_fps=T * F / dt, launches=counts, **prof)
            busy = (f"device busy {prof['device_ms_per_frame']:.2f} ms "
                    f"(port kernels {prof['port_kernels_ms_per_frame']:.2f}"
                    f", {prof['torch_launches_per_frame']:.0f} PyTorch "
                    f"launches {prof['torch_ops_ms_per_frame']:.2f})"
                    if "device_ms_per_frame" in prof
                    else f"profile not measured ({prof['profile_error']})")
            parts.append(f"{label} {dt / F * 1e3:.1f} ms a frame, "
                         f"{T * F / dt:.1f} tracked frames/s, {busy}")
        st, _ = self.run(self.init_state(T), 1, T,
                         cfg=self.cloud_cfg("mirror", plane=CUT_PLANE))
        inp = self.pack_inputs(st, self.depth_frame(1, T))
        r = self.results["cloud_rows_packed"]
        for n, args in inp.items():
            ms, k = self.event_ms(cloud_rows_packed, args, warm=2, reps=10)
            plain_ms, p = self.event_ms(cloud_rows_packed_plain, args,
                                        warm=0, reps=1)
            err, note = self.hold_pack(k, p)
            nbytes, ops = self.work("cloud_rows_packed", args)
            tb, to = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_S * 1e3
            res = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=max(tb, to),
                       bound_by="bytes" if tb >= to else "operations",
                       library_ms=None, bytes=nbytes, operations=ops)
            if n == 2048:                   # the dynamics pass's: the row
                r.update(res)
            r[f"n{n}"] = res
            parts.append(f"cloud_rows_packed N={n} {ms:.4f} ms (plain "
                         f"{plain_ms:.2f} ms, bound {max(tb, to):.4f} ms "
                         f"by {res['bound_by']}; {note})")
        return f"T={T}: " + "; ".join(parts)


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
    phase(9, "reference-solver kernels vs plain (T=4, T=512)",
          s.compare_ref)
    phase(10, "sequential and colored frames", s.ref_slice)
    phase(11, "reference-solver timing", s.ref_timing)
    phase(12, "kernel 2.5 vs plain (T=4, T=512)", s.compare_pack)
    phase(13, "voxel and mirror frames", s.cloud_slice)
    phase(14, "voxel and mirror timing", s.cloud_timing)
    s.results["row_sweep[colored]"]["launches"] = \
        s.ref_speed["colored"]["launches"]["row_sweep"]
    record["total_s"] = time.perf_counter() - t_all
    rows = []
    src_of = dict(KERNELS, **{k: KERNELS["pgs_solve"] for k in PLANS},
                  **REF_ROWS)
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
                           cnn_frame=s.cnn_stats, cnn_speed=s.cnn_speed,
                           reference=s.ref_stats,
                           reference_speed=s.ref_speed,
                           clouds=s.cloud_stats, cloud_speed=s.cloud_speed,
                           pack_err=s.pack_err),
                      f, indent=1, default=str)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
