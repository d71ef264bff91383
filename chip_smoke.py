#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (hand_tracking_samples_tpu_torch) on
one NVIDIA GPU.  Run from the repository root:

    python3 chip_smoke.py

Phases, each printing one line with its elapsed seconds:
  1. build (or reuse) the CUDA kernel library: one nvcc call into build/;
     ptxas's registers, stack, spills and static shared memory of the
     redesigned kernels (the row sweep, PGS, cloud-rows pack, contact,
     correspondence, cloud, vals and unpacked-rows kernels; the PGS kernel
     and the row sweep as two instances each, exact and jacobi); the last
     five (NO_SPILL) must use no stack and spill nothing; the staged cloud
     kernel's five instances (cloud_stage_kernel<0-4>) with the launch
     each takes at 320x240 (cluster size C, staged, its CTA's shared
     memory, cudaOccupancyMaxActiveClusters)
  2. the card's name and power limit, as nvidia-smi reports them
  3. each of the four kernels against its plain PyTorch version at T=4
     tracks, one frame, full width (the cloud kernel, kernel 2 and the
     contact kernel bit-identical); the cloud kernel bit for bit again on
     seeded rasters (ops.cloud_kernel.synthetic_depths: no valid pixel,
     every pixel valid, exactly the budget kept, hand-like blobs keeping
     fewer and more than it; frac 4 and 3); the contact kernel bit for bit again
     at bank poses with contacts and on seeded synthetic tracks
     (physics.contact_kernel.synthetic_contact_inputs: every collide pair
     near, and hulls with duplicated planes and vertices, so every
     reduction meets exact ties)
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
     tolerances, so every kernel is also checked at the main path's shapes;
     the cloud kernel on phase 3's seeded rasters at T=512;
     the contact kernel's near pairs and its design's issue floor; one more
     PGS launch reads its clock64 counters (cycles a step) and the tracks
     an SM holds
  6. the CNN frame's kernels against their plain versions at T=4: the
     unpacked-rows and vals variants of the cloud-rows kernel, bit for
     bit, also on seeded clouds (ops.cloud_rows.synthetic_cloud: the vals
     kernel at N=2048 and N=300, the unpacked rows at N=512 and N=67), and the PGS
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
     and plans timed at its T=512 shapes beside their bounds, each held to
     its plain version again under phase 6's tolerances (the PGS plans'
     cycles as in phase 5); the vals and unpacked-rows kernels' full-scan
     issue floor, the share of hull-plane evaluations their warp exits
     skipped (their evals counters), and both on seeded clouds at T=512
  9. the reference solvers' kernels against their plain versions, bit for
     bit, at T=4 and at T=512 (the T=512 ones timed): the correspondence
     kernel (also at T=4 on seeded inputs whose clip quotients tie and lie
     within an ulp, ops.correspondence.synthetic_clip_inputs; at T=512 with
     its clip candidates, divisions and issue floor) and the row sweep on a
     sequential and on a colored solve's rows, with the T=512 rows'
     wavefront (wave_schedule: level steps a sweep, mean and largest), the
     design's streamed floor and the kernel's clock64 cycles a level step;
     the contact kernel bit for bit and timed at T=512 on poses with active
     contacts (the golden's contact pose and animbank poses), with its
     near pairs and issue floor, and the reference-layout contact rows
     there; and the row sweep bit for bit on rows with active
     friction rows: a sequential and a colored frame's rows at those poses
     (T=512) and seeded synthetic rows with masters after their readers and
     inactive masters (T=4)
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
 12. kernels 2 and 2.5 (the 12- and 16-channel cloud-rows packs) against
     their plain versions at T=4 and at T=512, on the dynamics pass's cloud
     (N=2048, the mirror split by the cutting plane) and on MultiStepSim's
     (N=512), kernel 2 with its dt, and at T=4 on two seeded synthetic
     clouds (ops.cloud_rows.synthetic_cloud: N=2048 with a thinned body, a
     quarter of the points inactive and inner-sphere winners; N=32): every
     channel of every slot equal and the counts equal
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
 14. those frames' time at T=512, their device-time split, and kernels 2
     and 2.5 timed at both N beside their plain versions and their bounds,
     held to the plain versions again at the timed shapes
 15. the CNN frame on the reference solvers (the JAX package's default
     tracker): the sequential CNN frame (use_pallas=True) at T=512 for 8
     frames on phase 7's renders and groups, held to CNN_BAND_MM, with
     every kernel of its path launched (REF_CNN_PATH: the cloud, contact,
     vals, unpacked-rows and correspondence kernels, the row sweep, the
     PGS kernel on the unibody plan only); the C++ goldens with their net
     (assets/handposedd_synth.cnnb) on 2 tracks, each with use_pallas True
     and False: synctrack_atc's 12 frames (< 3 mm a frame, mean < 2.5 mm)
     and synctrack_trained's first 2 (< 5 mm); colored against sequential
     at 2048 cloud rows a body over 3 CNN frames (COLORED_M,
     COLORED_QUAT); use_pallas=False on 2 tracks (no cloud-rows,
     correspondence or PGS launch) and its peak memory at T=64; a 2-track
     CPU re-run of each configuration's first frame, the reset included
     (< 1e-4 m); kernel 8 on MultiStepSim's N=512 subsample and the row
     sweep on a MultiStepSim step's sequential and colored rows and on
     UnibodyFit's one-body rows, bit for bit with their plain versions at
     T=4 and T=512
 16. both reference-solver CNN frames' time at T=512 (use_pallas=True):
     host clock, device busy and idle, launches; and phase 15's new kernel
     shapes timed beside their plain versions and their bounds
 17. slowfit, the annotation-grade fit (tracker.runtime.slowfit,
     use_pallas=True, 6 solves) at T=512 on phase 4's dyn30 renders, each
     track started from the animbank pose of its render's frame before,
     the cloud as the annotate CLI builds it (apps.annotate.points_of):
     plain, hold=2 toward the start pose, and a nail dragging bone 16
     12 mm along x (within 4 mm of its target), the plain fit no further
     from the renders' poses than its start, every kernel of its path
     launched and no other; a 2-track CPU re-run of each variant
     (< 1e-4 m); use_pallas=False at T=64 (no correspondence launch) and
     its peak memory; kernel 3, kernel 8 (N=2048, rays from the world
     origin) and the row sweep (the first solve's rows with the hold rows,
     and the last solve's rows: no cloud, no caller rows) bit for bit with
     their plain versions at T=512, timed beside their bounds; the plain
     call's host clock, device busy and idle, and launches
 18. jacobi contacts (contacts_mode="jacobi"): the PGS kernel's jacobi
     class (dynamics and multistep plans) and the row sweep's jacobi
     levels (the colored jacobi rows) bit for bit with their plain
     versions at T=4 and T=512 on the contact poses' rows, with their
     active contact rows counted (> 0), timed beside their bounds, with
     their clock64 counters (cycles a jacobi step or level, the sweep
     cycles' max/mean, active units and kept phases, the row sweep's
     levelling and placement) and the tracks an SM; the same three
     kernels with exact contacts on the same poses' rows, timed (the
     baseline); the PGS jacobi class bit for bit at T=4 on seeded edge
     inputs (JACOBI_EDGES: no active unit, 40 active units, the 96-unit
     maximum, phases with no active row); the
     jacobi dynamics frame on the kernel solver (30 frames) and the
     colored one (10) on phase 4's renders, each frame's largest distance
     from the exact-contacts frame and the dyn30 golden errors, timed, and
     3 frames at the contact poses on their renders (where the jacobi
     class and levels run: their launches); two jacobi CNN frames (the
     multistep plan's jacobi class); the angles-only CNN frame (every
     track resets, no main pass) for 8 frames on phase 7's renders, timed,
     with kernels 6 and 7 on its second frame's inputs (T=512: every
     track resets) bit for bit and timed; kickstart_multi at 128 tracks x 4 hypotheses from the rest
     pose (the mean joint error before and after, the time); the kernel
     solver with use_pallas=False at T=64 for 10 frames (its peak memory,
     its distance from use_pallas=True); 2-track CPU re-runs of each
     (< 1e-4 m; the jacobi frames' at the contact poses, on the two tracks
     with the most active contact rows, each frame with some); the synthetic-track CLI as two subprocesses on the card
     (--tracks 64 --frames 8, with and without --dynamics-only)
 19. the C++ goldens of the JAX suite that the port's tracker reaches,
     each at its test file's gates: the contact sweep (the 20 sweep poses'
     reference-layout contact rows against contact_sweep_ref.json's pairs
     and depths, then 3 sequential joint-and-contact updates from each),
     the fast-drift golden (T=8, the bench row configuration on the
     colored solver, 32 frames on the port's renders of 8 fast animbank
     segments), cold-start acquisition (8 tracks, initializing=50, 8
     colored CNN frames) and the recorded CNN cadence (CADENCE_CASES:
     cnntrack_rec and cnntrack_rec2 at T=1, k = 1, 4 and 8, up to 128
     frames); each case's first GOLDEN_CPU_FRAMES frames re-run on 2
     tracks on the CPU (< 1e-4 m)
 20. the training half of the flywheel: the SGD golden at batch 1 (MSE
     within 1e-6, the output after the step within 1e-5), the synthetic
     training set (TRAIN_FRAMES renders) and TRAIN_STEPS SGD steps at
     batch TRAIN_BATCH from golden_cnn_init.cnnb (the MSE over every
     frame and over the held-out frames each below 0.9x its start; ms a
     step, examples/s, device busy and idle and launches a step from the
     profiler), one batch-64 step on the
     card against the CPU (SGD_CARD_CPU), the streaming loader on both
     cadence recordings against load_dataset (bit for bit) and
     compress_dataset on the card against the CPU (COMPRESS_CARD_CPU), and
     the train and export CLIs as two subprocesses on the card
 21. scale-out and profiling: two meshes (every visible card, and the
     first card listed twice); sharded_track_sequences on each against
     track_sequences (P21_GATE on poses and states) for P21_FRAMES T=512
     dynamics frames on phase 4's renders and one T=512 CNN frame on phase
     7's render with every 4th track reset, each with its launches and
     host ms a frame; the data-parallel SGD step at batch TRAIN_BATCH on
     each mesh against sgd_step (MSE 1e-6, every parameter 2e-6) and ms a
     step; the port's dryrun_multichip on each mesh; device_trace around
     one dynamics frame (the Chrome trace, written beside the --json file
     or under build/trace, must name a port kernel) and the phase's StageTimer report; the kernel solver's
     dynamics frame with use_pallas=False at T=512 (P21_NOPALLAS_FRAMES
     frames: peak memory, ms a frame, distance from use_pallas=True, a
     2-track CPU re-run; if T=512 does not fit, the peak it reached and
     the T that fits)
 22. the tools (hand_tracking_samples_tpu_torch.tools): the profiling
     kernels of csrc/prof_cloud.cu (the staged cloud kernel cut after each
     stage 0-4, the sum kernel at 1-16 tracks a block and a track a block)
     against their plain versions at T=4 on phase 4's renders and on
     seeded rasters, the stages also at frac P22_FRACS on seeded rasters
     that keep 0, more than, exactly and fewer than the budget and on the
     renders at budgets 2048 and 8192 (empty slots), then driven through
     their tools (prof_cloud_kernel, prof_cloud_mt, prof_cloud_pre at
     T=512, one frame: every stage and every tracks-a-block launched),
     then timed at T=512 on phase 4's renders beside their plain versions,
     their bounds and the PyTorch sum (for the sums and stage 0) (stages
     1-4 equal, stage 0 and the sums within P22_SUM_REL); then
     every ported tool as a subprocess on the card at a small size
     (P22_FIRST alone, then P22_TOOLS, then P22_LAST), each exiting 0
     with its expected line: eval_fastdrift --tracks 8 held to phase 19's
     fast-drift gates, eval_coldstart on every 8th start of the JAX
     tool's 64 x 64 protocol for 8 frames (colored, EVAL_START_STEP=8,
     EVAL_PROTOCOL_FRAMES=64) held to phase 19's cold-start gates,
     prof_full at T=512 with its stage times in its --json
     (prof_full.json beside this script's --json file, else under
     build/)

Each phase drives its path with the launch counts set to 0 just before it
and reads them just after.  The line before the last is the kernels' JSON
record (launches: the dynamics path's for the first four kernels, the CNN
frame's for kernels 6-7 and the plans, the sequential frame's (phase 10)
for the correspondence kernel and the row sweep, the colored frame's
(phase 11) for the row sweep on colored rows, the far-mirror dynamics
frame's (phase 13) for kernel 2.5, slowfit's hold call (phase 17) for
the rows of its four shapes, and phase 18's runs for its five rows: the
jacobi frames at the contact poses, the jacobi CNN frames, the angles-only
frames); the last line is
{"ok": true, "device": {...}}.  Exits non-zero, printing no result, when a
phase fails, when there is no CUDA device, or when run outside the
repository.  --json PATH writes every measured number to PATH.  Every
kernel is held to its plain version bit for bit (max_abs_err 0) at T=4
and T=512.
"""
from __future__ import annotations

import argparse
import ctypes
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
# the kernels redesigned for the card, whose ptxas report phase 1 prints
REDESIGNED = ("row_sweep_kernel", "pgs_kernel", "cloud_rows_pack_kernel",
              "contact_fields_kernel", "correspondence_kernel",
              "cloud_from_depth_kernel", "cloud_vals_kernel",
              "cloud_rows_unpacked_kernel")
# of those, the kernels that must use no stack and spill nothing
NO_SPILL = REDESIGNED[3:]
FIRST = ("cloud_from_depth", "cloud_rows_solve", "contact_fields",
         "pgs_solve")            # the dynamics path's kernels (phases 3-5)
# the PGS kernel's plans that the CNN frame adds: row name -> plan kind
PLANS = {"pgs_solve[multistep]": "ms", "pgs_solve[unibody]": "uni"}
NEW = ("cloud_rows_unpacked", "cloud_vals") + tuple(PLANS)
# the points a warp of the blocked winner scan takes: 32 x the points a
# thread (csrc/cloud_rows.cu UR_K for kernel 6, CV_K for kernel 7)
SCAN_WARP_POINTS = {"cloud_rows_unpacked": 32, "cloud_vals": 128}
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
# The CNN frame on the reference solvers (phases 15-16): the kernels it
# launches with use_pallas (the PGS kernel on the unibody plan only)
REF_CNN_PATH = ("cloud_from_depth", "contact_fields", "cloud_vals",
                "cloud_rows_unpacked", "correspondence", "row_sweep",
                "pgs_solve")
COLORED_CNN_TRACKS = 128  # colored against sequential, 3 CNN frames
REF_CNN_TIMED_FRAMES = 4  # CNN frames timed per reference solver
# the shapes of the path that earlier phases did not run: kernel 8 on
# MultiStepSim's compacted subsample, the row sweep on MultiStepSim's and
# on UnibodyFit's one-body rows (use_pallas=False)
REF_CNN_SHAPES = {"correspondence": "correspondence[N=512]",
                  "row_sweep": "row_sweep[multistep]",
                  "row_sweep[colored]": "row_sweep[colored, multistep]",
                  "row_sweep[unibody]": "row_sweep[unibody]"}
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


# slowfit, the annotation-grade fit (phase 17): T=512 tracks on phase 4's
# dyn30 renders, track t on render f = 1 + t % 29, started from the animbank
# pose of frame f - 1 (a one-frame-old annotation, what the fixer refines);
# the cloud as the annotate CLI builds it; use_pallas, 6 solves, three
# variants: plain, hold=2 toward the start pose, and a nail dragging bone
# 16 12 mm along x (tests/test_annotate_edits.py), which must end within
# 4 mm of its target (that test's bound)
SLOWFIT_TRACKS, SLOWFIT_STEPS = 512, 6
SLOWFIT_NAIL = (16, 0.012)               # bone, metres along x
SLOWFIT_NAIL_M = 0.004
SLOWFIT_VARIANTS = ("plain", "hold", "nail")
SLOWFIT_TIMED_CALLS = 3                  # plain calls timed (host clock)
SLOWFIT_PATH = ("contact_fields", "correspondence", "row_sweep")
# its kernels at slowfit's shapes: kernel 3 on a fitted state, kernel 8 on
# the annotator's cloud (N=2048, rays from the world origin), the row sweep
# on the first solve's rows with the hold rows and on the last solve's
# rows (no cloud, no caller rows)
SLOWFIT_SHAPES = {"contact_fields": "contact_fields[slowfit]",
                  "correspondence": "correspondence[slowfit]",
                  "row_sweep": "row_sweep[slowfit, hold]",
                  "row_sweep[last]": "row_sweep[slowfit, last]"}


# jacobi contacts, the angles-only frame, kickstart_multi, the kernel
# solver without use_pallas and the synthetic-track CLI (phase 18), T=512
# unless named: jacobi frames on phase 4's renders (30 on the kernel
# solver, 10 on the colored one) beside the exact ones on the same renders,
# two CNN frames with jacobi contacts on phase 7's renders (the multistep
# plan's jacobi class), the angles-only CNN frame (8 frames on phase 7's
# renders), kickstart_multi (128 tracks x 4 hypotheses from the rest pose),
# the kernel solver without use_pallas (64 tracks, 10 frames: the plane
# dots' (T, 17, 2048, 96) tensor bounds it), the CLI as a subprocess
JACOBI_FRAMES = dict(kernel=30, colored=10)
JACOBI_CONTACT_FRAMES = 3     # frames at the contact poses (their renders)
JACOBI_CNN_FRAMES = 2
# the PGS kernel's jacobi class on seeded edge inputs (pgs_kernel.
# synthetic_jacobi_inputs, T=4, 6+2 sweeps): label -> (units, active units
# a track, phases with no active row)
JACOBI_EDGES = {"no active unit": (88, 0, ()),
                "40 active units": (88, 40, ()),
                "96 units, all active": (96, 96, ()),
                "dead phases": (88, 10, (1, 2, 3, 7, 11))}
ANGLES_FRAMES = 8
KICK_TRACKS, KICK_HYP = 128, 4
NOPALLAS_TRACKS, NOPALLAS_FRAMES = 64, 10
CLI_ARGS = ("--tracks", "64", "--frames", "8")
# the rows of phase 18's kernels in the kernels line: name -> (source, the
# TPU kernel it replaces); the jacobi classes and levels, and kernels 6
# and 7 on the angles-only resets (every track, T=512)
P18_ROWS = {
    "pgs_solve[jacobi]": (f"{PORT}/csrc/pgs_kernel.cu",
                          f"{JAXPKG}/physics/pgs_kernel.py:185"),
    "pgs_solve[jacobi, multistep]": (f"{PORT}/csrc/pgs_kernel.cu",
                                     f"{JAXPKG}/physics/pgs_kernel.py:185"),
    "row_sweep[colored, jacobi]": (f"{PORT}/csrc/row_sweep.cu",
                                   f"{JAXPKG}/physics/colored.py:300"),
    "cloud_rows_unpacked[angles-only]": (f"{PORT}/csrc/cloud_rows.cu",
                                         f"{JAXPKG}/ops/cloud_rows.py:34"),
    "cloud_vals[angles-only]": (f"{PORT}/csrc/cloud_rows.cu",
                                f"{JAXPKG}/ops/cloud_rows.py:34"),
}


# Phase 19: the C++ goldens of the JAX suite, each at its test file's
# gates.  The recorded CNN cadence (tests/test_cnntrack_golden.py):
# (recording, reference, frames, per-frame deviation gate, per-frame joint
# error slack, mean joint error ratio, its slack, mean deviation gate), in
# m; the first is test_cnn_cadence_recorded_parity (:62-69), the rest
# _CADENCE_CASES (:86-97).  T=1, colored, DEFAULT_CNNB.
CADENCE_CASES = [
    ("cnntrack_rec", "cnntrack_ref", 32, 4.5e-3, 3e-3, 1.0, 1.5e-3, 2e-3),
    ("cnntrack_rec", "cnntrack_ref_k1", 16, 3.0e-3, 3e-3, 1.15, 1.0e-3,
     2e-3),
    ("cnntrack_rec", "cnntrack_ref_k8", 32, 3.5e-3, 3e-3, 1.15, 1.0e-3,
     2e-3),
    ("cnntrack_rec2", "cnntrack_ref2_k1", 64, 4.5e-3, 4e-3, 1.45, 1.0e-3,
     2.5e-3),
    ("cnntrack_rec2", "cnntrack_ref2_k4", 128, None, 30e-3, 1.30, 2.0e-3,
     12e-3),
    ("cnntrack_rec2", "cnntrack_ref2_k8", 128, 14e-3, 8e-3, 1.15, 2.0e-3,
     5e-3),
]
GOLDEN_CPU_FRAMES = 2     # frames of each golden's 2-track CPU re-run
# the cadence cases (indices into CADENCE_CASES) each spawned process runs,
# balanced by their host time (CNN frames at T=1 dominate: 64; 32 + 16;
# 16 + 8 + 4)
CADENCE_WORKERS = ((3,), (4, 1), (5, 0, 2))
# Phase 20: training.  The synthetic set (512 animbank frames, the train
# CLI's ids, not augmented), 300 SGD steps at batch 64 from the golden
# init; the MSE gate of tests/test_train_meshes.py:37.
TRAIN_FRAMES, TRAIN_STEPS, TRAIN_BATCH, TRAIN_ALPHA = 512, 300, 64, 0.001
TRAIN_PROFILE_STEPS = 20  # steps read by the profiler
SGD_CARD_CPU = 1e-5       # batch-64 step, card against CPU, any parameter
COMPRESS_CARD_CPU = 1e-5  # compress_dataset, card against CPU
TRAIN_CLI = ("tests/fixtures/cnntrack_rec.rs", "--synthetic", "64",
             "--steps", "20", "--batch", "16", "--eval-every", "10",
             "--init-cnnb", "tests/fixtures/golden_cnn_init.cnnb")
EXPORT_CLI = ("tests/fixtures/cnntrack_rec.rs", "--max-frames", "8")
# Phase 21: scale-out and profiling.  Sharded against unsharded: JAX's gate
# (tests/test_parallel.py:52-55) on poses and states; the dynamics frames
# sharded (T=512, phase 4's renders), the dp step's timed steps, and the
# use_pallas=False frames at T=512 (the plane dots' (T, 17, 2048, 96)
# tensors bound its memory)
P21_GATE = 2e-5
P21_FRAMES = 4
P21_STEPS = 20
P21_NOPALLAS_FRAMES = 3
# Phase 22: the tools.  The profiling kernels' rows in the kernels line:
# name -> (the TPU kernel it replaces); all in csrc/prof_cloud.cu.  Stage
# 0 and the sums add float32 products in float64 in one fixed order, as
# their plain versions do in another: held to P22_SUM_REL relative.
P22_SRC = f"{PORT}/csrc/prof_cloud.cu"
P22_STAGES = {f"cloud_stage[{s}]": "tools/prof_cloud_kernel.py:38"
              for s in range(5)}
P22_TRK = (1, 2, 4, 8, 16)
P22_SUMS = {**{f"group_sum[trk={k}]": "tools/prof_cloud_mt.py:35"
               for k in P22_TRK}, "track_sum": "tools/prof_cloud_pre.py:29"}
P22_SUM_REL = 1e-6
P22_FRACS = (1, 3, 4, 5, 16)     # the stages' fracs at T=4
P22_PATH_ENV = dict(PROF_TRACKS="512", PROF_FRAMES="1", PROF_REPS="1")
P22_WORKERS = 8           # tool subprocesses at a time
# Three batches of tool subprocesses: prof_full at T=512, alone on the
# card and the host (its stage times go into PERF.md); every other ported
# tool at a small size, P22_WORKERS at a time; then train_finetune, which
# reads eval_coldstart's dump.  Each is (label, module, arguments,
# environment, a regular expression its output must match); {out} is a
# temporary directory, {json} prof_full's --json
P22_FIRST = ("prof_full", "prof_full", ("--json", "{json}"),
             dict(PROF_TRACKS="512", PROF_FRAMES="3", PROF_REPS="3"),
             r"cloud\(N,3\) +[\d.]+ ms/frame")
_A = ("--out", "{out}/artifacts")
P22_TOOLS = (
    ("eval_artifacts fastdrift", "eval_artifacts", ("fastdrift", *_A),
     dict(EVAL_TRACKS="8", EVAL_FRAMES="4"), r"wrote"),
    ("eval_artifacts coldstart", "eval_artifacts", ("coldstart", *_A),
     dict(EVAL_TRACKS="8", EVAL_FRAMES="4"), r"coldstart_r04.json"),
    ("eval_artifacts dyntrack", "eval_artifacts", ("dyntrack", *_A),
     dict(EVAL_FRAMES="4"), r"dyntrack_kernel_r04.json"),
    ("eval_artifacts cnntrack_kernel", "eval_artifacts",
     ("cnntrack_kernel", *_A), dict(EVAL_FRAMES="4"),
     r"cnntrack_kernel_r04.json"),
    # every 8th start of the JAX tool's 64 x 64 protocol, 8 frames, on the
    # colored solver: phase 19's gate (test_coldstart_gate)
    ("eval_coldstart", "eval_coldstart", ("--out", "{out}"),
     dict(EVAL_TRACKS="8", EVAL_START_STEP="8", EVAL_PROTOCOL_FRAMES="64",
          EVAL_FRAMES="8", EVAL_SOLVER="colored", EVAL_DUMP="cold.npz"),
     r"cold-start after 8"),
    ("eval_accum_threshold", "eval_accum_threshold", ("--out", "{out}"),
     dict(EVAL_FRAMES="8"), r"accum_threshold_r04.json"),
    ("eval_cap_recorded", "eval_cap_recorded", (), dict(EVAL_FRAMES="8"),
     r"^kernel cap=128: mean je [\d.]+ mm[\s\S]*^kernel cap=256: mean je "
     r"[\d.]+ mm[\s\S]*^colored cap=512: mean je [\d.]+ mm"),
    ("profile_cnn_frame", "profile_cnn_frame", (), dict(BENCH_TRACKS="64"),
     r"update run_cnn=True"),
    ("prof_trace", "prof_trace", ("cloud", "--out", "{out}"),
     dict(PROF_TRACKS="64", PROF_FRAMES="1"), r"== cloud: device total"),
    ("eval_fastdrift", "eval_fastdrift",
     ("--tracks", "8", "--json", "{out}/fastdrift.json"), {},
     r"per-track final"),
    ("eval_coldstart_modes", "eval_coldstart_modes", (),
     dict(MODE="gated", EVAL_TRACKS="8", EVAL_FRAMES="4"), r"MODE=gated"),
    ("profile_frame", "profile_frame", (),
     dict(BENCH_TRACKS="64", BENCH_FRAMES="2"), r"chamber total"),
    ("profile_stages", "profile_stages", (), dict(BENCH_TRACKS="64"),
     r"1\+1 iters"),
    ("check_pgs_kernel", "check_pgs_kernel", (), {}, r"^OK$"),
    ("dyn_colored_ctrl", "dyn_colored_ctrl", (), dict(EVAL_FRAMES="8"),
     r"^\[[\d., ]+\]$"),
    ("train_v3", "train_v3", ("--out", "{out}"),
     dict(TRAIN_FRAMES="64", TRAIN_AUG="1", TRAIN_STEPS="20",
          TRAIN_BATCH="16", TRAIN_CACHE=""), r"saved .*v3.cnnb"),
    ("prof_cloud_kernel", "prof_cloud_kernel", (),
     dict(PROF_TRACKS="64", PROF_FRAMES="2"), r"stage 5: +[\d.]+ ms/frame"),
    ("prof_cloud_mt", "prof_cloud_mt", (),
     dict(PROF_TRACKS="64", PROF_FRAMES="2"), r"tracks/instance +16:"),
    ("prof_cloud_pre", "prof_cloud_pre", (),
     dict(PROF_TRACKS="64", PROF_FRAMES="2"), r"current: +[\d.]+"),
    ("prof_cloud_epi", "prof_cloud_epi", (),
     dict(PROF_TRACKS="64", PROF_FRAMES="2"), r"deproject +:"),
)
P22_LAST = ("train_finetune", "train_finetune", ("--out", "{out}"),
            dict(FT_DUMP="cold.npz", FT_FRAMES="64", FT_STEPS="20",
                 FT_BATCH="16", FT_CACHE=""), r"saved .*v5.cnnb")
# the port kernels' entry names, one of which the trace must show
PORT_KERNEL_SYMBOLS = ("cloud_from_depth_kernel", "cloud_rows_pack_kernel",
                       "contact_fields_kernel", "pgs_kernel")


class PhaseError(RuntimeError):
    pass


def _cadence_worker(cases):
    """A spawned process of phase 19: the cases of CADENCE_CASES at these
    indices on the card (Smoke.cadence_case)."""
    sys.path.insert(0, REPO)
    s = Smoke()
    s.cnn_setup()
    return [s.cadence_case(CADENCE_CASES[i]) for i in cases]


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def quat_err(a, b):
    """Sign-invariant max quaternion component error."""
    import torch
    sign = torch.sign((a * b).sum(-1, keepdim=True))
    return (a - b * sign).abs().max().item()


def near_pairs(args):
    """Kernel 3's cull on its inputs (vw, nw, dw, aux, pairs, ...): (T, NP)
    bool, the pairs whose bounding spheres meet, by the kernel's
    expression."""
    aux, pairs = args[3], args[4]
    a, b = pairs[:, 0], pairs[:, 1]
    dc = [aux[:, a, 6 + c] - aux[:, b, 6 + c] for c in range(3)]
    rs = aux[:, a, 9] + aux[:, b, 9]
    return dc[0] * dc[0] + dc[1] * dc[1] + dc[2] * dc[2] <= rs * rs


def _first(x, n, device=None):
    """The first n tracks of every tensor in x (nested tuples of
    tensors with the tracks leading), moved to device when given."""
    if isinstance(x, tuple):
        return type(x)(*[_first(f, n, device) for f in x]) \
            if hasattr(x, "_fields") else tuple(_first(f, n, device)
                                                 for f in x)
    return x[:n] if device is None else x[:n].to(device)


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

    def kernel_inputs(self, st, depth, contacts_mode="exact"):
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
        plan = build_dynamics_plan(m.np, cfg.cloud_rows_per_body + 5,
                                   contacts_mode)
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
        if name == "cloud_rows_solve":       # bit-identical, as 2.5
            return self.hold_pack(k, p, name)
        if name == "contact_fields":
            # bit for bit, every row: skip rows and inactive rows too
            err = (k - p).abs().max().item()
            check(torch.equal(k, p), f"contacts not bit-identical ({err})")
            return err, (f"contacts {err:.3g} (bit-identical; "
                         f"{int((p[:, :, 8] > 0.5).sum())} active rows)")
        if name == "cloud_vals":             # bit-identical
            err = (k - p).abs().max().item()
            check(torch.equal(k, p), f"vals not bit-identical ({err}; "
                  f"{int((k[:, 1] != p[:, 1]).sum())} winners differ)")
            return err, (f"vals {err:.3g} (bit-identical; {k.shape[2]} "
                         f"points a track)")
        if name == "cloud_rows_unpacked":    # bit-identical
            err = (k - p).abs().max().item()
            check(torch.equal(k, p), f"unpacked rows not bit-identical "
                  f"({err})")
            return err, (f"unibody rows {err:.3g} (bit-identical; "
                         f"{int((p[:, 7] > 0.5).sum())} active)")
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
            check(err == 0.0, f"unibody pgs momenta differ: {err}")
            return err, (f"unibody pgs momenta {err:.3g}, pos {perr:.3g} m, "
                         f"quat {qerr:.3g}")
        # PGS on identical planes: positions < 1e-5 m, quats < 1e-5, and
        # the momenta bit for bit
        from hand_tracking_samples_tpu_torch.physics.fused_fit import integrate
        sk = integrate(k, P, self.model.np, self.params.deltaT)
        sp = integrate(p, P, self.model.np, self.params.deltaT)
        perr = (sk.pose[..., :3] - sp.pose[..., :3]).abs().max().item()
        qerr = quat_err(sk.pose[..., 3:], sp.pose[..., 3:])
        check(perr < 1e-5 and qerr < 1e-5, f"pgs differs: {perr} {qerr}")
        err = (k - p).abs().max().item()
        check(err == 0.0, f"pgs momenta differ: {err}")
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
        lines[0] += "; " + self.cloud_synthetic(4)
        lines[2] += "; " + self.contacts_at_bank_poses(inp, fns)
        return "; ".join(lines)

    def cloud_synthetic(self, T):
        """Kernel 1 bit for bit on the seeded rasters of
        ops.cloud_kernel.synthetic_depths at T tracks (no valid pixel,
        every pixel valid, exactly the budget kept, hand-like blobs keeping
        fewer and more than the budget), at the path's frac and at 3."""
        from hand_tracking_samples_tpu_torch.ops.cloud_kernel import (
            cloud_from_depth_planes, cloud_from_depth_planes_plain,
            depth_tensor, synthetic_depths)
        cfg, notes = self.cfg, []
        H, W = self.dyn.shape[1], self.dyn.shape[2]
        for frac in (cfg.subsample_fraction, 3):
            d = depth_tensor(synthetic_depths(T, H, W, seed=T + frac,
                                              frac=frac,
                                              budget=cfg.point_budget),
                             self.dev)
            args = (d, self.cam, 0.1, cfg.drangey, frac, cfg.point_budget)
            err, _ = self.hold("cloud_from_depth",
                               cloud_from_depth_planes(*args),
                               cloud_from_depth_planes_plain(*args))
            self.results["cloud_from_depth"][
                f"max_abs_err_synthetic_t{T}_frac{frac}"] = err
            notes.append(f"frac {frac} {err:.3g}")
        return (f"synthetic rasters T={T} bit-identical "
                f"({', '.join(notes)})")

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
        return f"at bank poses: {note}; " + self.contacts_synthetic(inp, fns)

    def contacts_synthetic(self, inp, fns):
        """Kernel 3 bit for bit on seeded synthetic tracks at T=4
        (physics.contact_kernel.synthetic_contact_inputs): tracks 0-1 with
        every collide pair near, odd tracks with each hull's second half of
        planes and vertices copied from its first (exact ties in every
        reduction)."""
        torch = self.torch
        from hand_tracking_samples_tpu_torch.physics.contact_kernel import (
            synthetic_contact_inputs)
        cin = synthetic_contact_inputs(
            torch.tensor(self.bank[[0, 30, 60, 90]], device=self.dev),
            self.model, seed=3) + inp["contact_fields"][4:]
        near = near_pairs(cin)
        check(bool(near[:2].all()), "synthetic contacts: a pair not near")
        err, note = self.hold("contact_fields", fns["contact_fields"][0](*cin),
                              fns["contact_fields"][1](*cin))
        self.results["contact_fields"]["max_abs_err_synthetic"] = err
        return (f"synthetic ({int(near.sum())} near pairs of "
                f"{near.numel()}): {note}")

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
            if name == "pgs_solve":
                note += "; " + self.cycles(name, args)
            if name == "contact_fields":
                note += "; " + self.contact_floor(args, self.results[name])
            if name == "cloud_from_depth":
                note += "; " + self.cloud_synthetic(T)
            parts.append(f"{name} {ms:.4f} ms (bound {max(tb, to):.4f} ms "
                         f"by {'bytes' if tb >= to else 'operations'}; "
                         f"plain {plain_ms:.2f}; {note})")
        return (f"T={T}: {fps:.1f} tracked frames/s{busy}; "
                + "; ".join(parts))

    def cycles(self, name, args, rec=None):
        """One more launch of a redesigned solve kernel with its clock64
        counters (per track: prologue, sweeps, steps a sweep, rows or
        slots; the jacobi counters: the PGS kernel's cycles in its jacobi
        groups and compaction, active units and kept phases, the row
        sweep's levelling and placement cycles, cycles in jacobi levels and
        their count) and the tracks an SM holds; records them (in rec,
        default the kernel's record) and returns the cycles a step."""
        torch = self.torch
        from hand_tracking_samples_tpu_torch.physics import pgs_kernel as pk
        from hand_tracking_samples_tpu_torch.physics import row_sweep as rs
        pgs = name.startswith("pgs_solve")
        T = (args[3] if pgs else args[0]).shape[0]
        it, ip = (args[1], args[2]) if pgs else (args[3], args[4])
        c = torch.zeros((T, 8), dtype=torch.int64, device=self.dev)
        (pk.pgs_solve if pgs else rs.row_sweep)(*args, cycles=c)
        torch.cuda.synchronize()
        c = c.double()
        steps = c[:, 2] * (it + ip)
        res = dict(prologue_cycles_mean=c[:, 0].mean().item(),
                   sweep_cycles_mean=c[:, 1].mean().item(),
                   sweep_cycles_max=c[:, 1].max().item(),
                   steps_per_sweep_mean=c[:, 2].mean().item(),
                   steps_per_sweep_max=c[:, 2].max().item(),
                   cycles_per_step=(c[:, 1].sum() / steps.sum().clamp(min=1))
                   .item(), blocks_per_sm=(
                       pk.occupancy(args[0], args[3].shape[2], self.dev)
                       if pgs else rs.occupancy(args[2], args[0].shape[1],
                                                self.dev)))
        # the sweeps' cycles are all 20 sweeps': a sweep's is / (it + ip)
        res["sweep_max_over_mean"] = (res["sweep_cycles_max"]
                                      / max(res["sweep_cycles_mean"], 1.0))
        jac = ""
        per = lambda k, f: (f(c[:, k]) / (it + ip)).item()   # a sweep
        if pgs and bool((c[:, 6] > 0).any()):
            res.update(jacobi_cycles_a_sweep_mean=per(4, torch.mean),
                       jacobi_cycles_a_sweep_max=per(4, torch.max),
                       jacobi_prologue_cycles_mean=c[:, 5].mean().item(),
                       jacobi_units_mean=c[:, 6].mean().item(),
                       jacobi_units_max=c[:, 6].max().item(),
                       jacobi_phases_mean=c[:, 7].mean().item(),
                       jacobi_cycles_a_step=(c[:, 4].sum() / (
                           c[:, 7].sum() * (it + ip)).clamp(min=1)).item())
            jac = (f"; jacobi groups {res['jacobi_cycles_a_step']:.0f} "
                   f"cycles a step (their sums in), "
                   f"{res['jacobi_cycles_a_sweep_mean']:.0f}"
                   f" cycles a sweep (max "
                   f"{res['jacobi_cycles_a_sweep_max']:.0f}), compaction "
                   f"{res['jacobi_prologue_cycles_mean']:.0f} cycles, "
                   f"{res['jacobi_units_mean']:.1f} active units a track "
                   f"(max {res['jacobi_units_max']:.0f}), "
                   f"{res['jacobi_phases_mean']:.1f} kept phases")
        if not pgs:
            res.update(levelling_cycles_mean=c[:, 4].mean().item(),
                       placement_cycles_mean=c[:, 5].mean().item())
            if bool((c[:, 7] > 0).any()):
                res.update(jacobi_cycles_a_sweep_mean=per(6, torch.mean),
                           jacobi_cycles_a_sweep_max=per(6, torch.max),
                           jacobi_levels_mean=c[:, 7].mean().item(),
                           jacobi_cycles_a_level=(c[:, 6].sum() / (
                               c[:, 7].sum() * (it + ip)).clamp(min=1))
                           .item())
                jac = (f"; jacobi levels {res['jacobi_cycles_a_level']:.0f} "
                       f"cycles a level (steps and sums), "
                       f"{res['jacobi_cycles_a_sweep_mean']:.0f} cycles a "
                       f"sweep (max {res['jacobi_cycles_a_sweep_max']:.0f},"
                       f" {res['jacobi_levels_mean']:.1f} levels)")
            jac += (f"; prologue levelling "
                    f"{res['levelling_cycles_mean']:.0f}, placement "
                    f"{res['placement_cycles_mean']:.0f} cycles")
        (self.results[name] if rec is None else rec)["cycles"] = res
        floor = ""
        if pgs:   # the design's floor: every step's block every sweep
            ms = (self.pgs_row_bytes(args, streamed=True) * (it + ip)
                  / PEAK_BYTES_S * 1e3)
            (self.results[name] if rec is None else rec)[
                "stream_floor_ms"] = ms
            floor = f"; streamed floor {ms:.4f} ms"
        return (f"{res['cycles_per_step']:.0f} cycles a "
                f"{'step' if pgs else 'level step'} "
                f"({res['steps_per_sweep_mean']:.1f} steps a sweep, at most "
                f"{res['steps_per_sweep_max']:.0f}; sweep cycles max/mean "
                f"{res['sweep_max_over_mean']:.2f}; prologue "
                f"{res['prologue_cycles_mean']:.0f} cycles; "
                f"{res['blocks_per_sm']} tracks an SM{floor}{jac})")

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
            near = int(near_pairs(args).sum())
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
            # the winner scan: the hull-plane evaluations these inputs need,
            # those the kernel's exit leaves (scan_exit, run first; 3 mul,
            # 3 add, 1 max each), and the spheres
            evals = self.results[name]["hull_plane_evals"]
            ops = evals * 7 + T * N * B * 12
            if name == "cloud_vals":
                return nin + T * 2 * N * 4, ops
            # the row pass: the blend for hull winners (a plane's value and
            # its comparison, 7), the slab clip for front points (a plane's
            # value, the difference, the quotient, two side tests, max and
            # min, 12), and the row itself
            hull, front = self.row_pass_points(args)
            return (nin + T * 8 * N * 4,
                    ops + (hull * 7 + front * 12) * P + T * N * 60)
        plan, it, ip, mom0, mi, singles, lin_rows, ang_rows = args
        T, _, bp = mom0.shape
        B = len(plan.massinv)                 # the real bodies
        nact, g_acts = self.pgs_active(args)
        nbytes = self.pgs_row_bytes(args) + mom0.numel() * 4 * 3
        sweeps = it + ip
        ops = nact * B * 32 * sweeps
        for cls, rows, g_act in zip(plan.lin_classes, lin_rows, g_acts):
            if cls.jacobi:        # the active units on the kept phases
                units, kept = self.jacobi_active(rows)
                nbytes += T * cls.n_phases * cls.W * 4        # every dinv
                ops += int((units * kept).sum()) * 60 * sweeps
            elif cls.friction:
                real = torch.tensor((cls.unit_b0 >= 0).sum(-1),
                                    device=rows.device)
                units = int((g_act * real).sum())
                nbytes += T * cls.n_phases * cls.W * 4
                ops += units * cls.U * 60 * sweeps
            else:
                units = int((cls.unit_b0 >= 0).sum())
                ops += T * units * cls.U * 60 * sweeps
        for cls, rows in zip(plan.ang_classes, ang_rows):
            units = int((cls.unit_b0 >= 0).sum())
            ops += T * units * cls.U * 30 * sweeps
        return nbytes, ops

    def pgs_active(self, args):
        """The PGS inputs' active slots (summed over the tracks, each
        track's last active slot) and each linear class's active groups
        ((T, G) bool for a friction class, else None)."""
        torch = self.torch
        plan, singles, lin_rows = args[0], args[5], args[6]
        act = singles[:, :, 9].abs().sum(-1) > 0              # (T, CS)
        idx = torch.arange(1, act.shape[1] + 1, device=act.device)
        g_acts = [rows[:, :, 15].abs().sum(-1).reshape(
                      rows.shape[0], cls.n_groups, cls.U).sum(-1) > 0
                  if cls.friction else None
                  for cls, rows in zip(plan.lin_classes, lin_rows)]
        return int((act * idx).amax(-1).sum()), g_acts

    def jacobi_active(self, rows):
        """A jacobi class's active units and kept phases a track ((T,)
        each), as the kernel's prologue finds them: a unit or a phase
        with a row whose dinv (channel 15) is not 0."""
        d = rows[:, :, 15] != 0                               # (T, U, W)
        return d.any(1).sum(-1), d.any(2).sum(-1)

    def pgs_row_bytes(self, args, streamed=False):
        """The bytes of the row blocks a PGS sweep needs: the active
        slots, the active contact groups, every other class's rows; of a
        jacobi class the active units on the kept phases, without their
        dinv (the bound counts every dinv once), or, streamed, the
        (23, A rounded up to 4) blocks that the kernel reads a sweep."""
        plan, mom0, lin_rows, ang_rows = args[0], args[3], args[6], args[7]
        nact, g_acts = self.pgs_active(args)
        n = nact * 14 * mom0.shape[2] * 4
        for cls, rows, g_act in zip(plan.lin_classes, lin_rows, g_acts):
            if cls.jacobi:
                units, kept = self.jacobi_active(rows)
                if streamed:
                    n += int((kept * ((units + 3) // 4 * 4)).sum()) * 23 * 4
                else:
                    n += int((kept * units).sum()) * 22 * 4
            elif cls.friction:
                n += int(g_act.sum()) * cls.U * 23 * cls.W * 4
            else:
                n += rows.numel() * 4
        return n + sum(rows.numel() * 4 for rows in ang_rows)


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

    def cnn_kernel_inputs(self, st, depth, contacts_mode="exact"):
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
        # contiguous, as cloud_rows_unibody hands it to the kernel
        uph = compact_planes(ph, keep, max(N // 4, 64)).contiguous()
        rows = (uph,) + _kernel_inputs_ph(b0.pose, m, cam[:, :3], zb, 0.0)
        x = rt.unibody_inputs(b0, m, self.params, ph, cam[:, :3],
                              cfg.unibody_force)
        uni = (x["plan"], it, ip, x["mom0"], x["mi"], x["singles"], [], [])
        blk = rt._keypoint_block(body, m, an, cam, cfg)
        plan = build_multistep_plan(m.np, 4 + cfg.cloud_rows_per_body, True,
                                    contacts_mode)
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
        cpu = fq.fma_exact(*(torch.tensor(v) for v in (a, b, c)))
        card = fq.fma(*(torch.tensor(v, device=self.dev)
                        for v in (a, b, c))).cpu()
        check(torch.equal(cpu, card), "addcmul on the card is not one fused "
              f"multiply-add: {int((cpu != card).sum())} of {n} differ")
        r = torch.tensor(self.np.abs(a) * 1e3)
        check(torch.equal(fq.sqrt(r), fq.sqrt(r.to(self.dev)).cpu()),
              "sqrt on the card is not correctly rounded")
        return (f"fma and sqrt card forms equal the exact CPU forms ({n} "
                f"values); this build's CPU addcmul is "
                f"{'fused' if fq._cpu_addcmul_fused() else 'not fused'}")

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
        lines[1] += "; " + self.scan_synthetic("cloud_rows_unpacked", T)
        lines[2] += "; " + self.scan_synthetic("cloud_vals", T)
        return "; ".join(lines)

    def scan_synthetic(self, name, T):
        """Kernel 7 (cloud_vals) or kernel 6 (cloud_rows_unpacked) bit for
        bit on seeded clouds of ops.cloud_rows.synthetic_cloud around T
        tracks' poses, the camera at the origin (a crowded body, points on
        body centres where the inner sphere ties with or beats the hull, a
        quarter inactive): kernel 7 at N=2048, and N=300 at T=4 (a block's
        last warp partly past N); kernel 6 at UnibodyFit's N=512 and at
        N=67 (a thread's 4 points partly past N)."""
        torch = self.torch
        from hand_tracking_samples_tpu_torch.ops.cloud_rows import (
            _kernel_inputs_ph, synthetic_cloud)
        pose = self.init_state(T).body.pose
        B = pose.shape[1]
        rest = _kernel_inputs_ph(pose, self.model, (0.0, 0.0, 0.0),
                                 torch.zeros(B, device=self.dev), 0.0)
        kfn, pfn = self.pairs_of()[name]
        ns = ((512, 67) if name == "cloud_rows_unpacked"
              else (2048, 300) if T == 4 else (2048,))
        notes = []
        for n in ns:
            pts = synthetic_cloud(pose, n, seed=T + n)
            err, _ = self.hold(name, kfn(pts, *rest), pfn(pts, *rest))
            self.results[name][f"max_abs_err_synthetic_t{T}_n{n}"] = err
            notes.append(f"N={n} {err:.3g}")
        return (f"synthetic clouds T={T} bit-identical "
                f"({', '.join(notes)})")

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
            if name in ("cloud_vals", "cloud_rows_unpacked"):
                # their work depends on the data
                note += "; " + self.scan_exit(name, args) + "; " \
                    + self.scan_synthetic(name, T)
            nbytes, ops = self.work(name, args)
            tb, to = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_S * 1e3
            self.results[name].update(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(tb, to),
                bound_by="bytes" if tb >= to else "operations",
                library_ms=None, bytes=nbytes, operations=ops)
            if name in PLANS:
                note += "; " + self.cycles(name, args)
            parts.append(f"{name} {ms:.4f} ms (bound {max(tb, to):.4f} ms "
                         f"by {'bytes' if tb >= to else 'operations'}; "
                         f"plain {plain_ms:.2f}; {note})")
        return (f"T={T}: {dt / F * 1e3:.1f} ms a CNN frame, "
                f"{T * F / dt:.1f} tracked frames/s{busy}; "
                + "; ".join(parts))

    # ---- the reference solvers: phases 9-11 --------------------------------
    def ref_cfg(self, solver, use_pallas=True, **kw):
        from hand_tracking_samples_tpu_torch.tracker.config import (
            TrackerConfig)
        return TrackerConfig(cnn_every_frame=False, solver=solver,
                             use_pallas=use_pallas, point_budget=2048, **kw)

    def ref_inputs(self, body, depth, contacts_mode="exact"):
        """The new kernels' inputs for one reference frame of bodies body:
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
        cfg, m = self.ref_cfg("sequential"), self.model
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
                ("row_sweep[colored]",
                 build_hand_schedule(m.np, contacts_mode),
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

    def work_ref(self, name, args, rec=None):
        """(bytes, float32 operations) of one call on these inputs; the
        correspondence's clip candidates go into rec (default the
        kernel's record)."""
        torch = self.torch
        if name == "correspondence":
            pts_h, planes, d0 = args
            T, B, P = d0.shape
            N = pts_h.shape[2]
            # clip candidates: where a plane the origin lies on the outer
            # (inner) side of has the point inside (outside); the function
            # takes a subtract and a division for each
            ndiv = 0
            for i in range(0, T, 16):
                pl, dd, ph = planes[i:i + 16], d0[i:i + 16], pts_h[i:i + 16]
                d1 = torch.einsum("tbpk,tkn->tbpn", pl[..., :4],
                                  ph[:, :4])
                a = dd[..., None]
                ndiv += int((((a >= 0) & (d1 < 0)) | ((a <= 0) & (d1 > 0)))
                            .sum())
            nbytes = T * N * 3 * 4 + T * B * P * 5 * 4 + 5 * T * B * N * 4
            (self.results[name] if rec is None else rec)[
                "clip_candidates"] = ndiv
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
            inp = self.ref_inputs(st.body, self.depth_frame(1, T))
            for name, (kfn, pfn) in fns.items():
                args = inp[name]
                if T == 4:
                    err, note = self.hold_ref(name, kfn(*args), pfn(*args))
                    self.results[name]["max_abs_err_t4"] = err
                    lines.append(f"T=4 {note}")
                    if name == "correspondence":
                        lines.append(self.clip_synthetic(kfn, pfn))
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
                if name != "correspondence":
                    note += "; " + self.waves(name, args) + "; " \
                        + self.cycles(name, args)
                if name == "correspondence":
                    pts_h, planes, _ = args
                    dots_ms, _ = self.event_ms(
                        lambda a, b: torch.matmul(
                            a.reshape(T, -1, 8), b), (planes, pts_h),
                        warm=2, reps=5)
                    r = self.results[name]
                    Bp = planes.shape[1] * planes.shape[2]
                    r.update(dots_only_matmul_ms=dots_ms,
                             divisions=2 * T * planes.shape[1]
                             * pts_h.shape[2],
                             issue_floor_ms=self.issue_ms(
                                 T * Bp * pts_h.shape[2] * 7 / 32))
                    note += (f"; dots-only matmul {dots_ms:.4f} ms; issue "
                             f"floor {r['issue_floor_ms']:.4f} ms; "
                             f"{r['clip_candidates']} clip candidates, "
                             f"{r['divisions']} divisions")
                lines.append(f"T={T} {name} {ms:.4f} ms (plain "
                             f"{plain_ms:.1f} ms, bound {max(tb, to):.4f} "
                             f"ms; {note})")
        lines.append(self.contacts_active_t512())
        lines.append(self.sweep_friction_rows())
        return "; ".join(lines)

    def clip_synthetic(self, kfn, pfn):
        """Kernel 8 bit for bit on seeded inputs whose clip quotients tie
        and lie within an ulp of each other (ops.correspondence.
        synthetic_clip_inputs, T=4, N=2048)."""
        from hand_tracking_samples_tpu_torch.ops.correspondence import (
            synthetic_clip_inputs)
        args = synthetic_clip_inputs(4, self.model.n_bodies, 96, 2048,
                                     seed=10, device=self.dev)
        err, note = self.hold_ref("correspondence", kfn(*args), pfn(*args))
        self.results["correspondence"]["max_abs_err_synthetic"] = err
        return f"T=4 synthetic near-ties: {note}"

    def waves(self, name, args, rec=None):
        """The wavefront of the row sweep's rows (wave_schedule): level
        steps a sweep (linear + angular levels) over the tracks, and the
        design's streamed floor (every active row's 96-byte record read
        every sweep) at the card's memory rate; recorded in rec (default
        the kernel's record)."""
        from hand_tracking_samples_tpu_torch.physics.row_sweep import (
            REC, wave_schedule)
        mom0, _, rows, it, ip = args
        ws = wave_schedule(rows.lm, rows.am)
        top = lambda lv: (lv.amax(1) if lv.shape[1]     # no rows: 0
                          else lv.new_zeros(lv.shape[0]))
        lev = (top(ws.lin_level) + top(ws.ang_level)).double()
        nrows = int((ws.lin_level > 0).sum() + (ws.ang_level > 0).sum())
        floor = nrows * REC * 4 * (it + ip) / PEAK_BYTES_S * 1e3
        (self.results[name] if rec is None else rec).update(
            levels_mean=lev.mean().item(), levels_max=lev.max().item(),
            active_rows_mean=nrows / mom0.shape[0], stream_floor_ms=floor)
        return (f"levels a sweep mean {lev.mean().item():.1f}, max "
                f"{lev.max().item():.0f} ({nrows / mom0.shape[0]:.1f} "
                f"active rows a track); streamed floor {floor:.4f} ms")

    def contact_poses(self):
        """(frames, BodyState) at T=512: the golden's contact pose and a
        spread of 63 animbank poses, tiled, with small random momenta."""
        torch, np = self.torch, self.np
        from hand_tracking_samples_tpu_torch.physics.solver import BodyState
        with open(os.path.join(REPO, "tests", "fixtures", "golden.json")) as f:
            cf = int(json.load(f)["contact_frame"][0])
        frames = [cf] + list(range(0, len(self.bank),
                                   len(self.bank) // 63))[:63]
        frames = (frames * (TRACKS // len(frames) + 1))[:TRACKS]
        rng = np.random.RandomState(5)
        f32 = lambda a: torch.tensor(a.astype(np.float32), device=self.dev)
        return frames, BodyState(f32(self.bank[frames]),
                                 f32(rng.randn(TRACKS, 17, 3) * 1e-3),
                                 f32(rng.randn(TRACKS, 17, 3) * 1e-4))

    def contact_depth(self, frames):
        """The contact poses' own fake_depth renders (T=512)."""
        if getattr(self, "_contact_depth", None) is None:
            torch = self.torch
            from hand_tracking_samples_tpu_torch.data.synth import fake_depth
            uniq = sorted(set(frames))
            d = fake_depth(torch.tensor(self.bank[uniq], device=self.dev),
                           self.model, self.cam, chunk=8)
            self._contact_depth = d[torch.tensor(
                [uniq.index(f) for f in frames], device=self.dev)]
        return self._contact_depth

    def contacts_active_t512(self):
        """The reference-layout contact rows (contacts.contact_rows_from_
        fields) at T=512 on the contact poses: the kernel's fields and rows
        against the plain version's."""
        torch = self.torch
        from hand_tracking_samples_tpu_torch.physics.contact_kernel import (
            contact_fields_plain, contact_fields_raw, contact_inputs,
            fields_of)
        from hand_tracking_samples_tpu_torch.physics.contacts import (
            contact_rows_from_fields)
        _, body = self.contact_poses()
        cin = contact_inputs(*body, self.model)
        pairs = torch.as_tensor(self.model.np["collide_pairs"],
                                device=self.dev)
        args = cin + (pairs, 4, 3, self.params.driftmax)
        ms, k = self.event_ms(contact_fields_raw, args, warm=2, reps=10)
        p = contact_fields_plain(*args)
        err, note = self.hold("contact_fields", k, p)
        nbytes, ops = self.work("contact_fields", args)
        rec = dict(ms=ms, max_abs_err=err, bound_ms=max(
            nbytes / PEAK_BYTES_S, ops / PEAK_F32_S) * 1e3)
        note += (f"; {ms:.4f} ms, bound {rec['bound_ms']:.4f} ms, "
                 + self.contact_floor(args, rec))
        self.results["contact_fields"]["contact_poses"] = rec
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

    def sweep_friction_rows(self):
        """The row sweep held to its plain version bit for bit on rows with
        active friction rows: the sequential and colored rows of one frame
        at the contact poses (T=512, the cloud the poses' own fake_depth
        renders) and seeded synthetic rows (T=4, row_sweep.synthetic_rows:
        masters after their readers, inactive masters)."""
        torch = self.torch
        from hand_tracking_samples_tpu_torch.physics.row_sweep import (
            row_sweep, row_sweep_plain, synthetic_rows)
        frames, body = self.contact_poses()
        inp = self.ref_inputs(body, self.contact_depth(frames))
        cases = [(f"T={TRACKS} contact poses {n}", inp[n])
                 for n in ("row_sweep", "row_sweep[colored]")]
        cases += [(f"T=4 synthetic seed {k}",
                   synthetic_rows(4, 260, 40, 17, k, self.dev) + (3, 1))
                  for k in (0, 1)]
        parts = []
        for label, args in cases:
            lm = args[2].lm.long()
            r = torch.arange(lm.shape[1], device=self.dev)
            fr = ((lm >> 16) & 1 == 1) & ((lm >> 17) > 0)
            mp = (lm >> 17) - 1
            late = int((fr & (mp > r)).sum())
            m_act = torch.gather((lm >> 16) & 1, 1, mp.clamp(min=0)) == 1
            idle = int((fr & ~m_act).sum())
            nfr = int(fr.sum())
            check(nfr > 0, f"row sweep, {label}: no active friction row")
            err, _ = self.hold_ref("row_sweep", row_sweep(*args),
                                   row_sweep_plain(*args))
            parts.append(f"{label}: {nfr} active friction rows ({late} "
                         f"masters later, {idle} inactive) momenta {err:.3g}")
            self.results["row_sweep"].setdefault("friction_checks", []) \
                .append(dict(case=label, friction_rows=nfr,
                             late_masters=late, inactive_masters=idle,
                             max_abs_err=err))
        return "row sweep on friction rows: " + "; ".join(parts)

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

    def pack_inputs(self, st, depth, dt=0.0):
        """The pack kernels' inputs for state st and depth (T, H, W): the
        dynamics pass's (the frame's cloud split by the cutting plane,
        N=2048) and the first MultiStepSim cloud step's (the CNN frame's
        cloud, its stride-4 subsample compacted to N=512, the
        segmentation's camera as the ray origin).  dt: 0 as kernel 2.5's
        callers pass it; kernel 2's callers pass params.deltaT (its tsm
        channel is td / dt)."""
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
                                        dt) + (C,)
        seg, _, _, _, cph = rt._cnn_frame_inputs(self.cnn, depth, self.cam,
                                                 cfg, ph)
        mph, origin, scale = rt.multistep_cloud(cph, seg.cam.pose, cfg, B)
        ms = (mph.contiguous(),) + _kernel_inputs_ph(pose, m, origin, scale,
                                                     dt) + (C,)
        return {2048: dyn, 512: ms}

    def issue_ms(self, warp_instructions):
        """The time the card takes to issue this many warp instructions:
        one a clock on each of the SMs' 4 schedulers at its largest SM
        clock (nvidia-smi clocks.max.sm)."""
        torch = self.torch
        if not hasattr(self, "max_sm_hz"):
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.max.sm",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, timeout=60)
            self.max_sm_hz = float(out.stdout.split()[0]) * 1e6
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        return warp_instructions / (4 * sms * self.max_sm_hz) * 1e3

    def scan_exit(self, name, args):
        """Kernel 7 (cloud_vals) or kernel 6 (cloud_rows_unpacked) on these
        inputs: the full scan's issue floor (every point against every
        body's planes, scan_issue_ms), the share of hull-plane evaluations
        its warp exit skipped (one more launch with its evals counter: the
        planes each warp scanned, of B * P8, for its SCAN_WARP_POINTS) and
        the issue floor of those it made."""
        torch = self.torch
        pts, planes = args[0], args[1]
        T, _, N = pts.shape
        P, B = planes.shape[1] // 5, planes.shape[2]
        ev = torch.zeros(T, dtype=torch.int64, device=self.dev)
        self.pairs_of()[name][0](*args, evals=ev)
        torch.cuda.synchronize()
        wp = SCAN_WARP_POINTS[name]
        full = T * -(-N // wp) * B * (-(-P // 8) * 8)
        skipped = 1.0 - int(ev.sum()) / full
        evals = int(ev.sum()) * wp
        r = self.results[name]
        r.update(issue_floor_ms=self.scan_issue_ms(args),
                 exit_skipped_share=skipped, hull_plane_evals=evals,
                 exit_issue_floor_ms=self.issue_ms(evals * 5 / 32))
        return (f"full scan's issue floor {r['issue_floor_ms']:.4f} ms; the "
                f"exit skipped {skipped:.3f} of the hull-plane evaluations "
                f"(theirs {r['exit_issue_floor_ms']:.4f} ms)")

    def row_pass_points(self, args):
        """Kernel 6's row pass on these inputs: the points won by a hull
        (their blend reads the winner's planes) and the points whose ray
        meets the normal from the front (their slab clip reads them).  A
        point is front where the ray and the row's normal meet from the
        front: a clipped row's normal is the ray's own direction."""
        from hand_tracking_samples_tpu_torch.ops.cloud_rows import (
            _winner_plain, cloud_rows_unpacked_plain)
        pts, planes, body, misc = args
        _, widx, _ = _winner_plain(pts, planes, body)
        rows = cloud_rows_unpacked_plain(*args)
        ray = pts[:, 0:3] - misc[:, 0:3, None]
        front = (ray * rows[:, 0:3]).sum(1) > 0
        return int((widx >= planes.shape[2]).sum()), int(front.sum())

    def scan_issue_ms(self, args):
        """The least time the pack kernels' exact winner scan takes on
        this card: 5 float32 instructions a hull-plane evaluation (FMUL,
        FFMA, FFMA, FADD, FMNMX; the bound's 7 operations fold into them),
        every point against every body's planes (issue_ms)."""
        pts, planes = args[0], args[1]
        T, _, N = pts.shape
        evals = T * N * planes.shape[1] // 5 * planes.shape[2]
        return self.issue_ms(evals * 5 / 32)

    def contact_floor(self, args, rec):
        """Kernel 3's near pairs on these inputs and its design's issue
        floor: a warp per near pair, whose two face scans take, for each of
        the other hull's V vertices, one broadcast load and 3 planes a lane
        of 6 float32 instructions (FMUL, FMUL, FADD, FMUL, FADD, FMNMX);
        the refinement and the manifold not counted.  Records both in
        rec and returns a note."""
        near = int(near_pairs(args).sum())
        T, V = args[0].shape[0], args[0].shape[-1]
        rec.update(near_pairs=near,
                   issue_floor_ms=self.issue_ms(near * 2 * V * (3 * 6 + 1)))
        return (f"{near} near pairs ({near / T:.1f} a track), issue floor "
                f"{rec['issue_floor_ms']:.4f} ms")

    def pack_pairs(self):
        """{kernel name: (wrapper, plain version, dt)} of kernels 2, 2.5."""
        from hand_tracking_samples_tpu_torch.ops.cloud_rows import (
            cloud_rows_packed, cloud_rows_packed_plain, cloud_rows_solve,
            cloud_rows_solve_plain)
        return {"cloud_rows_solve": (cloud_rows_solve, cloud_rows_solve_plain,
                                     self.params.deltaT),
                "cloud_rows_packed": (cloud_rows_packed,
                                      cloud_rows_packed_plain, 0.0)}

    def synthetic_pack_inputs(self, dt):
        """Seeded T=4 inputs (ops.cloud_rows.synthetic_cloud around
        phase 3's poses): N=2048 with a crowded body that wins more than
        128 active points (its slots thinned), a quarter of the points
        inactive and points on body centres (inner-sphere winners); and
        N=32, the smallest N the kernels take."""
        torch = self.torch
        from hand_tracking_samples_tpu_torch.model.hand import (
            PHYSICS_WEAK_FORCE)
        from hand_tracking_samples_tpu_torch.ops.cloud_rows import (
            _kernel_inputs_ph, synthetic_cloud)
        pose = self.init_state(4).body.pose
        B = pose.shape[1]
        scale_b = torch.where(torch.arange(B, device=self.dev) <= 2,
                              PHYSICS_WEAK_FORCE, 1.0).float()
        rest = _kernel_inputs_ph(pose, self.model, (0.01, -0.02, 0.3),
                                 scale_b, dt) + (128,)
        return {f"synthetic N={n}": (synthetic_cloud(pose, n, seed=n),)
                + rest for n in (2048, 32)}

    def hold_pack(self, k, p, name):
        """Kernel 2 or 2.5 equals its plain version: the counts and every
        channel of every slot, bit for bit."""
        torch = self.torch
        (kp, kc), (pp, pc) = k, p
        check(torch.equal(kc, pc), f"{name}: counts differ")
        err = (kp - pp).abs().max().item()
        check(torch.equal(kp, pp), f"{name} differs from its plain version: "
              f"{err}")
        slots = int((pp[:, 0:3] != 0).any(1).sum())
        thinned = int((pc > pp.shape[2] // 24).sum())
        return err, (f"packed {err:.3g} ({slots} slots, {thinned} bodies "
                     f"thinned)")

    def compare_pack(self):
        """Phase 12: kernels 2 and 2.5 against their plain versions, bit
        for bit, at T=4 and at T=512 (one cutting-plane frame in), N=2048
        and N=512, and on the seeded synthetic inputs at T=4."""
        lines = []
        self.pack_err = {}
        for T in (4, TRACKS):
            st = self.init_state(T)
            if T == TRACKS:
                st, _ = self.run(st, 1, T,
                                 cfg=self.cloud_cfg("mirror", plane=CUT_PLANE))
            for name, (kfn, pfn, dt) in self.pack_pairs().items():
                inp = {f"N={n}": a for n, a in self.pack_inputs(
                    st, self.depth_frame(1, T), dt).items()}
                if T == 4:
                    inp.update(self.synthetic_pack_inputs(dt))
                for label, args in inp.items():
                    err, note = self.hold_pack(kfn(*args), pfn(*args), name)
                    self.pack_err[f"{name} T={T} {label}"] = err
                    lines.append(f"{name} T={T} {label} {note}")
        for name in self.pack_pairs():
            self.results[name]["max_abs_err_pack"] = max(
                v for k, v in self.pack_err.items() if k.startswith(name))
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
        and launch counts, and kernels 2 and 2.5 at both N (CUDA events)
        beside their plain versions and their bounds."""
        torch = self.torch
        from hand_tracking_samples_tpu_torch import kernels
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
        for name, (kfn, pfn, dt) in self.pack_pairs().items():
            r = self.results[name]
            for n, args in self.pack_inputs(st, self.depth_frame(1, T),
                                            dt).items():
                ms, k = self.event_ms(kfn, args, warm=2, reps=10)
                plain_ms, p = self.event_ms(pfn, args, warm=0, reps=1)
                err, note = self.hold_pack(k, p, name)
                nbytes, ops = self.work(name, args)
                tb, to = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_S * 1e3
                res = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=max(tb, to),
                           bound_by="bytes" if tb >= to else "operations",
                           library_ms=None, bytes=nbytes, operations=ops,
                           scan_issue_ms=self.scan_issue_ms(args))
                # kernel 2.5's row: the far-mirror dynamics pass's N=2048
                # (kernel 2's is phase 5's, on the plain cloud)
                if n == 2048 and name == "cloud_rows_packed":
                    r.update(res)
                r[f"n{n}"] = res
                parts.append(f"{name} N={n} {ms:.4f} ms (plain "
                             f"{plain_ms:.2f} ms, bound {max(tb, to):.4f} ms"
                             f" by {res['bound_by']}, winner scan's issue "
                             f"{res['scan_issue_ms']:.4f} ms; {note})")
        return f"T={T}: " + "; ".join(parts)


    # ---- the CNN frame on the reference solvers: phases 15-16 --------------
    def cnn_ref_cfg(self, solver, use_pallas=True, **kw):
        from hand_tracking_samples_tpu_torch.tracker.config import (
            TrackerConfig)
        return TrackerConfig(cnn_every_frame=True, cnn_every_k=1,
                             solver=solver, use_pallas=use_pallas,
                             point_budget=2048, **kw)

    def cnn_ref_inputs(self, st, depth):
        """The reference CNN frame's new kernel shapes for state st and
        depth (T, H, W): kernel 8 on MultiStepSim's subsample (N=512), the
        row sweep on MultiStepSim's step-1 rows (keypoints, cloud,
        ApplyAngles, the arm cone, joints, contacts, ranges) for the
        sequential and the colored solve, and on the one-body rows of
        UnibodyFit without the kernels (at the PoseFromScratch pose)."""
        from hand_tracking_samples_tpu_torch.model.hand import body_params
        from hand_tracking_samples_tpu_torch.ops import correspondence as oc
        from hand_tracking_samples_tpu_torch.physics.colored import (
            colored_sweep_inputs)
        from hand_tracking_samples_tpu_torch.physics.schedule import (
            build_hand_schedule)
        from hand_tracking_samples_tpu_torch.physics.solver import (
            sweep_inputs)
        from hand_tracking_samples_tpu_torch.tracker import runtime as rt
        cfg, m, body = self.cnn_ref_cfg("sequential"), self.model, st.body
        it, ip = cfg.physics_iterations, cfg.physics_iterations_post
        seg, an, _, _, ph = rt._cnn_frame_inputs(self.cnn, depth, self.cam,
                                                 cfg)
        cam = seg.cam.pose
        ms = rt.multistep_reference_cloud(ph, cam, cfg, m.n_bodies)
        pw = oc.world_planes(body.pose, m)
        out = {"correspondence": (oc.points_h(ms.points), pw,
                                  oc.origin_dots(pw, m, ms.origin))}
        for name, sched, fn in (
                ("row_sweep", None, sweep_inputs),
                ("row_sweep[colored]", build_hand_schedule(m.np),
                 colored_sweep_inputs)):
            lin, ang = rt.multistep_rows(body, m, an, ms, cam, cfg,
                                         self.params, 1, sched)
            mom0, rows = fn(body, body_params(m), lin, ang, self.params)
            out[name] = (mom0, m.massinv, rows, it, ip)
        b0 = rt.pose_from_scratch(body, m, an, ph, cam)
        ust, ubody, blk = rt.unibody_rows(b0, m, ph, cam[:, :3],
                                          cfg.unibody_force)
        mom0, rows = colored_sweep_inputs(ust, ubody, [blk], [], self.params)
        out["row_sweep[unibody]"] = (mom0, ubody.massinv, rows, it, ip)
        return out

    def ref_sweep_fns(self):
        from hand_tracking_samples_tpu_torch.ops.correspondence import (
            correspondence_reductions, correspondence_reductions_plain)
        from hand_tracking_samples_tpu_torch.physics.row_sweep import (
            row_sweep, row_sweep_plain)
        sweep = (row_sweep, row_sweep_plain)
        return {"correspondence": (correspondence_reductions,
                                   correspondence_reductions_plain),
                "row_sweep": sweep, "row_sweep[colored]": sweep,
                "row_sweep[unibody]": sweep}

    def golden_cnn(self, use_pallas):
        """The C++ goldens with their net (assets/handposedd_synth.cnnb) on
        the sequential solver, T=2 tracks from the start pose on the cached
        dyn30 renders: synctrack_atc (always_take_cnn, bank frames 0, 2,
        .., 22; every frame's mean joint deviation < 3 mm and their mean <
        2.5 mm, tests/test_tracker_e2e.py:148-150) and synctrack_trained's
        first 2 frames (bank 0, 7; every coordinate within 5 mm, :116)."""
        torch, np = self.torch, self.np
        from hand_tracking_samples_tpu_torch.cnn.model import load_cnnb
        from hand_tracking_samples_tpu_torch.parallel.tracks import (
            batched_tracker_state, batched_update)
        from hand_tracking_samples_tpu_torch.tracker.config import (
            TrackerConfig)
        if not hasattr(self, "golden_net"):
            path = os.path.join(REPO, "assets", "handposedd_synth.cnnb")
            check(os.path.exists(path), f"the C++ goldens' net {path} is "
                  f"missing")
            self.golden_net = load_cnnb(path, self.dev)
        with open(os.path.join(REPO, "tests", "fixtures", "golden.json")) as f:
            g = json.load(f)
        out = {}
        for name, frames, stride, kw in (
                ("synctrack_atc", 12, 2, dict(always_take_cnn=True)),
                ("synctrack_trained", 2, 7, {})):
            cfg = TrackerConfig(point_budget=2048, use_pallas=use_pallas,
                                **kw)
            ref = torch.tensor(np.asarray(g[f"{name}_poses"], np.float32)
                               .reshape(-1, 17, 7), device=self.dev)
            st = batched_tracker_state(self.model, 2)
            devs = []
            for f in range(frames):
                d = self.dyn[(f * stride) % len(self.dyn)].expand(2, -1, -1)
                st, _ = batched_update(st, self.model, self.golden_net,
                                       d.contiguous(), self.cam, cfg,
                                       self.params)
                diff = st.body.pose[..., :3] - ref[f][:, :3]
                devs.append(diff.norm(dim=-1).mean(-1).max().item()
                            if name == "synctrack_atc"
                            else diff.abs().max().item())
            devs = np.asarray(devs)
            mm = " ".join(f"{x * 1e3:.3f}" for x in devs)
            if name == "synctrack_atc":
                check((devs < 3e-3).all() and devs.mean() < 2.5e-3,
                      f"{name} (use_pallas={use_pallas}): mean joint "
                      f"deviation per frame [{mm}] mm")
            else:
                check((devs < 5e-3).all(), f"{name} (use_pallas="
                      f"{use_pallas}): largest deviation per frame [{mm}] mm")
            out[name] = devs.tolist()
        return out

    def cnn_ref_slice(self):
        """Phase 15: the sequential CNN frame (use_pallas=True) at T=512 x
        8 frames on phase 7's renders and groups (CNN_BAND_MM); the C++
        goldens with use_pallas True and False; colored against sequential
        at 2048 cloud rows a body over 3 CNN frames; use_pallas=False on
        the card with its peak memory; 2-track CPU re-runs of each
        configuration's first frame; kernel 8 at N=512 and the row sweep
        on MultiStepSim's and UnibodyFit's rows bit for bit at T=4 and
        T=512."""
        torch = self.torch
        from hand_tracking_samples_tpu_torch import kernels
        from hand_tracking_samples_tpu_torch.physics.pgs_kernel import (
            pgs_solve)
        T, F = CNN_TRACKS, CNN_FRAMES
        cfg = self.cnn_ref_cfg("sequential")
        grp = self.reset_group(T)
        bank = torch.tensor(self.bank, device=self.dev)
        fmt = lambda v: " ".join(f"{e:.2f}" for e in v)
        box = []

        def keep(st):
            je = (st.body.pose[..., :3] - bank[30 + len(box)][:, :3]).norm(
                dim=-1).mean(-1)
            box.append(0)
            return (je[~grp].mean(), je[~grp].max(), je[grp].mean(),
                    je[grp].max(), st.body.pose[[0, 3]].clone())
        kernels.reset_counts()
        st, hist = self.cnn_run(self.cnn_state(T), F, T, keep=keep, cfg=cfg)
        counts = kernels.counts()
        kinds = dict(pgs_solve.kinds)
        torch.cuda.synchronize()
        check(all(counts[k] > 0 for k in REF_CNN_PATH),
              f"a kernel of the path did not launch: {counts}")
        check(counts["cloud_rows_solve"] == 0
              and counts["cloud_rows_packed"] == 0 and set(kinds) == {"uni"},
              f"a kernel solver's kernel launched: {counts}, plans {kinds}")
        check(bool(torch.isfinite(st.body.pose).all()), "non-finite poses")
        gt_mean, gt_max, rs_mean, rs_max = (
            torch.stack([x[i] for x in hist]).cpu().numpy() * 1e3
            for i in range(4))
        band = CNN_BAND_MM
        check(gt_max.max() < band["gt"] and rs_max[0] < band["reset_first"]
              and rs_max[-1] < band["reset_last"],
              f"sequential CNN frame outside {band}: on-hand tracks per "
              f"frame [{fmt(gt_max)}] mm, reset tracks [{fmt(rs_max)}] mm")
        self.cnn_ref_final = st
        cpu = {"sequential": self.cnn_cpu_reference([hist[0][4]], cfg)}
        lines = [f"sequential T={T} F={F}: joint err on-hand "
                 f"[{fmt(gt_mean)}] mm, reset [{fmt(rs_mean)}] mm; launches "
                 f"{counts}, PGS plans {kinds}"]

        # the C++ goldens
        golden = {f"use_pallas_{up}": self.golden_cnn(up)
                  for up in (True, False)}
        lines.append("C++ goldens: " + "; ".join(
            f"{k} {n} [{fmt([x * 1e3 for x in v])}] mm"
            for k, r in golden.items() for n, v in r.items()))

        # colored against sequential, no cloud row thinned
        Tc = COLORED_CNN_TRACKS
        cmp = []
        for solver in ("sequential", "colored"):
            c = self.cnn_ref_cfg(solver, cloud_rows_per_body=2048)
            _, h = self.cnn_run(self.cnn_state(Tc), 3, Tc, cfg=c,
                                keep=lambda s: s.body.pose.clone())
            cmp.append(h)
        cerr = max((a[..., :3] - b[..., :3]).abs().max().item()
                   for a, b in zip(*cmp))
        qerr = max(quat_err(a[..., 3:], b[..., 3:]) for a, b in zip(*cmp))
        check(cerr < COLORED_M and qerr < COLORED_QUAT,
              f"colored CNN frame differs from sequential: {cerr} m, quat "
              f"{qerr}")
        cpu["colored"] = self.cnn_cpu_reference(
            [cmp[1][0][[0, 3]]], self.cnn_ref_cfg("colored",
                                                  cloud_rows_per_body=2048))
        lines.append(f"colored vs sequential (2048 rows a body, T={Tc}, 3 "
                     f"frames) {cerr:.3g} m, quat {qerr:.3g}")

        # use_pallas=False on the card: 2 tracks against the CPU, the peak
        # memory of one frame at NOPALLAS_MEM_TRACKS
        nop = self.cnn_ref_cfg("sequential", use_pallas=False)
        idx = torch.tensor([0, 3], device=self.dev)
        full = self.cnn_state(4)
        st2 = type(full)(type(full.body)(*[x[idx] for x in full.body]),
                         full.prev_frame_error[idx], full.initializing[idx])
        kernels.reset_counts()
        _, h = self.cnn_run(st2, 1, 4, idx=idx, cfg=nop,
                            keep=lambda s: s.body.pose.clone())
        ncounts = kernels.counts()
        check(all(ncounts[k] == 0 for k in ("correspondence", "cloud_vals",
                                            "cloud_rows_unpacked",
                                            "pgs_solve"))
              and ncounts["row_sweep"] > 0 and ncounts["contact_fields"] > 0,
              f"use_pallas=False launched: {ncounts}")
        cpu["sequential_nopallas"] = self.cnn_cpu_reference(h, nop)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m0 = torch.cuda.memory_allocated()
        Tn = NOPALLAS_MEM_TRACKS
        self.cnn_run(self.cnn_state(Tn), 1, Tn, cfg=nop)
        torch.cuda.synchronize()
        npeak = (torch.cuda.max_memory_allocated() - m0) / 2**30
        lines.append(f"use_pallas=False: launches {ncounts}; peak at T={Tn} "
                     f"{npeak:.3f} GiB")
        lines.append("CPU plain reference (first frame, reset included) "
                     + ", ".join(f"{k} {v:.2g} m" for k, v in cpu.items()))

        # the new kernel shapes against their plain versions, bit for bit
        errs = {}
        fns = self.ref_sweep_fns()
        for t in (4, T):
            inp = self.cnn_ref_inputs(self.cnn_state(t),
                                      self.cnn_depth(1, t))
            for name, (kfn, pfn) in fns.items():
                err, _ = self.hold_ref(name, kfn(*inp[name]),
                                       pfn(*inp[name]))
                errs[f"{name}_t{t}"] = err
        lines.append("kernel 8 at N=512 and the row sweep on MultiStepSim's "
                     "and UnibodyFit's rows vs plain: " + ", ".join(
                         f"{k} {v:.3g}" for k, v in errs.items()))
        self.cnn_ref_stats = dict(
            gt_joint_err_mm_per_frame=gt_mean.tolist(),
            gt_joint_err_mm_max_per_frame=gt_max.tolist(),
            reset_joint_err_mm_per_frame=rs_mean.tolist(),
            reset_joint_err_mm_max_per_frame=rs_max.tolist(),
            launches=counts, pgs_plans=kinds, golden_dev_m=golden,
            colored_vs_sequential_m=cerr, colored_vs_sequential_quat=qerr,
            nopallas_launches=ncounts, nopallas_peak_gib=npeak,
            nopallas_peak_tracks=Tn, cpu_reference_err_m=cpu,
            new_shapes_max_abs_err=errs)
        return "; ".join(lines)

    def cnn_ref_timing(self):
        """Phase 16: both CNN frames on the reference solvers
        (use_pallas=True) at T=512: frame time, device busy and idle, the
        launches of the timed frames; then kernel 8 at N=512 and the row
        sweep on MultiStepSim's and UnibodyFit's rows timed (CUDA events)
        beside their plain versions and bounds."""
        torch = self.torch
        from hand_tracking_samples_tpu_torch import kernels
        T, F = CNN_TRACKS, REF_CNN_TIMED_FRAMES
        self.cnn_ref_speed = {}
        parts = []
        for solver in ("sequential", "colored"):
            cfg = self.cnn_ref_cfg(solver)
            run = lambda st, fr, t, cfg=cfg: self.cnn_run(st, fr, t, cfg=cfg)
            run(self.cnn_state(T), 1, T)                          # warm
            torch.cuda.synchronize()
            kernels.reset_counts()
            t0 = time.perf_counter()
            run(self.cnn_state(T), F, T)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = {k: v for k, v in kernels.counts().items() if v}
            prof = self.profile(T, 2, run=run, state=self.cnn_state(T))
            self.cnn_ref_speed[solver] = dict(
                tracks=T, frames=F, seconds=dt, ms_per_frame=dt / F * 1e3,
                tracked_fps=T * F / dt, launches=counts, **prof)
            # idle: the timed frames' host clock less the device's busy
            # time (the profiled frames' own clock carries the profiler)
            idle = dt / F * 1e3 - prof.get("device_ms_per_frame", 0.0)
            self.cnn_ref_speed[solver]["idle_ms_per_frame"] = idle
            busy = (f"device busy {prof['device_ms_per_frame']:.2f} ms, idle "
                    f"{idle:.1f} ms ({idle / (dt / F * 1e3):.0%}) (port "
                    f"kernels {prof['port_kernels_ms_per_frame']:.2f}"
                    f", {prof['torch_launches_per_frame']:.0f} PyTorch "
                    f"launches {prof['torch_ops_ms_per_frame']:.2f})"
                    if "device_ms_per_frame" in prof
                    else f"profile not measured ({prof['profile_error']})")
            parts.append(f"{solver} CNN frame {dt / F * 1e3:.1f} ms, "
                         f"{T * F / dt:.1f} tracked frames/s, {busy}, "
                         f"launches {counts}")
        inp = self.cnn_ref_inputs(self.cnn_ref_final,
                                  self.cnn_depth(CNN_FRAMES - 1, T))
        self.cnn_ref_shapes = {}
        for name, (kfn, pfn) in self.ref_sweep_fns().items():
            args = inp[name]
            ms, k = self.event_ms(kfn, args, warm=2, reps=5)
            plain_ms, p = self.event_ms(pfn, args, warm=0, reps=1)
            err, note = self.hold_ref(name, k, p)
            rec = {}
            nbytes, ops = self.work_ref(name, args, rec)
            tb, to = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_S * 1e3
            rec.update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=max(tb, to),
                       bound_by="bytes" if tb >= to else "operations",
                       bytes=nbytes, operations=ops)
            if name != "correspondence":
                note += "; " + self.waves(name, args, rec)
            key = REF_CNN_SHAPES[name]
            self.cnn_ref_shapes[key] = rec
            parts.append(f"{key} {ms:.4f} ms (plain {plain_ms:.1f} ms, bound "
                         f"{max(tb, to):.4f} ms by {rec['bound_by']}; {note})")
        parts.append(self.unpacked_reset_subset())
        return f"T={T}: " + "; ".join(parts)

    def unpacked_reset_subset(self):
        """Kernel 6 at the shape the CNN frames launch it with: the tracks
        that reset on the first frame (every 4th, T=128 of 512), at their
        PoseFromScratch poses; timed beside its plain version and its bound
        (the hull-plane evaluations its exit makes on these inputs and the
        row pass), recorded as the kernel's "reset_t128"."""
        name = "cloud_rows_unpacked"
        inp = self.cnn_kernel_inputs(self.cnn_state(CNN_TRACKS),
                                     self.cnn_depth(0, CNN_TRACKS))
        grp = self.reset_group(CNN_TRACKS)
        args = tuple(x[grp].contiguous() for x in inp[name])
        kfn, pfn = self.pairs_of()[name]
        ms, k = self.event_ms(kfn, args, warm=2, reps=10)
        plain_ms, p = self.event_ms(pfn, args, warm=0, reps=1)
        err, note = self.hold(name, k, p)
        saved = dict(self.results[name])          # scan_exit records here
        note += "; " + self.scan_exit(name, args)
        nbytes, ops = self.work(name, args)
        tb, to = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_S * 1e3
        rec = {k: self.results[name][k] for k in (
            "exit_skipped_share", "hull_plane_evals", "exit_issue_floor_ms")}
        rec.update(tracks=int(grp.sum()), max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, bound_ms=max(tb, to),
                   bound_by="bytes" if tb >= to else "operations",
                   bytes=nbytes, operations=ops)
        self.results[name] = dict(saved, reset_t128=rec)
        return (f"{name} on the reset tracks (T={rec['tracks']}) {ms:.4f} "
                f"ms (plain {plain_ms:.2f} ms, bound {rec['bound_ms']:.4f} "
                f"ms by {rec['bound_by']}; {note})")

    # ---- slowfit: phase 17 ---------------------------------------------
    def slowfit_inputs(self, T):
        """(state, points, mask, start poses, render poses) at T tracks:
        track t on the dyn30 render f = 1 + t % 29, from bank[f - 1]; the
        annotate CLI's cloud (apps.annotate.points_of)."""
        torch = self.torch
        from hand_tracking_samples_tpu_torch.apps.annotate import points_of
        from hand_tracking_samples_tpu_torch.parallel.tracks import (
            batched_tracker_state)
        fr = 1 + torch.arange(T, device=self.dev) % 29
        bank = torch.tensor(self.bank, device=self.dev)
        pts, mask = points_of(self.dyn[fr], self.cam)
        st = batched_tracker_state(self.model, T)
        st = st._replace(body=st.body._replace(pose=bank[fr - 1].clone()))
        return st, pts, mask, bank[fr - 1], bank[fr]

    def slowfit_kw(self, variant, start):
        torch = self.torch
        if variant == "hold":
            return dict(hold=2, refpose=start)
        if variant == "nail":
            bone, dx = SLOWFIT_NAIL
            return dict(select_bone=bone, spoint=start[:, bone, :3]
                        + torch.tensor([dx, 0.0, 0.0], device=start.device),
                        rbpoint=torch.zeros_like(start[:, 0, :3]))
        return {}

    def slowfit_call(self, variant, inp, use_pallas=True, model=None):
        from hand_tracking_samples_tpu_torch.tracker.config import (
            TrackerConfig)
        from hand_tracking_samples_tpu_torch.tracker.runtime import slowfit
        st, pts, mask, start, _ = inp
        cfg = TrackerConfig(point_budget=2048, solver="sequential",
                            use_pallas=use_pallas)
        return slowfit(st, model or self.model, pts, mask, cfg, self.params,
                       steps=SLOWFIT_STEPS, **self.slowfit_kw(variant, start))

    def slowfit_kernel_inputs(self, inp, fitted):
        """The kernels' inputs at slowfit's shapes (SLOWFIT_SHAPES), from
        the fitted states of the hold and plain variants."""
        from hand_tracking_samples_tpu_torch.model.hand import body_params
        from hand_tracking_samples_tpu_torch.ops import correspondence as oc
        from hand_tracking_samples_tpu_torch.physics.contact_kernel import (
            contact_inputs)
        from hand_tracking_samples_tpu_torch.physics.solver import (
            sweep_inputs)
        from hand_tracking_samples_tpu_torch.tracker.config import (
            TrackerConfig)
        from hand_tracking_samples_tpu_torch.tracker.runtime import (
            slowfit_rows)
        torch, m = self.torch, self.model
        _, pts, mask, start, _ = inp
        cfg = TrackerConfig(point_budget=2048, solver="sequential",
                            use_pallas=True)
        hold, plain = fitted["hold"].body, fitted["plain"].body
        pw = oc.world_planes(plain.pose, m)
        out = {"correspondence": (oc.points_h(pts), pw,
                                  oc.origin_dots(pw, m, (0.0, 0.0, 0.0))),
               "contact_fields": contact_inputs(
                   hold.pose, hold.linear_momentum, hold.angular_momentum,
                   m) + (torch.as_tensor(m.np["collide_pairs"],
                                         device=self.dev), 4, 3,
                         self.params.driftmax)}
        it, ip = cfg.physics_iterations, cfg.physics_iterations_post
        for name, body, st, kw in (
                ("row_sweep", hold, 0, self.slowfit_kw("hold", start)),
                ("row_sweep[last]", plain, SLOWFIT_STEPS - 1, {})):
            lin, ang = slowfit_rows(body, m, pts, mask, cfg, self.params,
                                    st, SLOWFIT_STEPS, **kw)
            mom0, rows = sweep_inputs(body, body_params(m), lin, ang,
                                      self.params)
            out[name] = (mom0, m.massinv, rows, it, ip)
        return out

    def slowfit_phase(self):
        """Phase 17: slowfit (use_pallas, 6 solves) at T=512 in its three
        variants, every kernel of its path launched; the plain fit no
        further from the renders' poses than its start, the nail within
        4 mm; a 2-track CPU re-run of each variant (< 1e-4 m);
        use_pallas=False at T=64 with its peak memory; kernels 3 and 8 and
        the row sweep bit for bit with their plain versions at slowfit's
        shapes, timed beside their bounds; the plain call's host clock,
        device busy time and launches."""
        torch, np = self.torch, self.np
        from hand_tracking_samples_tpu_torch import kernels
        from hand_tracking_samples_tpu_torch.model.bake import (
            from_numpy_model)
        T = SLOWFIT_TRACKS
        inp = self.slowfit_inputs(T)
        st0, _, mask, start, truth = inp
        je = lambda p: (p[..., :3] - truth[..., :3]).norm(dim=-1).mean(-1)
        self.slowfit_call("plain", inp)                          # warm
        torch.cuda.synchronize()
        fitted, stats, lines = {}, {}, []
        for variant in SLOWFIT_VARIANTS:
            kernels.reset_counts()
            t0 = time.perf_counter()
            res = self.slowfit_call(variant, inp)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = {k: v for k, v in kernels.counts().items() if v}
            check(set(counts) == set(SLOWFIT_PATH),
                  f"slowfit {variant}: launches {counts}, its path is "
                  f"{SLOWFIT_PATH}")
            pose = res.body.pose
            check(bool(torch.isfinite(pose).all()),
                  f"slowfit {variant}: non-finite poses")
            fitted[variant] = res
            rec = dict(seconds=dt, launches=counts,
                       joint_dev_mm=je(pose).mean().item() * 1e3,
                       start_joint_dev_mm=je(start).mean().item() * 1e3)
            note = ""
            if variant == "nail":
                bone, _ = SLOWFIT_NAIL
                d = (pose[:, bone, :3]
                     - self.slowfit_kw("nail", start)["spoint"]).norm(dim=-1)
                rec.update(nail_mm_max=d.max().item() * 1e3,
                           nail_mm_mean=d.mean().item() * 1e3)
                check(d.max().item() < SLOWFIT_NAIL_M,
                      f"nailed bone up to {d.max().item() * 1e3:.2f} mm "
                      f"from its target")
                note = (f", bone {bone} {rec['nail_mm_mean']:.2f} mm from "
                        f"its target (largest {rec['nail_mm_max']:.2f})")
            if variant == "plain":
                check(rec["joint_dev_mm"] <= rec["start_joint_dev_mm"],
                      f"slowfit moved the tracks away from the renders: "
                      f"{rec['joint_dev_mm']:.3f} mm, start "
                      f"{rec['start_joint_dev_mm']:.3f} mm")
            stats[variant] = rec
            lines.append(f"{variant} {dt * 1e3:.1f} ms, joint dev "
                         f"{rec['joint_dev_mm']:.3f} mm (start "
                         f"{rec['start_joint_dev_mm']:.3f}){note}, launches "
                         f"{counts}")

        # tracks 0 and 1 through the plain versions on the CPU
        cpu_model = from_numpy_model(self.model.np, "cpu")
        two = _first(inp, 2, "cpu")
        cpu = {}
        for variant in SLOWFIT_VARIANTS:
            ref = self.slowfit_call(variant, two, model=cpu_model).body.pose
            err = (fitted[variant].body.pose[:2, :, :3].cpu()
                   - ref[..., :3]).abs().max().item()
            check(err < 1e-4, f"slowfit {variant}: the CPU plain versions "
                  f"differ by {err} m")
            cpu[variant] = err
        lines.append("CPU plain reference (2 tracks) " + ", ".join(
            f"{k} {v:.2g} m" for k, v in cpu.items()))

        # use_pallas=False: the plane dots at T=64, its peak memory
        Tn = NOPALLAS_MEM_TRACKS
        small = _first(inp, Tn)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m0 = torch.cuda.memory_allocated()
        kernels.reset_counts()
        nres = self.slowfit_call("plain", small, use_pallas=False)
        torch.cuda.synchronize()
        npeak = (torch.cuda.max_memory_allocated() - m0) / 2**30
        ncounts = {k: v for k, v in kernels.counts().items() if v}
        check(set(ncounts) == {"contact_fields", "row_sweep"},
              f"slowfit use_pallas=False launched {ncounts}")
        ndiff = (nres.body.pose[..., :3]
                 - fitted["plain"].body.pose[:Tn, :, :3]).abs().max().item()
        lines.append(f"use_pallas=False at T={Tn}: peak {npeak:.3f} GiB, "
                     f"launches {ncounts}, {ndiff:.3g} m from use_pallas")

        # the kernels at slowfit's shapes, bit for bit, timed
        kin = self.slowfit_kernel_inputs(inp, fitted)
        pairs = self.pairs_of()
        fns = dict(self.ref_sweep_fns(),
                   contact_fields=pairs["contact_fields"])
        fns["row_sweep[last]"] = fns["row_sweep"]
        self.slowfit_shapes = {}
        for name, key in SLOWFIT_SHAPES.items():
            kfn, pfn = fns[name]
            args = kin[name]
            ms, k = self.event_ms(kfn, args, warm=2, reps=5)
            plain_ms, p = self.event_ms(pfn, args, warm=0, reps=1)
            rec = {}
            if name == "contact_fields":
                err, note = self.hold(name, k, p)
                nbytes, ops = self.work(name, args)
                note += "; " + self.contact_floor(args, rec)
            else:
                base = "row_sweep" if name.startswith("row_sweep") else name
                err, note = self.hold_ref(base, k, p)
                nbytes, ops = self.work_ref(base, args, rec)
                if base == "row_sweep":
                    note += "; " + self.waves(base, args, rec)
            tb, to = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_S * 1e3
            rec.update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=max(tb, to),
                       bound_by="bytes" if tb >= to else "operations",
                       bytes=nbytes, operations=ops,
                       launches=stats["hold"]["launches"][
                           name.split("[")[0]])
            self.slowfit_shapes[key] = rec
            lines.append(f"{key} {ms:.4f} ms (plain {plain_ms:.1f} ms, "
                         f"bound {max(tb, to):.4f} ms by {rec['bound_by']}; "
                         f"{note})")

        # the plain call's host clock, device busy time and launches
        secs = []
        for _ in range(SLOWFIT_TIMED_CALLS):
            t0 = time.perf_counter()
            self.slowfit_call("plain", inp)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)

        def run(st, calls, t):
            for _ in range(calls):
                st = self.slowfit_call("plain", (st,) + inp[1:])
            return st, None
        prof = self.profile(T, 1, run=run, state=st0)
        ms = float(np.mean(secs)) * 1e3
        self.slowfit_speed = dict(tracks=T, calls=len(secs),
                                  ms_per_call=ms,
                                  ms_each=[x * 1e3 for x in secs], **prof)
        if "device_ms_per_frame" in prof:
            busy = prof["device_ms_per_frame"]
            idle = ms - busy
            self.slowfit_speed["idle_ms_per_call"] = idle
            lines.append(
                f"plain call {ms:.1f} ms host ({', '.join(f'{x * 1e3:.1f}' for x in secs)}), "
                f"device busy {busy:.2f} ms, idle {idle:.1f} ms "
                f"({idle / ms:.0%}) (port kernels "
                f"{prof['port_kernels_ms_per_frame']:.2f} ms, "
                f"{prof['launches_per_frame']:.0f} launches, of them "
                f"{prof['torch_launches_per_frame']:.0f} PyTorch "
                f"{prof['torch_ops_ms_per_frame']:.2f} ms)")
        else:
            lines.append(f"plain call {ms:.1f} ms host; profile not "
                         f"measured ({prof['profile_error']})")
        self.slowfit_stats = dict(
            variants=stats, cpu_reference_err_m=cpu,
            nopallas_peak_gib=npeak, nopallas_tracks=Tn,
            nopallas_launches=ncounts, nopallas_vs_pallas_m=ndiff,
            points_mean=mask.sum(1).float().mean().item())
        return f"T={T}: " + "; ".join(lines)

    # ---- phase 18: jacobi contacts, angles-only, kickstart_multi, the
    # kernel solver without use_pallas, the synthetic-track CLI ---------------
    def jacobi_kernels(self):
        """The PGS kernel's jacobi class (dynamics and multistep plans) and
        the row sweep's jacobi levels (the colored solve's jacobi rows) on
        the contact poses' rows: bit for bit with their plain versions at
        T=4 and T=512, timed at T=512 beside their bounds, with their
        clock64 counters; the count of active contact rows (it must be >
        0); the same kernels with exact contacts on the same poses, timed
        (the baseline); and the PGS kernel's jacobi class bit for bit on
        seeded edge inputs at T=4 (JACOBI_EDGES)."""
        from types import SimpleNamespace
        from hand_tracking_samples_tpu_torch.physics.row_sweep import (
            jacobi_phases)
        torch = self.torch
        frames, body = self.contact_poses()
        depth = self.contact_depth(frames)
        st = SimpleNamespace(body=body)
        dyn = self.kernel_inputs(st, depth, "jacobi")
        cnn = self.cnn_kernel_inputs(st, depth, "jacobi")
        ref = self.ref_inputs(body, depth, "jacobi")
        cases = {"pgs_solve[jacobi]": (dyn["pgs_solve"], dyn["P"]),
                 "pgs_solve[jacobi, multistep]": (
                     cnn["pgs_solve[multistep]"],
                     cnn["P"]["pgs_solve[multistep]"]),
                 "row_sweep[colored, jacobi]": (ref["row_sweep[colored]"],
                                                None)}
        pairs = dict(self.pairs_of(), **self.ref_sweep_fns())
        lines = []
        for name, (args, P) in cases.items():
            pgs = name.startswith("pgs")
            kfn, pfn = pairs["pgs_solve" if pgs else "row_sweep"]
            if pgs:
                plan, lin = args[0], args[6]
                k = [i for i, c in enumerate(plan.lin_classes) if c.jacobi]
                check(len(k) == 1, f"{name}: no jacobi class in the plan")
                nact = int((lin[k[0]][:, :, 15] != 0).sum())
                n = 4
                small = args[:3] + (args[3][:n], args[4],
                                    args[5][:n] if args[5] is not None
                                    else None,
                                    [r[:n] for r in args[6]],
                                    [r[:n] for r in args[7]])
            else:
                lm = args[2].lm
                nact = int(((((lm >> 16) & 1) == 1)
                            & (jacobi_phases(lm) >= 0)).sum())
                rows = args[2]
                small = (args[0][:4], args[1], rows._replace(
                    lf=rows.lf[:4].contiguous(),
                    af=rows.af[:4].contiguous())) + args[3:]
            check(nact > 0, f"{name}: no active contact row")
            e4 = (kfn(*small) - pfn(*small)).abs().max().item()
            check(e4 == 0.0, f"{name} at T=4 differs from its plain "
                  f"version: {e4}")
            ms, kout = self.event_ms(kfn, args, warm=2, reps=10)
            plain_ms, pout = self.event_ms(pfn, args, warm=0, reps=1)
            rec = self.results[name]
            if pgs:
                err, note = self.hold("pgs_solve", kout, pout, P)
                nbytes, ops = self.work("pgs_solve", args)
            else:
                err, note = self.hold_ref("row_sweep", kout, pout)
                nbytes, ops = self.work_ref("row_sweep", args, rec)
                note += "; " + self.waves("row_sweep", args, rec)
            tb, to = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_S * 1e3
            rec.update(max_abs_err=err, max_abs_err_t4=e4, ms=ms,
                       plain_ms=plain_ms, bound_ms=max(tb, to),
                       bound_by="bytes" if tb >= to else "operations",
                       library_ms=None, bytes=nbytes, operations=ops,
                       active_contact_rows=nact)
            note += "; " + self.cycles(name, args)
            lines.append(f"{name} {ms:.4f} ms (plain {plain_ms:.1f} ms, "
                         f"bound {max(tb, to):.4f} ms by {rec['bound_by']}; "
                         f"{nact} active contact rows; T=4 {e4:.3g}; "
                         f"{note})")
        # the baseline: exact contacts on the same poses' rows
        dyn = self.kernel_inputs(st, depth)
        cnn = self.cnn_kernel_inputs(st, depth)
        ref = self.ref_inputs(body, depth)
        base = {"pgs_solve[jacobi]": dyn["pgs_solve"],
                "pgs_solve[jacobi, multistep]": cnn["pgs_solve[multistep]"],
                "row_sweep[colored, jacobi]": ref["row_sweep[colored]"]}
        self.p18["exact_baseline"] = {}
        for name, args in base.items():
            pgs = name.startswith("pgs")
            kfn = pairs["pgs_solve" if pgs else "row_sweep"][0]
            ms, _ = self.event_ms(kfn, args, warm=2, reps=10)
            rec = self.p18["exact_baseline"][name] = dict(ms=ms)
            lines.append(f"exact contacts, {name}'s rows: {ms:.4f} ms "
                         f"({self.cycles(name, args, rec)})")
        # seeded edge inputs of the PGS kernel's jacobi class, T=4
        from hand_tracking_samples_tpu_torch.physics.pgs_kernel import (
            synthetic_jacobi_inputs)
        kfn, pfn = pairs["pgs_solve"]
        edge = {}
        for label, (n, na, dead) in JACOBI_EDGES.items():
            args = synthetic_jacobi_inputs(4, n, na, 11, dead, 6, 2,
                                           device=self.dev)
            k, p = kfn(*args), pfn(*args)
            e = (k - p).abs().max().item()
            check(torch.equal(k, p), f"pgs_solve[jacobi] on {label} differs "
                  f"from its plain version: {e}")
            check(not torch.equal(p[:, 1], args[3]),
                  f"pgs_solve[jacobi] on {label}: the momenta did not move")
            edge[label] = e
        self.p18["jacobi_edges_t4"] = edge
        lines.append("jacobi class at T=4 on " + ", ".join(
            f"{k} {v:.3g}" for k, v in edge.items()))
        return "; ".join(lines)

    def frames_of(self, cfg, frames, T, cnn=False, state=None):
        """(seconds, launch counts, the PGS and row sweep kinds, per-frame
        poses) of `frames` frames of cfg at T tracks from state (default
        phase 4's or phase 7's start)."""
        torch = self.torch
        from hand_tracking_samples_tpu_torch import kernels
        from hand_tracking_samples_tpu_torch.physics.pgs_kernel import (
            pgs_solve)
        from hand_tracking_samples_tpu_torch.physics.row_sweep import (
            row_sweep)
        run = self.cnn_run if cnn else self.run
        st0 = state if state is not None else (
            self.cnn_state(T) if cnn else self.init_state(T))
        kernels.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, hist = run(st0, frames, T, keep=lambda s: s.body.pose.clone(),
                      cfg=cfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return (dt, {k: v for k, v in kernels.counts().items() if v},
                dict(pgs_solve.kinds), dict(row_sweep.kinds), hist)

    def contact_run(self, st, depth, frames, cfg):
        """`frames` dynamics frames of cfg from st on the fixed renders
        depth: (launch counts, the PGS and row sweep kinds, per-frame
        poses)."""
        torch = self.torch
        from hand_tracking_samples_tpu_torch import kernels
        from hand_tracking_samples_tpu_torch.parallel.tracks import (
            batched_update)
        from hand_tracking_samples_tpu_torch.physics.pgs_kernel import (
            pgs_solve)
        from hand_tracking_samples_tpu_torch.physics.row_sweep import (
            row_sweep)
        kernels.reset_counts()
        hist = []
        for _ in range(frames):
            st, _ = batched_update(st, self.model, None, depth, self.cam,
                                   cfg, self.params)
            hist.append(st.body.pose)
        check(bool(torch.isfinite(st.body.pose).all()),
              "contact-pose frames: non-finite poses")
        return ({k: v for k, v in kernels.counts().items() if v},
                dict(pgs_solve.kinds), dict(row_sweep.kinds), hist)

    def contact_cpu_reference(self, body, depth, poses, cfg):
        """The two tracks with the most active contact rows at body (T, ..)
        through the plain versions on the CPU, len(poses) frames of cfg on
        the renders depth from the contact state: (the largest position
        difference from the card's per-frame poses, the two tracks, the
        active contact rows of the two at each frame's start, each > 0)."""
        from hand_tracking_samples_tpu_torch.model.bake import from_numpy_model
        from hand_tracking_samples_tpu_torch.parallel.tracks import (
            batched_tracker_state, batched_update)
        from hand_tracking_samples_tpu_torch.physics.contacts import (
            contact_rows)
        model = from_numpy_model(self.model.np, "cpu")
        act = contact_rows(body, self.model, self.params).active.sum(-1)
        idx = act.topk(2).indices.sort().values
        st = batched_tracker_state(model, 2)
        st = st._replace(body=type(body)(*[x[idx].cpu() for x in body]))
        d = depth[idx].cpu()
        err, nact = 0.0, []
        for ref in poses:
            nact.append(int(contact_rows(st.body, model, self.params)
                            .active.sum()))
            st, _ = batched_update(st, model, None, d, self.cam, cfg,
                                   self.params)
            err = max(err, (st.body.pose[..., :3] - ref[idx][..., :3].cpu())
                      .abs().max().item())
        check(min(nact) > 0, f"contact-pose CPU re-run: a frame with no "
              f"active contact row ({nact})")
        check(err < 1e-4, f"contact-pose frames: CPU plain reference "
              f"differs: {err} m")
        return err, idx.tolist(), nact

    def speed_of(self, cfg, T, cnn=False, state=None):
        """Device busy time and launches a frame of cfg (profile)."""
        run = self.cnn_run if cnn else self.run
        return self.profile(T, 2, run=lambda st, fr, t: run(st, fr, t,
                                                             cfg=cfg),
                            state=state)

    def busy_note(self, prof, ms):
        if "device_ms_per_frame" not in prof:
            return f"profile not measured ({prof['profile_error']})"
        busy = prof["device_ms_per_frame"]
        return (f"device busy {busy:.2f} ms, idle {ms - busy:.1f} ms "
                f"({(ms - busy) / ms:.0%}), port kernels "
                f"{prof['port_kernels_ms_per_frame']:.2f} ms, "
                f"{prof['launches_per_frame']:.0f} launches")

    def jacobi_frames(self):
        """The dynamics frame with jacobi contacts on the kernel solver (30
        frames) and the colored one (10) on phase 4's renders: each
        frame's largest distance from the exact-contacts frame on the same
        renders, the even tracks' dyntrack golden errors, the time; the
        same frames at the contact poses on their renders (3 frames), where
        contact rows are active, so the PGS kernel's jacobi class and the
        row sweep's jacobi levels run in the frame (their launches are
        counted there), and the gap between the two solvers' poses there
        with jacobi and with exact contacts; a 2-track CPU re-run of each
        solver's jacobi frames at the contact poses (the two tracks with
        the most active contact rows; each frame has some); two CNN frames
        with jacobi contacts (the multistep plan's jacobi class)."""
        import dataclasses
        torch, np = self.torch, self.np
        T = TRACKS
        even = torch.arange(0, T, 2, device=self.dev)
        lines, stats, finals = [], {}, {}
        for solver, F in JACOBI_FRAMES.items():
            exact = self.cfg if solver == "kernel" else self.ref_cfg(solver)
            cfg = dataclasses.replace(exact, contacts_mode="jacobi")
            self.run(self.init_state(T), 1, T, cfg=cfg)             # warm
            dt, counts, pk, rk, hist = self.frames_of(cfg, F, T)
            check(solver != "kernel" or (pk.get("dyn_jacobi", 0) == F
                                         and "dyn" not in pk),
                  f"jacobi kernel frames: PGS plans {pk}")
            # at the contact poses: the jacobi class and levels in use
            Fc = JACOBI_CONTACT_FRAMES
            frames, body = self.contact_poses()
            depth = self.contact_depth(frames)
            st = self.init_state(T)._replace(body=body)
            c_counts, c_pk, c_rk, chist = self.contact_run(st, depth, Fc,
                                                           cfg)
            finals[solver, "jacobi"] = chist[-1]
            finals[solver, "exact"] = self.contact_run(st, depth, Fc,
                                                       exact)[3][-1]
            if solver == "kernel":
                check(c_pk.get("dyn_jacobi", 0) == Fc,
                      f"jacobi kernel frames at the contact poses: PGS "
                      f"plans {c_pk}")
                self.results["pgs_solve[jacobi]"]["launches"] = \
                    c_pk["dyn_jacobi"]
            else:
                check(c_rk.get("jacobi", 0) == Fc,
                      f"jacobi colored frames at the contact poses: row "
                      f"sweep {c_rk}")
                self.results["row_sweep[colored, jacobi]"]["launches"] = \
                    c_rk["jacobi"]
            _, _, _, _, ehist = self.frames_of(exact, F, T)
            dist = [(a[..., :3] - b[..., :3]).abs().max().item()
                    for a, b in zip(hist, ehist)]
            gold = [(h[even, :, :3] - self.ref[f][:, :3]).norm(dim=-1)
                    .mean(-1).max().item() * 1e3 for f, h in enumerate(hist)]
            check(all(bool(torch.isfinite(h).all()) for h in hist),
                  f"jacobi {solver} frames: non-finite poses")
            cpu, cpu_tracks, cpu_act = self.contact_cpu_reference(
                body, depth, chist, cfg)
            ms = dt / F * 1e3
            prof = self.speed_of(cfg, T)
            stats[solver] = dict(frames=F, ms_per_frame=ms, launches=counts,
                                 pgs_kinds=pk, sweep_kinds=rk,
                                 contact_launches=c_counts,
                                 contact_pgs_kinds=c_pk,
                                 contact_sweep_kinds=c_rk,
                                 from_exact_m=dist, golden_mm=gold,
                                 cpu_reference_err_m=cpu,
                                 cpu_reference_tracks=cpu_tracks,
                                 cpu_reference_active_contact_rows=cpu_act,
                                 **prof)
            lines.append(
                f"{solver}: {ms:.1f} ms a frame ({self.busy_note(prof, ms)}"
                f"); from the exact frame max {max(dist) * 1e3:.4f} mm "
                f"(per frame " + " ".join(f"{d * 1e3:.3f}" for d in dist)
                + f"); dyn30 golden max {max(gold):.3f} mm, mean "
                f"{np.mean(gold):.3f} mm; launches {counts}; at the contact "
                f"poses {Fc} frames, launches {c_counts}, PGS plans {c_pk}, "
                f"row sweep {c_rk}, CPU re-run of tracks {cpu_tracks} "
                f"{cpu:.2g} m (active contact rows a frame {cpu_act})")
        # the kernel solver against the colored one at the contact poses
        gap = {m: (finals["kernel", m][..., :3] - finals["colored", m]
                   [..., :3]).abs().max().item() for m in ("jacobi", "exact")}
        stats["kernel_vs_colored_m"] = gap
        lines.append(f"kernel against colored at the contact poses after "
                     f"{JACOBI_CONTACT_FRAMES} frames: jacobi "
                     f"{gap['jacobi']:.3g} m, exact {gap['exact']:.3g} m")
        # the CNN frame with jacobi contacts: the multistep plan's class
        cfg = dataclasses.replace(self.cnn_cfg, contacts_mode="jacobi")
        dt, counts, pk, _, hist = self.frames_of(cfg, JACOBI_CNN_FRAMES,
                                                 CNN_TRACKS, cnn=True)
        check(pk.get("ms_jacobi", 0) > 0 and pk.get("dyn_jacobi", 0) > 0,
              f"jacobi CNN frames: PGS plans {pk}")
        check(all(bool(torch.isfinite(h).all()) for h in hist),
              "jacobi CNN frames: non-finite poses")
        self.results["pgs_solve[jacobi, multistep]"]["launches"] = \
            pk["ms_jacobi"]
        stats["cnn"] = dict(frames=JACOBI_CNN_FRAMES, seconds=dt,
                            launches=counts, pgs_kinds=pk)
        lines.append(f"CNN frame: {dt / JACOBI_CNN_FRAMES * 1e3:.1f} ms a "
                     f"frame, PGS plans {pk}")
        self.p18["jacobi"] = stats
        return "; ".join(lines)

    def angles_only(self):
        """The angles-only CNN frame on the kernel solver, 8 frames at
        T=512 on phase 7's renders: every track resets and takes the
        refit, no main-thread pass; timed; kernels 6 and 7 bit for bit on
        the second frame's own inputs (T=512: the FitError at the state
        after the first frame, the first UnibodyFit step of every track's
        reset), timed beside their bounds; a 2-track CPU re-run of its first
        frame."""
        import dataclasses
        torch, np = self.torch, self.np
        T, F = CNN_TRACKS, ANGLES_FRAMES
        cfg = dataclasses.replace(self.cnn_cfg, angles_only=True)
        st1, _ = self.cnn_run(self.cnn_state(T), 1, T, cfg=cfg)     # warm
        dt, counts, pk, _, hist = self.frames_of(cfg, F, T, cnn=True)
        need = dict(cloud_rows_unpacked=3 * F, cloud_vals=2 * F)
        check(all(counts.get(k) == v for k, v in need.items())
              and pk.get("uni") == 3 * F and pk.get("ms") == 5 * F
              and "dyn" not in pk,
              f"angles-only launches {counts}, PGS plans {pk}")
        truth = torch.tensor(self.bank[30:30 + F], device=self.dev)
        je = [(h[..., :3] - truth[f][:, :3]).norm(dim=-1).mean().item()
              * 1e3 for f, h in enumerate(hist)]
        check(all(bool(torch.isfinite(h).all()) for h in hist),
              "angles-only: non-finite poses")
        ms = dt / F * 1e3
        prof = self.speed_of(cfg, T, cnn=True, state=self.cnn_state(T))
        cpu = self.cnn_cpu_reference([hist[0][[0, 3]]], cfg)
        # kernels 6 and 7 on the second frame's inputs: every track resets
        inp = self.cnn_kernel_inputs(st1, self.cnn_depth(1, T))
        parts = []
        for name in ("cloud_rows_unpacked", "cloud_vals"):
            key = f"{name}[angles-only]"
            kfn, pfn = self.pairs_of()[name]
            args = inp[name]
            kms, k = self.event_ms(kfn, args, warm=2, reps=10)
            plain_ms, p = self.event_ms(pfn, args, warm=0, reps=1)
            err, note = self.hold(name, k, p)
            saved = dict(self.results[name])     # scan_exit records there
            note += "; " + self.scan_exit(name, args)
            nbytes, ops = self.work(name, args)
            tb, to = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_S * 1e3
            rec = {x: self.results[name][x] for x in (
                "exit_skipped_share", "hull_plane_evals",
                "exit_issue_floor_ms", "issue_floor_ms")}
            self.results[name] = saved
            rec.update(max_abs_err=err, ms=kms, plain_ms=plain_ms,
                       bound_ms=max(tb, to),
                       bound_by="bytes" if tb >= to else "operations",
                       library_ms=None, bytes=nbytes, operations=ops,
                       launches=counts[name])
            self.results[key].update(rec)
            parts.append(f"{key} {kms:.4f} ms (plain {plain_ms:.2f} ms, "
                         f"bound {rec['bound_ms']:.4f} ms by "
                         f"{rec['bound_by']}; {note})")
        self.p18["angles_only"] = dict(
            frames=F, ms_per_frame=ms, launches=counts, pgs_kinds=pk,
            joint_err_mm=je, cpu_reference_err_m=cpu, **prof)
        return (f"{ms:.1f} ms a frame ({self.busy_note(prof, ms)}); mean "
                f"joint error per frame " + " ".join(f"{x:.2f}" for x in je)
                + f" mm; CPU re-run {cpu:.2g} m; launches {counts}; "
                + "; ".join(parts))

    def kickstart(self):
        """kickstart_multi at 128 tracks x 4 hypotheses (512 fits) from the
        rest pose on phase 7's renders: the mean joint error to the ground
        truth before and after, the time, the launches; two tracks'
        hypotheses re-run on the CPU."""
        torch = self.torch
        from hand_tracking_samples_tpu_torch import kernels
        from hand_tracking_samples_tpu_torch.cnn.model import from_numpy
        from hand_tracking_samples_tpu_torch.model.bake import (
            from_numpy_model)
        from hand_tracking_samples_tpu_torch.parallel.tracks import (
            batched_tracker_state)
        from hand_tracking_samples_tpu_torch.tracker.runtime import (
            kickstart_hypotheses, kickstart_multi)
        T, H, cfg = KICK_TRACKS, KICK_HYP, self.cnn_cfg
        f = torch.arange(T, device=self.dev) % 8
        depth = self.fake[f]
        truth = torch.tensor(self.bank[30:38], device=self.dev)[f]
        st = batched_tracker_state(self.model, T)
        je = lambda p: (p[..., :3] - truth[..., :3]).norm(dim=-1).mean()
        kickstart_multi(st, self.model, self.cnn, depth, self.cam, cfg,
                        self.params, n_hyp=H)                      # warm
        kernels.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, _ = kickstart_multi(st, self.model, self.cnn, depth, self.cam,
                                 cfg, self.params, n_hyp=H)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {k: v for k, v in kernels.counts().items() if v}
        pose = new.body.pose
        check(bool(torch.isfinite(pose).all()), "kickstart: non-finite")
        before, after = je(st.body.pose).item(), je(pose).item()
        check(after < before, f"kickstart_multi moved the tracks away: "
              f"{after * 1e3:.2f} mm, before {before * 1e3:.2f} mm")
        check(counts.get("cloud_rows_unpacked") == cfg.steps_unibody
              and counts.get("cloud_vals") == 1,
              f"kickstart_multi launches {counts}")
        # tracks 0 and 1 on the CPU: every hypothesis and its score
        bodies, score, _ = kickstart_hypotheses(
            st, self.model, self.cnn, depth, self.cam, cfg, self.params,
            n_hyp=H)
        cm = from_numpy_model(self.model.np, "cpu")
        cc = from_numpy({k: {kk: vv.cpu().numpy() for kk, vv in v.items()}
                         for k, v in self.cnn.items()}, "cpu")
        two = batched_tracker_state(cm, 2)
        cb, cs, _ = kickstart_hypotheses(two, cm, cc, depth[:2].cpu(),
                                         self.cam, cfg, self.params,
                                         n_hyp=H)
        cpu = (bodies.pose[:2, ..., :3].cpu() - cb.pose[..., :3]).abs() \
            .max().item()
        check(cpu < 1e-4, f"kickstart_multi: the CPU re-run differs by "
              f"{cpu} m")
        srel = ((score[:2].cpu() - cs).abs() / cs.abs()).max().item()
        self.p18["kickstart"] = dict(
            tracks=T, hypotheses=H, seconds=dt, launches=counts,
            joint_err_before_mm=before * 1e3, joint_err_after_mm=after * 1e3,
            cpu_reference_err_m=cpu, cpu_score_rel=srel,
            chosen=torch.bincount(score.argmin(1), minlength=H).tolist())
        return (f"T={T} x {H} hypotheses: {dt * 1e3:.1f} ms; mean joint "
                f"error {before * 1e3:.2f} -> {after * 1e3:.2f} mm; chosen "
                f"{self.p18['kickstart']['chosen']}; CPU re-run {cpu:.2g} "
                f"m, scores {srel:.2g} relative; launches {counts}")

    def kernel_nopallas(self):
        """The dynamics frame on the kernel solver with use_pallas=False at
        T=64 for 10 frames: its peak memory, its distance from the
        use_pallas=True frames, no cloud-rows kernel launched; a 2-track
        CPU re-run."""
        import dataclasses
        torch = self.torch
        T, F = NOPALLAS_TRACKS, NOPALLAS_FRAMES
        cfg = dataclasses.replace(self.cfg, use_pallas=False)
        _, _, _, _, ref = self.frames_of(self.cfg, F, T)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m0 = torch.cuda.memory_allocated()
        dt, counts, pk, _, hist = self.frames_of(cfg, F, T)
        peak = (torch.cuda.max_memory_allocated() - m0) / 2**30
        check(not any(k.startswith("cloud_rows") for k in counts)
              and pk.get("dyn") == F,
              f"use_pallas=False launches {counts}, PGS plans {pk}")
        dist = max((a[..., :3] - b[..., :3]).abs().max().item()
                   for a, b in zip(hist, ref))
        check(all(bool(torch.isfinite(h).all()) for h in hist),
              "use_pallas=False: non-finite poses")
        cpu = self.cpu_reference([h[:2] for h in hist[:REF_CPU_FRAMES]], cfg)
        self.p18["nopallas"] = dict(tracks=T, frames=F, seconds=dt,
                                    peak_gib=peak, from_pallas_m=dist,
                                    launches=counts,
                                    cpu_reference_err_m=cpu)
        return (f"T={T}: {dt / F * 1e3:.1f} ms a frame, peak {peak:.3f} "
                f"GiB, {dist:.3g} m from use_pallas; CPU re-run {cpu:.2g} "
                f"m; launches {counts}")

    def synthetic_cli(self):
        """The synthetic-track CLI as two subprocesses on the card, run
        together, with and without --dynamics-only: each exits 0 and
        prints its error lines."""
        np = self.np
        t0 = time.perf_counter()
        procs = {("dynamics-only" if extra else "CNN"): subprocess.Popen(
            [sys.executable, "-m", f"{PORT}.apps.synthetic_track",
             *CLI_ARGS, *extra], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
            for extra in ((), ("--dynamics-only",))}
        out = {}
        for label, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            check(proc.returncode == 0, f"synthetic_track {label}: exit "
                  f"{proc.returncode}: {stderr[-400:]}")
            errs = [float(x.split("err")[1].split()[0])
                    for x in stdout.splitlines() if x.startswith("frame")]
            check(len(errs) == 2 and all(np.isfinite(errs)),
                  f"synthetic_track {label}: {stdout[-400:]}")
            out[label] = dict(seconds=time.perf_counter() - t0,
                              frame_err_mm=errs,
                              last_line=stdout.strip().splitlines()[-1])
        self.p18["cli"] = out
        return "; ".join(f"{k} {v['seconds']:.1f} s, frames "
                         f"{v['frame_err_mm']} mm, {v['last_line']}"
                         for k, v in out.items())

    def phase18(self):
        """Phase 18: jacobi contacts, the angles-only frame,
        kickstart_multi, the kernel solver without use_pallas and the
        synthetic-track CLI."""
        self.p18 = {}
        for k in P18_ROWS:
            self.results.setdefault(k, {})
        if getattr(self, "cnn", None) is None:
            self.cnn_setup()
        return self.parts(18, (("kernels", self.jacobi_kernels),
                               ("jacobi frames", self.jacobi_frames),
                               ("angles-only", self.angles_only),
                               ("kickstart_multi", self.kickstart),
                               ("use_pallas=False", self.kernel_nopallas),
                               ("CLI", self.synthetic_cli)))


    # ---- phase 19: the C++ goldens -----------------------------------------
    def recording(self, name):
        """A fixture recording: (its camera, its depth (F, H, W) on the
        card, its recorded poses (F, 17, 7) as NumPy)."""
        if not hasattr(self, "_recs"):
            self._recs = {}
        if name not in self._recs:
            from hand_tracking_samples_tpu_torch.data.dataset import (
                load_dataset)
            from hand_tracking_samples_tpu_torch.ops.cloud_kernel import (
                depth_tensor)
            path = os.path.join(REPO, "tests", "fixtures", name)
            check(os.path.exists(path + ".rs"), f"{path}.rs is missing")
            ds = load_dataset(path)
            self._recs[name] = (ds.info.camera(),
                                depth_tensor(ds.depth, self.dev), ds.pose)
        return self._recs[name]

    def cpu_copies(self):
        """The model and the trained net as CPU copies."""
        if not hasattr(self, "_cpu"):
            from hand_tracking_samples_tpu_torch.cnn.model import (
                from_numpy, to_numpy)
            from hand_tracking_samples_tpu_torch.model.bake import (
                from_numpy_model)
            self._cpu = (from_numpy_model(self.model.np, "cpu"),
                         from_numpy(to_numpy(self.cnn), "cpu"))
        return self._cpu

    def golden_frames(self, st, depth, cam, cfg, cnn, run_cnn, model=None):
        """Frames f = 0.. of depth (F, T, H, W) from st through
        batched_update (run_cnn(f) its run_cnn): [pose per frame]."""
        from hand_tracking_samples_tpu_torch.parallel.tracks import (
            batched_update)
        hist = []
        for f in range(len(depth)):
            st, _ = batched_update(st, model or self.model, cnn, depth[f],
                                   cam, cfg, self.params, run_cnn=run_cnn(f))
            hist.append(st.body.pose.clone())
        return hist

    def cpu_gap(self, label, card, cpu):
        """The largest position gap between the card's and the CPU's poses
        (lists of (T, 17, 7)); fails above 1e-4 m."""
        err = max((a[..., :3].cpu() - b[..., :3]).abs().max().item()
                  for a, b in zip(card, cpu))
        check(err < 1e-4, f"{label}: CPU plain reference differs: {err} m")
        return err

    def cadence_case(self, case):
        """One case of CADENCE_CASES at T=1 on the colored CNN frame, the
        CNN on frames f % k == 0, at its gates: (refname, its record, its
        recording, k, its first GOLDEN_CPU_FRAMES poses as NumPy)."""
        torch, np = self.torch, self.np
        from hand_tracking_samples_tpu_torch.parallel.tracks import (
            batched_tracker_state)
        from hand_tracking_samples_tpu_torch.tracker.config import (
            TrackerConfig)
        (rec, refname, F, devgate, jeslack, ratio, meanslack,
         meandev) = case
        t0 = time.perf_counter()
        cam, depth, gt = self.recording(rec)
        with open(os.path.join(REPO, "tests", "fixtures",
                               refname + ".json")) as f:
            ref = json.load(f)
        k, F = ref["k"], min(F, ref["n_frames"])
        refp = np.asarray(ref["cnntrack_poses"], np.float32).reshape(
            ref["n_frames"], 17, 7)[:F]
        ref_je = np.asarray(ref["cnntrack_joint_err"])[:F]
        cfg = TrackerConfig(cnn_every_frame=True, cnn_every_k=k,
                            solver="colored")
        hist = self.golden_frames(
            batched_tracker_state(self.model, 1), depth[:F, None], cam,
            cfg, self.cnn, lambda f: f % k == 0)
        mine = torch.stack(hist)[:, 0].cpu().numpy()
        devs = np.linalg.norm(mine[..., :3] - refp[..., :3],
                              axis=-1).mean(-1)
        jes = np.linalg.norm(mine[..., :3] - gt[:F, :, :3],
                             axis=-1).mean(-1)
        bad = [f for f in range(F)
               if (devgate is not None and devs[f] >= devgate)
               or jes[f] >= ref_je[f] + jeslack]
        rec_ = dict(k=k, frames=F, seconds=time.perf_counter() - t0,
                    dev_max_mm=float(devs.max() * 1e3),
                    dev_mean_mm=float(devs.mean() * 1e3),
                    je_mean_mm=float(jes.mean() * 1e3),
                    ref_je_mean_mm=float(ref_je.mean() * 1e3),
                    je_minus_ref_max_mm=float((jes - ref_je).max() * 1e3))
        check(not bad, f"{refname}: frames {bad[:6]}: deviation "
              f"{np.round(devs[bad[:6]] * 1e3, 2)} mm, joint error "
              f"{np.round(jes[bad[:6]] * 1e3, 2)} against the "
              f"reference's {np.round(ref_je[bad[:6]] * 1e3, 2)} mm")
        check(jes.mean() < ref_je.mean() * ratio + meanslack,
              f"{refname}: mean joint error {rec_['je_mean_mm']:.2f} "
              f"mm, the reference's {rec_['ref_je_mean_mm']:.2f}")
        check(devs.mean() < meandev, f"{refname}: mean deviation "
              f"{rec_['dev_mean_mm']:.2f} mm")
        return (refname, rec_, rec, k,
                [h.cpu().numpy() for h in hist[:GOLDEN_CPU_FRAMES]])

    def cadence(self):
        """The recorded CNN cadence (tests/test_cnntrack_golden.py): the
        cases of CADENCE_CASES (cadence_case), in CADENCE_WORKERS spawned
        processes at once (each case is a host-bound T=1 run); then both
        recordings' first GOLDEN_CPU_FRAMES frames as 2 tracks on the CPU,
        k = 1 and k > 1 (cnn_every_k is read only by track_sequences:
        every k > 1 runs the same first frames)."""
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        torch = self.torch
        from hand_tracking_samples_tpu_torch.parallel.tracks import (
            batched_tracker_state)
        from hand_tracking_samples_tpu_torch.tracker.config import (
            TrackerConfig)
        check(sorted(i for w in CADENCE_WORKERS for i in w)
              == list(range(len(CADENCE_CASES))),
              "CADENCE_WORKERS must run every case once")
        # a worker that dies ends the map with BrokenProcessPool
        with ProcessPoolExecutor(
                len(CADENCE_WORKERS),
                mp_context=multiprocessing.get_context("spawn")) as pool:
            done = [r for rs in pool.map(_cadence_worker, CADENCE_WORKERS)
                    for r in rs]
        by_name = {r[0]: r for r in done}
        out, first = {}, {}
        for case in CADENCE_CASES:
            refname, rec_, rec, k, frames = by_name[case[1]]
            out[refname] = rec_
            first[refname] = (rec, k, [torch.from_numpy(h) for h in frames])
        recs = ("cnntrack_rec", "cnntrack_rec2")
        cam = self.recording(recs[0])[0]
        check(all(self.recording(r)[0] == cam for r in recs),
              "the cadence recordings' cameras differ")
        d = torch.stack([self.recording(r)[1][:GOLDEN_CPU_FRAMES]
                         for r in recs], 1).cpu()
        mc, cc = self.cpu_copies()
        gaps = {}
        for kk in (1, 4):
            cfg = TrackerConfig(cnn_every_frame=True, cnn_every_k=kk,
                                solver="colored")
            cpu = self.golden_frames(batched_tracker_state(mc, 2), d, cam,
                                     cfg, cc, lambda f: f % kk == 0,
                                     model=mc)
            for refname, (rec, k, card) in first.items():
                if (k == 1) == (kk == 1):
                    t = recs.index(rec)
                    gaps[refname] = self.cpu_gap(refname, card,
                                                 [c[t:t + 1] for c in cpu])
        self.p19["cadence"] = dict(cases=out, cpu_gap_m=gaps)
        return "; ".join(
            f"{n} (k={v['k']}, {v['frames']} frames, {v['seconds']:.1f} s): "
            f"deviation max {v['dev_max_mm']:.2f} mean "
            f"{v['dev_mean_mm']:.2f} mm, joint error {v['je_mean_mm']:.2f}"
            f" (reference {v['ref_je_mean_mm']:.2f}) mm, CPU "
            f"{gaps[n]:.1e} m" for n, v in out.items())

    def bank_renders(self, fids):
        """The port's fake_depth renders of bank[fids] (F, T) -> (F, T, H,
        W) on the card."""
        from hand_tracking_samples_tpu_torch.data.synth import fake_depth
        F, T = fids.shape
        d = fake_depth(self.torch.tensor(self.bank[fids.reshape(-1)],
                                         device=self.dev),
                       self.model, self.cam, chunk=8)
        return d.reshape(F, T, *d.shape[1:])

    def coldstart(self):
        """Cold-start acquisition (tests/test_coldstart_gate.py:32-58): 8
        tracks from the rest pose with initializing=50, 8 colored CNN
        frames on renders of 8 animbank segments."""
        torch, np = self.torch, self.np
        from hand_tracking_samples_tpu_torch.parallel.tracks import (
            batched_tracker_state)
        from hand_tracking_samples_tpu_torch.tracker.config import (
            TrackerConfig)
        T, F = 8, 8
        starts = (np.arange(0, 64, 8) * 211) % (len(self.bank) - 64)
        fids = starts[None, :] + np.arange(F)[:, None]
        depth = self.bank_renders(fids)
        cfg = TrackerConfig(cnn_every_frame=True, solver="colored")

        def start(model, n):
            st = batched_tracker_state(model, n)
            return st._replace(initializing=torch.full(
                (n,), 50, dtype=torch.int32, device=model.device))
        hist = self.golden_frames(start(self.model, T), depth, self.cam, cfg,
                                  self.cnn, lambda f: None)
        e = np.stack([np.linalg.norm(h.cpu().numpy()[..., :3]
                                     - self.bank[fids[f]][..., :3],
                                     axis=-1).mean(-1)
                      for f, h in enumerate(hist)])
        means = e.mean(1)
        fin = e[-1]
        rec = dict(mean_mm=(means * 1e3).tolist(),
                   final_mm=(fin * 1e3).tolist(),
                   median_final_mm=float(np.median(fin) * 1e3),
                   converged=int((fin < 0.008).sum()))
        self.p19["coldstart"] = rec
        check(means[0] < 0.045, f"cold start: frame-0 acquisition "
              f"{means[0] * 1e3:.1f} mm")
        check(means[-1] < 0.0075, f"cold start: frame-7 mean "
              f"{means[-1] * 1e3:.1f} mm")
        check(np.median(fin) < 0.003, f"cold start: frame-7 median "
              f"{rec['median_final_mm']:.1f} mm")
        check(rec["converged"] >= 5, f"cold start: only {rec['converged']}"
              f"/8 starts converged: {np.round(fin * 1e3, 1)}")
        check(means[-1] < 0.4 * means[0], "cold start: no progress")
        idx = [0, 4]
        mc, cc = self.cpu_copies()
        cpu = self.golden_frames(start(mc, len(idx)),
                                 depth[:GOLDEN_CPU_FRAMES, idx].cpu(),
                                 self.cam, cfg, cc, lambda f: None, model=mc)
        rec["cpu_gap_m"] = self.cpu_gap("cold start", [h[idx] for h in
                                                       hist], cpu)
        return (f"mean per frame {np.round(means * 1e3, 2)} mm, finals "
                f"{np.round(fin * 1e3, 2)} mm ({rec['converged']}/8 under "
                f"8 mm), CPU {rec['cpu_gap_m']:.1e} m")

    def fastdrift(self):
        """The fast-drift golden (tests/test_bench_parity.py:84-123): the
        bench row configuration on the colored solver, T=8 from the poses
        of 8 fast animbank segments, the fixture's frame count, the final
        per-track joint error against fastdrift_ref.json's."""
        torch, np = self.torch, self.np
        from hand_tracking_samples_tpu_torch.parallel.tracks import (
            batched_tracker_state)
        from hand_tracking_samples_tpu_torch.tracker.config import (
            TrackerConfig)
        with open(os.path.join(REPO, "tests", "fixtures",
                               "fastdrift_ref.json")) as f:
            fdref = json.load(f)
        T, F = 8, fdref["n_frames"]
        cfg = TrackerConfig(point_budget=2048, cnn_every_frame=False,
                            cloud_rows_per_body=128, solver="colored")
        starts = (np.arange(T) * 37) % (len(self.bank) - F)
        fids = starts[None, :] + np.arange(F)[:, None]
        depth = self.bank_renders(fids)

        def start(model, idx):
            st = batched_tracker_state(model, len(idx))
            return st._replace(body=st.body._replace(pose=torch.tensor(
                self.bank[fids[0][idx]], device=model.device)))
        hist = self.golden_frames(start(self.model, list(range(T))), depth,
                                  self.cam, cfg, None, lambda f: None)
        fin = np.linalg.norm(hist[-1].cpu().numpy()[..., :3]
                             - self.bank[fids[-1]][..., :3],
                             axis=-1).mean(-1)
        ref = np.asarray(fdref["final_err_per_track"])[:T]
        ratio = fin.mean() / ref.mean()
        rec = dict(final_mm=(fin * 1e3).tolist(),
                   reference_mm=(ref * 1e3).tolist(), ratio=float(ratio))
        self.p19["fastdrift"] = rec
        for t in range(T):
            if ref[t] < 0.02:
                check(abs(fin[t] - ref[t]) < max(0.004, 0.5 * ref[t]),
                      f"fast drift track {t}: {fin[t] * 1e3:.1f} mm, the "
                      f"reference's {ref[t] * 1e3:.1f}")
            else:
                check(fin[t] < 1.6 * ref[t] + 0.01, f"fast drift track {t}:"
                      f" {fin[t] * 1e3:.1f} mm, the reference's "
                      f"{ref[t] * 1e3:.1f}")
        check(0.6 < ratio < 1.4, f"fast drift: aggregate ratio {ratio:.2f}")
        idx = [0, 3]
        mc, _ = self.cpu_copies()
        cpu = self.golden_frames(start(mc, idx),
                                 depth[:GOLDEN_CPU_FRAMES, idx].cpu(),
                                 self.cam, cfg, None, lambda f: None,
                                 model=mc)
        rec["cpu_gap_m"] = self.cpu_gap("fast drift",
                                        [h[idx] for h in hist], cpu)
        return (f"finals {np.round(fin * 1e3, 2)} mm against "
                f"{np.round(ref * 1e3, 2)}, ratio {ratio:.3f}, CPU "
                f"{rec['cpu_gap_m']:.1e} m")

    def contact_sweep(self):
        """The contact sweep (tests/test_contact_sweep.py): the reference-
        layout contact rows of the 20 sweep poses (one batch) against the
        reference's pairs and depths, then 3 joint-and-contact updates from
        each pose on the sequential solver with no cloud."""
        torch, np = self.torch, self.np
        from hand_tracking_samples_tpu_torch.model.hand import (
            fit_point_cloud)
        from hand_tracking_samples_tpu_torch.physics.contacts import (
            contact_rows)
        from hand_tracking_samples_tpu_torch.physics.solver import BodyState
        with open(os.path.join(REPO, "tests", "fixtures",
                               "contact_sweep_ref.json")) as f:
            sweep = json.load(f)["frames"]
        fr = [e["frame"] for e in sweep]

        def state(model, idx):
            z = torch.zeros((len(idx), 17, 3), device=model.device)
            return BodyState(torch.tensor(self.bank[[fr[i] for i in idx]],
                                          device=model.device), z, z)

        def solve(st, model, n):
            T, dev = st.pose.shape[0], st.pose.device
            hist = []
            for _ in range(n):
                st = fit_point_cloud(st, model, self.params,
                                     torch.zeros((T, 0, 3), device=dev),
                                     torch.zeros((T, 0), dtype=torch.bool,
                                                 device=dev), contacts=True)
                hist.append(st.pose.clone())
            return hist
        every = list(range(len(fr)))
        rows = contact_rows(state(self.model, every), self.model,
                            self.params)
        act = (rows.active & (rows.friction_master == 0)).cpu().numpy()
        b0, b1 = rows.b0.cpu().numpy(), rows.b1.cpu().numpy()
        td = rows.targetdist.cpu().numpy()
        total = missing = extra = 0
        depth_err, per_frame = [], []
        for t, entry in enumerate(sweep):
            mine = {}
            for a, b, d in zip(b0[t][act[t]], b1[t][act[t]], td[t][act[t]]):
                key = (int(a), int(b))
                mine[key] = min(mine.get(key, np.inf), float(d))
            ref = {(int(p[0]), int(p[1])): float(p[2])
                   for p in entry["pairs"]}
            total += len(ref)
            m, x = len(set(ref) - set(mine)), len(set(mine) - set(ref))
            missing, extra = missing + m, extra + x
            per_frame.append((m, x))
            depth_err += [abs(ref[k] - mine[k]) for k in set(ref) & set(mine)]
            check(m <= 3 and x <= 9, f"contact sweep frame {entry['frame']}:"
                  f" {m} pairs missing, {x} extra")
        depth_err = np.asarray(depth_err)
        check(missing <= total // 20, f"contact sweep: {missing} of {total} "
              f"pairs missing")
        check(depth_err.mean() < 1.6e-3 and depth_err.max() < 6e-3,
              f"contact sweep: depth error mean {depth_err.mean()} max "
              f"{depth_err.max()} m")
        hist = solve(state(self.model, every), self.model, 3)
        ref3 = np.asarray([e["pose3"] for e in sweep], np.float32)
        dev = np.linalg.norm(hist[-1].cpu().numpy()[..., :3]
                             - ref3[..., :3], axis=-1)
        rec = dict(pairs=total, missing=missing, extra=extra,
                   depth_err_mean_mm=float(depth_err.mean() * 1e3),
                   depth_err_max_mm=float(depth_err.max() * 1e3),
                   solve_mean_mm=float(dev.mean(1).mean() * 1e3),
                   solve_max_mm=float(dev.max() * 1e3))
        self.p19["contact_sweep"] = rec
        check(dev.mean(1).mean() < 1.0e-3, f"contact sweep solve: mean "
              f"{rec['solve_mean_mm']:.3f} mm")
        check(dev.max() < 9.0e-3, f"contact sweep solve: max "
              f"{rec['solve_max_mm']:.3f} mm")
        idx = [0, 1]
        mc, _ = self.cpu_copies()
        rec["cpu_gap_m"] = self.cpu_gap(
            "contact sweep", [h[idx] for h in hist[:GOLDEN_CPU_FRAMES]],
            solve(state(mc, idx), mc, GOLDEN_CPU_FRAMES))
        return (f"{total} pairs: {missing} missing, {extra} extra, depth "
                f"error mean {rec['depth_err_mean_mm']:.3f} max "
                f"{rec['depth_err_max_mm']:.3f} mm; solve mean "
                f"{rec['solve_mean_mm']:.3f} max {rec['solve_max_mm']:.3f} "
                f"mm; CPU {rec['cpu_gap_m']:.1e} m")

    def parts(self, n, steps):
        """Run (label, fn) steps, printing each one's seconds."""
        out = []
        for label, fn in steps:
            t0 = time.perf_counter()
            msg = fn()
            out.append(f"[{label}, {time.perf_counter() - t0:.1f} s]")
            print(f"  phase {n} {out[-1]} {msg}", flush=True)
        return " ".join(out)

    def phase19(self):
        """Phase 19: the four C++ goldens of the JAX suite that need only
        the port's tracker: the recorded CNN cadence, cold-start
        acquisition, the fast-drift golden and the contact sweep."""
        self.p19 = {}
        if getattr(self, "cnn", None) is None:
            self.cnn_setup()
        return self.parts(19, (("contact sweep", self.contact_sweep),
                               ("fast drift", self.fastdrift),
                               ("cold start", self.coldstart),
                               ("CNN cadence", self.cadence)))

    # ---- phase 20: training and the flywheel -------------------------------
    def golden_target(self, g):
        np = self.np
        t = np.zeros(2304, np.float32)
        for i in range(8):
            t[i * 256 + 37] = 1.0
        for i in range(16):
            t[2048 + i * 16 + 5] = 1.0
        return self.torch.tensor(t, device=self.dev)[None]

    def sgd_golden(self):
        """The SGD step golden at batch 1 on the card
        (tests/test_cnn.py:25-38): from golden_cnn_init.cnnb, the step's
        MSE within 1e-6 and the output after it within 1e-5."""
        torch, np = self.torch, self.np
        from hand_tracking_samples_tpu_torch.cnn.model import (
            forward, load_cnnb, sgd_step)
        with open(os.path.join(REPO, "tests", "fixtures", "golden.json")) as f:
            g = json.load(f)
        p = load_cnnb(self.init_cnnb, self.dev)
        x = torch.tensor(np.asarray(g["cnn_input"], np.float32),
                         device=self.dev).reshape(1, 64, 64)
        p2, mse = sgd_step(p, x, self.golden_target(g), 0.001)
        e_mse = abs(mse.item() - g["cnn_train_mse"][0])
        e_out = (forward(p2, x)[0].cpu() - torch.tensor(
            g["cnn_output_after_step"])).abs().max().item()
        self.p20["sgd_golden"] = dict(mse_err=e_mse, output_err=e_out)
        check(e_mse < 1e-6, f"SGD golden: MSE off by {e_mse}")
        check(e_out < 1e-5, f"SGD golden: output after the step off by "
              f"{e_out}")
        return f"MSE off by {e_mse:.2e}, output after the step {e_out:.2e}"

    def profile_steps(self, fn, steps):
        """(wall ms, device busy ms, launches) a step from torch.profiler
        over fn(), which runs `steps` steps, read on the second of two
        profiled runs (the first starts the profiler's tracing; a
        measurement only)."""
        torch = self.torch
        try:
            from torch.profiler import ProfilerActivity, profile
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as p:
                    fn()
                    torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / steps
            dev = [e for e in p.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
                       for e in dev) / 1e3 / steps
            check(busy > 0, "the profiler recorded no device time")
            return dict(profiled_wall_ms=wall, device_busy_ms=busy,
                        device_idle_ms=wall - busy,
                        launches=sum(e.count for e in dev) / steps)
        except Exception as e:  # measurement only
            return dict(profile_error=f"{type(e).__name__}: {e}"[:200])

    def train_run(self):
        """synthetic_training_set (TRAIN_FRAMES animbank frames, the train
        CLI's ids) and train_epoch (TRAIN_STEPS steps at TRAIN_BATCH from
        the golden init) on the card; evaluate's MSE over every frame and
        over the held-out (odd) frames must each fall below 0.9x its
        start (tests/test_train_meshes.py:37); the step's time and its
        device busy time and launches from the profiler."""
        torch, np = self.torch, self.np
        from hand_tracking_samples_tpu_torch.cnn.model import load_cnnb
        from hand_tracking_samples_tpu_torch.cnn.train import (
            evaluate, synthetic_training_set, train_epoch)
        ids = (np.arange(TRAIN_FRAMES) * 613) % len(self.bank)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        data = synthetic_training_set(self.model, self.bank, ids,
                                      device=self.dev)
        torch.cuda.synchronize()
        set_s = time.perf_counter() - t0
        check(data.inputs.shape == (TRAIN_FRAMES, 64, 64)
              and data.labels.shape == (TRAIN_FRAMES, 2304)
              and bool(torch.isfinite(data.inputs).all())
              and bool(torch.isfinite(data.labels).all()),
              "synthetic_training_set: bad shapes or values")
        fg = (data.inputs > 0.3).float().mean().item()
        check(fg > 0.03, f"synthetic crops hold no hand ({fg})")
        self.train_data = data
        p0 = load_cnnb(self.init_cnnb, self.dev)
        before = evaluate(p0, data, split="all")
        held_before = evaluate(p0, data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, train_mse = train_epoch(p0, data, np.random.RandomState(0),
                                   TRAIN_STEPS, TRAIN_BATCH, TRAIN_ALPHA)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        after = evaluate(p, data, split="all")
        held_after = evaluate(p, data)
        rec = dict(set_seconds=set_s, frames=TRAIN_FRAMES,
                   steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                   mse_before=before, mse_after=after,
                   epoch_mean_mse=train_mse, held_out_mse_before=held_before,
                   held_out_mse_after=held_after, seconds=run_s,
                   ms_per_step=run_s * 1e3 / TRAIN_STEPS,
                   examples_per_s=TRAIN_STEPS * TRAIN_BATCH / run_s,
                   card=getattr(self, "smi", None))
        torch.cuda.synchronize()       # steady state: the net is warm
        t0 = time.perf_counter()
        train_epoch(p, data, np.random.RandomState(1), TRAIN_STEPS,
                    TRAIN_BATCH, TRAIN_ALPHA)
        torch.cuda.synchronize()
        rec["steady_ms_per_step"] = ((time.perf_counter() - t0) * 1e3
                                     / TRAIN_STEPS)
        rec["steady_examples_per_s"] = (TRAIN_BATCH * 1e3
                                        / rec["steady_ms_per_step"])
        rec.update(self.profile_steps(
            lambda: train_epoch(p, data, np.random.RandomState(1),
                                TRAIN_PROFILE_STEPS, TRAIN_BATCH,
                                TRAIN_ALPHA), TRAIN_PROFILE_STEPS))
        if "device_busy_ms" in rec:    # idle against the unprofiled step
            rec["device_idle_ms"] = (rec["steady_ms_per_step"]
                                     - rec["device_busy_ms"])
        self.p20["train"] = rec
        check(np.isfinite(after) and after < 0.9 * before
              and held_after < 0.9 * held_before,
              f"training: MSE {before:.6f} -> {after:.6f}, held-out "
              f"{held_before:.6f} -> {held_after:.6f}")
        prof = (f"busy {rec['device_busy_ms']:.3f} ms, idle "
                f"{rec['device_idle_ms']:.3f} ms, {rec['launches']:.0f} "
                f"launches a step" if "device_busy_ms" in rec
                else rec["profile_error"])
        return (f"{TRAIN_FRAMES} frames in {set_s:.1f} s; MSE (all "
                f"frames) {before:.6f} -> {after:.6f}, held-out (odd) "
                f"{held_before:.6f} "
                f"-> {held_after:.6f}; {TRAIN_STEPS} steps at batch "
                f"{TRAIN_BATCH}: {rec['ms_per_step']:.3f} ms a step, "
                f"{rec['examples_per_s']:.0f} examples/s (warm: "
                f"{rec['steady_ms_per_step']:.3f} ms, "
                f"{rec['steady_examples_per_s']:.0f} examples/s); {prof} "
                f"({rec['card']})")

    def sgd_card_cpu(self):
        """One batch-64 sgd_step on the card and on the CPU from the same
        weights (the golden init) and inputs (the synthetic set's first
        64 frames): the largest parameter gap <= SGD_CARD_CPU."""
        from hand_tracking_samples_tpu_torch.cnn.model import (
            from_numpy, load_cnnb, sgd_step, to_numpy)
        data = self.train_data
        p = load_cnnb(self.init_cnnb, self.dev)
        pc = from_numpy(to_numpy(p), "cpu")
        x, t = data.inputs[:TRAIN_BATCH], data.labels[:TRAIN_BATCH]
        a, ma = sgd_step(p, x, t, TRAIN_ALPHA)
        b, mb = sgd_step(pc, x.cpu(), t.cpu(), TRAIN_ALPHA)
        gap = max((a[k][kk].cpu() - b[k][kk]).abs().max().item()
                  for k in a for kk in a[k])
        step = max((a[k][kk] - p[k][kk]).abs().max().item()
                   for k in a for kk in a[k])
        self.p20["sgd_card_cpu"] = dict(param_gap=gap, largest_update=step,
                                        mse_gap=abs(ma.item() - mb.item()))
        check(gap <= SGD_CARD_CPU, f"batch-{TRAIN_BATCH} step: card and CPU "
              f"parameters {gap} apart")
        return (f"largest parameter gap {gap:.2e} (largest update "
                f"{step:.2e}), MSE gap {abs(ma.item() - mb.item()):.2e}")

    def loader_compress(self):
        """StreamingLoader on cnntrack_rec and cnntrack_rec2 equal to
        load_dataset (depth and ids bit for bit, poses within 1e-6);
        compress_dataset of each on the card against the CPU (its first 32
        frames) within COMPRESS_CARD_CPU."""
        np = self.np
        from hand_tracking_samples_tpu_torch.cnn.train import (
            compress_dataset)
        from hand_tracking_samples_tpu_torch.data.dataset import load_dataset
        from hand_tracking_samples_tpu_torch.native import StreamingLoader
        rec, msgs = {}, []
        for name in ("cnntrack_rec", "cnntrack_rec2"):
            path = os.path.join(REPO, "tests", "fixtures", name)
            ds = load_dataset(path)
            t0 = time.perf_counter()
            with StreamingLoader([path], batch=64) as sl:
                total = sl.total_frames
                got = list(sl)
            load_s = time.perf_counter() - t0
            depth = np.concatenate([b[0] for b in got])
            pose = np.concatenate([b[1] for b in got])
            ids = np.concatenate([b[2] for b in got])
            check(total == len(ds.depth) and np.array_equal(depth, ds.depth)
                  and np.array_equal(ids, np.arange(total)),
                  f"StreamingLoader: {name} differs from load_dataset")
            pose_gap = float(np.abs(pose - ds.pose).max())
            check(pose_gap <= 1e-6, f"StreamingLoader: {name} poses "
                  f"{pose_gap} off")
            cam = ds.info.camera()
            card = compress_dataset(depth, cam, pose, device=self.dev)
            cpu = compress_dataset(depth[:32], cam, pose[:32], device="cpu")
            gaps = {f: (getattr(card, f)[:32].cpu() - getattr(cpu, f))
                    .abs().max().item() for f in card._fields}
            rec[name] = dict(frames=total, loader_seconds=load_s,
                             pose_gap=pose_gap, compress_gaps=gaps)
            check(max(gaps.values()) <= COMPRESS_CARD_CPU,
                  f"compress_dataset {name}: card against CPU {gaps}")
            msgs.append(f"{name}: {total} frames in {load_s:.2f} s, poses "
                        f"{pose_gap:.1e}; compress card/CPU " + ", ".join(
                            f"{k} {v:.1e}" for k, v in gaps.items()))
        self.p20["loader"] = rec
        return "; ".join(msgs)

    def flywheel_clis(self):
        """apps.train_cnn (TRAIN_CLI) and apps.export_dataset (EXPORT_CLI)
        as two subprocesses on the card, run together: both exit 0, the
        .cnnb loads and is finite, the label files hold a line a frame and
        the PNGs are written."""
        import tempfile
        torch, np = self.torch, self.np
        from hand_tracking_samples_tpu_torch.cnn.model import load_cnnb
        with tempfile.TemporaryDirectory() as tmp:
            cnnb = os.path.join(tmp, "trained.cnnb")
            exp = os.path.join(tmp, "export")
            t0 = time.perf_counter()
            procs = {
                "train_cnn": subprocess.Popen(
                    [sys.executable, "-m", f"{PORT}.apps.train_cnn",
                     *TRAIN_CLI, "--out", cnnb], cwd=REPO,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True),
                "export_dataset": subprocess.Popen(
                    [sys.executable, "-m", f"{PORT}.apps.export_dataset",
                     *EXPORT_CLI, "--out", exp], cwd=REPO,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)}
            out, text = {}, {}
            for label, proc in procs.items():
                text[label], stderr = proc.communicate(timeout=600)
                check(proc.returncode == 0, f"{label}: exit "
                      f"{proc.returncode}: {stderr[-400:]}")
                out[label] = dict(seconds=time.perf_counter() - t0,
                                  last_line=text[label].strip()
                                  .splitlines()[-1])
            mses = [float(ln.split("train mse")[1].split()[0])
                    for ln in text["train_cnn"].splitlines()
                    if ln.startswith("step")]
            check(len(mses) == 2 and all(np.isfinite(mses)),
                  f"train_cnn: {text['train_cnn'][-400:]}")
            out["train_cnn"]["train_mse"] = mses
            p = load_cnnb(cnnb, self.dev)
            check(all(bool(torch.isfinite(v).all()) for d in p.values()
                      for v in d.values()), "train_cnn: non-finite .cnnb")
            n = int(EXPORT_CLI[EXPORT_CLI.index("--max-frames") + 1])
            lines = {f: len(open(os.path.join(exp, f)).read().splitlines())
                     for f in ("labels_full.txt", "labels_seg.txt")}
            pngs = sorted(f for f in os.listdir(exp) if f.endswith(".png"))
            check(all(v == n for v in lines.values()) and len(pngs) >= 5 * n,
                  f"export_dataset: {lines} label lines, {len(pngs)} PNGs")
            out["export_dataset"].update(label_lines=lines, pngs=len(pngs))
        self.p20["clis"] = out
        return "; ".join(f"{k} {v['seconds']:.1f} s: {v['last_line']}"
                         for k, v in out.items())

    def phase20(self):
        """Phase 20: the training half of the data flywheel on the card."""
        self.p20 = {}
        self.init_cnnb = os.path.join(REPO, "tests", "fixtures",
                                      "golden_cnn_init.cnnb")
        check(os.path.exists(self.init_cnnb), f"{self.init_cnnb} is missing")
        return self.parts(20, (("SGD golden", self.sgd_golden),
                               ("training run", self.train_run),
                               ("batch 64, card against CPU",
                                self.sgd_card_cpu),
                               ("loader and compress", self.loader_compress),
                               ("CLIs", self.flywheel_clis)))


    # ---- phase 21: scale-out and profiling ---------------------------------
    def p21_meshes(self):
        """Every visible card, and the first card listed twice (the split
        and the merge on one card)."""
        torch = self.torch
        from hand_tracking_samples_tpu_torch.parallel.mesh import make_mesh
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=60)
        smi = [ln for ln in out.stdout.splitlines() if ln.startswith("GPU")]
        every = make_mesh("tracks")
        first = make_mesh("tracks", devices=[every.devices[0]] * 2)
        check(len(every) == torch.cuda.device_count() == len(smi),
              f"mesh {every.devices}, torch sees "
              f"{torch.cuda.device_count()}, nvidia-smi {len(smi)}")
        self.meshes = {f"every card ({len(every)})": every,
                       "first card twice": first}
        self.p21["meshes"] = {k: [str(d) for d in m.devices]
                              for k, m in self.meshes.items()}
        return (f"torch.cuda.device_count() {torch.cuda.device_count()}, "
                f"nvidia-smi -L {len(smi)}; " + "; ".join(
                    f"{k}: {v}" for k, v in self.p21["meshes"].items()))

    def p21_compare(self, label, run, path):
        """run(mesh or None) -> (states, poses): unsharded, then on each
        mesh, each timed by the phase's StageTimer (host clock, from a
        synchronized card to its output's); launch counts reset before and
        read after each sharded run; the largest difference from
        unsharded, states and poses, must be <= P21_GATE
        (tests/test_parallel.py:52-55)."""
        torch = self.torch
        from hand_tracking_samples_tpu_torch import kernels
        rec = {}
        torch.cuda.synchronize()
        base = self.timer.time(f"{label}, unsharded", run, None)
        for name, mesh in self.meshes.items():
            key = f"{label}, {name}"
            kernels.reset_counts()
            torch.cuda.synchronize()
            st, poses = self.timer.time(key, run, mesh)
            dt = self.timer.total[key]
            counts = {k: n for k, n in kernels.counts().items() if n}
            check(all(counts.get(k, 0) > 0 for k in path),
                  f"{label} on {name}: a kernel of {path} did not launch: "
                  f"{counts}")
            check(poses.shape == base[1].shape
                  and bool(torch.isfinite(poses).all()),
                  f"{label} on {name}: poses {tuple(poses.shape)}")
            gap = max((poses - base[1]).abs().max().item(),
                      max((a - b).abs().max().item() for a, b in
                          zip(st.body, base[0].body)))
            rec[name] = dict(max_diff=gap, seconds=dt, launches=counts)
            check(gap <= P21_GATE, f"{label} on {name}: {gap} from "
                  f"unsharded (gate {P21_GATE})")
        return rec

    def p21_dynamics(self):
        """T=512 dynamics frames (P21_FRAMES) on phase 4's renders,
        unsharded and on both meshes."""
        from hand_tracking_samples_tpu_torch.parallel.tracks import (
            sharded_track_sequences, track_sequences)
        T = TRACKS
        depths = [self.depth_frame(f, T) for f in range(P21_FRAMES)]

        def run(mesh):
            st = self.init_state(T)
            if mesh is None:
                return track_sequences(st, self.model, None, depths,
                                       self.cam, self.cfg, self.params)
            return sharded_track_sequences(mesh, st, self.model, None,
                                           depths, self.cam, self.cfg,
                                           self.params)
        rec = self.p21_compare("dynamics", run, FIRST)
        self.p21["dynamics"] = rec
        p5 = self.fps["seconds"] / self.fps["frames"] * 1e3
        return "; ".join(
            f"{k}: max diff {v['max_diff']:.3g}, "
            f"{v['seconds'] / P21_FRAMES * 1e3:.1f} ms a frame "
            f"(phase 5 unsharded {p5:.1f})" for k, v in rec.items()) + (
            f" ({self.smi})")

    def p21_cnn(self):
        """One T=512 CNN frame (DEFAULT_CNNB, every 4th track reset) on
        phase 7's render, unsharded and on both meshes."""
        from hand_tracking_samples_tpu_torch.parallel.tracks import (
            sharded_track_sequences, track_sequences)
        T = CNN_TRACKS
        depths = [self.cnn_depth(0, T)]

        def run(mesh):
            st = self.cnn_state(T)
            if mesh is None:
                return track_sequences(st, self.model, self.cnn, depths,
                                       self.cam, self.cnn_cfg, self.params)
            return sharded_track_sequences(mesh, st, self.model, self.cnn,
                                           depths, self.cam, self.cnn_cfg,
                                           self.params)
        rec = self.p21_compare("CNN frame", run,
                               FIRST + ("cloud_rows_unpacked",
                                        "cloud_vals"))
        # the net on half the tracks against the same tracks of the whole
        # batch: PyTorch's products may sum in another order at another
        # batch size, which a shard's CNN frame then carries
        from hand_tracking_samples_tpu_torch.cnn.model import forward
        from hand_tracking_samples_tpu_torch.tracker.runtime import (
            _cnn_frame_inputs)
        _, _, x, y, _ = _cnn_frame_inputs(self.cnn, depths[0], self.cam,
                                          self.cnn_cfg)
        net_gap = (forward(self.cnn, x[:T // 2]) - y[:T // 2]).abs().max() \
            .item()
        self.p21["cnn"] = dict(rec, net_half_batch_diff=net_gap)
        p8 = self.cnn_speed["ms_per_frame"]
        return "; ".join(
            f"{k}: max diff {v['max_diff']:.3g}, {v['seconds'] * 1e3:.1f} "
            f"ms a frame (phase 8 unsharded {p8:.1f})"
            for k, v in rec.items()) + (
            f"; the net at T={T // 2} against the first {T // 2} of "
            f"T={T}: {net_gap:.3g} ({self.smi})")

    def p21_dp_step(self):
        """The data-parallel SGD step at batch TRAIN_BATCH on both meshes
        against cnn.model.sgd_step from the golden init on phase 20's
        first frames (MSE within 1e-6, every parameter within 2e-6,
        tests/test_parallel.py:73-75); ms a step of each (P21_STEPS steps,
        host clock) beside the single step's."""
        torch = self.torch
        from hand_tracking_samples_tpu_torch.cnn.model import (
            load_cnnb, sgd_step)
        from hand_tracking_samples_tpu_torch.parallel.mesh import (
            make_dp_train_step)
        p = load_cnnb(self.init_cnnb, self.dev)
        x = self.train_data.inputs[:TRAIN_BATCH]
        t = self.train_data.labels[:TRAIN_BATCH]

        def ms_a_step(step):
            step(p, x, t)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(P21_STEPS):
                out = step(p, x, t)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / P21_STEPS, out
        single_ms, (ref, ref_mse) = ms_a_step(
            lambda *a: sgd_step(*a, TRAIN_ALPHA))
        rec = {"single": dict(ms_per_step=single_ms)}
        for name, mesh in self.meshes.items():
            step = make_dp_train_step(mesh, TRAIN_ALPHA)
            ms, (new, mse) = self.timer.time(f"dp step, {name}", ms_a_step,
                                             step)
            dmse = abs(mse.item() - ref_mse.item())
            dp = max((new[k][kk] - ref[k][kk]).abs().max().item()
                     for k in ref for kk in ref[k])
            rec[name] = dict(ms_per_step=ms, mse_diff=dmse, param_diff=dp)
            check(dmse <= 1e-6 and dp <= 2e-6, f"dp step on {name}: MSE "
                  f"{dmse}, parameters {dp} from the single step")
        self.p21["dp_step"] = rec
        p20 = self.p20["train"]["steady_ms_per_step"]
        return (f"single step {single_ms:.3f} ms (phase 20 {p20:.3f}); "
                + "; ".join(f"{k}: {v['ms_per_step']:.3f} ms a step, MSE "
                            f"{v['mse_diff']:.2g}, parameters "
                            f"{v['param_diff']:.2g}" for k, v in rec.items()
                            if k != "single") + f" ({self.smi})")

    def p21_dryrun(self):
        """The port's dryrun_multichip (__graft_entry__.py:44) on both
        meshes."""
        from hand_tracking_samples_tpu_torch.parallel.tracks import (
            dryrun_multichip)
        msgs = [self.timer.time(f"dryrun, {k}", dryrun_multichip, m,
                                self.model)
                for k, m in self.meshes.items()]
        self.p21["dryrun"] = msgs
        return "; ".join(msgs) + f" ({self.smi})"

    def p21_trace(self):
        """device_trace around one T=512 dynamics frame: the Chrome trace
        exists and names a port kernel; the phase's StageTimer report."""
        from hand_tracking_samples_tpu_torch.utils.profiling import (
            device_trace)
        T = TRACKS
        st = self.init_state(T)
        with device_trace(self.trace_dir) as trace:
            self.timer.time("traced dynamics frame", self.run, st, 1, T)
        check(os.path.exists(trace.path), f"no trace at {trace.path}")
        with open(trace.path) as f:
            text = f.read()
        named = [k for k in PORT_KERNEL_SYMBOLS if k in text]
        check(named, f"the trace {trace.path} names no port kernel")
        report = self.timer.report()
        self.p21["trace"] = dict(path=os.path.relpath(trace.path, REPO),
                                 bytes=len(text), kernels=named,
                                 report=report)
        print(f"StageTimer ({self.smi}):\n{report}", flush=True)
        return (f"{os.path.relpath(trace.path, REPO)} ({len(text)} bytes) "
                f"names {named}")

    def p21_nopallas(self):
        """The kernel solver's dynamics frame with use_pallas=False at
        T=512 (P21_NOPALLAS_FRAMES frames): peak memory and host ms a
        frame, the distance from the use_pallas=True frames, a 2-track CPU
        re-run (< 1e-4 m).  If T=512 does not fit in the card's memory,
        the peak it reached is recorded and T halves until it fits."""
        import dataclasses
        torch = self.torch
        F = P21_NOPALLAS_FRAMES
        cfg = dataclasses.replace(self.cfg, use_pallas=False)
        T, tries = TRACKS, []
        while True:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            m0 = torch.cuda.memory_allocated()
            try:
                dt, counts, pk, _, hist = self.frames_of(cfg, F, T)
                peak = (torch.cuda.max_memory_allocated() - m0) / 2**30
                break
            except torch.cuda.OutOfMemoryError as e:
                peak = (torch.cuda.max_memory_allocated() - m0) / 2**30
                tries.append(dict(tracks=T, peak_gib=peak,
                                  error=str(e)[:200]))
                print(f"  phase 21 use_pallas=False at T={T} does not fit: "
                      f"peak {peak:.3f} GiB", flush=True)
                check(T > 1, "use_pallas=False fits at no T")
                T //= 2
        _, _, _, _, ref = self.frames_of(self.cfg, F, T)
        check(not any(k.startswith("cloud_rows") for k in counts)
              and pk.get("dyn") == F,
              f"use_pallas=False launches {counts}, PGS plans {pk}")
        check(all(bool(torch.isfinite(h).all()) for h in hist),
              "use_pallas=False: non-finite poses")
        dist = max((a[..., :3] - b[..., :3]).abs().max().item()
                   for a, b in zip(hist, ref))
        cpu = self.cpu_reference([h[:2] for h in hist[:REF_CPU_FRAMES]], cfg)
        self.p21["nopallas"] = dict(tracks=T, frames=F, seconds=dt,
                                    ms_per_frame=dt / F * 1e3,
                                    peak_gib=peak, from_pallas_m=dist,
                                    launches=counts, did_not_fit=tries,
                                    cpu_reference_err_m=cpu)
        return (f"T={T}{' (did not fit: ' + str(tries) + ')' if tries else ''}"
                f": {dt / F * 1e3:.1f} ms a frame, peak {peak:.3f} GiB, "
                f"{dist:.3g} m from use_pallas; CPU re-run {cpu:.2g} m; "
                f"launches {counts} ({self.smi})")

    def phase21(self):
        """Phase 21: the sharded entry points, the data-parallel step,
        dryrun_multichip, device_trace and use_pallas=False at T=512."""
        from hand_tracking_samples_tpu_torch.utils.profiling import (
            StageTimer)
        self.p21 = {}
        self.timer = StageTimer()
        if getattr(self, "cnn", None) is None:
            self.cnn_setup()
        return self.parts(21, (("meshes", self.p21_meshes),
                               ("sharded dynamics", self.p21_dynamics),
                               ("sharded CNN frame", self.p21_cnn),
                               ("dp step", self.p21_dp_step),
                               ("dryrun_multichip", self.p21_dryrun),
                               ("device_trace", self.p21_trace),
                               ("use_pallas=False, T=512",
                                self.p21_nopallas)))

    # ---- phase 22: the tools ------------------------------------------------
    def p22_hold(self, label, a, b, rel):
        """a (kernel) against b (plain): equal, or within rel of b where
        rel > 0; returns the largest absolute difference."""
        torch = self.torch
        err = (a - b).abs().max().item()
        if rel:
            ok = bool(((a - b).abs() <= rel * b.abs()).all())
        else:
            ok = torch.equal(a, b)
        check(ok, f"{label}: kernel against plain {err}")
        return err

    def p22_compare(self, draw, label, timed=False):
        """Kernels 9-11 against their plain versions on draw (T, 600,
        128); with timed, each timed beside its plain version, its bound
        and (kernels 10-11) the PyTorch sum, into the kernels rows."""
        torch = self.torch
        from hand_tracking_samples_tpu_torch.tools import (
            prof_cloud_kernel as pk, prof_cloud_mt as pm, prof_cloud_pre as pp)
        T = draw.shape[0]
        scal = pk.scalars()
        out = {}
        calls = [(f"cloud_stage[{s}]", (lambda s=s: pk.cloud_stage(
            draw, scal, s)), (lambda s=s: pk.stage_plain(draw, scal, s)),
            (lambda: (draw * scal[2]).sum((-2, -1))) if s == 0 else None,
            P22_SUM_REL if s == 0 else 0, draw.numel() * 4
            + T * pk.BUDGET * 8 * 4, draw.numel() * (2 if s == 0 else 4))
            for s in range(5)]
        for trk in P22_TRK:
            if T % trk:
                continue
            x = draw.reshape(T // trk, -1, 128)
            calls.append((f"group_sum[trk={trk}]",
                          lambda x=x: pm.group_sum(x),
                          lambda x=x: pm.group_sum_plain(x),
                          lambda x=x: (x * 0.001).sum((-2, -1)),
                          P22_SUM_REL, x.numel() * 4 + x.shape[0] * 4096,
                          x.numel() * 2))
        calls.append(("track_sum", lambda: pp.track_sum(draw),
                      lambda: pm.group_sum_plain(draw),
                      lambda: (draw * 0.001).sum((-2, -1)), P22_SUM_REL,
                      draw.numel() * 4 + T * 4096, draw.numel() * 2))
        for name, kern, plain, lib, rel, nbytes, ops in calls:
            if not timed:
                out[name] = self.p22_hold(f"{name} {label}", kern(),
                                          plain(), rel)
                continue
            ms, a = self.event_ms(kern, (), 3, 20)
            pms, b = self.event_ms(plain, (), 1, 3)
            lms = self.event_ms(lib, (), 3, 20)[0] if lib else None
            bb, bo = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_S * 1e3
            self.results[name].update(
                max_abs_err=self.p22_hold(f"{name} {label}", a, b, rel),
                ms=ms, plain_ms=pms, library_ms=lms, bound_ms=max(bb, bo),
                bound_by="bytes" if bb >= bo else "operations")
            out[name] = ms
        return out

    def p22_small(self):
        """At T=4 on phase 4's renders and on seeded rasters; then the
        stages at each frac of P22_FRACS on seeded rasters keeping 0, more
        than, exactly and fewer than the budget (synthetic_depths' kinds
        0-3) and on the renders at budgets 2048 and 8192."""
        from hand_tracking_samples_tpu_torch.ops.cloud_kernel import (
            depth_tensor, synthetic_depths)
        from hand_tracking_samples_tpu_torch.tools import (
            prof_cloud_kernel as pk)
        from hand_tracking_samples_tpu_torch.tools.common import to_raster
        errs = {}
        renders = to_raster(self.depth_frame(0, 4))
        for label, draw in (
                ("renders", renders),
                ("seeded", to_raster(depth_tensor(synthetic_depths(
                    4, 240, 320, seed=22), self.dev)))):
            for k, v in self.p22_compare(draw, label).items():
                errs[k] = max(errs.get(k, 0.0), v)
        scal, n = pk.scalars(), 0
        for frac in P22_FRACS:
            seeded = to_raster(depth_tensor(synthetic_depths(
                4, 240, 320, seed=22 + frac, frac=frac), self.dev))
            for label, draw, budget in (("seeded", seeded, pk.BUDGET),
                                        ("renders", renders, pk.BUDGET),
                                        ("renders", renders, 8192)):
                for st in range(5):
                    name = f"cloud_stage[{st}]"
                    errs[name] = max(errs[name], self.p22_hold(
                        f"{name} {label} frac {frac} budget {budget}",
                        pk.cloud_stage(draw, scal, st, budget, frac),
                        pk.stage_plain(draw, scal, st, budget, frac),
                        P22_SUM_REL if st == 0 else 0))
                    n += 1
        self.p22["t4_max_abs_err"] = errs
        return (f"{len(errs)} kernels held, then {n} stage launches at "
                f"fracs {P22_FRACS}; largest error {max(errs.values())}")

    def p22_path(self):
        """The tools' path: prof_cloud_kernel (stages 0-4), prof_cloud_mt
        and prof_cloud_pre at T=512, one frame, in this process with the
        launch counts set to 0 just before: every kernel launched."""
        from hand_tracking_samples_tpu_torch import kernels
        from hand_tracking_samples_tpu_torch.tools import (
            prof_cloud_kernel as pk, prof_cloud_mt as pm, prof_cloud_pre as pp)
        saved = {k: os.environ.get(k) for k in P22_PATH_ENV}
        os.environ.update(P22_PATH_ENV)
        try:
            self.torch.cuda.synchronize()
            kernels.reset_counts()
            times = dict(stages=pk.main(["0", "1", "2", "3", "4"]),
                         mt=pm.main([]), pre=pp.main([]))
            self.torch.cuda.synchronize()
            counts = dict(kernels.counts())
            kinds = {k: dict(kernels.WRAPPERS[k].kinds)
                     for k in ("cloud_stage", "group_sum")}
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        launches = {**{f"cloud_stage[{s}]": kinds["cloud_stage"].get(s, 0)
                       for s in range(5)},
                    **{f"group_sum[trk={k}]": kinds["group_sum"].get(k, 0)
                       for k in P22_TRK},
                    "track_sum": counts["track_sum"]}
        for name, n in launches.items():
            check(n > 0, f"{name} was not launched on the tools' path")
            self.results.setdefault(name, {})["launches"] = n
        self.p22["path"] = dict(ms_per_frame=times, launches=launches)
        return f"launches {launches}; ms a frame {times}"

    def p22_timing(self):
        """At T=512 on phase 4's renders (frame 0), timed; on seeded
        rasters, held."""
        from hand_tracking_samples_tpu_torch.ops.cloud_kernel import (
            depth_tensor, synthetic_depths)
        from hand_tracking_samples_tpu_torch.tools.common import to_raster
        ms = self.p22_compare(to_raster(self.depth_frame(0, TRACKS)),
                              "T=512", timed=True)
        self.p22_compare(to_raster(depth_tensor(synthetic_depths(
            TRACKS, 240, 320, seed=23), self.dev)), "seeded T=512")
        return "; ".join(
            f"{k} {v:.4f} ms (plain {self.results[k]['plain_ms']:.3f}, "
            f"bound {self.results[k]['bound_ms']:.4f}"
            + (f", library {self.results[k]['library_ms']:.4f}"
               if self.results[k].get("library_ms") else "") + ")"
            for k, v in ms.items()) + f" ({self.smi})"

    def p22_run_tools(self, tools, out, json_path):
        """The tools as subprocesses on the card, P22_WORKERS at a time:
        {label: (seconds, stdout)}; fails, after every tool has run,
        unless each exited 0 and printed its expected line."""
        import re
        pending, running, done, bad = list(tools), {}, {}, []
        try:
            while pending or running:
                while pending and len(running) < P22_WORKERS:
                    t = pending.pop(0)
                    label, mod, argv, env, _ = t
                    args = [a.format(out=out, json=json_path) for a in argv]
                    running[label] = (t, time.perf_counter(),
                                      subprocess.Popen(
                        [sys.executable, "-m", f"{PORT}.tools.{mod}",
                         *args], cwd=REPO, stdout=subprocess.PIPE,
                        stderr=subprocess.PIPE, text=True,
                        env={**os.environ, **env}))
                time.sleep(0.2)
                for label in [k for k, v in running.items()
                              if v[2].poll() is not None]:
                    t, t0, proc = running.pop(label)
                    stdout, stderr = proc.communicate()
                    done[label] = (time.perf_counter() - t0, stdout)
                    print(f"  tool {label}: exit {proc.returncode}, "
                          f"{done[label][0]:.1f} s", flush=True)
                    if proc.returncode != 0:
                        bad.append(f"{label}: exit {proc.returncode}: "
                                   f"{stderr[-600:]}")
                    elif not re.search(t[4], stdout, re.M):
                        bad.append(f"{label}: no line {t[4]!r} in "
                                   f"{stdout[-600:]}")
        finally:
            for _, _, proc in running.values():
                proc.kill()
        check(not bad, "tools failed: " + " | ".join(bad))
        return done

    def p22_tools(self):
        """Every ported tool as a subprocess on the card (P22_FIRST alone,
        then P22_TOOLS, then P22_LAST), the fast-drift and cold-start
        tools at phase 19's gates, prof_full's stage times kept."""
        import tempfile
        np = self.np
        json_path = os.path.join(os.path.dirname(self.trace_dir),
                                 "prof_full.json")
        self.torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as out:
            done = self.p22_run_tools((P22_FIRST,), out, json_path)
            done.update(self.p22_run_tools(P22_TOOLS, out, json_path))
            done.update(self.p22_run_tools((P22_LAST,), out, json_path))
            with open(os.path.join(out, "fastdrift.json")) as f:
                fd = json.load(f)
            cold = np.load(os.path.join(out, "cold.npz"))["errs"]
            arts = sorted(os.listdir(os.path.join(out, "artifacts")))
            with open(os.path.join(out, "artifacts",
                                   "fastdrift_r04.json")) as f:
                self.p22["attribution"] = json.load(f).get("attribution")
        with open(json_path) as f:
            stages = json.load(f)["ms_per_frame"]
        self.p22["prof_full"] = stages
        self.p22["tools_s"] = {k: v[0] for k, v in done.items()}
        self.p22["tools_tail"] = {k: v[1].strip().splitlines()[-12:]
                                  for k, v in done.items()}
        # phase 19's gates (fastdrift, coldstart)
        with open(os.path.join(REPO, "tests", "fixtures",
                               "fastdrift_ref.json")) as f:
            ref = np.asarray(json.load(f)["final_err_per_track"])[:8]
        fin = np.asarray(fd["final_err_per_track_mm"]) / 1e3
        for t in range(8):
            ok = (abs(fin[t] - ref[t]) < max(0.004, 0.5 * ref[t])
                  if ref[t] < 0.02 else fin[t] < 1.6 * ref[t] + 0.01)
            check(ok, f"eval_fastdrift track {t}: {fin[t] * 1e3:.1f} mm, "
                  f"the reference's {ref[t] * 1e3:.1f}")
        ratio = fin.mean() / ref.mean()
        check(0.6 < ratio < 1.4, f"eval_fastdrift: ratio {ratio:.2f}")
        means, final = cold.mean(1), cold[-1]
        check(means[0] < 0.045 and means[-1] < 0.0075
              and np.median(final) < 0.003 and (final < 0.008).sum() >= 5
              and means[-1] < 0.4 * means[0],
              f"eval_coldstart: means {np.round(means * 1e3, 2)} mm, "
              f"finals {np.round(final * 1e3, 2)} mm")
        self.p22["gates"] = dict(fastdrift_final_mm=(fin * 1e3).tolist(),
                                 fastdrift_ratio=float(ratio),
                                 coldstart_mean_mm=(means * 1e3).tolist(),
                                 coldstart_final_mm=(final * 1e3).tolist())
        print(f"prof_full T=512 ms a frame ({self.smi}): "
              + json.dumps(stages), flush=True)
        return (f"{len(done)} tools in "
                f"{sum(v[0] for v in done.values()):.0f} s of subprocess "
                f"time; fast drift ratio {ratio:.3f}; cold start means "
                f"{np.round(means * 1e3, 2)} mm; artifacts {arts}")

    def phase22(self):
        """Phase 22: the tools and their kernels."""
        self.p22 = {}
        for k in (*P22_STAGES, *P22_SUMS):
            self.results.setdefault(k, {})
        if getattr(self, "cnn", None) is None:
            self.cnn_setup()
        return self.parts(22, (("kernels at T=4", self.p22_small),
                               ("the tools' path", self.p22_path),
                               ("kernels at T=512", self.p22_timing),
                               ("tools", self.p22_tools)))



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
        ptx = {k: v for k, v in kernels.ptxas_summary(
            info.get("log", "")).items()
            if any(n in k for n in REDESIGNED)}
        record["ptxas"] = ptx
        stage_ptx = {k: v for k, v in kernels.ptxas_summary(
            info.get("log", "")).items() if "cloud_stage_kernel" in k}
        launch, res = {}, (ctypes.c_int * 5)()     # at 320x240, S = 2048
        for st in range(5):
            kernels.check(kernels.library().hts_cloud_stage_config(
                240 * 320, 4, 2048, st, 0, -1, res), "cloud_stage_config")
            launch[st] = dict(zip(("C", "staged", "smem",
                                   "max_active_clusters", "thin32"), res))
        record["cloud_stage"] = dict(ptxas=stage_ptx, launch=launch)
        if info["built"]:
            check(len(stage_ptx) == 5, f"ptxas: the stage kernel's five "
                  f"instances: {list(stage_ptx)}")
        check(all(c["C"] > 1 and c["max_active_clusters"] > 0
                  for c in launch.values()),
              f"the stage kernel's launch at 320x240: {launch}")
        if info["built"]:        # a reused library has no log to read
            pgs = [k for k in ptx if "pgs_kernel" in k]
            check(len(pgs) == 2, f"ptxas: the PGS kernel's two instances "
                  f"(exact, jacobi): {pgs}")
            for n in NO_SPILL:
                got = [v for k, v in ptx.items() if n in k]
                check(len(got) == 1, f"ptxas: no entry for {n}")
                check(got[0].get("stack") == 0
                      and got[0].get("spill_stores") == 0
                      and got[0].get("spill_loads") == 0,
                      f"ptxas: {n} uses a stack or spills: {got[0]}")
        return (f"{'built' if info['built'] else 'reused'} "
                f"{os.path.relpath(info['path'], REPO)} in "
                f"{info['seconds']:.1f} s; ptxas -v: " + "; ".join(
                    f"{k} {v}" for k, v in {**ptx, **stage_ptx}.items())
                + f"; cloud_stage launch at 320x240 by stage: {launch}")
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
    s.smi = smi["line"]
    s.trace_dir = os.path.join(os.path.dirname(os.path.abspath(args.json))
                               if args.json else os.path.join(REPO, "build"),
                               "trace")
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
    phase(12, "kernels 2 and 2.5 vs plain (T=4, T=512)", s.compare_pack)
    phase(13, "voxel and mirror frames", s.cloud_slice)
    phase(14, "voxel and mirror timing", s.cloud_timing)
    phase(15, "CNN frame on the reference solvers", s.cnn_ref_slice)
    phase(16, "reference-solver CNN frame timing", s.cnn_ref_timing)
    phase(17, "slowfit", s.slowfit_phase)
    phase(18, "jacobi, angles-only, kickstart_multi, use_pallas=False, CLI",
          s.phase18)
    phase(19, "C++ goldens", s.phase19)
    phase(20, "training and the flywheel", s.phase20)
    phase(21, "scale-out and profiling", s.phase21)
    phase(22, "tools", s.phase22)
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
    for name, key in SLOWFIT_SHAPES.items():   # phase 17's run and shapes
        src, rep = KERNELS[name.split("[")[0]]
        r = s.slowfit_shapes[key]
        rows.append({"name": key, "route": "cuda", "source": src,
                     "replaces": rep, "launches": r["launches"],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": None})
    for name, (src, rep) in P18_ROWS.items():  # phase 18's runs and shapes
        r = s.results[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": r["launches"],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": None})
    for name, rep in {**P22_STAGES, **P22_SUMS}.items():   # phase 22
        r = s.results[name]
        rows.append({"name": name, "route": "cuda", "source": P22_SRC,
                     "replaces": rep, "launches": r["launches"],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
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
                           pack_err=s.pack_err,
                           cnn_reference=s.cnn_ref_stats,
                           cnn_reference_speed=s.cnn_ref_speed,
                           cnn_reference_shapes=s.cnn_ref_shapes,
                           slowfit=s.slowfit_stats,
                           slowfit_speed=s.slowfit_speed,
                           slowfit_shapes=s.slowfit_shapes,
                           phase18=s.p18, phase19=s.p19, phase20=s.p20,
                           phase21=s.p21, phase22=s.p22),
                      f, indent=1, default=str)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
