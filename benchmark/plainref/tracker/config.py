"""HandTracker configuration (the ~30 tunables of handtrack.h:523-581).

Same fields and defaults as hand_tracking_samples_tpu.tracker.config, so the
same JSON config files work in both packages.  The port runs one setting of
the framework knobs so far (tracker/runtime.py says which); the rest of the
fields are carried for the later slices.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    segment_scale: float = 0.17
    full_reset_on_error: float = 0.6
    angles_only: bool = False
    always_take_cnn: bool = False
    drangey: float = 0.7
    boundary_planes: int = 1
    microforce: float = 1.0
    cloudforce_max_point: float = 15.0
    cloudforce_max_sum: float = 3000.0
    mainthreadpasses: int = 1
    subsample_fraction: int = 4
    subsample_voxel: int = 0
    subsample_size: float = 0.0
    min_point_num: int = 400
    accum_error_threshold: float = 0.0
    min_cray_prob: float = 0.0
    steps: int = 5
    steps_keypoints: int = 3
    steps_keyangles: int = 2
    steps_palmangle: int = 2
    steps_cloudstart: int = 1
    steps_unibody: int = 3
    physics_iterations: int = 16
    physics_iterations_post: int = 4
    physics_use_collision: int = 1
    physics_weak_force: float = 0.4
    bone_sum_error_scale: float = 4.0
    unibody_force: float = 0.1

    # --- framework additions (not in the reference) ---
    point_budget: int = 2048        # static cloud-point slots per frame
    cnn_every_frame: bool = True    # run the CNN refit every frame
    cnn_every_k: int = 1            # CNN cadence under track_sequences
    solver: str = "sequential"      # "sequential" | "colored" | "kernel"
    cloud_rows_per_body: int = 128  # per-body cloud-row slots (uniformly
    # thinned when a body wins more points)
    use_pallas: bool = False        # fused correspondence kernels (the port
    # runs its hand-written CUDA kernels on this path)
    contacts_mode: str = "exact"    # "exact" precedence schedule or "jacobi"
    mirror_plane: tuple = ()        # mirror-rig plane (a, b, c, d); () none
    init_take_gated: bool = False   # gate the initializing CNN take

