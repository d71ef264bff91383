"""The port's counterparts of the repository's tools/ scripts, one module
each with the same name, run as

    python -m hand_tracking_samples_tpu_torch.tools.<name> [--device cpu]

They import torch and the port only, keep the JAX tools' flags and their
PROF_* / EVAL_* environment names, run on the card unless given
--device cpu, and write only under --out (default build/eval/).  Three
hold the profiling kernels (csrc/prof_cloud.cu): prof_cloud_kernel
(cloud_stage), prof_cloud_mt (group_sum) and prof_cloud_pre (track_sum).
"""
