"""A frozen copy of the plain PyTorch paths of hand_tracking_samples_tpu_torch
(the PyTorch port of the hand tracker), the benchmark's reference.

Copied module for module from the port at commit a9f0a04, then cut to
what the benchmark's configurations run (tracker/runtime.py _check_config
refuses any other setting): each kernel wrapper keeps only its plain
version, and the functions those paths never reach are gone.  Add a
module or a function back, from the port at that commit, when a new
configuration needs it.  Nothing here imports the port, JAX or the JAX
package.  The benchmark also renders its depth inputs with this copy's
`data.synth.fake_depth`, so that a change to the port's renderer cannot
change them.
"""
