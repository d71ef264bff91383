"""Train the pose-initialiser net (the port's counterpart of
tools/train_v3.py, which trained the shipped net): the whole animbank
rendered plus TRAIN_AUG augmented copies, plain SGD on the softmax-MSE loss
(train-cnn.cpp:143-170) in chunks of 2000 steps at batch TRAIN_BATCH,
alpha 0.001 for the first two thirds of TRAIN_STEPS and 0.0003 after
(TRAIN_ALPHA overrides), from Xavier weights (seed 0) or TRAIN_WARM.  The
train and held-out MSE print after the first chunk and every 10000 steps,
with a .partial of the weights; the .cnnb is written through
cnn.model.save_cnnb.  TRAIN_OUT (handposedd_synth_v3.cnnb) and the
rendered set's cache TRAIN_CACHE (train_v3_set.npz; empty: none) land under
--out when relative.  TRAIN_FRAMES takes the first N animbank frames only.

    python -m hand_tracking_samples_tpu_torch.tools.train_v3
    TRAIN_FRAMES=16 TRAIN_AUG=1 TRAIN_STEPS=2 TRAIN_BATCH=4 TRAIN_CACHE= python -m hand_tracking_samples_tpu_torch.tools.train_v3 --device cpu
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from .common import add_device, add_out, env_int, setup

CHUNK = 2000


def load_or_render(path, make):
    """The TrainingSet cached at path (an .npz of its fields), else
    make() written there; path "" caches nothing."""
    from ..cnn.train import TrainingSet
    if path and os.path.exists(path):
        z = np.load(path)
        return TrainingSet(*[torch.as_tensor(z[k]) for k in ("x", "l", "p")]
                           ), True
    data = make()
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(path, x=data.inputs.cpu().numpy(),
                 l=data.labels.cpu().numpy(), p=data.poses.cpu().numpy())
    return data, False


def train_chunks(params, data, rng, steps, batch, alpha_of, report,
                 out_path):
    """SGD in chunks of CHUNK steps (train_epoch_scanned), reporting after
    the first chunk and every 10000 steps (report(done, alpha, train MSE,
    seconds, weights)) with a .partial of the weights; returns the
    weights."""
    from ..cnn.model import save_cnnb
    from ..cnn.train import train_epoch_scanned
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    done = 0
    while done < steps:
        n = min(CHUNK, steps - done)
        alpha = alpha_of(done)
        t0 = time.time()
        params, mse = train_epoch_scanned(params, data, rng, n,
                                          batch_size=batch, alpha=alpha)
        done += n
        if done % 10000 == 0 or done == n:
            report(done, alpha, mse, time.time() - t0, params)
            save_cnnb(params, out_path + ".partial")
    save_cnnb(params, out_path)
    print("saved", out_path)
    return params


def main(argv=None):
    ap = add_out(add_device(argparse.ArgumentParser(
        description=__doc__.split("\n")[0])))
    args = ap.parse_args(argv)
    from ..cnn.model import init_params, load_cnnb
    from ..cnn.train import TrainingSet, evaluate, synthetic_training_set
    aug, steps = env_int("TRAIN_AUG", 3), env_int("TRAIN_STEPS", 40000)
    batch = env_int("TRAIN_BATCH", 128)
    out = os.path.join(args.out, os.environ.get(
        "TRAIN_OUT", "handposedd_synth_v3.cnnb"))
    cache = os.environ.get("TRAIN_CACHE", "train_v3_set.npz")
    cache = os.path.join(args.out, cache) if cache else ""
    warm = os.environ.get("TRAIN_WARM", "")
    dev, model, bank, _, _ = setup(args.device)
    ids = np.arange(min(env_int("TRAIN_FRAMES", len(bank)), len(bank)))

    def make():
        sets = [synthetic_training_set(model, bank, ids, device=dev)]
        for k in range(aug):
            sets.append(synthetic_training_set(model, bank, ids,
                                               augment=True,
                                               seed=1000 * (k + 1),
                                               device=dev))
        return TrainingSet(*[torch.cat(xs) for xs in zip(*sets)])
    t0 = time.time()
    data, cached = load_or_render(cache, make)
    data = TrainingSet(*[x.to(dev) for x in data])
    print(f"training set: {data.inputs.shape[0]} frames "
          + ("(cached)" if cached else f"({time.time() - t0:.0f}s to "
             "render)"), flush=True)
    params = (load_cnnb(warm, dev) if warm
              else init_params(torch.Generator().manual_seed(0), dev))
    fixed = float(os.environ.get("TRAIN_ALPHA", "0"))

    def report(done, alpha, mse, dt, p):
        print(f"step {done:6d} alpha {alpha} train-mse {mse:.6f} "
              f"heldout-mse {evaluate(p, data):.6f} ({dt:.1f}s/chunk)",
              flush=True)
    return train_chunks(params, data, np.random.RandomState(7), steps,
                        batch, lambda done: fixed or (
                            0.001 if done < steps * 2 // 3 else 0.0003),
                        report, out)

if __name__ == "__main__":
    main()
    sys.exit(0)
