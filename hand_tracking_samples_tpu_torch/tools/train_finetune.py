"""Targeted fine-tune of the pose-initialiser net (the port's counterpart
of tools/train_finetune.py): oversample the animbank segments where
cold-start tracking settles into a wrong basin.  Reads a cold-start dump
(eval_coldstart with EVAL_DUMP; FT_DUMP, default cold_v4.npz under --out)
for the starts whose final error exceeds FT_FAIL_MM, builds a set of the
bank's training frames plus FT_PLAIN - 1 plain and FT_AUG augmented copies
of the failing starts' FT_WINDOW-frame windows (every 8th bank frame is
held out of every copy), and continues SGD from FT_WARM (the shipped v4
net) at FT_ALPHA in chunks of 2000 steps (train_v3's loop), printing the
held-out MSE before and during.  FT_OUT (handposedd_synth_v5.cnnb) and the
set's cache FT_CACHE (keyed on the settings; empty: none) land under --out
when relative.  FT_FRAMES takes the first N animbank frames only.

    python -m hand_tracking_samples_tpu_torch.tools.train_finetune
    FT_FRAMES=32 FT_STEPS=2 FT_BATCH=4 FT_CACHE= python -m hand_tracking_samples_tpu_torch.tools.train_finetune --device cpu
"""
from __future__ import annotations

import argparse
import hashlib
import os
import sys
import time

import numpy as np
import torch

from .common import add_device, add_out, env_int, setup
from .train_v3 import load_or_render, train_chunks


def main(argv=None):
    ap = add_out(add_device(argparse.ArgumentParser(
        description=__doc__.split("\n")[0])))
    args = ap.parse_args(argv)
    from ..assets_paths import ASSETS
    from ..cnn.model import load_cnnb
    from ..cnn.train import TrainingSet, evaluate, synthetic_training_set
    dump = os.path.join(args.out, os.environ.get("FT_DUMP", "cold_v4.npz"))
    warm = os.environ.get("FT_WARM", os.path.join(
        ASSETS, "handposedd_synth_v4.cnnb"))
    out = os.path.join(args.out, os.environ.get(
        "FT_OUT", "handposedd_synth_v5.cnnb"))
    steps, batch = env_int("FT_STEPS", 30000), env_int("FT_BATCH", 128)
    alpha = float(os.environ.get("FT_ALPHA", "0.0003"))
    fail_mm = float(os.environ.get("FT_FAIL_MM", "8.0"))
    window, plain = env_int("FT_WINDOW", 64), env_int("FT_PLAIN", 2)
    aug = env_int("FT_AUG", 6)

    z = np.load(dump)
    errs, starts = z["errs"], z["starts"]          # (F, T), (T,)
    fail = errs[-1] > fail_mm / 1000.0
    fail_starts = starts[fail]
    print(f"{fail.sum()}/{len(starts)} failing starts (final err > "
          f"{fail_mm} mm): {sorted(fail_starts.tolist())}")
    dev, model, bank, _, _ = setup(args.device)
    n = min(env_int("FT_FRAMES", len(bank)), len(bank))
    fail_ids = np.unique(np.concatenate(
        [np.arange(s, min(s + window, n)) for s in fail_starts]
        + [np.zeros(0, np.int64)])).astype(np.int64)
    print(f"fine-tune window frames: {len(fail_ids)} / bank {n}")
    # a frame-disjoint split: every 8th bank frame is held out and lies in
    # no training copy, plain or augmented
    all_ids = np.arange(n)
    held_ids = all_ids[all_ids % 8 == 3]
    train_mask = np.ones(n, bool)
    train_mask[held_ids] = False
    train_ids = all_ids[train_mask]
    fail_train = fail_ids[train_mask[fail_ids]]
    key = hashlib.sha1(repr((sorted(fail_starts.tolist()), fail_mm, window,
                             plain, aug, held_ids.tolist())).encode()
                       ).hexdigest()[:12]
    cache = os.environ.get("FT_CACHE", f"ft_set_{key}.npz")
    cache = os.path.join(args.out, cache) if cache else ""

    def render(ids, **kw):
        return synthetic_training_set(model, bank, ids, device=dev, **kw)

    def make():
        sets = [render(train_ids)]
        if len(fail_train):          # no failing start: the bank alone
            sets += [render(fail_train) for _ in range(max(plain - 1, 0))]
            sets += [render(fail_train, augment=True, seed=5000 * (k + 1))
                     for k in range(aug)]
        return TrainingSet(*[torch.cat(xs) for xs in zip(*sets)])
    t0 = time.time()
    data, cached = load_or_render(cache, make)
    held, _ = load_or_render(cache and cache[:-4] + "_held.npz",
                             lambda: render(held_ids))
    data = TrainingSet(*[x.to(dev) for x in data])
    held = TrainingSet(*[x.to(dev) for x in held])
    print(f"training set: {data.inputs.shape[0]} frames, heldout "
          f"{held.inputs.shape[0]} " + ("(cached)" if cached else
                                        f"({time.time() - t0:.0f}s to "
                                        "render)"), flush=True)
    params = load_cnnb(warm, dev)
    print(f"warm-start heldout mse: {evaluate(params, held, split='all'):.6f}",
          flush=True)

    def report(done, a, mse, dt, p):
        print(f"step {done:6d} alpha {a} train-mse {mse:.6f} heldout-mse "
              f"{evaluate(p, held, split='all'):.6f} ({dt:.1f}s/chunk)",
              flush=True)
    return train_chunks(params, data, np.random.RandomState(17), steps,
                        batch, lambda done: alpha, report, out)


if __name__ == "__main__":
    main()
    sys.exit(0)
