"""train-hand-pose-cnn equivalent: batched CNN training, the port's
counterpart of hand_tracking_samples_tpu.apps.train_cnn (the same flags and
lines).

Trains the pose-initialiser CNN on recorded datasets (.rs + .pose) and/or
synthetic animbank renders, with the reference's even/odd train/test split,
writing the .cnnb at each evaluation.  Recordings stream through the C++
reader (native.StreamingLoader) into the compress step.  It runs on the
card unless --device says otherwise:

    python -m hand_tracking_samples_tpu_torch.apps.train_cnn --synthetic 2048 \
        --steps 2000 --out handposedd.cnnb
    python -m hand_tracking_samples_tpu_torch.apps.train_cnn rec.rs \
        --steps 20 --batch 16 --device cpu
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..assets_paths import DEFAULT_ANIMBANK, DEFAULT_MODEL_JSON


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("recordings", nargs="*", help=".rs recordings to train on")
    ap.add_argument("--model", default=DEFAULT_MODEL_JSON)
    ap.add_argument("--animbank", default=DEFAULT_ANIMBANK)
    ap.add_argument("--synthetic", type=int, default=0,
                    help="add N synthetic animbank frames to the training set")
    ap.add_argument("--augment", action="store_true",
                    help="random global rigid transforms on synthetic poses")
    ap.add_argument("--init-cnnb", default=None, help="warm-start weights")
    ap.add_argument("--out", default="handposedd.cnnb")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--alpha", type=float, default=0.001)
    ap.add_argument("--eval-every", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the CPU)")
    args = ap.parse_args(argv)

    from ..cnn.model import init_params, load_cnnb, save_cnnb
    from ..cnn.train import (TrainingSet, compress_frame, evaluate,
                             synthetic_training_set, train_epoch)
    from ..data.animbank import load_animbank
    from ..data.dataset import DatasetInfo
    from ..device import resolve_device
    from ..model.bake import from_numpy_model, load_hand_model
    from ..native import StreamingLoader
    from ..ops.cloud_kernel import depth_tensor

    dev = resolve_device(args.device)
    model = from_numpy_model(load_hand_model(args.model), dev)
    sets = []
    for rec in args.recordings:
        bname = rec[:-3] if rec.endswith(".rs") else rec
        with open(bname + ".json") as f:
            cam = DatasetInfo.from_json_dict(json.load(f)).camera()
        parts = []
        with StreamingLoader([bname], batch=64) as sl:
            print(f"streaming {bname}: {sl.total_frames} frames")
            for depth, pose, _ in sl:
                parts.append(compress_frame(
                    depth_tensor(depth, dev), cam,
                    torch.as_tensor(pose, device=dev)))
        sets.append(TrainingSet(*[torch.cat(p) for p in zip(*parts)]))
    if args.synthetic:
        bank = load_animbank(args.animbank)
        ids = (np.arange(args.synthetic) * 613) % len(bank)
        print(f"rendering {args.synthetic} synthetic frames")
        sets.append(synthetic_training_set(model, bank, ids,
                                           augment=args.augment,
                                           seed=args.seed, device=dev))
    if not sets:
        ap.error("no training data: pass recordings and/or --synthetic N")
    data = TrainingSet(*[torch.cat(xs) for xs in zip(*sets)])
    n = data.inputs.shape[0]
    print(f"training set: {n} frames ({n // 2} train / {n // 2} test)")

    params = load_cnnb(args.init_cnnb, dev) if args.init_cnnb \
        else init_params(torch.Generator().manual_seed(args.seed), dev)
    rng = np.random.RandomState(args.seed)
    t0 = time.time()
    done = 0
    while done < args.steps:
        k = min(args.eval_every, args.steps - done)
        params, train_mse = train_epoch(params, data, rng, k, args.batch,
                                        args.alpha)
        done += k
        test_mse = evaluate(params, data)
        ex_s = done * args.batch / (time.time() - t0)
        print(f"step {done:6d}: train mse {train_mse:.6f} "
              f"test mse {test_mse:.6f}  ({ex_s:.0f} examples/s)")
        save_cnnb(params, args.out)
    print(f"saved {args.out}")


if __name__ == "__main__":
    sys.exit(main())
