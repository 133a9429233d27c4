"""Train and save the metric classifier (``graphical_gan_tpu/tools/
train_classifier.py``): the port's ``MetricClassifier`` trained supervised
on a labeled dataset, its parameters saved as an npz under the JAX names
(``train/checkpoint.py: save_dict``), which either package loads, so every
comparison can use one shared instrument.

    python -m graphical_gan_tpu_torch.tools.train_classifier \\
        --dataset cifar10 --data-dir DIR --steps 3000 --out clf_cifar10.npz

Without ``--data-dir`` (or without the files there) the loader's synthetic
fallback trains it. Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def load_arrays(dataset: str, data_dir):
    """((train images, labels), (test images, labels)): the whole train
    split and up to 10,000 test images, in 256-row epoch batches."""
    from graphical_gan_tpu_torch.data import cifar10, mnist, svhn
    if dataset == "cifar10":
        train, test = cifar10.load(256, data_dir)
    elif dataset == "svhn":
        train, test = svhn.load(256, data_dir)
    elif dataset == "mnist":
        path = os.path.join(data_dir, mnist.FILENAME) if data_dir else None
        train, _, test = mnist.load(256, 256, path=path)
    else:
        raise ValueError(dataset)

    def collect(factory, limit=None):
        xs, ys = [], []
        n = 0
        for x, y in factory():
            xs.append(np.asarray(x))
            ys.append(np.asarray(y))
            n += len(x)
            if limit and n >= limit:
                break
        return np.concatenate(xs), np.concatenate(ys)

    return collect(train), collect(test, limit=10000)


def main(argv=None) -> dict:
    from graphical_gan_tpu_torch.core.config import dataset_spec
    from graphical_gan_tpu_torch.core.device import set_numerics
    from graphical_gan_tpu_torch.metrics.classifier import MetricClassifier
    from graphical_gan_tpu_torch.train import checkpoint

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", default="cifar10",
                   choices=["cifar10", "svhn", "mnist"])
    p.add_argument("--data-dir", default=None)
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="metric_classifier.npz")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")
    args = p.parse_args(argv)

    (train_x, train_y), (test_x, test_y) = load_arrays(args.dataset,
                                                       args.data_dir)
    spec = dataset_spec(args.dataset)
    # mnist arrives as floats in [0, 1]; the classifier takes [0, 255]
    if train_x.dtype != np.int32 and train_x.max() <= 1.5:
        train_x = (train_x * 255).astype(np.int32)
        test_x = (test_x * 255).astype(np.int32)

    clf = MetricClassifier(image_hw=spec.image_hw, channels=spec.channels,
                           n_classes=int(train_y.max()) + 1, dim=args.dim,
                           device=args.device)
    set_numerics()
    params = clf.fit(train_x.astype(np.int32), train_y, steps=args.steps,
                     batch_size=args.batch_size, lr=args.lr, seed=args.seed,
                     log_every=max(1, args.steps // 10))
    acc = clf.accuracy(params, test_x.astype(np.int32), test_y)
    checkpoint.save_dict(args.out, params,
                         extra={"dataset": args.dataset, "dim": args.dim,
                                "test_accuracy": acc})
    rec = {"out": args.out, "test_accuracy": round(acc, 4),
           "dataset": args.dataset, "dim": args.dim}
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
