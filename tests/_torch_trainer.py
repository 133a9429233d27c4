"""The small Trainer of the port's failure-handling tests (JAX
``tests/test_trainer.py: make_trainer``): mnist ``ali`` (or ``dataset``
and ``mode``) at dim 8, B 8, on 64 random rows (integer pixels where the
dataset's are), on the CPU; host-fed through a loader factory unless
``resident`` (the rows uploaded once, each iteration's batches gathered
on the device)."""

import numpy as np

from graphical_gan_tpu_torch.core.config import gan_inference_defaults
from graphical_gan_tpu_torch.data.common import generator_factory
from graphical_gan_tpu_torch.models.gan_inference import GanInferenceModel
from graphical_gan_tpu_torch.train.trainer import Trainer


def make_trainer(tmp_path, resident=False, rows=64, dataset="mnist",
                 mode="ali", **kw):
    cfg = gan_inference_defaults(dataset, mode, dim=8, batch_size=8)
    rng = np.random.RandomState(0)
    x = rng.rand(rows, cfg.data.output_dim).astype("float32")
    if cfg.data.normalization != "unit":
        x = np.floor(x * 256.0).astype("float32")
    y = rng.randint(0, 10, size=rows)
    train = generator_factory(8, x, y, seed=0)
    dev = generator_factory(8, x[:16], y[:16], seed=1)
    return Trainer(GanInferenceModel(cfg), x if resident else None,
                   str(tmp_path), device="cpu", dev_gen_factory=dev,
                   train_gen_factory=None if resident else train, **kw)
