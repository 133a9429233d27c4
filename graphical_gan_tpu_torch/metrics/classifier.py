"""The metric classifier (``graphical_gan_tpu/metrics/jax_classifier.py``)
on the port's ops: a small conv classifier over flat NCHW-ordered integer
images, trained supervised on a labeled set, whose softmax feeds the
inception score's split-KL (``metrics/inception.py``) and whose pooled
penultimate features feed FID (``metrics/fid.py``). Scores compare across
runs that share one trained classifier.

Three 3x3 stride-2 SAME convs (``ops/conv.py: conv2d``, the K1 kernel with
the leaky ReLU in its epilogue on the first), batch-statistics BN with the
leaky ReLU after the other two (``ops/norm.py: batchnorm_act``: K2a/K2b
forward, K2c+K2d backward), a global average pool and a dense layer, in
f32. Parameter names are the JAX ones, ``Classifier.{1,2,3,BN2,BN3,
Output}.*``, so JAX parameters load through ``train/checkpoint.py:
params_from_jax``. ``fit`` draws its batch indices from
``np.random.RandomState(seed)`` as JAX does, and trains with TF1 Adam
(1e-3, 0.9, 0.999). Every call keeps BN on batch statistics, so features
depend on the batch (see ``metrics/fid.py: compute_fid``).
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from graphical_gan_tpu_torch.core.device import resolve_device
from graphical_gan_tpu_torch.ops import (
    batchnorm_act, conv2d, initializers, linear, unflatten_image)
from graphical_gan_tpu_torch.optim.optimizers import Adam

Params = Dict[str, torch.Tensor]


def _flat_of_hwc(images_hwc) -> np.ndarray:
    """[N, H, W, C] images -> [N, C*H*W] int32 in NCHW order (floats
    truncate, as the JAX scoring functions' ``astype(np.int32)``)."""
    x = np.transpose(np.asarray(images_hwc), (0, 3, 1, 2))
    return x.reshape(x.shape[0], -1).astype(np.int32)


class MetricClassifier:
    """Small conv classifier over flat NCHW-ordered int images."""

    def __init__(self, image_hw=(32, 32), channels=3, n_classes=10, dim=64,
                 device: Union[str, torch.device] = "cuda"):
        self.image_hw = tuple(image_hw)
        self.channels = channels
        self.n_classes = n_classes
        self.dim = dim
        self.device = resolve_device(device)

    def param_specs(self):
        """Every parameter of the JAX ``init``, by name (the format of
        ``ops/initializers.py: init_params``)."""
        d, c = self.dim, self.channels
        s = {}
        for i, (cin, cout) in enumerate(((c, d), (d, 2 * d), (2 * d, 4 * d)),
                                        1):
            s[f"Classifier.{i}.Filters"] = ("conv", (3, 3, cin, cout),
                                            (cin, cout, 3, 2))
            s[f"Classifier.{i}.Biases"] = ("zeros", (cout,), ())
            if i > 1:
                s[f"Classifier.BN{i}.offset"] = ("zeros", (cout,), ())
                s[f"Classifier.BN{i}.scale"] = ("ones", (cout,), ())
        s["Classifier.Output.W"] = ("linear", (4 * d, self.n_classes),
                                    (4 * d, self.n_classes))
        s["Classifier.Output.b"] = ("zeros", (self.n_classes,), ())
        return s

    def init(self, seed: int = 0) -> Params:
        """Fresh parameters on the classifier's device (the JAX init's
        statistics; the values differ from JAX's for the same seed)."""
        return initializers.init_params(self.param_specs(), seed, self.device)

    def _input(self, x_flat) -> torch.Tensor:
        if not isinstance(x_flat, torch.Tensor):
            x_flat = torch.from_numpy(np.ascontiguousarray(x_flat))
        return x_flat.to(self.device)

    def trunk(self, params: Params, x_flat) -> torch.Tensor:
        """Pooled penultimate features [B, 4*dim] (also the FID features)."""
        h_, w_ = self.image_hw
        x = 2.0 * (self._input(x_flat).float() / 255.0 - 0.5)
        x = unflatten_image(x, self.channels, h_, w_)
        h = conv2d(params, "Classifier.1", x, stride=2, act="leaky_relu")
        for i in (2, 3):
            h = batchnorm_act(params, f"Classifier.BN{i}",
                              conv2d(params, f"Classifier.{i}", h, stride=2),
                              "leaky_relu")
        return h.mean(dim=(1, 2))  # global average pool

    def forward(self, params: Params, x_flat) -> torch.Tensor:
        return linear(params, "Classifier.Output", self.trunk(params, x_flat))

    # -- training -------------------------------------------------------------

    def make_train_step(self, lr: float = 1e-3):
        """``(step, opt_init)``: ``step(params, opt_state, x, y)`` updates
        params and the Adam state in place and returns (loss, acc) as
        device scalars."""
        opt = Adam(lr=lr, beta1=0.9, beta2=0.999)

        def step(params: Params, opt_state: dict, x, y):
            leaves = {n: p.detach().requires_grad_(True)
                      for n, p in params.items()}
            logits = self.forward(leaves, x)
            y = self._input(y).long()
            logp = torch.log_softmax(logits, dim=1)
            nll = -logp.gather(1, y[:, None]).mean()
            grads = torch.autograd.grad(nll, list(leaves.values()))
            opt.update(dict(zip(leaves, grads)), opt_state, params)
            acc = (logits.detach().argmax(dim=1) == y).float().mean()
            return nll.detach(), acc

        return step, opt.init

    def fit(self, images: np.ndarray, labels: np.ndarray,
            steps: int = 2000, batch_size: int = 256, lr: float = 1e-3,
            seed: int = 0, log_every: int = 0,
            params: Optional[Params] = None) -> Params:
        """Train from ``init(seed)`` (or from ``params``, trained in place)
        on batches drawn with replacement by ``RandomState(seed)``; the
        images and labels are uploaded once."""
        params = self.init(seed) if params is None else params
        step, opt_init = self.make_train_step(lr)
        opt_state = opt_init(params)
        rng = np.random.RandomState(seed)
        x_all = self._input(images)
        y_all = self._input(np.asarray(labels).astype(np.int64))
        for i in range(steps):
            idx = torch.from_numpy(
                rng.randint(0, len(images), size=batch_size)).to(self.device)
            loss, acc = step(params, opt_state, x_all.index_select(0, idx),
                             y_all.index_select(0, idx))
            if log_every and i % log_every == log_every - 1:
                print(f"classifier step {i + 1}: loss={float(loss):.4f} "
                      f"acc={float(acc):.3f}")
        return params

    # -- scoring --------------------------------------------------------------

    def as_feature_fn(self, params: Params):
        """``images[N, H, W, C] in [0, 255] -> feats[N, 4*dim]`` (numpy),
        one batch-statistics forward over all N."""

        @torch.no_grad()
        def feature_fn(images_hwc) -> np.ndarray:
            return self.trunk(params, _flat_of_hwc(images_hwc)).cpu().numpy()

        return feature_fn

    def as_prob_fn(self, params: Params):
        """``images[N, H, W, C] in [0, 255] -> probs[N, K]`` (numpy) for
        ``metrics/inception.py: get_inception_score``."""

        @torch.no_grad()
        def classifier(images_hwc) -> np.ndarray:
            logits = self.forward(params, _flat_of_hwc(images_hwc))
            return torch.softmax(logits, dim=1).cpu().numpy()

        return classifier

    @torch.no_grad()
    def accuracy(self, params: Params, images: np.ndarray,
                 labels: np.ndarray, batch_size: int = 512) -> float:
        """Held-out accuracy over batches of ``batch_size`` (the last one
        partial), counted on the device and fetched once."""
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        y_all = self._input(np.asarray(labels).astype(np.int64))
        for i in range(0, len(images), batch_size):
            logits = self.forward(params, images[i:i + batch_size])
            correct += (logits.argmax(dim=1)
                        == y_all[i:i + batch_size]).sum()
        return int(correct) / len(images)
