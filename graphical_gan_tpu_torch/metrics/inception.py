"""Inception score (``graphical_gan_tpu/metrics/inception.py``), numpy only
but for the optional torchvision classifier.

The reference pipes 50,000 samples in batches of 100 through the frozen
Inception-2015 GraphDef and computes the 10-split exp-mean-KL
(``tflib/inception_score.py:25-53``). The arithmetic is
``inception_score_from_probs``; the classifier is any callable
``images[N, H, W, C] in [0, 255] -> probs[N, K]``: the port's
``MetricClassifier`` (``metrics/classifier.py``) where no Inception weights
are on the machine, or ``TorchInceptionClassifier`` where torchvision's are.
IS numbers compare only under the same classifier.
"""

from __future__ import annotations

import math
import os
from typing import Callable, List, Sequence, Tuple

import numpy as np

#: the frozen Inception-2015 graph's default place (``tflib/
#: inception_score.py:19-20``), relative to the working directory
DEFAULT_PB = "inception_score_model/classify_image_graph_def.pb"
#: the file name of torchvision's InceptionV3 IMAGENET1K_V1 weights
INCEPTION_V3_FILE = "inception_v3_google-0cc3c7bd.pth"


def inception_score_from_probs(preds: np.ndarray, splits: int = 10
                               ) -> Tuple[float, float]:
    """The split-KL arithmetic (``inception_score.py:47-53``): per split,
    exp(mean_i KL(p(y|x_i) || p(y)))."""
    preds = np.asarray(preds, dtype=np.float64)
    n = preds.shape[0]
    scores: List[float] = []
    for i in range(splits):
        part = preds[i * n // splits:(i + 1) * n // splits]
        kl = part * (np.log(part) - np.log(np.mean(part, axis=0,
                                                   keepdims=True)))
        scores.append(float(np.exp(np.mean(np.sum(kl, axis=1)))))
    return float(np.mean(scores)), float(np.std(scores))


def get_inception_score(images: Sequence[np.ndarray],
                        classifier: Callable[[np.ndarray], np.ndarray],
                        splits: int = 10, batch_size: int = 100
                        ) -> Tuple[float, float]:
    """The reference protocol (``inception_score.py:25-46``): HWC images in
    the uint8 range, batches of 100 through the classifier, then split-KL."""
    if not len(images) or np.asarray(images[0]).ndim != 3:
        raise ValueError("get_inception_score takes a non-empty sequence "
                         "of HWC images")
    preds = []
    n_batches = int(math.ceil(len(images) / batch_size))
    for i in range(n_batches):
        chunk = np.stack(images[i * batch_size:(i + 1) * batch_size], axis=0)
        preds.append(np.asarray(classifier(chunk)))
    return inception_score_from_probs(np.concatenate(preds, axis=0), splits)


def default_is_classifier(device: str = "cuda"):
    """The IS hook's classifier, in the JAX package's order: the frozen
    Inception-2015 graph where its ``.pb`` is (``GGAN_INCEPTION_PB`` or
    ``DEFAULT_PB``), else torchvision's InceptionV3 on ``device``. The port
    has no GraphDef interpreter yet, so a present ``.pb`` raises
    ``NotImplementedError``; a machine without torchvision or its weights
    raises from ``TorchInceptionClassifier``."""
    pb = os.environ.get("GGAN_INCEPTION_PB", DEFAULT_PB)
    if os.path.isfile(pb):
        raise NotImplementedError(
            f"{pb}: the frozen Inception-2015 graph needs the GraphDef "
            "interpreter (metrics/graphdef.py, inception_frozen.py), which "
            "the port does not have yet (ROADMAP.md §1 item 7)")
    return TorchInceptionClassifier(device)


def inception_weights_path() -> str:
    """torchvision's InceptionV3 weights already on this machine:
    ``GGAN_INCEPTION_WEIGHTS``, else ``INCEPTION_V3_FILE`` in torch.hub's
    checkpoint directory, where torchvision keeps them. Nothing is
    downloaded: a missing file raises ``FileNotFoundError``."""
    path = os.environ.get("GGAN_INCEPTION_WEIGHTS")
    if path is None:
        import torch
        path = os.path.join(torch.hub.get_dir(), "checkpoints",
                            INCEPTION_V3_FILE)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"{path}: no InceptionV3 weights on this machine (set "
            "GGAN_INCEPTION_WEIGHTS; nothing is downloaded)")
    return path


class TorchInceptionClassifier:
    """InceptionV3 softmax classifier on ``device`` from local weights
    (``inception_weights_path``), built as torchvision builds it for its
    IMAGENET1K_V1 weights; raises at construction when the weights or
    torchvision are missing."""

    def __init__(self, device: str = "cuda"):
        import torch
        path = inception_weights_path()
        import torchvision
        model = torchvision.models.inception_v3(
            weights=None, aux_logits=True, transform_input=True,
            init_weights=False)
        model.load_state_dict(torch.load(path, map_location="cpu",
                                         weights_only=True))
        model.aux_logits, model.AuxLogits = False, None
        self.torch = torch
        self.model = model.eval().to(device)
        self.device = device

    def __call__(self, images: np.ndarray) -> np.ndarray:
        """images: [B, H, W, 3] in [0, 255] -> softmax probs [B, 1000]."""
        torch = self.torch
        x = torch.tensor(
            np.ascontiguousarray(images, dtype=np.float32) / 255.0
        ).permute(0, 3, 1, 2).to(self.device)
        x = torch.nn.functional.interpolate(
            x, size=(299, 299), mode="bilinear", align_corners=False)
        mean = torch.tensor([0.485, 0.456, 0.406], device=self.device)
        std = torch.tensor([0.229, 0.224, 0.225], device=self.device)
        x = (x - mean[None, :, None, None]) / std[None, :, None, None]
        with torch.no_grad():
            logits = self.model(x)
        return torch.softmax(logits, dim=1).cpu().numpy()
