"""REINFORCE surrogate for discrete latents
(``graphical_gan_tpu/objectives/discrete.py``, ``tflib/objs/
discrete_variables.py:4-8``): ``(f_k - cv) * log p_k`` with the first
factor detached, added to the loss, so that differentiating the generator
cost gives the score-function estimate for the categorical parameters."""

from __future__ import annotations

import torch


def score_function(f_k: torch.Tensor, p_k: torch.Tensor, c_v: float
                   ) -> torch.Tensor:
    return (f_k - c_v).detach() * torch.log(p_k)
