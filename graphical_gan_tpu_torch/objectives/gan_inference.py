"""Adversarial-inference losses over (data, code) pairs
(``graphical_gan_tpu/objectives/gan_inference.py``). Each returns
``(gen_cost, disc_cost)``. The sigmoid-CE losses train the generator with
both labels flipped (fake -> 1 and real -> 0), as the reference does; the
means are taken in the scores' dtype, as ``jnp.mean`` does. ``s_f`` is
GMGAN's REINFORCE surrogate (``objectives/discrete.py``), added to the
generator cost where the reference adds it (``gan_inference.py:65-66``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from graphical_gan_tpu_torch.objectives.common import sigmoid_ce

Pair = Tuple[torch.Tensor, torch.Tensor]


def wali(disc_fake: torch.Tensor, disc_real: torch.Tensor) -> Pair:
    """Wasserstein ALI (``gan_inference.py:4-26``); the reference's
    generator cost is ``-E[f] - E[r]``, both negative, reproduced."""
    gen_cost = -disc_fake.mean() - disc_real.mean()
    disc_cost = disc_fake.mean() - disc_real.mean()
    return gen_cost, disc_cost


def wali_gp(disc_fake: torch.Tensor, disc_real: torch.Tensor,
            gradient_penalty: torch.Tensor) -> Pair:
    """Wasserstein ALI + gradient penalty (``gan_inference.py:28-45``)."""
    gen_cost = -disc_fake.mean() + disc_real.mean()
    disc_cost = disc_fake.mean() - disc_real.mean() + gradient_penalty
    return gen_cost, disc_cost


def ali(disc_fake: torch.Tensor, disc_real: torch.Tensor,
        s_f: Optional[torch.Tensor] = None) -> Pair:
    """Sigmoid-CE ALI with one joint discriminator
    (``gan_inference.py:47-79``)."""
    gen_cost = sigmoid_ce(disc_fake, 1.0) + sigmoid_ce(disc_real, 0.0)
    disc_cost = sigmoid_ce(disc_fake, 0.0) + sigmoid_ce(disc_real, 1.0)
    if s_f is not None:
        gen_cost = gen_cost + s_f
    return gen_cost, disc_cost


def local_ep(disc_fake_list: Sequence[torch.Tensor],
             disc_real_list: Sequence[torch.Tensor],
             s_f: Optional[torch.Tensor] = None) -> Pair:
    """The paper's method: CE averaged over local discriminators
    (``gan_inference.py:81-119``); ``s_f`` is added before the division
    by the list's length, as the reference adds it."""
    gen_cost = torch.zeros((), device=disc_fake_list[0].device)
    disc_cost = torch.zeros((), device=disc_fake_list[0].device)
    for df, dr in zip(disc_fake_list, disc_real_list):
        gen_cost = gen_cost + sigmoid_ce(df, 1.0) + sigmoid_ce(dr, 0.0)
        disc_cost = disc_cost + sigmoid_ce(df, 0.0) + sigmoid_ce(dr, 1.0)
    if s_f is not None:
        gen_cost = gen_cost + s_f
    n = len(disc_fake_list)
    return gen_cost / n, disc_cost / n


def local_epce(disc_fake_list: Sequence[torch.Tensor],
               disc_real_list: Sequence[torch.Tensor],
               rec_penalty: torch.Tensor,
               s_f: Optional[torch.Tensor] = None) -> Pair:
    """local_ep + reconstruction penalty on the generator, added after the
    division (``gan_inference.py:121-159``)."""
    gen_cost, disc_cost = local_ep(disc_fake_list, disc_real_list, s_f)
    return gen_cost + rec_penalty, disc_cost


def alice(disc_fake: torch.Tensor, disc_real: torch.Tensor,
          rec_penalty: torch.Tensor,
          s_f: Optional[torch.Tensor] = None) -> Pair:
    """ALI + reconstruction penalty on the generator
    (``gan_inference.py:161-192``)."""
    gen_cost, disc_cost = ali(disc_fake, disc_real, s_f)
    return gen_cost + rec_penalty, disc_cost


def vegan(disc_fake: torch.Tensor, disc_real: torch.Tensor,
          rec_penalty: torch.Tensor, lamb: float,
          s_f: Optional[torch.Tensor] = None) -> Pair:
    """VEEGAN-style code-space objective (``gan_inference.py:194-223``):
    gen = lamb·(CE(fake -> 1) [+ s_f]) + rec; disc = (lamb/2)·(CE of
    both)."""
    gen_cost = sigmoid_ce(disc_fake, 1.0)
    if s_f is not None:
        gen_cost = gen_cost + s_f
    gen_cost = gen_cost * lamb + rec_penalty
    disc_cost = (sigmoid_ce(disc_fake, 0.0) + sigmoid_ce(disc_real, 1.0)) \
        * (lamb / 2.0)
    return gen_cost, disc_cost


def vegan_wgan_gp(disc_fake: torch.Tensor, disc_real: torch.Tensor,
                  rec_penalty: torch.Tensor, gradient_penalty: torch.Tensor,
                  lamb: float) -> Pair:
    """Wasserstein vegan + gradient penalty (``gan_inference.py:225-244``)."""
    gen_cost = (-disc_fake.mean() + disc_real.mean()) * lamb + rec_penalty
    disc_cost = (disc_fake.mean() - disc_real.mean()) * lamb \
        + gradient_penalty
    return gen_cost, disc_cost


def local_ep_dynamic(disc_fake_zz: Sequence[torch.Tensor],
                     disc_real_zz: Sequence[torch.Tensor],
                     disc_fake_xz: torch.Tensor, disc_real_xz: torch.Tensor,
                     rec_penalty: Optional[torch.Tensor] = None) -> Pair:
    """A list of zz-pair discriminators and one xz discriminator
    (``gan_inference.py:246-304``): the zz sum is divided by its length +
    1, and the xz terms are added after that division, as the reference
    does."""
    gen_cost = torch.zeros((), device=disc_fake_xz.device)
    disc_cost = torch.zeros((), device=disc_fake_xz.device)
    for df, dr in zip(disc_fake_zz, disc_real_zz):
        gen_cost = gen_cost + sigmoid_ce(df, 1.0) + sigmoid_ce(dr, 0.0)
        disc_cost = disc_cost + sigmoid_ce(df, 0.0) + sigmoid_ce(dr, 1.0)
    if len(disc_fake_zz) > 0:
        gen_cost = gen_cost / (len(disc_fake_zz) + 1)
        disc_cost = disc_cost / (len(disc_fake_zz) + 1)
    gen_cost = gen_cost + sigmoid_ce(disc_fake_xz, 1.0) \
        + sigmoid_ce(disc_real_xz, 0.0)
    disc_cost = disc_cost + sigmoid_ce(disc_fake_xz, 0.0) \
        + sigmoid_ce(disc_real_xz, 1.0)
    if rec_penalty is not None:
        gen_cost = gen_cost + rec_penalty
    return gen_cost, disc_cost


def weighted_local_epce(disc_fake_list: Sequence[torch.Tensor],
                        disc_real_list: Sequence[torch.Tensor],
                        ratio_list,
                        rec_penalty: Optional[torch.Tensor] = None):
    """SSGAN's per-discriminator weighted CE (``gan_inference.py:
    307-358``): ``(gen, disc, gen_debug, disc_debug)``, the debug lists each
    discriminator's weighted contribution; ``rec_penalty`` (local_epce-z's)
    is added to the generator cost after the sum."""
    if len(disc_fake_list) != len(ratio_list):
        raise ValueError(f"{len(disc_fake_list)} discriminators, "
                         f"{len(ratio_list)} weights")
    dev = disc_fake_list[0].device
    gen_cost = torch.zeros((), device=dev)
    disc_cost = torch.zeros((), device=dev)
    gen_debug, disc_debug = [], []
    for df, dr, ratio in zip(disc_fake_list, disc_real_list, ratio_list):
        # the weight rounded to f32 first, as jnp.float32(ratio)
        r = torch.tensor(float(ratio), dtype=torch.float32).item()
        g = r * sigmoid_ce(df, 1.0) + r * sigmoid_ce(dr, 0.0)
        d = r * sigmoid_ce(df, 0.0) + r * sigmoid_ce(dr, 1.0)
        gen_cost = gen_cost + g
        disc_cost = disc_cost + d
        gen_debug.append(g)
        disc_debug.append(d)
    if rec_penalty is not None:
        gen_cost = gen_cost + rec_penalty
    return gen_cost, disc_cost, gen_debug, disc_debug
