"""Expert parallelism for the mixture family, GMGAN (``graphical_gan_tpu/
parallel/expert.py``): a ``(data, expert)`` mesh over the mixture's
components.

``Generator.Hyper.Mu [n_coms, dim_latent]`` and its Adam moments are held
in blocks of components over ``expert``: n_coms / E rows a rank. Then, in
``models/gmgan.py`` through ``core/shard_ctx.py``:

- the component logits ``[B, n_coms/E]`` (the squared distances to the
  rank's means) are computed locally;
- the softmax and argmax over components take their max and sum over the
  ranks (``component_softmax``, ``component_argmax_one_hot``);
- the prior product ``k @ Mu`` is the rank's partial product plus a sum
  over the group (``sum_components``);
- the categorical draws (the Gumbel noise, the prior's component) are
  drawn whole, ``[B, n_coms]``, from the seed every rank shares, and the
  rank takes its block (``constrain_components``); the discriminators read
  k gathered whole (``gather_components``).

The rest of the program (convs, the Ds) is replicated over ``expert`` and
runs identically on its ranks. An n_coms the group does not divide keeps
``Mu`` whole, as in JAX.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def ep_param_shardings(params: Dict[str, torch.Tensor], mesh,
                       expert_axis: str = "expert"
                       ) -> Dict[str, Tuple[str, int]]:
    """{name: (expert_axis, 0)}: the mixture means, where ``expert``
    divides their rows; everything else replicated."""
    size = mesh.shape[expert_axis]
    return {n: (expert_axis, 0) for n, p in params.items()
            if n.endswith(".Mu") and p.ndim == 2 and p.shape[0] % size == 0}


def make_ep_train_step(model, mesh, data_axis: str = "data",
                       expert_axis: str = "expert", lr_scale=None):
    """EP over a ``(data, expert)`` mesh. Returns ``(step, init_state,
    place, gather_state)`` as ``parallel/mesh.py: make_sharded_step``."""
    from graphical_gan_tpu_torch.parallel.mesh import make_sharded_step
    if model.cfg.n_coms % mesh.shape[expert_axis]:
        expert_axis = None  # Mu whole, the component axis unsplit
    return make_sharded_step(
        model, mesh, stats_axes=(data_axis,), expert_axis=expert_axis,
        shardings=None if expert_axis is None else (
            lambda params: ep_param_shardings(params, mesh, expert_axis)),
        lr_scale=lr_scale)
