"""The rest of family 1 beside the per-mode loss files: svhn ``ali`` and
celeba ``ali`` (the face script's only mode) losses and gradients against
JAX; the ``learn_std`` / ``fix_std`` posterior heads against JAX's; the
port's parameter table against the JAX ``init`` for every dataset and head;
JAX parameters carried across by ``params_from_jax`` (mnist's
``Discriminator.2.W`` beside ``Discriminator.2.Filters``,
``Extractor.Std``, the code discriminator); and the serving entries over
run directories of mnist, celeba and a ``learn_std`` mode on the CPU.

Tolerances: losses and gradients as ``tests/_torch_family1.py`` states
(atol 1e-4 of max(1, |ref|); gradient leaves 1e-4 of max(1e-2, leaf, 1e-2
of the player's largest)); the heads' outputs to atol 1e-4 (f32, up to 6
layers).
"""

import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from graphical_gan_tpu.core import registry
from graphical_gan_tpu.models import networks as jax_nets
from graphical_gan_tpu_torch.core.config import asdict as port_asdict
from graphical_gan_tpu_torch.models import networks
from graphical_gan_tpu_torch.models.common import Draws
from graphical_gan_tpu_torch.serve.server import sampler_from_run_dir
from graphical_gan_tpu_torch.train import checkpoint as ckpt_lib

from _torch_family1 import (
    check_losses, close, jax_draws, models, raw_batch, to_torch)


@pytest.mark.parametrize("dataset", ["svhn", "celeba"])
@pytest.mark.parametrize("player", ["gen", "disc"])
def test_ali_losses_match_jax(dataset, player):
    check_losses(dataset, "ali", player)


@pytest.mark.parametrize("type_q", ["learn_std", "fix_std"])
def test_posterior_heads_match_jax(type_q):
    """(z, mean, std) of the extractor with a stochastic head; eps is
    JAX's first draw under the key."""
    jm, tm, jp, tp = models("mnist", "vegan-kl", type_q=type_q)
    x = raw_batch(tm.cfg, np.random.default_rng(2))
    key = jax.random.PRNGKey(9)
    want = jax.jit(lambda p, v: registry.apply(
        lambda: jax_nets.extractor(jm.cfg, v), p, key))(jp, jnp.asarray(x))
    eps = to_torch(jax_draws(tm.cfg, key))["eps_q"]
    got = networks.extractor(tm.cfg, tp, torch.from_numpy(x),
                             Draws({"eps_q": eps}))
    for g, w in zip(got, want):
        close(g, w)
    assert float(got[2].min()) > 0


CONFIGS = [("mnist", "ali", {}), ("mnist", "wali-gp", {}),
           ("mnist", "vegan", {}), ("mnist", "vegan-kl", {}),
           ("mnist", "vae", {}), ("mnist", "alice", {"type_q": "fix_std"}),
           ("celeba", "ali", {}), ("svhn", "vegan-wgan-gp", {}),
           ("cifar10", "vegan-mmd", {})]


@pytest.mark.parametrize("dataset,mode,extra", CONFIGS)
def test_param_table_matches_jax_init(dataset, mode, extra):
    """Every parameter the JAX ``init`` makes, by name and shape, and no
    other."""
    jm, tm, _, _ = models(dataset, mode, **extra)
    jax_params = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    want = {n: tuple(v.shape) for n, v in jax_params.items()}
    got = {n: shape for n, (_, shape, _) in tm.param_specs().items()}
    assert got == want


def test_params_from_jax_carries_the_new_names():
    """Parameters under the JAX ``init``'s names and shapes (mnist's D
    Linear named 'Discriminator.2' beside the conv of that name,
    learn_std's Extractor.Std, the code discriminator) load by name and
    value, and the port's model runs on them."""
    rng = np.random.default_rng(5)
    for mode in ("ali", "vegan-kl", "vegan"):
        jm, tm, _, _ = models("mnist", mode)
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(1))
        jax_params = {n: rng.standard_normal(v.shape).astype(np.float32)
                      * 0.05 for n, v in shapes.items()}
        back = ckpt_lib.params_from_jax(jax_params, "cpu")
        assert set(back) == set(tm.param_specs())
        for n, v in jax_params.items():
            assert np.array_equal(back[n].numpy(), v), n
        raw = torch.from_numpy(raw_batch(tm.cfg, rng))
        assert torch.isfinite(tm.gen_loss(
            back, raw, generator=torch.Generator().manual_seed(0))[0])
    assert {"Discriminator.2.W", "Discriminator.2.Filters"} <= set(
        models("mnist", "ali")[3])


def _run_dir(path, dataset, mode):
    from graphical_gan_tpu_torch.core.config import gan_inference_defaults
    from graphical_gan_tpu_torch.models.gan_inference import (
        GanInferenceModel)
    from _torch_family1 import config_kw
    cfg = gan_inference_defaults(dataset, mode, **config_kw(dataset))
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(port_asdict(cfg), f)
    model = GanInferenceModel(cfg)
    params = model.init(seed=0, device="cpu")
    ckpt_lib.save_params(os.path.join(path, "ckpt_1.npz"), params,
                         {"iteration": 1})
    return cfg, model, params


@pytest.mark.parametrize("dataset,mode", [("mnist", "ali"),
                                          ("celeba", "ali"),
                                          ("mnist", "vegan-kl")])
def test_serving_entries_of_the_new_run_dirs(tmp_path, dataset, mode):
    """sampler / encoder / reconstructor on the CPU: shapes, the output
    range (sigmoid for mnist, tanh for celeba), and a seed's draws
    (celeba's input noise, learn_std's eps) fixed by the seed."""
    cfg, model, params = _run_dir(str(tmp_path / "run"), dataset, mode)
    rng = np.random.default_rng(0)
    raw = raw_batch(cfg, rng)
    lo = 0.0 if dataset == "mnist" else -1.0
    for entry, dims in (("sampler", cfg.data.output_dim),
                        ("encoder", cfg.dim_latent),
                        ("reconstructor", cfg.data.output_dim)):
        call, kinds, _, ident = sampler_from_run_dir(
            str(tmp_path / "run"), entry=entry, device="cpu")
        x = rng.standard_normal((4, cfg.dim_latent)).astype(np.float32) \
            if kinds == ["normal"] else raw
        out = call(3, x)
        assert out.shape == (4, dims) and np.isfinite(out).all()
        if entry != "encoder":
            assert out.min() >= lo and out.max() <= 1.0
        else:
            stochastic = dataset == "celeba" or mode == "vegan-kl"
            assert np.array_equal(call(3, x), out)
            assert np.array_equal(call(4, x), out) != stochastic
            gen = torch.Generator().manual_seed(3)
            direct = model.encode(params, torch.from_numpy(raw),
                                  generator=gen)
            np.testing.assert_array_equal(direct.numpy(), out)
