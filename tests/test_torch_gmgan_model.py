"""The port's GMGAN model against the JAX package's beyond the losses
(``tests/test_torch_gmgan_losses_*.py``): the parameters (names and shapes
of the JAX ``init`` for every dataset and mode), a JAX-initialised
checkpoint served through both servers' entries (``sampler``, ``encoder``,
``cluster``, ``reconstructor``: the port's ``cluster_probs``, ``sample``
and ``encode`` of the JAX parameters, loaded through ``params_from_jax``,
within 1e-4), ``clustering_accuracy`` against the JAX function, and the
structured loaders' rows against JAX's."""

import json
import os

import numpy as np
import jax
import pytest
import torch

from graphical_gan_tpu_torch.core.config import (
    GMGAN_MODES, asdict, gmgan_defaults)
from graphical_gan_tpu_torch.models.gmgan import GMGanModel

DATASETS = ("mnist", "cifar10", "svhn", "celeba")


@pytest.mark.parametrize("dataset", DATASETS)
def test_param_specs_are_the_jax_init_s(dataset):
    """Every mode's parameters: the JAX ``init``'s names and shapes
    (abstractly traced, no compile), at dim 8 and 5 components."""
    from graphical_gan_tpu.core.config import gmgan_defaults as jcfg
    from graphical_gan_tpu.models.gmgan import GMGanModel as J
    kw = dict(dim=8, batch_size=4, n_coms=5)
    if dataset == "celeba":
        kw.update(dim_g=8, dim_d=8)
    for mode in GMGAN_MODES:
        want = jax.eval_shape(J(jcfg(dataset, mode, **kw)).init,
                              jax.random.PRNGKey(0))
        specs = GMGanModel(gmgan_defaults(dataset, mode, **kw)).param_specs()
        assert {n: tuple(s) for n, (_, s, _) in specs.items()} == \
            {n: tuple(v.shape) for n, v in want.items()}, mode


@pytest.fixture(scope="module")
def jax_run_dir(tmp_path_factory):
    """A JAX mnist local_ep run directory (BN on): config.json and a JAX
    TrainState checkpoint of a JAX init."""
    from graphical_gan_tpu.core.config import gmgan_defaults as jcfg
    from graphical_gan_tpu.models.gmgan import GMGanModel as J
    from graphical_gan_tpu.train import checkpoint as jax_ckpt
    from graphical_gan_tpu.train.step import make_train_step
    from dataclasses import asdict as dc_asdict
    cfg = jcfg("mnist", "local_ep", dim=8, batch_size=8, n_coms=5)
    model = J(cfg)
    run_dir = str(tmp_path_factory.mktemp("gmgan_run"))
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        json.dump(dc_asdict(cfg), f, default=str)
    _, init_state = make_train_step(model, jit=False)
    from _torch_gmgan import compiled
    key = jax.random.PRNGKey(4)
    params = compiled(jax.jit(model.init), key)(key)
    jax_ckpt.save(os.path.join(run_dir, "ckpt_3.npz"), init_state(params),
                  {"iteration": 3})
    return run_dir, cfg


@pytest.mark.parametrize("entry", ["sampler", "encoder", "cluster",
                                   "reconstructor"])
def test_jax_checkpoint_serves_same_outputs(jax_run_dir, entry):
    """The port's server entry on the JAX run directory against the JAX
    model's method on the checkpoint's parameters, and the JAX export's
    input kinds and shapes."""
    from graphical_gan_tpu.core import registry
    from graphical_gan_tpu.models.gmgan import GMGanModel as J
    from graphical_gan_tpu.serve.export import make_entry as jax_make_entry
    from graphical_gan_tpu.train import checkpoint as jax_ckpt
    from graphical_gan_tpu_torch.serve.server import sampler_from_run_dir
    run_dir, cfg = jax_run_dir
    model = J(cfg)
    _, jexample, jkinds = jax_make_entry("gmgan", model, entry)
    pcall, pkinds, pshapes, pident = sampler_from_run_dir(run_dir,
                                                          entry=entry,
                                                          device="cpu")
    assert pkinds == list(jkinds)
    assert pshapes == [tuple(a.shape) for a in jexample]
    assert (pident["family"], pident["checkpoint"], pident["iteration"]) \
        == ("gmgan", "ckpt_3.npz", 3)
    flat, _ = jax_ckpt.load_raw(os.path.join(run_dir, "ckpt_3.npz"))
    params = {k[len("n:params|k:"):]: v for k, v in flat.items()
              if k.startswith("n:params|k:")}
    rng = np.random.default_rng(1)
    if entry == "sampler":
        assert pkinds == ["onehot", "normal"]
        x = (np.eye(cfg.n_coms, dtype=np.float32)[rng.integers(0, 5, 6)],
             rng.standard_normal((6, cfg.dim_latent)).astype(np.float32))
    else:
        x = (rng.random((6, cfg.data.output_dim), dtype=np.float32),)
    method = {"sampler": model.sample, "encoder": model.encode,
              "cluster": model.cluster_probs,
              "reconstructor": model.reconstruct}[entry]
    want = np.asarray(registry.jit_apply(method)(
        params, jax.random.PRNGKey(0), *x))
    got = pcall(0, *x)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    if entry == "cluster":
        assert pident["output"] == "probs"
        np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("seed", range(4))
def test_clustering_accuracy_matches_jax(seed):
    from graphical_gan_tpu.metrics.clustering import (
        clustering_accuracy as jax_acc)
    from graphical_gan_tpu_torch.metrics.clustering import (
        clustering_accuracy)
    rng = np.random.default_rng(seed)
    probs = rng.dirichlet(np.ones(7), size=200).astype(np.float32)
    y = rng.integers(0, 10, 200)
    if seed == 3:  # a perfect clustering: each class its own component
        y = rng.integers(0, 7, 200)
        probs = np.eye(7, dtype=np.float32)[y] * 0.9 + 0.1 / 7
    got = clustering_accuracy(probs, y)
    assert got == jax_acc(probs, y)
    assert seed != 3 or got == 1.0


@pytest.mark.parametrize("dataset", ["mnist", "cifar10"])
def test_structured_loaders_rows_match_jax(dataset):
    """(train, dev, test) epochs, rows and labels, at a small size; and
    the same defaults (20,000 / 2,000, seed 0)."""
    import inspect
    from graphical_gan_tpu.core.config import gmgan_defaults as jcfg
    from graphical_gan_tpu.runs import gmgan as jax_run
    from graphical_gan_tpu_torch.runs import gmgan as port_run
    for fn in (jax_run._structured_loaders, port_run._structured_loaders):
        p = inspect.signature(fn).parameters
        assert (p["n_classes"].default, p["seed"].default,
                p["n_train"].default, p["n_eval"].default) == \
            (10, 0, 20000, 2000)
    kw = dict(n_train=100, n_eval=20)
    ours = port_run._structured_loaders(gmgan_defaults(dataset,
                                                       batch_size=10), **kw)
    theirs = jax_run._structured_loaders(jcfg(dataset, batch_size=10), **kw)
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        for _ in range(2):  # two epochs of each factory
            got, want = list(a()), list(b())
            assert len(got) == len(want) > 0
            for (xa, ya), (xb, yb) in zip(got, want):
                assert xa.dtype == xb.dtype
                np.testing.assert_array_equal(xa, xb)
                np.testing.assert_array_equal(ya, yb)


def test_config_json_round_trips_with_jax():
    """A port gmgan config.json is the JAX GMGanConfig's fields, so either
    package rebuilds the other's run directory."""
    from dataclasses import fields
    from graphical_gan_tpu.core.config import GMGanConfig as JaxCfg
    from graphical_gan_tpu.core.config import gmgan_defaults as jcfg
    for ds in DATASETS:
        for mode in GMGAN_MODES:
            ours = asdict(gmgan_defaults(ds, mode))
            assert ours == {f.name: getattr(jcfg(ds, mode), f.name)
                            for f in fields(JaxCfg)}
    with pytest.raises(ValueError, match="MODE_K"):
        gmgan_defaults("mnist", mode_k="GUMBEL")
    with pytest.raises(ValueError, match="mode"):
        gmgan_defaults("mnist", "wali-gp")


def test_sample_gumbel_and_score_function_match_jax():
    from graphical_gan_tpu.objectives.discrete import (
        score_function as jax_sf)
    from graphical_gan_tpu.ops.activations import sample_gumbel as jax_g
    from graphical_gan_tpu_torch.objectives.discrete import score_function
    from graphical_gan_tpu_torch.ops.activations import sample_gumbel
    key = jax.random.PRNGKey(2)
    u = np.array(jax.random.uniform(key, (6, 5)))
    np.testing.assert_allclose(sample_gumbel(torch.from_numpy(u)).numpy(),
                               np.asarray(jax_g(key, (6, 5))), rtol=1e-6,
                               atol=1e-6)
    f = np.random.default_rng(0).standard_normal(6).astype(np.float32)
    p = np.random.default_rng(1).random(6).astype(np.float32) + 0.1
    f_t = torch.from_numpy(f).requires_grad_(True)
    p_t = torch.from_numpy(p).requires_grad_(True)
    s = score_function(f_t, p_t, 0.5)
    np.testing.assert_allclose(s.detach().numpy(),
                               np.asarray(jax_sf(f, p, 0.5)), rtol=1e-6)
    gf, gp = torch.autograd.grad(s.sum(), [f_t, p_t], allow_unused=True)
    jgf, jgp = jax.grad(lambda a, b: jax_sf(a, b, 0.5).sum(),
                        argnums=(0, 1))(f, p)
    # f_k is detached: no gradient reaches it (JAX's is zeros)
    assert gf is None and not np.asarray(jgf).any()
    np.testing.assert_allclose(gp.numpy(), np.asarray(jgp), rtol=1e-6)
