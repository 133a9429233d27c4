"""The pipeline's state layout against the JAX package's (``graphical_gan
_tpu_torch/parallel/pipeline.py`` vs ``graphical_gan_tpu/parallel/
pipeline.py``), at dim 8: the packed rows equal JAX's ``pack_stacked``
byte for byte at 2 and 4 stages (families 1 and 2), the stage partitions
are JAX's, disjoint and complete, and each trunk followed by its head
equals the whole network; pipeline npz checkpoints written by either
package load in the other; a standard state packs as JAX packs it and
comes back bit for bit; ``tools/generate.py: restore_params`` reads the
packed layouts (npz and sharded) at both stage counts; the cuts JAX
refuses are refused.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import _torch_pipeline as tpl
from _torch_threads import one_thread  # noqa: F401
from graphical_gan_tpu.parallel import pipeline as jpp
from graphical_gan_tpu.train import checkpoint as jckpt
from graphical_gan_tpu_torch.parallel import pipeline as pp
from graphical_gan_tpu_torch.train import checkpoint

CUTS = {"gan-cifar10-ali-2": ("gan", "cifar10", "ali", 2, {}),
        "gan-cifar10-wali-gp-2": ("gan", "cifar10", "wali-gp", 2, {}),
        "gan-cifar10-ali-4": ("gan", "cifar10", "ali", 4, {}),
        "gan-svhn-ali-4": ("gan", "svhn", "ali", 4, {}),
        "gmgan-mnist-local_ep-2": ("gmgan", "mnist", "local_ep", 2,
                                   {"mode_k": "REINFORCE"})}


def _case(name):
    family, dataset, mode, n, kw = CUTS[name]
    jm, tm, jp, tp = tpl.models(family, dataset, mode, **kw)
    jm.init = lambda key: jp  # the JAX cut reads names and shapes only
    return jm, tm, jp, tp, n


@pytest.mark.parametrize("name", list(CUTS))
def test_packed_rows_equal_jax_byte_for_byte(name):
    jm, tm, jp, tp, n = _case(name)
    j_templates = jpp._normalized_stages(jm, n)[0]
    want = np.asarray(jpp.pack_stacked(jm, jp, j_templates))
    stages = pp.normalized_stages(tm, n)
    got = pp.pack_stacked(tp, stages.templates).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    back = pp.unpack_stacked(torch.from_numpy(got), stages.templates)
    assert set(back) == set(tp)
    for k, v in tp.items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("name", list(CUTS))
def test_partition_is_jax_s_disjoint_and_complete(name):
    jm, tm, jp, tp, n = _case(name)
    j_templates = jpp._normalized_stages(jm, n)[0]
    stages = pp.normalized_stages(tm, n)
    seen = set()
    for t, jt in zip(stages.templates, j_templates):
        names = set(t.names)
        assert names == {e[0] for e in jt.entries}
        assert not names & seen
        seen |= names
    assert seen == set(tp)
    assert stages.gen_rows == jpp._normalized_stages(jm, n)[3]


def test_trunk_then_head_is_the_whole_network():
    from graphical_gan_tpu.core import registry
    from graphical_gan_tpu.models import networks as jnet
    from graphical_gan_tpu_torch.models import networks
    from graphical_gan_tpu_torch.ops.layout import unflatten_image
    jm, tm, jp, tp, _ = _case("gan-cifar10-ali-4")
    cfg = tm.cfg
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (8, cfg.data.output_dim)).astype(np.float32)
    z = rng.standard_normal((8, cfg.dim_latent)).astype(np.float32)
    xt, zt = torch.from_numpy(x), torch.from_numpy(z)
    img = unflatten_image(xt, cfg.data.channels, *cfg.data.image_hw)
    whole_q, _, _ = networks.extractor(cfg, tp, xt)
    split_q, _, _ = networks.extractor_back(
        cfg, tp, networks.extractor_front(cfg, tp, img))
    assert torch.equal(whole_q, split_q)
    whole_d = networks.discriminator_xz(cfg, tp, xt, zt)
    split_d = networks.discriminator_xz_head(
        cfg, tp, networks.discriminator_x_trunk(cfg, tp, img), zt)
    assert torch.equal(whole_d, split_d)
    want = registry.apply(lambda: jnet.discriminator_xz(
        jm.cfg, jnp.asarray(x), jnp.asarray(z)), jp, jax.random.PRNGKey(0))
    np.testing.assert_allclose(whole_d.numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


def _filled(tm, tp, n, seed=0):
    """A port pp state with every leaf non-trivial."""
    stages = pp.normalized_stages(tm, n)
    state = pp._state(pp.pack_stacked(tp, stages.templates))
    g = torch.Generator().manual_seed(seed)
    state["m"] = torch.randn(state["packed"].shape, generator=g)
    state["v"] = torch.rand(state["packed"].shape, generator=g)
    state["t"] = torch.arange(1, n + 1, dtype=torch.int32) * 3
    state["step"] = 7
    return state


@pytest.mark.parametrize("name", ["gan-cifar10-wali-gp-2",
                                  "gan-cifar10-ali-4",
                                  "gmgan-mnist-local_ep-2"])
def test_pp_npz_loads_across_the_packages(name, tmp_path):
    jm, tm, jp, tp, n = _case(name)
    # the port writes, JAX reads
    mine = _filled(tm, tp, n)
    path = str(tmp_path / "ckpt_4.npz")
    checkpoint.save_state(path, mine, {"iteration": 4})
    got, extra = jckpt.restore(path, jpp.pp_state_like(jm, n))
    assert extra["iteration"] == 4 and int(got["step"]) == 7
    for f in ("packed", "m", "v", "t"):
        assert np.array_equal(np.asarray(got[f]), mine[f].numpy()), f
    j_params, _ = jpp.restore_pp_params(jm, path)
    for k, v in j_params.items():
        assert np.array_equal(np.asarray(v), tp[k].numpy()), k
    # JAX writes, the port reads
    jstate = {f: jnp.asarray(mine[f].numpy()) for f in ("packed", "m", "v",
                                                        "t")}
    jstate["step"] = jnp.asarray(7, jnp.int32)
    jpath = str(tmp_path / "ckpt_5.npz")
    jckpt.save(jpath, jstate, extra={"iteration": 5})
    back, extra = checkpoint.restore_state(jpath, pp.pp_state_like(tm, n))
    assert extra["iteration"] == 5 and back["step"] == 7
    for f in ("packed", "m", "v", "t"):
        assert torch.equal(back[f], mine[f]), f
    params, _ = pp.restore_pp_params(tm, jpath)
    for k, v in tp.items():
        assert torch.equal(params[k], v), k


@pytest.mark.parametrize("n", [2, 4])
def test_standard_state_packs_as_jax_and_comes_back(n, tmp_path):
    from graphical_gan_tpu.train.step import make_train_step as jax_make
    from graphical_gan_tpu_torch.train.step import make_train_step
    jm, tm, jp, tp, _ = _case("gan-cifar10-ali-4")
    step, init = make_train_step(tm)
    ts = init({k: v.clone() for k, v in tp.items()})
    rng = np.random.default_rng(1)
    for it in range(2):  # moments and step counts of both players
        raw = torch.from_numpy(tpl.f1.raw_batch(tm.cfg, rng, lead=(2,)))
        ts, _ = step(ts, raw, it > 0, torch.Generator().manual_seed(it))
    mine = pp.pp_state_from_train_state(tm, ts, n)
    # JAX packs the same state (read from the port's npz) identically
    path = str(tmp_path / "std.npz")
    checkpoint.save_state(path, ts)
    jts, _ = jckpt.restore(path, jax_make(jm, jit=False)[1](jp))
    want = jpp.pp_state_from_train_state(jm, jts, n_stages=n)
    for f in ("packed", "m", "v", "t"):
        assert np.asarray(want[f]).tobytes() == mine[f].numpy().tobytes(), f
    assert int(want["step"]) == mine["step"] == 2
    back = pp.train_state_from_pp_state(tm, mine, init)
    assert back.step == ts.step
    for k, v in ts.params.items():
        assert torch.equal(back.params[k], v), k
    for field in ("gen_opt", "disc_opt"):
        a, b = getattr(ts, field), getattr(back, field)
        assert int(a["t"]) == int(b["t"])
        for slot in ("m", "v"):
            for k, v in a[slot].items():
                assert torch.equal(b[slot][k], v), (field, slot, k)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("backend", ["npz", "orbax"])
def test_generate_restores_packed_layouts(n, backend, tmp_path):
    from graphical_gan_tpu_torch.tools.generate import restore_params
    jm, tm, jp, tp, _ = _case("gan-cifar10-ali-4")
    path = str(tmp_path / f"ckpt_3.{backend}")
    checkpoint.save_state(path, _filled(tm, tp, n), {"iteration": 3})
    params, extra = restore_params(tm, path, "cpu")
    assert extra["iteration"] == 3 and set(params) == set(tp)
    for k, v in tp.items():
        assert torch.equal(params[k], v), k


def test_generate_restores_a_standard_sharded_directory(tmp_path):
    from graphical_gan_tpu_torch.tools.generate import restore_params
    from graphical_gan_tpu_torch.train.step import make_train_step
    _, tm, _, tp, _ = _case("gan-cifar10-ali-4")
    path = str(tmp_path / "ckpt_1.orbax")
    checkpoint.save_state(path, make_train_step(tm)[1](tp), {"iteration": 1})
    params, _ = restore_params(tm, path, "cpu")
    for k, v in tp.items():
        assert torch.equal(params[k], v), k


@pytest.mark.parametrize("family,dataset,mode,n,kw", [
    ("gan", "cifar10", "vegan", 2, {}), ("gan", "mnist", "ali", 4, {}),
    ("gan", "cifar10", "wali-gp", 4, {}), ("gmgan", "mnist", "vegan", 2, {}),
    ("gan", "cifar10", "ali", 2, {"param_dtype": "bfloat16"}),
    ("gan", "cifar10", "ali", 3, {})])
def test_cuts_jax_refuses_are_refused(family, dataset, mode, n, kw):
    from graphical_gan_tpu_torch.tools.parallel_check import build_model
    model = build_model(family, dataset, mode, dim=8, batch_size=8, **kw)
    with pytest.raises((NotImplementedError, ValueError)):
        pp.normalized_stages(model, n)


def test_step_refuses_what_jax_refuses():
    from graphical_gan_tpu_torch.tools.parallel_check import build_model
    from graphical_gan_tpu_torch.train.trainer import parallel_factory
    wali = build_model("gan", "cifar10", "ali", dim=8, batch_size=8)
    # the wali preset clips D's weights: no Adam-only pipeline for it
    clip = build_model("gan", "cifar10", "wali", dim=8, batch_size=8)
    with pytest.raises((NotImplementedError, ValueError)):
        pp.make_staged_reference_step(clip)
    with pytest.raises(NotImplementedError, match="lr_scale"):
        parallel_factory(wali, None, "pp", lr_scale=lambda t: 1.0)
