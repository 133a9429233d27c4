"""The port's config copy (graphical_gan_tpu_torch/core/config.py) equals
the JAX package's, field by field, for every dataset and mode."""

import dataclasses

import pytest

from graphical_gan_tpu.core import config as jcfg
from graphical_gan_tpu_torch.core import config as tcfg

DATASETS = ("mnist", "cifar10", "svhn", "celeba")


@pytest.mark.parametrize("mode", jcfg.GAN_INFERENCE_MODES)
@pytest.mark.parametrize("dataset", DATASETS)
def test_defaults_match_jax(dataset, mode):
    j = jcfg.gan_inference_defaults(dataset, mode)
    t = tcfg.gan_inference_defaults(dataset, mode)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert tcfg.asdict(t) == jcfg.asdict(j)
    assert dataclasses.asdict(t.data) == dataclasses.asdict(j.data)
    assert t.data.output_dim == j.data.output_dim
    assert t.has_discriminator == j.has_discriminator
    assert t.has_rec_penalty == j.has_rec_penalty


def test_mode_lists_and_field_names_match():
    assert tcfg.GAN_INFERENCE_MODES == jcfg.GAN_INFERENCE_MODES
    assert tcfg.VEGAN_DIVERGENCE_MODES == jcfg.VEGAN_DIVERGENCE_MODES
    assert tcfg.VEGAN_CODE_MODES == jcfg.VEGAN_CODE_MODES
    assert tcfg.REC_MODES == jcfg.REC_MODES
    names = [f.name for f in dataclasses.fields(tcfg.GanInferenceConfig)]
    assert names == [f.name for f in dataclasses.fields(
        jcfg.GanInferenceConfig)]


@pytest.mark.parametrize("name", ["mnist", "cifar10", "svhn", "celeba",
                                  "moving_mnist", "chairs"])
def test_data_specs_match(name):
    assert dataclasses.asdict(tcfg.dataset_spec(name)) == \
        dataclasses.asdict(jcfg.dataset_spec(name))


def test_overrides_and_errors_match():
    kw = dict(dim=8, batch_size=4, compute_dtype="bfloat16")
    assert tcfg.asdict(tcfg.gan_inference_defaults("cifar10", "wali-gp",
                                                   **kw)) == \
        jcfg.asdict(jcfg.gan_inference_defaults("cifar10", "wali-gp", **kw))
    for bad in (("cifar10", "nope"), ("imagenet", "ali")):
        with pytest.raises(ValueError):
            jcfg.gan_inference_defaults(*bad)
        with pytest.raises(ValueError):
            tcfg.gan_inference_defaults(*bad)


@pytest.mark.parametrize("mode", ["wali-gp", "ali", "vegan", "vegan-mmd"])
@pytest.mark.parametrize("dataset", ["cifar10", "svhn"])
def test_param_specs_match_jax_init(dataset, mode):
    """The port's init makes every parameter the JAX init makes (G, E and
    the mode's D), with the same names and shapes."""
    import jax
    import torch
    from graphical_gan_tpu.models.gan_inference import GanInferenceModel as J
    from graphical_gan_tpu_torch.models.gan_inference import (
        GanInferenceModel as T)

    kw = dict(dim=8, batch_size=4)
    jp = J(jcfg.gan_inference_defaults(dataset, mode, **kw)).init(
        jax.random.PRNGKey(0))
    tp = T(tcfg.gan_inference_defaults(dataset, mode, **kw)).init(
        seed=0, device="cpu")
    assert set(tp) == set(jp)
    for name, v in jp.items():
        assert tuple(tp[name].shape) == tuple(v.shape), name
        assert tp[name].dtype == torch.float32


def test_flagship_is_the_published_width():
    cfg = tcfg.gan_inference_defaults("cifar10", "wali-gp")
    assert (cfg.dim, cfg.dim_latent, cfg.bn, cfg.type_q) == \
        (64, 128, True, "no_std")
