"""The port's alternating step (graphical_gan_tpu_torch/train/step.py)
against the JAX ``make_train_step``: 3 iterations at dim 8, B 4, k 2, f32,
from the same parameters, batches and random draws (the JAX ``p_z`` and
``alpha`` taken out of the JAX registry under the step's keys and handed to
the port as ``noise``); params and both optimizer states compared leaf by
leaf, with max |Δ| per leaf reported. Iteration 0 skips the G update.

Tolerances. The first D update's gradient (read back from Adam's first
moment, m = (1 - b1)·g after one update) is compared tightly: max |Δ| <=
1e-4 · max(1e-2, max |g|) per leaf, f32 sums in another order. After that,
TF1 Adam's first step is about lr·sign(g), so a gradient element near 0
whose sign differs between the frameworks moves its parameter by up to
2·lr_t (lr_t <= 1e-4·sqrt(1 - 0.9^t)/(1 - 0.5^t) < 1.3e-4) the other way,
and the moments then follow the parameters: a parameter may differ by
2.6e-4 per update of its player (G: 2, D: 6 in 3 iterations), and each
moment leaf by 1e-2 of its largest element. The biases of the convs before
a BN have a gradient of zero in exact arithmetic (BN takes the mean out);
their rounding noise, up to 3e-8 here, differs, so m has a floor of 1e-7
and v (its square's average) one of 1e-14.
"""

import numpy as np
import torch
import jax
import jax.numpy as jnp

from graphical_gan_tpu.core import registry
from graphical_gan_tpu.core.config import gan_inference_defaults as jax_cfg
from graphical_gan_tpu.core.registry import next_rng_key
from graphical_gan_tpu.models.gan_inference import GanInferenceModel as JaxM
from graphical_gan_tpu.train.step import make_train_step as jax_make_step
from graphical_gan_tpu_torch.core.config import gan_inference_defaults
from graphical_gan_tpu_torch.models.gan_inference import GanInferenceModel
from graphical_gan_tpu_torch.train.checkpoint import params_from_jax
from graphical_gan_tpu_torch.train.step import make_train_step

B = 4
BASE_KEY = jax.random.PRNGKey(11)


def _models(k):
    kw = dict(dim=8, batch_size=B, critic_iters=k)
    jm = JaxM(jax_cfg("cifar10", "wali-gp", **kw))
    tm = GanInferenceModel(gan_inference_defaults("cifar10", "wali-gp", **kw))
    np_params = {n: v.numpy() for n, v in tm.init(5, "cpu").items()}
    return jm, tm, np_params


def _draw_fn(jm, jp):
    @jax.jit
    def draw(raw, key):
        def f():
            p_z = jm._graph(raw)["p_z"]
            return p_z, jax.random.uniform(next_rng_key(), (raw.shape[0], 1))
        return registry.apply(f, jp, key)
    return draw


def _run(k, iters):
    """(JAX state, port state) after ``iters`` iterations."""
    jm, tm, np_params = _models(k)
    jp = {n: jnp.asarray(v) for n, v in np_params.items()}
    jstep, jinit = jax_make_step(jm, jit=True, donate=False)
    tstep, tinit = make_train_step(tm)
    js = jinit(jp)
    ts = tinit(params_from_jax(np_params, "cpu"))
    draw = _draw_fn(jm, jp)
    rng = np.random.default_rng(0)
    for it in range(iters):
        key = jax.random.fold_in(BASE_KEY, it)
        raw = rng.integers(0, 256, (1 + k, B, 3072)).astype(np.float32)
        draws = [draw(jnp.asarray(raw[i]), jax.random.fold_in(key, i))
                 for i in range(1 + k)]
        noise = {"p_z": torch.from_numpy(np.stack([np.asarray(p)
                                                   for p, _ in draws])),
                 "alpha": torch.from_numpy(np.stack([np.asarray(a)
                                                     for _, a in draws[1:]]))}
        js, jm_ = jstep(js, jnp.asarray(raw), key, jnp.asarray(it > 0))
        ts, tm_ = tstep(ts, torch.from_numpy(raw), it > 0, noise=noise)
        assert abs(float(tm_["disc_cost"]) - float(jm_["disc_cost"])) <= \
            1e-3 * max(1.0, abs(float(jm_["disc_cost"])))
    return js, ts


def _max_diff(got, want):
    return float(np.abs(got.float().numpy() - np.asarray(want, np.float32)
                        ).max())


def test_first_d_gradient_matches():
    js, ts = _run(k=1, iters=1)
    assert int(js.gen_opt["t"]) == int(ts.gen_opt["t"]) == 0  # no G update
    assert int(js.disc_opt["t"]) == int(ts.disc_opt["t"]) == 1
    for name, m in js.disc_opt["m"].items():
        want = np.asarray(m) / 0.5  # m = (1 - b1)·g after one update
        got = ts.disc_opt["m"][name] / 0.5
        d = _max_diff(got, want)
        assert d <= 1e-4 * max(1e-2, float(np.abs(want).max())), (name, d)


def test_three_iterations_match_jax_step():
    k = 2
    js, ts = _run(k=k, iters=3)
    assert ts.step == int(js.step) == 3
    assert int(ts.gen_opt["t"]) == int(js.gen_opt["t"]) == 2
    assert int(ts.disc_opt["t"]) == int(js.disc_opt["t"]) == 3 * k
    report = {}
    for name, want in js.params.items():
        updates = 3 * k if name.startswith("Discriminator") else 2
        d = _max_diff(ts.params[name], want)
        report[f"params|{name}"] = d
        assert d <= 2.6e-4 * updates, (name, d)
    for field in ("gen_opt", "disc_opt"):
        for slot in ("m", "v"):
            for name, want in getattr(js, field)[slot].items():
                got = getattr(ts, field)[slot][name]
                d = _max_diff(got, want)
                report[f"{field}|{slot}|{name}"] = d
                floor = 1e-7 if slot == "m" else 1e-14
                assert d <= 1e-2 * float(np.abs(np.asarray(want)).max()) \
                    + floor, (field, slot, name, d)
    print("max |Δ| per leaf:", json_lines(report))


def json_lines(report):
    return "\n".join(f"  {k}: {v:.3g}" for k, v in sorted(report.items()))
