"""The train step's options (``graphical_gan_tpu_torch/train/step.py``)
against the JAX package's, on the CPU at dim 8, B 4:

- ``accum_steps = 2`` against JAX's accumulated step (``train/step.py:
  38-96``), given the same microbatch draws (microbatch m of update j
  draws under ``fold_in(fold_in(key, j), m)``): cifar10 wali-gp (BN in E
  and G sees microbatch statistics; the penalty's ``alpha`` is a D-only
  draw; ``tests/_torch_gmgan.py: step_noise`` lays out GMGAN's); held as
  the family-1 step tests hold theirs, at B 8, so
  that each BN normalizes 4 rows: over 2 rows the first update's
  gradients still agree to 1e-5, but the BNs carry TF1 Adam's sign flips
  (``check_states``) into the next iteration's D moments at 1e-2 of their
  largest element;
- ``remat`` against no remat, bit for bit, for modes that draw from the
  step's generator (wali-gp's ``alpha``, GMGAN CONCRETE's Gumbel noise):
  the loss runs twice per update (the checkpoint recomputes it), and a
  recompute that did not restore the generator's state gives other
  gradients (the control);
- Adam's ``lr_scale`` against the JAX Adam's, and ``run(decay=True)``'s
  step sizes;
- ``fused_gp`` against the unfused penalty and against JAX's fused path,
  and its refusal of the mnist D, whose BN couples the rows;
- the CLI's ``--accum-steps`` and the eight alias entry points.
"""

import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_family1 import (
    check_states, close, close_grads, jax_draws, loss_grads, raw_batch)
import _torch_family1 as family1
from _torch_gmgan import compiled
from graphical_gan_tpu_torch.core.config import (
    gan_inference_defaults, gmgan_defaults)
from graphical_gan_tpu_torch.models.gan_inference import GanInferenceModel
from graphical_gan_tpu_torch.models.gmgan import GMGanModel
from graphical_gan_tpu_torch.train import step as step_mod
from _torch_threads import one_thread  # noqa: F401

KW = dict(dim=8, batch_size=4)


# -- accum_steps --------------------------------------------------------------

def test_accum_matches_jax_accumulated_step_wali_gp():
    """cifar10 wali-gp at one critic update: ``alpha`` [k, a, B/a, 1]."""
    from graphical_gan_tpu.train.step import make_train_step as jax_make
    jm, tm, jp, tp = family1.models("cifar10", "wali-gp", seed=5,
                                    accum_steps=2, critic_iters=1,
                                    batch_size=8)
    jstep, jinit = jax_make(jm, jit=True, donate=False)
    tstep, tinit = step_mod.make_train_step(tm)
    js, ts = jinit(jp), tinit(tp)
    rng = np.random.default_rng(0)
    costs, step = [], None
    for it in range(2):
        key = jax.random.fold_in(jax.random.PRNGKey(11), it)
        raw = raw_batch(tm.cfg, rng, lead=(2,))
        per = [[jax_draws(tm.cfg, jax.random.fold_in(
            jax.random.fold_in(key, j), m), 4) for m in range(2)]
            for j in range(2)]
        noise = {"p_z": torch.from_numpy(np.stack(
            [[d["p_z"] for d in u] for u in per])),
            "alpha": torch.from_numpy(np.stack(
                [[d["alpha"] for d in u] for u in per[1:]]))}
        args = (js, jnp.asarray(raw), key, jnp.asarray(it > 0))
        if step is None:
            step = compiled(jstep, *args)
        js, jmet = step(*args)
        ts, tmet = tstep(ts, torch.from_numpy(raw), it > 0, noise=noise)
        costs.append({n: (float(jmet[n]), float(tmet[n])) for n in tmet
                      if it > 0 or n != "gen_cost"})
    check_states(js, ts, costs, 1, iters=2)


def test_accum_gen_cost_at_iteration_zero_is_the_microbatch_mean():
    """Without a G update the step reports the mean of the microbatches'
    G losses, each on its own draws."""
    tm = GMGanModel(gmgan_defaults("mnist", "ali", accum_steps=2, n_coms=5,
                                   **KW))
    step, init = step_mod.make_train_step(tm)
    params = tm.init(1, "cpu")
    raw = torch.rand(2, 4, 784, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(3)
    # [1 + k, accum, B / accum, ...]
    noise = {"gumbel_q": torch.rand(2, 2, 2, 5, generator=g),
             "hyper_p_z": torch.randn(2, 2, 2, 128, generator=g),
             "prior_idx": torch.randint(0, 5, (2, 2, 2), generator=g)}
    _, met = step(init({n: p.clone() for n, p in params.items()}), raw,
                  False, noise=noise)
    with torch.no_grad():
        want = sum(tm.gen_loss(params, raw[0].chunk(2)[j],
                               draws={n: t[0, j] for n, t in noise.items()}
                               )[0] for j in range(2)) / 2
    assert float(met["gen_cost"]) == pytest.approx(float(want), rel=1e-6)


# -- remat --------------------------------------------------------------------

def _train(model, remat, iters=2, restore=True, monkeypatch=None):
    """(state, costs, loss calls) after ``iters`` iterations from one
    seed, with or without remat."""
    calls = []
    gen_loss, disc_loss = model.gen_loss, model.disc_loss
    model.gen_loss = lambda *a, **k: calls.append("g") or gen_loss(*a, **k)
    model.disc_loss = lambda *a, **k: calls.append("d") or disc_loss(*a,
                                                                     **k)
    try:
        model.cfg = dataclasses.replace(model.cfg, remat=remat)
        if not restore:
            monkeypatch.setattr(
                step_mod, "_rematerialized",
                lambda fn, gen, rewinds: lambda p:
                torch.utils.checkpoint.checkpoint(
                    fn, p, use_reentrant=False))
        step, init = step_mod.make_train_step(model)
        state = init(model.init(2, "cpu"))
        raw = torch.from_numpy(raw_batch(
            model.cfg, np.random.default_rng(1),
            lead=(iters, 1 + model.cfg.critic_iters)))
        gen = torch.Generator()
        costs = []
        for it in range(iters):
            gen.manual_seed(100 + it)
            state, met = step(state, raw[it], it > 0, gen)
            costs.append({k: float(v) for k, v in met.items()})
    finally:
        del model.gen_loss, model.disc_loss
    return state, costs, calls


@pytest.mark.parametrize("family,dataset,mode,d_runs", [
    ("gan_inference", "cifar10", "wali-gp", 3),
    ("gmgan", "mnist", "local_ep", 2)], ids=["wali-gp alpha",
                                             "gmgan CONCRETE"])
def test_remat_is_bit_identical_to_no_remat(family, dataset, mode, d_runs,
                                            monkeypatch):
    """Each differentiated loss runs again in the backward; wali-gp's D
    loss, whose penalty differentiates inside the forward, a third time
    (that inner gradient unpacks the checkpointed tensors)."""
    if family == "gmgan":
        model = GMGanModel(gmgan_defaults(dataset, mode, n_coms=5, **KW))
    else:
        model = GanInferenceModel(gan_inference_defaults(
            dataset, mode, critic_iters=2, **KW))
    plain, c_plain, n_plain = _train(model, remat=False)
    remat, c_remat, n_remat = _train(model, remat=True)
    assert c_remat == c_plain
    assert all(torch.equal(remat.params[n], plain.params[n])
               for n in plain.params)
    # Adam's first moment starts at 0 and takes (1 - b1) g: the same bits
    # in m are the same gradients
    for field in ("gen_opt", "disc_opt"):
        for slot in ("m", "v"):
            ref = getattr(plain, field)[slot]
            assert all(torch.equal(getattr(remat, field)[slot][n], ref[n])
                       for n in ref)
    # iteration 0's G loss updates nothing and is not recomputed
    assert n_remat.count("g") == 2 * n_plain.count("g") - 1
    assert n_remat.count("d") == d_runs * n_plain.count("d")
    # the control: a recompute that does not restore the step's generator
    # draws other numbers, and the gradients differ
    other, _, _ = _train(model, remat=True, restore=False,
                         monkeypatch=monkeypatch)
    assert not all(torch.equal(other.params[n], plain.params[n])
                   for n in plain.params)


# -- lr_scale and decay -------------------------------------------------------

def test_lr_scale_matches_jax_adam():
    from graphical_gan_tpu.optim.optimizers import adam as jax_adam
    from graphical_gan_tpu_torch.optim.optimizers import Adam
    iters = 4
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((3, 5)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{n: rng.standard_normal(v.shape).astype(np.float32)
              for n, v in params.items()} for _ in range(3)]
    jopt = jax_adam(2e-4, 0.5, 0.999,
                    lr_scale=lambda t: jnp.maximum(0.0, 1.0 - t / iters))
    topt = Adam(lr=2e-4, beta1=0.5, beta2=0.999,
                lr_scale=lambda t: max(0.0, 1.0 - t / iters))
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    tp = {n: torch.tensor(v) for n, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        jp, js = jopt.update({n: jnp.asarray(v) for n, v in g.items()}, js,
                             jp)
        topt.update({n: torch.tensor(v) for n, v in g.items()}, ts, tp)
    for n in params:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                   rtol=0, atol=1e-7)
    assert topt.lr_t(4) == 0.0 and topt.lr_t(2) == pytest.approx(
        Adam(lr=2e-4, beta1=0.5, beta2=0.999).lr_t(2) * 0.5, rel=1e-6)


def test_run_with_decay_scales_adam_by_the_iteration_count(tmp_path,
                                                           monkeypatch):
    from graphical_gan_tpu_torch.optim.optimizers import Adam
    from graphical_gan_tpu_torch.runs.gan_inference import run
    seen = []
    lr_t = Adam.lr_t

    def spy(self, t):
        out = lr_t(self, t)
        plain = Adam(lr=self.lr, beta1=self.beta1, beta2=self.beta2,
                     eps=self.eps)
        seen.append((t, out, lr_t(plain, t)))
        return out

    monkeypatch.setattr(Adam, "lr_t", spy)
    tr, _ = run("mnist", "ali", iters=3, dim=8, batch_size=4, decay=True,
                outdir=str(tmp_path), checkpoint_every=0, sample_every=100,
                tsne_every=0, inception_every=0, data_pipeline="host",
                device="cpu")
    # the decay runs over the config's iterations (200,000), not the
    # run's, as in JAX
    assert tr.cfg.iters == 200_000
    assert seen and {t for t, _, _ in seen} == {1, 2, 3}
    for t, got, undecayed in seen:
        assert got == pytest.approx(undecayed * (1 - t / tr.cfg.iters),
                                    rel=1e-6, abs=0.0)
        assert got < undecayed


# -- fused_gp -----------------------------------------------------------------

@pytest.mark.parametrize("dataset", ["cifar10", "celeba"])
def test_fused_gp_matches_the_unfused_penalty_and_jax(dataset):
    """The D loss with ``fused_gp`` against the unfused one (f32 sums of
    one batched apply against three) and against JAX's fused path."""
    jm, tm, jp, tp = family1.models(dataset, "wali-gp", fused_gp=True)
    assert tm._fused_gp()
    raw = raw_batch(tm.cfg, np.random.default_rng(0))
    key = jax.random.PRNGKey(3)
    j_loss, j_grads, t_loss, t_grads = loss_grads(jm, tm, jp, tp, raw, key,
                                                  "disc")
    close(t_loss, j_loss)
    close_grads(t_grads, j_grads)
    unfused = GanInferenceModel(dataclasses.replace(tm.cfg, fused_gp=False))
    draws = {k: torch.from_numpy(np.array(v)) for k, v in
             jax_draws(tm.cfg, key).items()}
    a, aux_a = tm.disc_loss(tp, torch.from_numpy(raw), draws=draws)
    b, aux_b = unfused.disc_loss(tp, torch.from_numpy(raw), draws=draws)
    close(a, float(b), atol=1e-5)
    close(aux_a["gp"], float(aux_b["gp"]), atol=1e-5)


def test_fused_gp_is_refused_for_a_discriminator_with_bn(monkeypatch):
    """mnist's D has batch-statistics BN: ``fused_gp`` keeps the separate
    applies there, bit for bit the loss without it."""
    from graphical_gan_tpu_torch.objectives import penalties
    called = []
    monkeypatch.setattr(penalties, "wali_gp_fused",
                        lambda *a, **k: called.append(1))
    fused = GanInferenceModel(gan_inference_defaults(
        "mnist", "wali-gp", fused_gp=True, **KW))
    plain = GanInferenceModel(gan_inference_defaults("mnist", "wali-gp",
                                                     **KW))
    assert not fused._fused_gp()
    params = plain.init(0, "cpu")
    raw = torch.from_numpy(raw_batch(plain.cfg, np.random.default_rng(2)))
    a = fused.disc_loss(params, raw,
                        generator=torch.Generator().manual_seed(1))
    b = plain.disc_loss(params, raw,
                        generator=torch.Generator().manual_seed(1))
    assert not called and torch.equal(a[0], b[0])


# -- the CLI ------------------------------------------------------------------

def test_cli_accum_steps_trains_on_cpu(tmp_path, capsys):
    from graphical_gan_tpu_torch.runs.gan_inference_mnist import main
    run_dir = str(tmp_path / "run")
    main(["--mode", "ali", "--dim", "8", "--batch-size", "4",
          "--accum-steps", "2", "--iters", "2", "--device", "cpu",
          "--run-dir", run_dir])
    assert "iter 1\t" in capsys.readouterr().out
    with open(os.path.join(run_dir, "config.json")) as f:
        cfg = json.load(f)
    assert (cfg["dataset"], cfg["accum_steps"]) == ("mnist", 2)


@pytest.mark.parametrize("family,suffix,dataset", [
    (f, s, d) for f in ("gan_inference", "gmgan")
    for s, d in (("mnist", "mnist"), ("cifar10", "cifar10"),
                 ("svhn", "svhn"), ("face", "celeba"))])
def test_alias_entry_points_fix_the_dataset(family, suffix, dataset,
                                           monkeypatch):
    import importlib
    runs = "graphical_gan_tpu_torch.runs."
    base = importlib.import_module(runs + family)
    prefix = {"gan_inference": "gan_inference",
              "gmgan": "gmgan_inference"}[family]
    alias = importlib.import_module(f"{runs}{prefix}_{suffix}")
    got = {}
    monkeypatch.setattr(base, "run",
                        lambda ds, mode, **kw: got.update(ds=ds, mode=mode,
                                                          **kw))
    alias.main(["--iters", "1", "--device", "cpu", "--accum-steps", "2"])
    assert got["ds"] == dataset and got["accum_steps"] == 2
    assert got["mode"] == ("ali" if family == "gan_inference" else "local_ep")
