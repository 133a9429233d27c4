"""The trainer's step graph (``graphical_gan_tpu_torch/train/graph.py``) on
the CPU, mnist ali at dim 8, B 8 (``_torch_step_graph``): the graph
runner's host prologue, body and host epilogue, run per iteration as the
card replays them, equal the eager dispatch of the same tree bit for bit
over 12 iterations (parameters, Adam's m, v and t, the step, every logged
cost and every checkpoint array) at chunk sizes None, 1 and 3, across a
resume at a window boundary (also from an eager run's checkpoint into
the graph and back) and a rollback under ``GGAN_FAULT_NAN_AT``, and with
``lr_scale`` (the face script's linear decay); the resumed and the
rolled-back Trainer warm a new graph. Beside them: the eager rule
(``Trainer.eager_reason``); the launch counts of a capture and its
replays; Adam's device step sizes against JAX's ``adam`` with
``lr_scale`` (the tolerance of ``test_torch_optim.py``, and bit for bit
against the update that makes its own step size); and the step as the
graph runs it (a prologue into one step-size tensor, then the body)
against JAX's ``train/step.py`` over two iterations (the tolerances of
``test_torch_train_step.py``) and against the eager call, bit for bit.
(The step graph's wali-gp runs: ``test_torch_step_graph_wali*.py``.)
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_step_graph as sg
from _torch_threads import one_thread  # noqa: F401
from _torch_trainer import make_trainer
from test_torch_train_step import B, BASE_KEY, _draw_fn, _max_diff, _models
from graphical_gan_tpu.optim.optimizers import adam as jax_adam
from graphical_gan_tpu.train.step import make_train_step as jax_make_step
from graphical_gan_tpu_torch.ops import kernels
from graphical_gan_tpu_torch.optim.optimizers import Adam
from graphical_gan_tpu_torch.train.checkpoint import params_from_jax
from graphical_gan_tpu_torch.train.graph import StepGraph, counted
from graphical_gan_tpu_torch.train.step import make_train_step

MODE = "ali"


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    base = tmp_path_factory.mktemp("eager")
    return {(kind, scaled): sg.reference(
        base / f"{kind}_{scaled}", MODE, kind, sg.decay if scaled else None)
        for kind, scaled in (("plain", False), ("rollback", False),
                             ("plain", True))}


@pytest.mark.parametrize("scenario,scaled", [
    ("chunk None", False), ("chunk 1", False), ("chunk 3", False),
    ("resume", False), ("resume graph-eager", False),
    ("resume eager-graph", False), ("rollback", False), ("chunk 1", True)])
def test_graph_parts_equal_the_eager_dispatch(tmp_path, refs, scenario,
                                              scaled):
    kind = "rollback" if scenario == "rollback" else "plain"
    sg.check_scenario(tmp_path, MODE, scenario, refs[(kind, scaled)],
                      sg.decay if scaled else None)


def test_eager_rule(tmp_path):
    """Eager on the CPU, under a mesh, on the host-fed path and where the
    eager dispatch is asked for; no graph on the CPU."""
    tr = make_trainer(tmp_path / "resident", resident=True)
    assert tr.eager_reason() == "no CUDA graph on cpu"
    tr.train(3)
    assert tr._graph is None and tr.captures == 0
    host = make_trainer(tmp_path / "host")
    assert host.eager_reason().startswith("the host-fed loop")
    tr.mesh = object()
    assert tr.eager_reason().startswith("a mesh")
    tr.mesh, tr._eager = None, True
    assert "Trainer._eager" in tr.eager_reason()
    tr._eager = False
    # the step options capture: only the device decides
    tr.cfg = dataclasses.replace(tr.cfg, remat=True, accum_steps=2)
    assert tr.eager_reason() == "no CUDA graph on cpu"


def test_launch_counts_come_from_the_wrappers_alone(tmp_path):
    """The counters count the launches made from Python: a capture's are
    counted once (``counted`` reports them and leaves them in), and an
    epilogue adds none, since a replay calls no wrapper; it queues copies
    of the static costs. What replays run is read off a device trace:
    ``device_launches`` counts each training wrapper's kernels by name."""
    kernels.reset_launches()
    try:
        def capture():
            kernels.fused_conv2d_bias_act.launches += 69
            kernels.bn_stats.launches += 30
            kernels.int8_conv.routes["tma"] += 2
            return "graph"

        out, delta = counted(capture)
        assert out == "graph"
        assert delta == {"fused_conv2d_bias_act": 69, "bn_stats": 30,
                         "int8_conv/tma": 2}
        tr = make_trainer(tmp_path, resident=True)
        g = StepGraph(tr)
        g.launches = delta
        static = {"disc_cost": torch.tensor(1.5), "gen_cost": torch.tensor(2.)}
        pend = []
        for it in (2, 3, 4):
            g.epilogue(it, static, pend)
            static["disc_cost"].add_(1.0)  # the next replay overwrites it
        counts = kernels.launch_counts()
        assert counts["fused_conv2d_bias_act"] == 69
        assert counts["bn_stats"] == 30 and counts["int8_conv/tma"] == 2
        assert [(it, name, float(v)) for it, name, v in pend] == [
            (2, "train disc cost", 1.5), (3, "train disc cost", 2.5),
            (4, "train disc cost", 3.5)]
    finally:
        kernels.reset_launches()
    trace = {"void conv_k1_fma_kernel<64, 64, 8, 4, 4>(float const*)": 60,
             "conv_k1_wgmma_kernel(__nv_bfloat16 const*)": 9,
             "void conv_k1_splitk_reduce_kernel(float const*, int)": 7,
             "void bn_stats_fused_kernel<float, 4>(StatsArgs<float>)": 30,
             "void bn_stats_local_kernel<float, 4>(float const*)": 3,
             "void bn_apply_kernel<float, 4, false>(float const*)": 30,
             "void bn_apply_split_kernel<float, 4, false>(float const*)": 2,
             "void bn_bwd_fused_kernel<float, 4>(BwdArgs<float>)": 5,
             "Memcpy HtoD (Pageable -> Device)": 4}
    assert kernels.device_launches(trace) == {
        "fused_conv2d_bias_act": 69, "bn_stats": 30, "bn_apply": 30,
        "bn_bwd": 5}


@pytest.mark.parametrize("low_byte", [False, True])
def test_adam_device_step_sizes_match_jax(low_byte):
    """Three updates with the face script's decay: the step sizes counted
    by ``advance`` into a tensor (as the step's prologue does) against
    JAX's ``adam``, and bit for bit against the update that counts ``t``
    and makes its own step size."""
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((3, 5)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{n: rng.standard_normal(v.shape).astype(np.float32)
              for n, v in params.items()} for _ in range(3)]
    pdt = torch.bfloat16 if low_byte else torch.float32
    kw = dict(master_weights=low_byte,
              moment_dtype=torch.bfloat16 if low_byte else None)
    jopt = jax_adam(2e-4, 0.5, 0.999, master_weights=low_byte,
                    moment_dtype=jnp.bfloat16 if low_byte else None,
                    lr_scale=lambda t: jnp.maximum(0.0, 1.0 - t / 4))
    topt = Adam(lr=2e-4, beta1=0.5, beta2=0.999,
                lr_scale=lambda t: max(0.0, 1.0 - t / 4), **kw)
    jp = {n: jnp.asarray(v, pdt_name(pdt)) for n, v in params.items()}
    tp = {n: torch.tensor(v).to(pdt) for n, v in params.items()}
    own = {n: torch.tensor(v).to(pdt) for n, v in params.items()}
    js, ts, os_ = jopt.init(jp), topt.init(tp), topt.init(own)
    lr = torch.zeros(1)
    for g in grads:
        jp, js = jopt.update({n: jnp.asarray(v, pdt_name(pdt))
                              for n, v in g.items()}, js, jp)
        lr[0] = topt.advance(ts, 1)[0]
        topt.update({n: torch.tensor(v).to(pdt) for n, v in g.items()}, ts,
                    tp, lr_t=lr[0])
        topt.update({n: torch.tensor(v).to(pdt) for n, v in g.items()}, os_,
                    own)
    assert int(ts["t"]) == int(os_["t"]) == int(js["t"]) == 3
    for n in params:
        assert torch.equal(tp[n], own[n])
        if low_byte:
            np.testing.assert_allclose(
                ts["master"][n].numpy(), np.asarray(js["master"][n]),
                atol=1e-5, rtol=0)
        else:
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                       atol=1e-6, rtol=0)
            for slot in ("m", "v"):
                np.testing.assert_allclose(
                    ts[slot][n].numpy(), np.asarray(js[slot][n]), rtol=1e-5,
                    atol=1e-12)
    assert topt.lr_t(4) == 0.0


def pdt_name(dtype):
    return "bfloat16" if dtype == torch.bfloat16 else "float32"


def test_step_as_graphed_matches_jax_and_the_eager_call():
    """cifar10 wali-gp, dim 8, B 4, k 2: iterations 0 and 1 through
    ``prologue`` into one step-size tensor and ``body`` (the graph's
    form), against JAX's jitted step and, bit for bit, against the eager
    ``step`` call on the same draws."""
    k = 2
    jm, tm, np_params = _models(k)
    jp = {n: jnp.asarray(v) for n, v in np_params.items()}
    jstep, jinit = jax_make_step(jm, jit=True, donate=False)
    tstep, tinit = make_train_step(tm)
    js = jinit(jp)
    graphed = tinit(params_from_jax(np_params, "cpu"))
    eager = tinit(params_from_jax(np_params, "cpu"))
    lr = torch.zeros(1 + k)
    draw = _draw_fn(jm, jp)
    rng = np.random.default_rng(0)
    for it in range(2):
        key = jax.random.fold_in(BASE_KEY, it)
        raw = rng.integers(0, 256, (1 + k, B, 3072)).astype(np.float32)
        draws = [draw(jnp.asarray(raw[i]), jax.random.fold_in(key, i))
                 for i in range(1 + k)]
        noise = {"p_z": torch.from_numpy(np.stack([np.asarray(p)
                                                   for p, _ in draws])),
                 "alpha": torch.from_numpy(np.stack([np.asarray(a)
                                                     for _, a in draws[1:]]))}
        js, jmet = jstep(js, jnp.asarray(raw), key, jnp.asarray(it > 0))
        assert tstep.prologue(graphed, it > 0, lr) is lr
        gmet = tstep.body(graphed, torch.from_numpy(raw), it > 0, None,
                          noise, lr)
        _, emet = tstep(eager, torch.from_numpy(raw), it > 0, noise=noise)
        assert {n: float(v) for n, v in gmet.items()} == {
            n: float(v) for n, v in emet.items()}
        assert abs(float(gmet["disc_cost"]) - float(jmet["disc_cost"])) <= \
            1e-3 * max(1.0, abs(float(jmet["disc_cost"])))
    assert graphed.step == eager.step == int(js.step) == 2
    for field in ("gen_opt", "disc_opt"):
        a, b, j = (getattr(s, field) for s in (graphed, eager, js))
        assert int(a["t"]) == int(b["t"]) == int(j["t"])
        for slot in ("m", "v"):
            for name, want in j[slot].items():
                assert torch.equal(a[slot][name], b[slot][name])
                floor = 1e-7 if slot == "m" else 1e-14
                assert _max_diff(a[slot][name], want) <= 1e-2 * float(
                    np.abs(np.asarray(want)).max()) + floor, (field, slot)
    for name, want in js.params.items():
        assert torch.equal(graphed.params[name], eager.params[name])
        updates = 2 * k if name.startswith("Discriminator") else 1
        assert _max_diff(graphed.params[name], want) <= 2.6e-4 * updates
