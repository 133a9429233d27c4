"""Tensor parallelism of the port (``graphical_gan_tpu_torch/parallel/
sharding_rules.py``) on 2 gloo ranks on the CPU: cifar10 wali-gp (k = 1)
on a ``(data 1, model 2)`` mesh, against JAX's own TP mesh step over the
same mesh of virtual CPU devices and against the port's one-process step
(tolerances: ``tests/_torch_parallel.py``). Every conv, deconv and dense
layer whose output dim is 8 or more is held in halves (K1 at the halved
Cout), the BNs normalize their halves of the channels, and the penalty
differentiates through the gathers. The rules name the same parameters as
JAX's; the ranks hold each sharded parameter's and Adam moment's half and
the replicated ones bit for bit alike, and their gathered states agree.
"""

import numpy as np
import pytest
import torch

from _torch_parallel import (check_against, check_replicas, jax_mesh,
                             prepare, run_cases)
from _torch_threads import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def runs():
    case = prepare("gan", "cifar10", "wali-gp", "tp", (1, 2),
                   ("data", "model"), critic_iters=1)
    (case, ranks), = run_cases([case], 2)
    return case, ranks


def test_tp_matches_jax_mesh_step(runs):
    case, ranks = runs
    check_against(case, ranks[0]["costs"], ranks[0]["full"], "jax")


def test_tp_matches_one_process_step(runs):
    case, ranks = runs
    check_against(case, ranks[0]["costs"], ranks[0]["full"], "port")


def test_tp_ranks_hold_halves_and_agree(runs):
    case, ranks = runs
    results = ranks
    check_replicas(results)
    first = results[0]
    assert "Generator.2.Filters" in first["sharded"]
    assert "Discriminator.Output.W" not in first["sharded"]
    for name in first["sharded"]:
        local = first["local"][f"params/{name}"]
        full = first["full"][f"params/{name}"]
        assert local.size * 2 == full.size, name
    # rank 1 holds the other half
    a = results[0]["local"]["params/Generator.2.Filters"]
    b = results[1]["local"]["params/Generator.2.Filters"]
    np.testing.assert_array_equal(
        np.concatenate([a, b], axis=2),
        results[0]["full"]["params/Generator.2.Filters"])


def test_rules_name_the_jax_parameters():
    """The port's rules against JAX's ``tp_param_shardings`` on the same
    parameter tree (cifar10, model axis 2)."""
    from graphical_gan_tpu.parallel.sharding_rules import (
        tp_param_shardings as jax_rules)
    from graphical_gan_tpu_torch.core.config import gan_inference_defaults
    from graphical_gan_tpu_torch.models.gan_inference import (
        GanInferenceModel)
    from graphical_gan_tpu_torch.parallel.sharding_rules import (
        tp_param_shardings)
    import jax.numpy as jnp
    model = GanInferenceModel(gan_inference_defaults("cifar10", "wali-gp",
                                                     dim=8))
    params = model.init(0, "cpu")

    class _M:
        shape = {"data": 1, "model": 2}

    mine = tp_param_shardings(params, _M())
    theirs = jax_rules({n: jnp.zeros(tuple(p.shape)) for n, p in
                        params.items()}, jax_mesh((1, 2), ("data", "model")))
    for n, s in theirs.items():
        spec = tuple(s.spec)
        if "model" in spec:
            assert mine[n] == ("model", spec.index("model")), n
        else:
            assert n not in mine, n
    assert isinstance(params["Generator.Input.W"], torch.Tensor)
