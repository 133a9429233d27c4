"""The port's memory tool (graphical_gan_tpu_torch/tools/memory.py) on the
CPU: the parameters' and the resident data's bytes equal the JAX tool's
``_tree_bytes`` of its init state (``jax.eval_shape``: shapes and dtypes,
nothing compiled) and data at dim 8, B 8; the state's equal as well but
for JAX's ``TrainState.step``, an int32 array there and a Python int in
the port (the Adam step counts ``t`` are int32 scalars in both); the
knobs move the accounting as they should:
``moment_dtype=bfloat16`` shrinks the state by half the moments' bytes,
``param_dtype=bfloat16`` halves the parameters and adds f32 masters, a
larger batch grows the working set.
"""

import json

import jax
import pytest
import torch

from graphical_gan_tpu.tools import memory as jax_mem
from graphical_gan_tpu.tools import mfu as jax_mfu
from graphical_gan_tpu_torch.tools import memory
from _torch_threads import one_thread  # noqa: F401

TINY = {"gan": dict(dim=8, batch_size=8),
        "gmgan": dict(dim=8, batch_size=8, n_coms=5),
        "ssgan": dict(dim=8, batch_size=8, seq_len=3)}
ROWS = 32
STEP_COUNTER_BYTES = 4  # JAX's TrainState.step, int32


@pytest.fixture(scope="module")
def gan_f32():
    return memory.step_memory("float32", "gan", data_rows=ROWS, device="cpu",
                              **TINY["gan"])


@pytest.mark.parametrize("family", sorted(TINY))
def test_bytes_equal_jax(family, gan_f32):
    cfg, model, init_state, _, _ = jax_mfu._build("float32", family,
                                                  **TINY[family])
    # shapes and dtypes only: traced, neither compiled nor run
    state = jax.eval_shape(lambda key: init_state(model.init(key)),
                           jax.random.PRNGKey(0))
    data = jax_mfu._family_data(family, cfg, n=ROWS)
    got = gan_f32 if family == "gan" else memory.step_memory(
        "float32", family, data_rows=ROWS, device="cpu", **TINY[family])
    assert got["param_bytes"] == jax_mem._tree_bytes(state.params)
    assert got["data_resident_bytes"] == jax_mem._tree_bytes(data)
    assert got["state_bytes"] == jax_mem._tree_bytes(state) \
        - STEP_COUNTER_BYTES
    assert got["data_rows"] == ROWS


def test_moment_dtype_shrinks_state(gan_f32):
    bf16 = memory.step_memory("float32", "gan", data_rows=ROWS, device="cpu",
                              moment_dtype="bfloat16", **TINY["gan"])
    assert bf16["param_bytes"] == gan_f32["param_bytes"]
    # m and v of every f32 parameter go from 4 to 2 bytes an element
    assert gan_f32["state_bytes"] - bf16["state_bytes"] \
        == gan_f32["param_bytes"]


def test_param_dtype_halves_params_and_adds_masters(gan_f32):
    bf16 = memory.step_memory("float32", "gan", data_rows=ROWS, device="cpu",
                              param_dtype="bfloat16", **TINY["gan"])
    assert 2 * bf16["param_bytes"] == gan_f32["param_bytes"]
    assert bf16["state_bytes"] == gan_f32["state_bytes"] \
        + bf16["param_bytes"]


def test_batch_size_grows_working_set(gan_f32):
    big = memory.step_memory("float32", "gan", data_rows=ROWS, device="cpu",
                             **{**TINY["gan"], "batch_size": 16})
    assert big["temp_bytes"] > gan_f32["temp_bytes"] > 0
    assert big["state_bytes"] == gan_f32["state_bytes"]
    assert gan_f32["peak_bytes"] == gan_f32["state_bytes"] \
        + gan_f32["data_resident_bytes"] + gan_f32["temp_bytes"]
    assert gan_f32["backend"] == "cpu profiler memory events"


def test_cli_prints_one_json_line(capsys):
    rc = memory.main(["--family", "gan", "--dtype", "float32",
                      "--batch-size", "8", "--dim", "8", "--accum-steps",
                      "2", "--data-rows", str(ROWS), "--device", "cpu"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "step_memory"
    assert (rec["family"], rec["accum_steps"]) == ("gan", 2)
    assert rec["peak_bytes"] > rec["state_bytes"] > 0
    assert rec["device_kind"] == "cpu" and rec["hbm_budget_bytes"] is None
    # derived GiB fields accompany every byte field
    assert "peak_gib" in rec and "temp_gib" in rec


def test_cli_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        memory.main(["--family", "gan", "--dim", "8", "--batch-size", "8"])
