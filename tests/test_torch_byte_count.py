"""The byte count of the port's MFU tool (graphical_gan_tpu_torch/tools/
mfu.py: ``cost_per_iter``'s ``"bytes accessed"``) on the CPU:

- each rule of the contraction term equals a hand count from the layer's
  shapes (K1 forward and backward, its input-gradient-only backward, the
  transposed conv's SAME crop, conv1d, conv3d, a linear layer; f32 and
  bf16): a convolution reads its input, filter and cotangent and writes
  its result and gradients at their unpadded extents, the backward reading
  the cotangent once for dx and dw;
- over a whole step it counts the ops the FLOP counter counts, each bf16
  contraction at half its f32 bytes, and it does not change when K1's
  plain version sums in the input's dtype instead of f32;
- the optimizer term equals the per-update formula over the JAX package's
  parameter tree of the same config (``core/registry.py: param_count`` per
  player), over the 1 + k updates;
- the record's roofline fields, ``GGAN_PEAK_BW``, ``null`` on an unknown
  card, and the CLI on the CPU.
"""

import json
import math

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from graphical_gan_tpu.core import registry as jax_registry
from graphical_gan_tpu.tools import mfu as jax_mfu
from graphical_gan_tpu_torch.data.ondevice import sample_batches, to_device
from graphical_gan_tpu_torch.ops import conv
from graphical_gan_tpu_torch.ops.linear import linear
from graphical_gan_tpu_torch.ops.activations import activation
from graphical_gan_tpu_torch.ops.kernels import fused_conv
from graphical_gan_tpu_torch.tools import mfu
from graphical_gan_tpu_torch.train.step import make_train_step
from _torch_threads import one_thread  # noqa: F401

SMALL = {"gan": dict(dim=8, batch_size=8),
         "gmgan": dict(dim=8, batch_size=8, n_coms=5),
         "ssgan": dict(dim=4, batch_size=2, seq_len=3)}
H100 = "NVIDIA H100 80GB HBM3"


def _randn(*shape, dtype=torch.float32, grad=True):
    gen = torch.Generator().manual_seed(math.prod(shape))
    t = torch.randn(shape, generator=gen).to(dtype)
    return t.requires_grad_(grad)


def _k1(dtype, dx_only=False):
    """K1 (5x5 stride 2 SAME, 8x8x3 -> 4x4x4, B 2) forward and backward."""
    x, w, b = _randn(2, 8, 8, 3, dtype=dtype), _randn(5, 5, 3, 4), \
        _randn(4)
    y = fused_conv.conv2d_bias_act(x, w, b, 2, "SAME", "leaky_relu")
    loss = (y.float() * _randn(*y.shape, grad=False)).sum()
    if dx_only:
        with fused_conv.input_grads_only():
            torch.autograd.grad(loss, [x])
    else:
        loss.backward()
    return 2 * 8 * 8 * 3, 5 * 5 * 3 * 4, 2 * 4 * 4 * 4


def _deconv(dtype):
    """deconv's library route, stride 2 SAME, 4x4x8 -> 8x8x3 (the whole
    11x11 output computed, SAME's 8x8 kept)."""
    x, w = _randn(2, 4, 4, 8, dtype=dtype), _randn(5, 5, 3, 8)
    y = conv.conv_transpose(x, w, _randn(3), 2, "SAME")
    (y.float() * _randn(*y.shape, grad=False)).sum().backward()
    return 2 * 4 * 4 * 8, 5 * 5 * 3 * 8, 2 * 8 * 8 * 3


def _conv1d(dtype):
    params = {"c.Filters": _randn(5, 3, 4), "c.Biases": _randn(4)}
    y = conv.conv1d(params, "c", _randn(2, 10, 3, dtype=dtype))
    y.float().square().sum().backward()
    return 2 * 10 * 3, 5 * 3 * 4, 2 * 10 * 4


def _conv3d(dtype):
    params = {"c.Filters": _randn(3, 3, 3, 2, 4), "c.Biases": _randn(4)}
    y = conv.conv3d(params, "c", _randn(2, 3, 6, 6, 2, dtype=dtype))
    y.float().square().sum().backward()
    return 2 * 3 * 6 * 6 * 2, 3 * 3 * 3 * 2 * 4, 2 * 3 * 6 * 6 * 4


def _linear(dtype):
    params = {"l.W": _randn(16, 4), "l.b": _randn(4)}
    y = linear(params, "l", _randn(8, 16, dtype=dtype))
    y.float().square().sum().backward()
    return 8 * 16, 16 * 4, 8 * 4


# (layer, hand count of (input, filter, output) elements -> bytes moved)
CASES = {
    # forward x, w -> y; one convolution_backward reads dy, w, x and
    # writes dx, dw
    "k1": (_k1, lambda x, w, y: 3 * x + 3 * w + 2 * y),
    # the penalty's inner pass: dy, w -> dx
    "k1 dx only": (lambda dt: _k1(dt, dx_only=True),
                   lambda x, w, y: 2 * x + 2 * w + 2 * y),
    "deconv": (_deconv, lambda x, w, y: 3 * x + 3 * w + 2 * y),
    "conv1d": (_conv1d, lambda x, w, y: 3 * x + 3 * w + 2 * y),
    "conv3d": (_conv3d, lambda x, w, y: 3 * x + 3 * w + 2 * y),
    # dx and dw are two GEMMs, each reading dy
    "linear": (_linear, lambda x, w, y: 3 * x + 3 * w + 3 * y),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layer", sorted(CASES))
def test_each_layer_equals_the_hand_count(layer, dtype):
    run, formula = CASES[layer]
    with mfu.ByteCounter() as counter:
        elements = run(dtype)
    size = torch.empty((), dtype=dtype).element_size()
    assert counter.total == formula(*elements) * size
    assert counter.total == sum(b for _, b in counter.ops)


def _state(family, dtype, **kw):
    cfg, model = mfu.family_model(family, dtype, **kw)
    step, init_state = make_train_step(model)
    return cfg, model, step, init_state(model.init(0, "cpu"))


def _step_ops(family, dtype, **kw):
    """(ByteCounter, FlopCounterMode) over one fake step of ``family``."""
    cfg, model, step, state = _state(family, dtype, **kw)
    n = (1 + cfg.critic_iters) * cfg.batch_size
    data = to_device(mfu.family_data(family, cfg, n=n), "cpu")
    gen = torch.Generator().manual_seed(1)
    with FakeTensorMode(allow_non_fake_inputs=True):
        raw = sample_batches(data, 1 + cfg.critic_iters, cfg.batch_size, gen)
        with FlopCounterMode(display=False) as flops, \
                mfu.ByteCounter() as nbytes:
            step(state, raw, True, gen)
    return nbytes, flops


@pytest.fixture(scope="module")
def steps():
    """The contraction ops of each SMALL config in f32 and bf16."""
    return {(f, dt): _step_ops(f, dt, **kw) for f, kw in SMALL.items()
            for dt in ("float32", "bfloat16")}


@pytest.mark.parametrize("family", sorted(SMALL))
def test_the_step_counts_the_flop_counters_ops(family, steps):
    nbytes, flops = steps[(family, "float32")]
    counted = {str(op) for op, f in
               flops.get_flop_counts()["Global"].items() if f}
    assert {name for name, _ in nbytes.ops} == counted
    assert nbytes.total == sum(b for _, b in nbytes.ops) > 0


@pytest.mark.parametrize("family", sorted(SMALL))
def test_bf16_halves_each_bf16_contraction(family, steps):
    f32, bf16 = steps[(family, "float32")][0], steps[(family, "bfloat16")][0]
    assert [n for n, _ in f32.ops] == [n for n, _ in bf16.ops]
    half = sum(2 * b == a for (_, a), (_, b) in zip(f32.ops, bf16.ops))
    # the rest run on tensors the model keeps in f32 (gan: D's z branch
    # and the penalty's f32 interpolates; gmgan: one GEMM with an f32
    # operand); none is counted above its f32 bytes
    assert all(a / 2 <= b <= a for (_, a), (_, b) in zip(f32.ops, bf16.ops))
    assert half > len(f32.ops) / 2
    if family == "ssgan":
        assert 2 * bf16.total == f32.total


def _k1_in_its_dtype(x, w, bias, stride=1, padding="SAME", act=None):
    """K1's function with the products in x's dtype (no f32 copies): the
    same count, whatever sums the products."""
    kh, kw = w.shape[:2]
    (plo, phi), (qlo, qhi) = fused_conv._pads(
        x.shape[1], x.shape[2], kh, kw, stride,
        fused_conv.explicit_pads(padding))
    y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (qlo, qhi, plo, phi)),
                 w.to(x.dtype).permute(3, 2, 0, 1), stride=stride)
    y = y + bias.to(x.dtype).view(1, -1, 1, 1)
    return activation(act)(y).permute(0, 2, 3, 1).contiguous()


def test_the_count_does_not_depend_on_how_k1_sums(steps, monkeypatch):
    monkeypatch.setattr(fused_conv, "fused_conv2d_bias_act_plain",
                        _k1_in_its_dtype)
    nbytes, _ = _step_ops("gan", "bfloat16", **SMALL["gan"])
    assert nbytes.total == steps[("gan", "bfloat16")][0].total


def _jax_optimizer_bytes(family, dtype, **kw):
    """The optimizer term from the JAX package's parameter tree: per
    element and update, the parameter read and written and its gradient
    read at the parameter's size, each moment (Adam 2, RMSProp 1) and the
    f32 master (low-byte parameters only) read and written."""
    cfg, model = jax_mfu._family_model(family, dtype, **kw)
    params = {n: np.zeros(v.shape, v.dtype) for n, v in
              jax.eval_shape(model.init, jax.random.PRNGKey(0)).items()}
    p = np.dtype(cfg.param_dtype).itemsize
    m = np.dtype(cfg.moment_dtype).itemsize
    per = []
    for names, spec in zip((model.GEN_PLAYER, model.DISC_PLAYER),
                           model.opt_specs()):
        moments = {"adam": 2, "rmsprop": 1}[spec.kind] if spec else 0
        per.append(jax_registry.param_count(
            jax_registry.partition(params, names)[0])
            * (3 * p + 2 * m * moments + (8 if p != 4 else 0))
            if spec else 0)
    return per[0] + cfg.critic_iters * per[1]


@pytest.mark.parametrize("family, dtype, extra", [
    ("gan", "float32", {}),
    ("gan", "bfloat16", {}),
    ("gan", "bfloat16", {"param_dtype": "bfloat16"}),
    ("gmgan", "float32", {}),
    ("ssgan", "float32", {}),
])
def test_the_optimizer_term_is_the_formula_over_jax_params(family, dtype,
                                                           extra):
    kw = dict(SMALL[family], **extra)
    _, model, _, state = _state(family, dtype, **kw)
    assert mfu.optimizer_bytes(model, state) \
        == _jax_optimizer_bytes(family, dtype, **kw)


def test_the_roofline_fields(monkeypatch):
    monkeypatch.delenv("GGAN_PEAK_BW", raising=False)
    monkeypatch.delenv("GGAN_PEAK_FLOPS", raising=False)
    assert mfu.PEAK_BW == {H100: 3.35e12}
    rec = mfu.mfu_record("gan", "float32", 2.6e11, 0.02, H100, 2.6e9)
    assert rec["bytes_per_iter"] == 2.6e9
    assert rec["bytes_source"] == "cpu byte counter"
    assert rec["achieved_gbps"] == pytest.approx(130.0)
    assert rec["hbm_bw_util"] == pytest.approx(130e9 / 3.35e12)
    for kind in ("some other card", "cpu"):
        rec = mfu.mfu_record("gan", "float32", 2.6e11, 0.02, kind, 2.6e9)
        assert rec["hbm_bw_util"] is None
        assert rec["achieved_gbps"] == pytest.approx(130.0)
    monkeypatch.setenv("GGAN_PEAK_BW", "1e12")
    for kind in ("some other card", H100):  # the override wins
        rec = mfu.mfu_record("gan", "float32", 2.6e11, 0.02, kind, 2.6e9)
        assert rec["hbm_bw_util"] == pytest.approx(0.13)


def test_card_peaks_name_the_card():
    assert mfu.card_peaks(H100) == (mfu.PEAK[H100], 3.35e12)
    with pytest.raises(KeyError, match="some other card"):
        mfu.card_peaks("some other card")


def test_cli_prints_the_roofline_fields(monkeypatch, capsys, steps):
    monkeypatch.delenv("GGAN_PEAK_BW", raising=False)
    rec = mfu.main(["--family", "gan", "--dtype", "float32", "--dim", "8",
                    "--batch-size", "8", "--data-rows", "32", "--rounds",
                    "1", "--iters", "1", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == rec
    _, model, _, state = _state("gan", "float32", **SMALL["gan"])
    nbytes, flops = steps[("gan", "float32")]
    assert rec["flops_per_iter"] == flops.get_total_flops()
    # cost_per_iter's terms: the step's contractions and its optimizer
    assert rec["bytes_per_iter"] \
        == nbytes.total + mfu.optimizer_bytes(model, state) > 0
    assert rec["achieved_gbps"] == pytest.approx(
        rec["bytes_per_iter"] / rec["sec_per_iter"] / 1e9)
    assert rec["hbm_bw_util"] is None
    assert rec["bytes_source"] == "cpu byte counter"
