"""Why the port counts more FLOPs per iteration than XLA's cost model of
the JAX step (cifar10 wali-gp, dim 8, B 8, f32, on the CPU): the port's
``tools/mfu.py: flops_per_iter`` (FlopCounterMode) against
``graphical_gan_tpu/tools/mfu.py: cost_per_iter``'s program, its convs and
dots read per op from ``jax.jit(...).lower(...).compile().as_text()``.

The gap is three terms, each computed here on its own:

- XLA counts elementwise work (its total less its convs and dots); the
  port's counter counts none;
- XLA counts a conv's taps that fall inside its input only; the port's
  counter counts every tap of the padded conv (``padding_taps``: JAX's
  convs counted as the port counts them, less XLA's count of them);
- XLA rewrites the width-1 products of D's output layer as a multiply and
  a reduce (elementwise in its count); the port counts them as GEMMs.

A fourth term, conv work the port ran and JAX's step does not
(``redundant``), is now zero: in wali-gp's penalty K1's custom backward
(``ops/kernels/fused_conv.py: FusedConv2dBiasAct.backward``) took its
gradient mask from ``ctx.needs_input_grad``, so the inner ``autograd.grad``
w.r.t. the interpolates also computed the weight gradients of D.1-3, and
``aten.convolution_backward`` was handed the layer's input with its graph,
so the outer backward reached D's forward on the interpolates. The
penalty's ``input_grads_only`` scope and the detached input remove both:
the port's conv work equals JAX's layer by layer, with no patch here.

``pytest -s`` prints the terms.
"""

import collections
import math
import re

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from graphical_gan_tpu.tools import mfu as jax_mfu
from graphical_gan_tpu_torch.data.ondevice import sample_batches, to_device
from graphical_gan_tpu_torch.tools import mfu
from graphical_gan_tpu_torch.train.step import make_train_step
from _torch_threads import one_thread  # noqa: F401

DIM, B = 8, 8
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}
_LINE = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+) = \w+\[([\d,]*)\]")


def layer_flops(dim: int, b: int) -> dict:
    """One conv work item (a forward, an input or a weight gradient) of
    each E/D layer, 5x5 stride 2 SAME, as the port's counter counts it:
    2·B·Ho·Wo·Cin·Cout·25. G's deconvs are their transposes."""
    return {"L1": 2 * b * 16 * 16 * 3 * dim * 25,
            "L2": 2 * b * 8 * 8 * dim * 2 * dim * 25,
            "L3": 2 * b * 4 * 4 * 2 * dim * 4 * dim * 25}


def _layer(dims) -> str:
    """The E/D layer a conv serves, from its operands' dims at dim 8, B 8:
    only L1 has 3 channels; of the others only L3 has 32."""
    flat = {d for shape in dims for d in shape}
    return "L1" if 3 in flat else ("L3" if 32 in flat else "L2")


def _valid_pairs(size, out, k, stride, lo, ldil, rdil):
    """(output, tap) pairs of one spatial dim whose input position lies
    inside the (dilated) input and not in a dilation hole."""
    extent = (size - 1) * ldil + 1
    return sum(1 for o in range(out) for t in range(k)
               if 0 <= o * stride - lo + t * rdil < extent
               and (o * stride - lo + t * rdil) % ldil == 0)


def _hlo_ops(txt):
    """([(layer, XLA's valid-tap FLOPs)] per convolution, [(FLOPs, width-1
    or not)] per dot) of an optimized HLO module's text."""
    shape = {}
    for line in txt.splitlines():
        m = _LINE.match(line)
        if m:
            shape[m.group(1)] = [int(x) for x in m.group(2).split(",") if x]
    convs, dots = [], []
    for line in txt.splitlines():
        m = _LINE.match(line)
        if m is None:
            continue
        out = shape[m.group(1)]
        if " convolution(" in line:
            lhs_n, rhs_n = re.search(
                r"convolution\(%?([\w.\-]+), %?([\w.\-]+)\)", line).groups()
            lhs, rhs = shape[lhs_n], shape[rhs_n]
            ll, rl, ol = re.search(r"dim_labels=(\w+)_(\w+)->(\w+)",
                                   line).groups()
            win = dict(kv.split("=") for kv in re.search(
                r"window=\{([^}]*)\}", line).group(1).split())
            size = [int(x) for x in win["size"].split("x")]
            nd = len(size)

            def field(name, default, parse=int):
                return [parse(x) for x in win.get(
                    name, "x".join([default] * nd)).split("x")]
            stride = field("stride", "1")
            pad = field("pad", "0_0", lambda x: int(x.split("_")[0]))
            ldil, rdil = field("lhs_dilate", "1"), field("rhs_dilate", "1")
            pairs = math.prod(_valid_pairs(
                lhs[ll.index(str(d))], out[ol.index(str(d))], size[d],
                stride[d], pad[d], ldil[d], rdil[d]) for d in range(nd))
            flops = 2 * out[ol.index("b")] * out[ol.index("f")] \
                * rhs[rl.index("i")] * pairs
            convs.append((_layer([lhs, rhs, out]), flops))
        elif " dot(" in line:
            lhs_n, rhs_n = re.search(
                r"dot\(%?([\w.\-]+), %?([\w.\-]+)\)", line).groups()

            def dims(key):
                m = re.search(key + r"=\{([\d,]*)\}", line)
                return [int(x) for x in m.group(1).split(",") if x] if m \
                    else []

            def free(operand, side):
                skip = dims(side + "_contracting_dims") \
                    + dims(side + "_batch_dims")
                return math.prod(d for i, d in enumerate(operand)
                                 if i not in skip)
            lhs, rhs = shape[lhs_n], shape[rhs_n]
            k = math.prod(lhs[i] for i in dims("lhs_contracting_dims"))
            width1 = min(free(lhs, "lhs"), free(rhs, "rhs"), k) == 1
            dots.append((2 * math.prod(out) * k, width1))
    return convs, dots


@pytest.fixture(scope="module")
def jax_step():
    cfg, model, init_state, one_iter, _ = jax_mfu._build(
        "float32", "gan", dim=DIM, batch_size=B)
    state = jax.eval_shape(lambda key: init_state(model.init(key)),
                           jax.random.PRNGKey(0))
    data = jax.ShapeDtypeStruct((256, cfg.data.output_dim), jnp.int32)
    compiled = jax.jit(one_iter).lower(
        state, data, jax.ShapeDtypeStruct((2,), jnp.uint32)).compile(FAST)
    cost = compiled.cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    convs, dots = _hlo_ops(compiled.as_text())
    return {"total": float(cost["flops"]), "convs": convs, "dots": dots}


class _Items(TorchDispatchMode):
    """Conv work items per layer (a convolution_backward computing two
    gradients is two items) and GEMM FLOPs (width 1 apart)."""

    def __init__(self):
        super().__init__()
        self.items = collections.Counter()
        self.gemm = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if name == "aten.convolution":
            self.items[_layer([args[0].shape, args[1].shape])] += 1
        elif name == "aten.convolution_backward":
            self.items[_layer([a.shape for a in args[:3]])] += \
                int(args[10][0]) + int(args[10][1])
        elif name in ("aten.mm", "aten.addmm"):
            a, b = args[-2], args[-1]
            width1 = min(b.shape[1], a.shape[1]) == 1
            self.gemm[width1] += 2 * a.shape[0] * a.shape[1] * b.shape[1]
        return func(*args, **(kwargs or {}))


def _port_step():
    """(conv items per layer, GEMM FLOPs, FlopCounterMode's conv FLOPs) of
    one port iteration."""
    cfg, model = mfu.family_model("gan", "float32", dim=DIM, batch_size=B)
    step, init_state = make_train_step(model)
    state = init_state(model.init(0, "cpu"))
    data = to_device(mfu.family_data("gan", cfg, n=256), "cpu")
    gen = torch.Generator().manual_seed(1)
    raw = sample_batches(data, 1 + cfg.critic_iters, B, gen)
    with FlopCounterMode(display=False) as counter, _Items() as items:
        step(state, raw, True, gen)
    conv = sum(v for op, v in counter.get_flop_counts()["Global"].items()
               if "convolution" in str(op))
    return items.items, items.gemm, conv


def test_the_gap_is_four_terms(jax_step):
    """Three terms; the fourth (redundant conv work) is zero."""
    F = layer_flops(DIM, B)
    items, gemm, conv = _port_step()
    # the port's counter counts every conv item at its full tap count
    assert conv == sum(n * F[layer] for layer, n in items.items())
    port = mfu.flops_per_iter("float32", "gan", dim=DIM, batch_size=B)
    assert port == conv + gemm[True] + gemm[False]

    jax_items = collections.Counter(layer for layer, _ in jax_step["convs"])
    # the port runs JAX's convs, layer by layer, and its GEMMs (the
    # width-1 ones aside) are JAX's dots
    assert items == jax_items
    wide_dots = sum(f for f, width1 in jax_step["dots"] if not width1)
    assert gemm[False] == wide_dots

    canonical = sum(n * F[layer] for layer, n in jax_items.items())
    valid = sum(f for _, f in jax_step["convs"])
    dots = sum(f for f, _ in jax_step["dots"])
    elementwise = jax_step["total"] - valid - dots
    padding_taps = canonical - valid
    redundant = conv - canonical
    width1 = gemm[True] + gemm[False] - dots
    assert elementwise > 0 and padding_taps > 0 and width1 > 0
    assert redundant == 0
    assert port == jax_step["total"] - elementwise + padding_taps + width1
    # per iteration, the 5 D updates' 3 L1, 3 L2 and 1 L3 items the port
    # ran before: 35.91 GFLOP at the published config, now not run
    published = layer_flops(64, 64)
    print(f"\nxla total {jax_step['total']:.0f} = convs {valid:.0f} + dots "
          f"{dots:.0f} + elementwise {elementwise:.0f}\nport "
          f"{port:.0f}: padding taps +{padding_taps:.0f}, width-1 GEMMs "
          f"+{width1:.0f}, elementwise -{elementwise:.0f}\nitems port "
          f"{dict(items)} jax {dict(jax_items)}\nformerly redundant at "
          f"B 64, DIM 64: {15 * published['L1'] + 15 * published['L2'] + 5 * published['L3']}")


def test_xla_counts_no_tap_in_the_padding():
    # a 5x5 stride-2 SAME conv from 8x8 to 4x4 (pads 1, 2): 17 of its 20
    # (output, tap) pairs per dim fall inside the input
    assert _valid_pairs(8, 4, 5, 2, 1, 1, 1) == 17
    # its transpose as a conv with the input dilated by 2: the same pairs
    assert _valid_pairs(4, 8, 5, 1, 2, 2, 1) == 17
