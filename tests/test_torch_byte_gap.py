"""The port's contraction bytes per iteration (``tools/mfu.py:
ByteCounter``) against the operand and result bytes of every convolution
and dot of the JAX program (cifar10 wali-gp, dim 8, B 8, f32, on the CPU):
``graphical_gan_tpu/tools/mfu.py: cost_per_iter``'s program, read per op
from ``jax.jit(...).lower(...).compile().as_text()`` with
``tests/test_torch_flop_gap.py``'s HLO parser.

The two differ by two terms, each computed here on its own, and by no
byte more (tolerance 0 bytes):

- ``shared_cotangent``: a ``convolution_backward`` that computes dx and dw
  reads the cotangent once; XLA's two convolutions (the input and the
  filter gradient) read it once each;
- ``width1``: the port runs every width-1 product of D's output layer
  (and of its gradients) as a GEMM; XLA keeps some as matrix-vector dots
  and rewrites the others as a multiply and a reduce (elementwise, so in
  no dot): the port's width-1 GEMMs less XLA's width-1 dots, as
  flop_gap's ``_hlo_ops`` marks them (flop_gap's width-1 term, in
  bytes).

XLA's whole ``bytes accessed`` (every op, elementwise ones included, each
operand of each fusion) is printed beside the port's whole count;
``pytest -s`` prints the terms.
"""

import math
import re

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from graphical_gan_tpu.tools import mfu as jax_mfu
from graphical_gan_tpu_torch.data.ondevice import sample_batches, to_device
from graphical_gan_tpu_torch.tools import mfu
from graphical_gan_tpu_torch.train.step import make_train_step
from _torch_gmgan import FAST
from _torch_threads import one_thread  # noqa: F401
from test_torch_flop_gap import _LINE, _hlo_ops

DIM, B = 8, 8
_TYPE = re.compile(r"^\s*(?:ROOT\s+)?%?[\w.\-]+ = ([a-z]+)(\d*)\[")


def _hlo_bytes(txt):
    """{"convolution": [bytes], "dot": [bytes]}: each op's two operands and
    its result at their element types, per op of an HLO module's text in
    its order."""
    nbytes = {}
    for line in txt.splitlines():
        m = _LINE.match(line)
        if m:
            kind, bits = _TYPE.match(line).groups()
            size = 1 if kind == "pred" else int(bits) // 8
            nbytes[m.group(1)] = size * math.prod(
                int(x) for x in m.group(2).split(",") if x)
    out = {"convolution": [], "dot": []}
    for line in txt.splitlines():
        m = _LINE.match(line)
        for op in out:
            if m and f" {op}(" in line:
                lhs, rhs = re.search(
                    op + r"\(%?([\w.\-]+), %?([\w.\-]+)\)", line).groups()
                out[op].append(nbytes[lhs] + nbytes[rhs]
                               + nbytes[m.group(1)])
    return out


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
    txt = compiled.as_text()
    ops = _hlo_bytes(txt)
    _, dots = _hlo_ops(txt)
    assert len(dots) == len(ops["dot"])
    return {"bytes accessed": float(cost["bytes accessed"]),
            "convolution": sum(ops["convolution"]), "dot": sum(ops["dot"]),
            "width1 dot": sum(b for b, (_, width1) in zip(ops["dot"], dots)
                              if width1)}


class _Terms(mfu.ByteCounter):
    """The counter, with each term's bytes beside its total."""

    def __init__(self):
        super().__init__()
        self.shared_cotangent = 0
        self.width1 = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if name == "aten.convolution_backward" and args[10][0] \
                and args[10][1]:
            self.shared_cotangent += math.prod(self._of(args[0], True))
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if name in ("aten.mm", "aten.addmm"):
            a, b = args[-2], args[-1]
            if min(b.shape[1], a.shape[1]) == 1:
                self.width1 += self.ops[-1][1]
        return out


def test_the_gap_is_two_terms(jax_step):
    cfg, model = mfu.family_model("gan", "float32", dim=DIM, batch_size=B)
    step, init_state = make_train_step(model)
    state = init_state(model.init(0, "cpu"))
    optimizer = mfu.optimizer_bytes(model, state)
    data = to_device(mfu.family_data("gan", cfg, n=256), "cpu")
    gen = torch.Generator().manual_seed(1)
    with FakeTensorMode(allow_non_fake_inputs=True):
        raw = sample_batches(data, 1 + cfg.critic_iters, B, gen)
        with _Terms() as port:
            step(state, raw, True, gen)
    xla = jax_step["convolution"] + jax_step["dot"]
    width1 = port.width1 - jax_step["width1 dot"]
    assert port.shared_cotangent > 0 and width1 > 0
    assert port.total == xla - port.shared_cotangent + width1
    print(f"\nxla convolutions {jax_step['convolution']} + dots "
          f"{jax_step['dot']} = {xla}\nport contractions {port.total} = "
          f"xla - shared cotangent {port.shared_cotangent} + width-1 "
          f"GEMMs {port.width1} - xla's width-1 dots "
          f"{jax_step['width1 dot']}\nwhole: xla bytes accessed "
          f"{jax_step['bytes accessed']:.0f}, port {port.total + optimizer} "
          f"(optimizer {optimizer})")
