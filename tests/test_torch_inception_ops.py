"""The port's GraphDef interpreter (graphical_gan_tpu_torch/metrics/
inception_frozen.py) against the JAX package's, one op at a time, on the
CPU, from the same numpy inputs.

Each graph is a placeholder fed at ``ExpandDims``, the op under test and
its constant operands, written by chip_smoke.py's GraphDef writer and read
by both packages' readers. The edges are where a port goes wrong: TF1's
legacy resize (source = dest * in/out, edge clamped), SAME pools with the
odd pad high, MaxPool's -inf fill and a SAME AvgPool's divisor (the valid
elements of each window). Float results within 1e-6 (the same f32
operations, summed in another order at most); integer results equal.
"""

import os
import sys

import numpy as np
import pytest
import torch

from graphical_gan_tpu.metrics import graphdef as jax_graphdef
from graphical_gan_tpu.metrics import inception_frozen as jax_frozen
from graphical_gan_tpu_torch.metrics import graphdef
from graphical_gan_tpu_torch.metrics import inception_frozen as frozen

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

ATOL = RTOL = 1e-6


def run_both(nodes, x, fetch="out"):
    data = cs.pb_graphdef([cs.graph_feed()] + nodes)
    jint = jax_frozen.GraphInterpreter(jax_graphdef.parse_graphdef(data))
    want = np.asarray(jint.make_fn("ExpandDims", [fetch])(jint.consts, x)[0])
    tint = frozen.GraphInterpreter(graphdef.parse_graphdef(data), "cpu")
    got = tint.make_fn("ExpandDims", [fetch])(torch.from_numpy(x))[0]
    return got.numpy(), want


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("in_hw,out_hw", [
    ((7, 5), (13, 11)), ((7, 5), (29, 29)), ((7, 5), (3, 2)),
    ((7, 5), (7, 5)), ((32, 32), (299, 299)), ((8, 9), (5, 17))])
def test_legacy_resize(in_hw, out_hw):
    nodes = [cs.graph_const("size", np.asarray(out_hw, np.int32), np.int32),
             cs.graph_node("out", "ResizeBilinear", ["ExpandDims", "size"])]
    got, want = run_both(nodes, _x((2,) + in_hw + (3,)) * 100)
    assert got.shape == want.shape == (2,) + out_hw + (3,)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-4)


POOLS = [  # (H, W, k, stride, padding): odd and even sizes, edge windows
    (9, 9, 3, 2, b"SAME"), (9, 9, 3, 1, b"SAME"), (8, 10, 3, 2, b"SAME"),
    (7, 6, 2, 2, b"SAME"), (9, 9, 3, 2, b"VALID"), (8, 10, 3, 1, b"VALID"),
    (35, 35, 3, 2, b"VALID"), (5, 5, 5, 1, b"VALID")]


@pytest.mark.parametrize("op", ["MaxPool", "AvgPool"])
@pytest.mark.parametrize("h,w,k,s,pad", POOLS)
def test_pools(op, h, w, k, s, pad):
    nodes = [cs.graph_node("out", op, ["ExpandDims"], ksize=[1, k, k, 1],
                           strides=[1, s, s, 1], padding=pad)]
    # all-negative inputs: a zero fill would win MaxPool's edge windows
    x = -np.abs(_x((2, h, w, 4))) - 1.0
    got, want = run_both(nodes, x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("op,axis", [("Concat", 3), ("Concat", 1),
                                     ("ConcatV2", 3), ("ConcatV2", 2)])
def test_concat(op, axis):
    nodes = [cs.graph_const("axis", np.asarray(axis, np.int32), np.int32),
             cs.graph_node("b", "Relu", ["ExpandDims"]),
             cs.graph_node("c", "Relu6", ["ExpandDims"])]
    ins = ["b", "ExpandDims", "c"]
    inputs = ["axis"] + ins if op == "Concat" else ins + ["axis"]
    nodes.append(cs.graph_node("out", op, inputs, N=3))
    got, want = run_both(nodes, _x((2, 3, 4, 5)) * 4)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dims,shape", [([1, 2], (3, 1, 1, 7)),
                                        ([], (1, 4, 1, 1)),
                                        ([0], (1, 2, 3))])
def test_squeeze(dims, shape):
    attrs = {"squeeze_dims": dims} if dims else {}
    nodes = [cs.graph_node("out", "Squeeze", ["ExpandDims"], **attrs)]
    got, want = run_both(nodes, _x(shape))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pads", [[[0, 0], [1, 2], [2, 1], [0, 0]],
                                  [[1, 0], [0, 0], [0, 3], [2, 2]]])
def test_pad(pads):
    nodes = [cs.graph_const("p", np.asarray(pads, np.int32), np.int32),
             cs.graph_node("out", "Pad", ["ExpandDims", "p"],
                           Tpaddings=cs.TF_INT32)]
    got, want = run_both(nodes, _x((2, 3, 4, 2)))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dst", [cs.TF_FLOAT, cs.TF_INT32])
def test_cast(dst):
    nodes = [cs.graph_node("out", "Cast", ["ExpandDims"],
                           SrcT=cs.TF_FLOAT, DstT=dst)]
    got, want = run_both(nodes, _x((3, 5)) * 7)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ta,tb", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_matmul_transposes(ta, tb):
    w = _x((6, 4), seed=1) if tb else _x((4, 6), seed=1)
    nodes = [cs.graph_const("w", w),
             cs.graph_node("out", "MatMul", ["ExpandDims", "w"],
                           transpose_a=ta, transpose_b=tb)]
    x = _x((4, 5)) if ta else _x((5, 4))
    got, want = run_both(nodes, x)
    assert got.shape == want.shape == (5, 6)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("op", ["Sub", "Mul", "RealDiv", "Maximum", "Add",
                                "AddV2", "BiasAdd"])
def test_binary_ops(op):
    c = np.random.RandomState(2).rand(5).astype(np.float32) + 0.5
    nodes = [cs.graph_const("c", c),
             cs.graph_node("out", op, ["ExpandDims", "c"])]
    got, want = run_both(nodes, _x((2, 3, 5)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("op", ["Relu", "Relu6", "Softmax", "Identity",
                                "StopGradient", "CheckNumerics"])
def test_unary_ops(op):
    nodes = [cs.graph_node("out", op, ["ExpandDims"])]
    got, want = run_both(nodes, _x((3, 7)) * 5)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_reshape_expand_dims_and_shape():
    nodes = [cs.graph_const("shape", np.asarray([-1, 6], np.int32),
                            np.int32),
             cs.graph_const("one", np.asarray(1, np.int32), np.int32),
             cs.graph_node("r", "Reshape", ["ExpandDims", "shape"]),
             cs.graph_node("out", "ExpandDims", ["r", "one"]),
             cs.graph_node("sh", "Shape", ["out"], out_type=cs.TF_INT32)]
    x = _x((2, 3, 4))
    got, want = run_both(nodes, x)
    assert got.shape == want.shape == (4, 1, 6)
    np.testing.assert_array_equal(got, want)
    got, want = run_both(nodes, x, fetch="sh")
    np.testing.assert_array_equal(got, want)


def test_conv_same_stride2_batchnorm_and_control_inputs():
    """Conv2D SAME at stride 2 on an odd size (pads 0 and 1 against 1 and
    1), then the legacy BN with scale_after_normalization, with a control
    input that carries no value."""
    r = np.random.RandomState(4)
    nodes = [cs.graph_const("w", r.randn(3, 3, 4, 6).astype(np.float32)),
             cs.graph_node("conv", "Conv2D", ["ExpandDims", "w", "^w"],
                           strides=[1, 2, 2, 1], padding=b"SAME")]
    for name, v in (("m", r.randn(6)), ("v", r.rand(6) + 0.5),
                    ("beta", r.randn(6)), ("gamma", r.rand(6) + 0.5)):
        nodes.append(cs.graph_const(name, v.astype(np.float32)))
    nodes.append(cs.graph_node(
        "out", "BatchNormWithGlobalNormalization",
        ["conv", "m", "v", "beta", "gamma"], variance_epsilon=0.001,
        scale_after_normalization=True))
    got, want = run_both(nodes, _x((2, 9, 8, 4)))
    assert got.shape == want.shape == (2, 5, 4, 6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_an_unknown_op_raises():
    nodes = [cs.graph_node("out", "Erf", ["ExpandDims"])]
    data = cs.pb_graphdef([cs.graph_feed()] + nodes)
    tint = frozen.GraphInterpreter(graphdef.parse_graphdef(data), "cpu")
    with pytest.raises(NotImplementedError, match="Erf"):
        tint.make_fn("ExpandDims", ["out"])(torch.zeros(2))
