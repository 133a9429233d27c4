"""The port's GraphDef reader (graphical_gan_tpu_torch/metrics/graphdef.py)
against the JAX package's, and chip_smoke.py's GraphDef writer against
TensorFlow's serializer.

- The two readers give the same nodes, the same attributes and bit-equal
  Const arrays on tests/test_inception_frozen.py: build_fixture, on reduced
  tests/test_inception_full_graph.py: _V3Builder graphs (TensorFlow
  serializes both), and on the bytes of chip_smoke.py's writer.
- TensorFlow's ``GraphDef.ParseFromString`` accepts the writer's bytes,
  and the writer's v3 graph reads back equal to _V3Builder's (the same
  random draws in the same order).
"""

import os
import sys

import numpy as np
import pytest

from graphical_gan_tpu.metrics import graphdef as jax_graphdef
from graphical_gan_tpu_torch.metrics import graphdef

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

ATTR_FIELDS = ("s", "i", "f", "b", "type", "shape", "list_s", "list_i",
               "list_f", "list_type")


def assert_same_nodes(got, want):
    """Equal names, ops, inputs and attributes; Consts of the same dtype,
    shape and bits."""
    assert [n.name for n in got] == [n.name for n in want]
    for g, w in zip(got, want):
        assert (g.op, g.inputs) == (w.op, w.inputs), g.name
        assert set(g.attrs) == set(w.attrs), g.name
        for key, wa in w.attrs.items():
            ga = g.attrs[key]
            for f in ATTR_FIELDS:
                assert getattr(ga, f) == getattr(wa, f), (g.name, key, f)
            assert (ga.tensor is None) == (wa.tensor is None), (g.name, key)
            if wa.tensor is not None:
                assert ga.tensor.dtype == wa.tensor.dtype, (g.name, key)
                assert ga.tensor.shape == wa.tensor.shape, (g.name, key)
                assert ga.tensor.tobytes() == wa.tensor.tobytes(), \
                    (g.name, key)
            assert g.attr(key) is not None or w.attr(key) is None


def _tf_fixtures():
    pytest.importorskip("tensorflow")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import test_inception_frozen
    import test_inception_full_graph
    return test_inception_frozen, test_inception_full_graph


@pytest.mark.parametrize("seed", [0, 3])
def test_reader_equals_jax_on_the_mini_fixture(seed):
    frozen, _ = _tf_fixtures()
    data = frozen.build_fixture(seed).SerializeToString()
    assert_same_nodes(graphdef.parse_graphdef(data),
                      jax_graphdef.parse_graphdef(data))


def _v3_reduced_tf(full_graph, stages, seed=0):
    """_V3Builder's graph up to ``stages`` (as chip_smoke.py:
    inception_v3_2015_nodes cuts it), serialized by TensorFlow."""
    from tensorflow.core.framework import graph_pb2, node_def_pb2, types_pb2
    from test_inception_frozen import _const, _node
    b = full_graph._V3Builder(seed)
    inp = node_def_pb2.NodeDef(name="ExpandDims", op="Placeholder")
    inp.attr["dtype"].type = types_pb2.DT_FLOAT
    b.nodes += [
        inp,
        _node("Cast", "Cast", ["ExpandDims"], SrcT=types_pb2.DT_FLOAT,
              DstT=types_pb2.DT_FLOAT),
        _const("resize/size", np.asarray([299, 299], np.int32), np.int32),
        _node("ResizeBilinear", "ResizeBilinear", ["Cast", "resize/size"]),
        _const("Sub/y", 128.0),
        _node("Sub", "Sub", ["ResizeBilinear", "Sub/y"]),
        _const("Mul/y", 1.0 / 128.0),
        _node("Mul", "Mul", ["Sub", "Mul/y"]),
    ]
    b.channels["Mul"] = 3
    h = b.conv("conv", "Mul", 3, 32, 3, 3, stride=2, padding=b"VALID")
    h = b.conv("conv_1", h, 32, 32, 3, 3, padding=b"VALID")
    h = b.conv("conv_2", h, 32, 64, 3, 3)
    h = b.maxpool("pool", h)
    h = b.conv("conv_3", h, 64, 80, 1, 1, padding=b"VALID")
    h = b.conv("conv_4", h, 80, 192, 3, 3, padding=b"VALID")
    h = b.maxpool("pool_1", h)
    if stages >= 2:
        h = b.mixed_35("mixed", h, pool_proj=32)
        h = b.mixed_35("mixed_1", h, pool_proj=64)
        h = b.mixed_35("mixed_2", h, pool_proj=64)
    c = b.channels[h]
    b.nodes += [
        _node("pool_3", "AvgPool", [h], ksize=[1, 35, 35, 1],
              strides=[1, 1, 1, 1], padding=b"VALID"),
        _const("softmax/w", (b.rng.randn(c, 1008) * 0.05).astype(
            np.float32)),
        _const("pool_3/shape", np.asarray([-1, c], np.int32), np.int32),
        _node("pool_3/reshaped", "Reshape", ["pool_3", "pool_3/shape"],
              T=types_pb2.DT_FLOAT),
        _node("softmax/logits/MatMul", "MatMul",
              ["pool_3/reshaped", "softmax/w"]),
        _node("softmax", "Softmax", ["softmax/logits/MatMul"]),
    ]
    gd = graph_pb2.GraphDef()
    gd.versions.producer = 8
    gd.node.extend(b.nodes)
    return gd.SerializeToString()


@pytest.mark.parametrize("stages", [1, 2])
def test_reader_equals_jax_on_reduced_v3_graphs(stages):
    _, full_graph = _tf_fixtures()
    data = _v3_reduced_tf(full_graph, stages)
    got = graphdef.parse_graphdef(data)
    assert_same_nodes(got, jax_graphdef.parse_graphdef(data))
    # chip_smoke.py's writer emits the same graph
    assert_same_nodes(graphdef.parse_graphdef(
        chip_smoke.inception_v3_2015_graphdef(stages=stages)), got)


def test_reader_equals_jax_on_the_writers_full_graph():
    data = chip_smoke.inception_v3_2015_graphdef()
    got = graphdef.parse_graphdef(data)
    assert_same_nodes(got, jax_graphdef.parse_graphdef(data))
    convs = [n for n in got if n.op == "Conv2D"]
    assert len(convs) == 94
    n_params = sum(n.attr("value").size for n in got if n.op == "Const"
                   and n.name.endswith(("/w", "softmax/w")))
    assert 23e6 < n_params < 26e6  # Inception-v3's ~24M weights


def test_tensorflow_parses_the_writers_bytes():
    pytest.importorskip("tensorflow")
    from tensorflow.core.framework import graph_pb2
    data = chip_smoke.inception_v3_2015_graphdef(stages=1)
    gd = graph_pb2.GraphDef()
    gd.ParseFromString(data)
    assert gd.versions.producer == 8
    assert [n.name for n in gd.node] == [
        n.name for n in graphdef.parse_graphdef(data)]
    conv = next(n for n in gd.node if n.name == "conv/conv")
    assert list(conv.attr["strides"].list.i) == [1, 2, 2, 1]
    assert conv.attr["padding"].s == b"VALID"
    bn = next(n for n in gd.node if n.name == "conv/bn")
    assert bn.attr["scale_after_normalization"].b is False
    assert abs(bn.attr["variance_epsilon"].f - 0.001) < 1e-9


@pytest.mark.parametrize("value", [
    np.asarray(3, np.int32), np.asarray([-1, 12], np.int32),
    np.float32(128.0), np.arange(24, dtype=np.float32).reshape(2, 3, 4)])
def test_writer_tensors_read_back_bit_equal(value):
    nodes = graphdef.parse_graphdef(chip_smoke.pb_graphdef(
        [chip_smoke.graph_const("c", value, np.asarray(value).dtype)]))
    got = nodes[0].attr("value")
    want = np.asarray(value)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("n", [0, 1, 127, 128, 300, 2 ** 40, -1, -7])
def test_writer_varints_read_back(n):
    enc = chip_smoke._pb_int(3, n)
    fields = list(graphdef._fields(enc))
    assert len(fields) == 1 and fields[0][:2] == (3, 0)
    assert graphdef._as_signed(fields[0][2]) == n
