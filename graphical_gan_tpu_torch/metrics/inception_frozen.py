"""The frozen Inception-2015 GraphDef as a PyTorch forward, for the
reference's own inception score (``graphical_gan_tpu/metrics/
inception_frozen.py``).

The reference's inception score (``tflib/inception_score.py:56-97``)
loads the frozen ``classify_image_graph_def.pb``, feeds image batches into
``ExpandDims:0``, runs to ``pool_3`` and rebuilds a bias-free softmax from
the ``softmax/logits/MatMul`` weight; the 10-split exp-mean-KL is
``metrics/inception.py``. ``metrics/graphdef.py`` reads the proto (no
TensorFlow, no protobuf) and :class:`GraphInterpreter` evaluates its nodes
as torch ops: the op set of a frozen inference graph of that era (Conv2D,
BatchNormWithGlobalNormalization, the pools, Concat, the legacy
ResizeBilinear sampling, ...).

Tensors stay logically NHWC, so a node's axis arguments (Concat,
ConcatV2, Squeeze, ExpandDims) mean what they say. Conv2D runs
``F.conv2d`` on the channels-last NCHW view of the NHWC tensor, with TF's
asymmetric SAME pads applied first (the odd pad goes high), as the JAX
package computes it with ``lax.conv_general_dilated`` outside any Pallas
kernel. MaxPool pads with -inf; a SAME AvgPool divides each window's sum by
its count of valid elements. The Const tensors go to the device once, when
the classifier is built; shape-like operands are read from the host-side
Const store.

The weights file is not in the repository; wherever it is on the machine,
``FrozenInceptionClassifier(path)`` plugs into ``metrics.inception.
get_inception_score`` (``metrics/inception.py: default_is_classifier``
picks it up from ``GGAN_INCEPTION_PB``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from graphical_gan_tpu_torch.metrics.graphdef import (
    Node, dtype_to_numpy, load_graphdef, parse_graphdef)
from graphical_gan_tpu_torch.ops.kernels.fused_conv import same_pads


def _pad_str(node: Node) -> str:
    return node.attr("padding", b"SAME").decode()


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np_dtype)).dtype


def _resize_bilinear_legacy(x: torch.Tensor, out_h: int, out_w: int
                            ) -> torch.Tensor:
    """TF1 ResizeBilinear with align_corners=False, half_pixel_centers=False
    (the 2015 graph's attributes) on NHWC x: source coordinate = dest *
    (in/out), the edge clamped. ``F.interpolate``'s bilinear mode samples
    at half-pixel centres, which is another function."""
    b, h, w, c = x.shape
    if (h, w) == (out_h, out_w):
        return x
    dtype = x.dtype
    x = x.float()

    def axis_weights(n_in: int, n_out: int):
        src = torch.arange(n_out, dtype=torch.float32, device=x.device) \
            * np.float32(n_in / n_out)
        lo = torch.floor(src).to(torch.int64).clamp(0, n_in - 1)
        hi = torch.clamp(lo + 1, max=n_in - 1)
        return lo, hi, src - lo.to(torch.float32)

    y0, y1, fy = axis_weights(h, out_h)
    x0, x1, fx = axis_weights(w, out_w)
    top = x.index_select(1, y0)
    bot = x.index_select(1, y1)
    rows = top + (bot - top) * fy[None, :, None, None]
    left = rows.index_select(2, x0)
    right = rows.index_select(2, x1)
    out = left + (right - left) * fx[None, None, :, None]
    return out.to(dtype)


def _window(node: Node):
    """(kh, kw), (sh, sw) of an NHWC pool; pools over the batch or the
    channels are not a 2015 graph's."""
    ksize, strides = node.attr("ksize"), node.attr("strides")
    if ksize[0] != 1 or ksize[3] != 1 or strides[0] != 1 or strides[3] != 1:
        raise NotImplementedError(
            f"pool '{node.name}' with ksize {ksize}, strides {strides}: only "
            "spatial NHWC windows are supported")
    return (int(ksize[1]), int(ksize[2])), (int(strides[1]), int(strides[2]))


def _nchw_padded(x: torch.Tensor, k, s, padding: str, value: float = 0.0):
    """The channels-last NCHW view of NHWC x, padded for TF's ``padding``
    with ``value``, and the (lo, hi) pads of H and W."""
    xc = x.permute(0, 3, 1, 2)
    if padding == "VALID":
        return xc, ((0, 0), (0, 0))
    if padding != "SAME":
        raise ValueError(f"padding {padding!r}")
    ph = same_pads(x.shape[1], k[0], s[0])
    pw = same_pads(x.shape[2], k[1], s[1])
    if any(ph + pw):
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]), value=value)
    return xc, (ph, pw)


def _valid_counts(n: int, k: int, s: int, lo: int, device) -> torch.Tensor:
    """Per output position along one axis, how many of its k taps fall
    inside the unpadded input of size n."""
    n_out = -(-n // s)
    start = torch.arange(n_out, device=device) * s - lo
    return (torch.clamp(start + k, max=n) - torch.clamp(start, min=0)
            ).to(torch.float32)


def _oihw(w_hwio: torch.Tensor) -> torch.Tensor:
    """An HWIO filter as ``F.conv2d``'s OIHW weight, stored channels-last
    (O, H, W, I in memory), the layout cuDNN's NHWC convs read."""
    return w_hwio.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)


def _conv2d(x: torch.Tensor, w_oihw: torch.Tensor, strides, padding: str
            ) -> torch.Tensor:
    """TF Conv2D of NHWC x with the filter as :func:`_oihw` gives it."""
    k = (w_oihw.shape[2], w_oihw.shape[3])
    xc, _ = _nchw_padded(x, k, strides, padding)
    out = F.conv2d(xc, w_oihw, stride=tuple(strides))
    return out.permute(0, 2, 3, 1)


def _max_pool(x: torch.Tensor, node: Node) -> torch.Tensor:
    k, s = _window(node)
    xc, _ = _nchw_padded(x, k, s, _pad_str(node), value=-float("inf"))
    return F.max_pool2d(xc, k, s).permute(0, 2, 3, 1)


def _avg_pool(x: torch.Tensor, node: Node) -> torch.Tensor:
    """TF AvgPool: with SAME padding each window's sum is divided by the
    number of its valid (non-padding) elements."""
    k, s = _window(node)
    padding = _pad_str(node)
    xc, (ph, pw) = _nchw_padded(x, k, s, padding)
    summed = F.avg_pool2d(xc, k, s, divisor_override=1).permute(0, 2, 3, 1)
    if padding == "VALID":
        return summed / float(k[0] * k[1])
    counts = (_valid_counts(x.shape[1], k[0], s[0], ph[0], x.device)[:, None]
              * _valid_counts(x.shape[2], k[1], s[1], pw[0], x.device))
    return summed / counts[:, :, None].to(summed.dtype)


class GraphInterpreter:
    """Evaluate a frozen GraphDef's ops as torch ops on ``device``, feeding
    one tensor. The Const store (``consts``, torch tensors on the device)
    is made once here; ``host_consts`` keeps the numpy values that
    shape-like operands are read from."""

    def __init__(self, nodes: List[Node],
                 device: Union[str, torch.device] = "cpu"):
        self.nodes: Dict[str, Node] = {n.name: n for n in nodes}
        self.host_consts: Dict[str, np.ndarray] = {
            n.name: n.attr("value") for n in nodes if n.op == "Const"}
        self.device = torch.device(device)
        self.consts: Dict[str, torch.Tensor] = {
            k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
            for k, v in self.host_consts.items()
            if v is not None and v.dtype != object}
        # Conv2D filters that are Consts, in :func:`_oihw`'s layout, made at
        # their first use
        self._filters: Dict[str, torch.Tensor] = {}

    def schedule(self, feed_name: str, fetches: Sequence[str]) -> List[str]:
        """The nodes that ``fetches`` need, past ``feed_name``, each after
        its data inputs (control inputs carry no value and are not run)."""
        order: List[str] = []
        seen = {feed_name}
        stack = [(t.partition(":")[0], False) for t in reversed(fetches)]
        while stack:
            name, expanded = stack.pop()
            if expanded:
                order.append(name)
                continue
            if name in seen:
                continue
            seen.add(name)
            stack.append((name, True))
            for t in reversed(self.nodes[name].inputs):
                if not t.startswith("^"):
                    stack.append((t.partition(":")[0], False))
        return order

    def make_fn(self, feed_name: str, fetches: Sequence[str]
                ) -> Callable[[torch.Tensor], list]:
        """Returns ``fn(feed) -> [fetched tensors]``: the nodes run in
        :meth:`schedule`'s order, and each output is dropped after its
        last reader, so a batch holds only the tensors still to be read."""
        order = self.schedule(feed_name, fetches)
        keep = {t.partition(":")[0] for t in fetches}
        last_read: Dict[str, int] = {}
        for i, name in enumerate(order):
            for t in self.nodes[name].inputs:
                if not t.startswith("^"):
                    last_read[t.partition(":")[0]] = i
        drops: Dict[int, List[str]] = {}
        for name, i in last_read.items():
            if name not in keep and name != feed_name:
                drops.setdefault(i, []).append(name)

        def fn(feed: torch.Tensor) -> list:
            memo: Dict[str, tuple] = {feed_name: (feed,)}

            def ref(tname: str):
                name, _, idx = tname.partition(":")
                return memo[name][int(idx) if idx else 0]

            for i, name in enumerate(order):
                memo[name] = self._eval_node(self.nodes[name], ref)
                for dead in drops.get(i, ()):
                    del memo[dead]
            return [ref(t) for t in fetches]

        return fn

    def _filter(self, tname: str, w: torch.Tensor) -> torch.Tensor:
        """Conv2D's filter operand in :func:`_oihw`'s layout, kept for a
        Const filter."""
        name = tname.partition(":")[0]
        if self.nodes[name].op != "Const":
            return _oihw(w)
        if name not in self._filters:
            self._filters[name] = _oihw(w)
        return self._filters[name]

    def _static_value(self, tname: str) -> np.ndarray:
        """Shape-like operands (Reshape shapes, resize sizes, concat axes,
        pad amounts) come from the host-side Const store, through
        Identity-like nodes."""
        name, _, _ = tname.partition(":")
        node = self.nodes[name]
        if node.op == "Const":
            return np.asarray(self.host_consts[name])
        if node.op in ("Identity", "CheckNumerics", "StopGradient"):
            return self._static_value(node.inputs[0])
        raise ValueError(
            f"'{tname}' feeds a shape operand but is not a constant "
            f"(op {node.op})")

    # -- op table -----------------------------------------------------------

    def _eval_node(self, node: Node, ref) -> tuple:
        op = node.op
        # control inputs ("^name") carry no value
        data_inputs = [t for t in node.inputs if not t.startswith("^")]

        def static(i: int) -> np.ndarray:
            return self._static_value(data_inputs[i])

        if op == "Const":
            return (self.consts[node.name],)
        if op == "Placeholder":
            raise ValueError(
                f"placeholder '{node.name}' reached — feed it instead")
        if op in ("Concat", "ConcatV2"):
            # Concat's axis is input 0; ConcatV2's is the last input
            pos = 0 if op == "Concat" else len(data_inputs) - 1
            axis = int(static(pos))
            parts = [ref(t) for i, t in enumerate(data_inputs) if i != pos]
            return (torch.cat(parts, dim=axis),)
        if op in ("Reshape", "ExpandDims", "ResizeBilinear", "Pad"):
            x = ref(data_inputs[0])
            if op == "Reshape":
                return (torch.reshape(x, [int(d) for d in static(1)]),)
            if op == "ExpandDims":
                return (torch.unsqueeze(x, int(static(1))),)
            if op == "ResizeBilinear":
                out_h, out_w = [int(d) for d in static(1)]
                return (_resize_bilinear_legacy(x, out_h, out_w),)
            pads = []
            for a, b in reversed([(int(a), int(b)) for a, b in static(1)]):
                pads += [a, b]
            return (F.pad(x, pads),)
        ins = [ref(t) for t in data_inputs]
        if op in ("Identity", "CheckNumerics", "StopGradient",
                  "PreventGradient"):
            return (ins[0],)
        if op == "Conv2D":
            sh, sw = node.attr("strides")[1:3]
            return (_conv2d(ins[0], self._filter(data_inputs[1], ins[1]),
                            (int(sh), int(sw)), _pad_str(node)),)
        if op == "BatchNormWithGlobalNormalization":
            t, m, v, beta, gamma = ins
            eps = node.attr("variance_epsilon", 1e-3)
            inv = torch.rsqrt(v + eps)
            if node.attr("scale_after_normalization", False):
                inv = inv * gamma
            return ((t - m) * inv + beta,)
        if op == "Relu":
            return (torch.clamp_min(ins[0], 0),)
        if op == "Relu6":
            return (torch.clamp(ins[0], 0, 6),)
        if op == "MaxPool":
            return (_max_pool(ins[0], node),)
        if op == "AvgPool":
            return (_avg_pool(ins[0], node),)
        if op == "Squeeze":
            dims = node.attr("squeeze_dims") or node.attr("axis")
            if dims:
                return (torch.squeeze(ins[0], tuple(int(d) for d in dims)),)
            return (torch.squeeze(ins[0]),)
        if op == "MatMul":
            a = ins[0].T if node.attr("transpose_a", False) else ins[0]
            b = ins[1].T if node.attr("transpose_b", False) else ins[1]
            return (a @ b,)
        if op in ("BiasAdd", "Add", "AddV2"):
            return (ins[0] + ins[1],)
        if op == "Sub":
            return (ins[0] - ins[1],)
        if op == "Mul":
            return (ins[0] * ins[1],)
        if op == "RealDiv":
            return (ins[0] / ins[1],)
        if op == "Maximum":
            return (torch.maximum(ins[0], ins[1]),)
        if op == "Softmax":
            return (torch.softmax(ins[0], dim=-1),)
        if op == "Cast":
            return (ins[0].to(_torch_dtype(
                dtype_to_numpy(node.attr("DstT")))),)
        if op == "Shape":
            return (torch.tensor(list(ins[0].shape), dtype=torch.int32,
                                 device=ins[0].device),)
        raise NotImplementedError(
            f"GraphDef op '{op}' (node '{node.name}') not supported")


class FrozenInceptionClassifier:
    """The reference's scorer head over a frozen GraphDef, on ``device``.

    ``images [B, H, W, 3] float 0-255 -> probs [B, 1008]``: feed
    ``ExpandDims:0`` -> ``pool_3`` -> squeeze -> @ the
    ``softmax/logits/MatMul`` weight -> softmax
    (``tflib/inception_score.py:92-94``: no logits bias). Runs under the
    port's numerics (``core/device.py: set_numerics``: no TF32 in cuDNN's
    f32 convs or in the head's product). Plugs into
    ``metrics.inception.get_inception_score``.
    """

    FEED = "ExpandDims"
    POOL = "pool_3"
    LOGITS_MATMUL = "softmax/logits/MatMul"

    def __init__(self, graphdef: Union[str, bytes, List[Node]],
                 device: Union[str, torch.device] = "cuda"):
        from graphical_gan_tpu_torch.core.device import (
            resolve_device, set_numerics)
        self.device = resolve_device(device)
        set_numerics()
        if isinstance(graphdef, str):
            nodes = load_graphdef(graphdef)
        elif isinstance(graphdef, bytes):
            nodes = parse_graphdef(graphdef)
        else:
            nodes = graphdef
        self.interp = GraphInterpreter(nodes, self.device)
        w_ref = self.interp.nodes[self.LOGITS_MATMUL].inputs[1]
        self._pool_fn = self.interp.make_fn(self.FEED, [self.POOL, w_ref])

    def pool3_and_probs(self, x: torch.Tensor):
        """``(pool_3 [B, 1, 1, 2048], probs [B, K])`` of a float32 NHWC
        batch already on the device."""
        with torch.inference_mode():
            pool3, w = self._pool_fn(x)
            logits = torch.squeeze(pool3, (1, 2)) @ w
            return pool3, torch.softmax(logits, dim=-1)

    def __call__(self, images: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(images, dtype=np.float32))
        return self.pool3_and_probs(x.to(self.device))[1].cpu().numpy()
