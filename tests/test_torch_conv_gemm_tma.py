"""K3a's TMA path (``graphical_gan_tpu_torch/csrc/conv_gemm_tma.cu``) on the
CPU: the geometry the card's Tensor Memory Accelerator is given, checked
through the Python functions that compute it (``ops/kernels/conv_gemm.py:
tma_geometry``, ``k3a_steps``, ``route``), and K3's routing.

- A numpy emulation of the im2col load, driven only by the map's parameters
  (dims, byte strides, bounding-box corners, traversal strides, channels
  and pixels per column) and one load's coordinates and offsets: BM pixels
  walked W -> H -> B at the stride, wrapping at the box's corners, each
  read at (h + kh, w + kw) from x's flat buffer, zero where that falls in
  the padding, past the last image (rows past M) or past Cin. It is held
  equal, exactly, to the A tile of tap (kh, kw) that the JAX ``_kernel``
  slices from JAX's ``phase_stack`` (``conv_gemm.py:89-92``) at square
  shapes, and from the port's ``phase_stack`` at non-square ones (JAX's
  takes the height's span for both axes), at every ``chip_smoke.py``
  K3_CHECK shape, for tiles that start the batch, cross an image boundary
  and cross M's end.
- The W map's boxes, emulated the same way from w's flat buffer, against
  the JAX kernel's ``w_ref[kh, kw]`` blocks.
- K3a's steps cover each HWIO column once, in the JAX taps order.
- The route (path, tile, splits) of every check shape in both dtypes.

The hardware itself is held to these on the card by ``chip_smoke.py``,
where K3a on the TMA path must equal the plain version and K1 bit for bit.
"""

import os
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from graphical_gan_tpu.ops.pallas.conv_gemm import phase_stack as jax_phase
from graphical_gan_tpu_torch.ops.kernels import fused_conv
from graphical_gan_tpu_torch.ops.kernels.conv_gemm import (
    IM2COL_CORNER, TMA_BK, VARIANTS, k3a_steps, phase_stack, route,
    tma_geometry)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import K3_CHECK  # noqa: E402

K = 5
S = 2
BF16 = torch.bfloat16


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _emulate_im2col(flat, geo, coords, offsets):
    """The A tile one im2col load writes (before the swizzle), from the
    map's parameters and x's flat element buffer alone."""
    cdim, wdim, hdim, ndim = geo.x_dims
    e1, e2, e3 = (st // 2 for st in geo.x_strides)  # bf16: 2 bytes
    c0, w, h, n = coords
    ow, oh = offsets
    w_lo, h_lo = geo.lower
    w_hi, h_hi = wdim - 1 + geo.upper[0], hdim - 1 + geo.upper[1]
    sw, sh = geo.elem_strides[1], geo.elem_strides[2]
    tile = np.zeros((geo.pixels, geo.channels), np.float32)
    nc = max(0, min(geo.channels, cdim - c0))
    for p in range(geo.pixels):
        pw, ph = w + ow, h + oh
        if 0 <= pw < wdim and 0 <= ph < hdim and 0 <= n < ndim:
            base = c0 + pw * e1 + ph * e2 + n * e3
            tile[p, :nc] = flat[base:base + nc]
        w += sw
        if w > w_hi:
            w, h = w_lo, h + sh
            if h > h_hi:
                h, n = h_lo, n + 1
    return tile


def _emulate_w_box(flat, geo, coords):
    """One tiled box of the W map ([Cin rows, 64 Cout columns] of one tap),
    from the map's parameters and w's flat element buffer alone."""
    d0, d1, d2 = geo.w_dims
    e1, e2 = (st // 2 for st in geo.w_strides)
    b0, b1, b2 = geo.w_box
    n0, c0, t = coords
    assert b2 == 1 and 0 <= t < d2
    box = np.zeros((b1, b0), np.float32)
    for r in range(b1):
        if c0 + r < d1:
            nn = max(0, min(b0, d0 - n0))
            base = n0 + (c0 + r) * e1 + t * e2
            box[r, :nn] = flat[base:base + nn]
    return box


def _jax_tap_windows(x, square):
    """tap -> the [M, Cin] A matrix the JAX ``_kernel`` multiplies at tap
    (kh, kw): ``xp[ph*s + pw, :, oh0:oh0+oh, ow0:ow0+ow, :]``."""
    b, h, w, cin = x.shape
    xp = (np.asarray(jax_phase(jnp.asarray(x), K, S)) if square
          else phase_stack(torch.from_numpy(x), K, S).numpy())
    oh, ow = -(-h // S), -(-w // S)
    out = {}
    for kh in range(K):
        for kw in range(K):
            win = xp[(kh % S) * S + kw % S, :, kh // S:kh // S + oh,
                     kw // S:kw // S + ow, :]
            out[kh * K + kw] = win.reshape(b * oh * ow, cin)
    return out


def _tiles_to_check(m, oh_ow, bm):
    """Row offsets m0 of three tiles: the first, the first that crosses an
    image boundary (else the second), and the last (which crosses M's end
    where M % BM != 0)."""
    starts = list(range(0, m, bm))
    crossing = next((m0 for m0 in starts
                     if (m0 // oh_ow) != (min(m0 + bm, m) - 1) // oh_ow),
                    starts[min(1, len(starts) - 1)])
    return sorted({starts[0], crossing, starts[-1]})


@pytest.mark.parametrize("case", K3_CHECK, ids=[c[0] for c in K3_CHECK])
def test_im2col_emulation_equals_jax_tap_windows(case):
    name, b, h, w, cin, cout = case
    p = route((b, h, w, cin), (K, K, cin, cout), S, BF16, "taps")
    assert p.path == "tma"
    geo = tma_geometry((b, h, w, cin), (K, K, cin, cout), S, p.bm)
    x = _x((b, h, w, cin), seed=len(name))
    flat = x.reshape(-1)
    windows = _jax_tap_windows(x, square=h == w)
    oh, ow = geo.out_hw
    m = b * oh * ow
    assert m == p.m
    for m0 in _tiles_to_check(m, oh * ow, p.bm):
        rows = slice(m0, min(m0 + p.bm, m))
        for tap, c0 in k3a_steps(K, cin):
            coords, offsets = geo.a_load(m0, tap, c0)
            got = _emulate_im2col(flat, geo, coords, offsets)
            want = np.zeros_like(got)
            block = windows[tap][rows, c0:c0 + TMA_BK]
            want[:block.shape[0], :block.shape[1]] = block
            np.testing.assert_array_equal(
                got, want, err_msg=f"{name} m0={m0} tap={tap} c0={c0}")


@pytest.mark.parametrize("case", K3_CHECK, ids=[c[0] for c in K3_CHECK])
def test_w_boxes_equal_jax_tap_blocks(case):
    """The JAX ``_kernel`` multiplies tap (kh, kw) by ``w_ref[kh, kw]``
    ([Cin, Cout]); each box is that block's rows c0.. and columns n0..,
    zero past Cin and Cout."""
    name, _, _, _, cin, cout = case
    w = (np.random.RandomState(7).randn(K, K, cin, cout) * 0.05).astype(
        np.float32)
    geo = tma_geometry((2, 8, 8, cin), (K, K, cin, cout), S, 64)
    assert geo.w_dims == (cout, cin, K * K) and geo.w_box == (64, TMA_BK, 1)
    flat = w.reshape(-1)
    for tap, c0 in k3a_steps(K, cin):
        for n0 in range(0, cout, 64):
            # the kernel's W load names (n0, c0, tap), innermost first
            got = _emulate_w_box(flat, geo, (n0, c0, tap))
            want = np.zeros_like(got)
            block = w[tap // K, tap % K][c0:c0 + TMA_BK, n0:n0 + 64]
            want[:block.shape[0], :block.shape[1]] = block
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,cin", [(5, 64), (5, 128), (5, 8), (5, 16),
                                   (3, 72), (1, 200), (7, 64)])
def test_steps_cover_each_hwio_column_once_in_taps_order(k, cin):
    """Step (tap, c0) multiplies HWIO rows tap·Cin + c0 .. + 64 (those
    below Cin; the rest are zeros on both sides): in order, the taps
    (kh, kw) row-major as the JAX loop runs them, each tap's channels
    ascending, every row once."""
    steps = k3a_steps(k, cin)
    assert len(steps) == k * k * -(-cin // TMA_BK)
    rows = [tap * cin + c0 + j for tap, c0 in steps for j in range(TMA_BK)
            if c0 + j < cin]
    assert rows == list(range(k * k * cin))
    assert [t for t, _ in steps] == sorted(t for t, _ in steps)


# (path, tile, splits) per K3_CHECK shape: bf16 K3a, bf16 K3b, f32 (both)
ROUTES = {
    "disc2": (("tma", 64, 64, 1), ("wgmma", 64, 64, 1), ("fma", 64, 64, 1)),
    "disc3": (("tma", 64, 64, 6), ("wgmma", 64, 64, 6), ("fma", 32, 64, 1)),
    "disc2_b512": (("tma", 128, 128, 1), ("wgmma", 128, 128, 1),
                   ("fma", 128, 128, 1)),
    "disc3_b512": (("tma", 128, 128, 1), ("wgmma", 128, 128, 1),
                   ("fma", 128, 128, 1)),
    "jax disc2-like": (("tma", 64, 64, 13), ("wgmma", 64, 64, 13),
                       ("fma", 32, 64, 1)),
    "jax disc3-like": (("tma", 64, 64, 25), ("wgmma", 64, 64, 25),
                       ("fma", 32, 64, 1)),
    "jax stem-like": (("tma", 64, 64, 7), ("wgmma", 64, 64, 1),
                      ("fma", 32, 64, 1)),
    "jax odd H": (("tma", 64, 64, 7), ("wgmma", 64, 64, 1),
                  ("fma", 32, 64, 1)),
    "non-square": (("tma", 64, 64, 7), ("wgmma", 64, 64, 7),
                   ("fma", 32, 64, 1)),
    "pads differ": (("tma", 64, 64, 7), ("wgmma", 64, 64, 7),
                    ("fma", 32, 64, 1)),
}


def _key(p):
    return (p.path, p.bm, p.bn, p.splits)


@pytest.mark.parametrize("case", K3_CHECK, ids=[c[0] for c in K3_CHECK])
def test_route_of_each_check_shape(case):
    name, b, h, w, cin, cout = case
    xs, ws = (b, h, w, cin), (K, K, cin, cout)
    taps_bf16, im2col_bf16, f32 = ROUTES[name]
    assert _key(route(xs, ws, S, BF16, "taps")) == taps_bf16
    assert _key(route(xs, ws, S, BF16, "im2col")) == im2col_bf16
    for v in VARIANTS:
        assert _key(route(xs, ws, S, torch.float32, v)) == f32


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", K3_CHECK + [("cin3", 2, 9, 9, 3, 16),
                                             ("cout70", 3, 9, 14, 8, 70)],
                         ids=[c[0] for c in K3_CHECK] + ["cin3", "cout70"])
def test_route_invariants(case, dtype):
    """K3b is K1's plan with SAME padding; K3a takes the TMA path exactly
    for bf16 with Cin and Cout multiples of 8, else K1's plan (``mma`` in
    bf16, ``fma`` in f32); at Cin % 64 == 0 K3a's TMA route is K1's plan
    (same tile, splits and steps), which the card's bit equality of K3a,
    K3b and K1 leans on; every step lies in exactly one split."""
    _, b, h, w, cin, cout = case
    xs, ws = (b, h, w, cin), (K, K, cin, cout)
    k1 = fused_conv.plan(xs, ws, S, "SAME", dtype)
    assert route(xs, ws, S, dtype, "im2col") == k1
    taps = route(xs, ws, S, dtype, "taps")
    tma = dtype == BF16 and cin % 8 == 0 and cout % 8 == 0
    assert (taps.path == "tma") == tma
    if not tma:
        assert taps == k1
        assert taps.path == ("fma" if dtype == torch.float32 else "mma")
        return
    steps = len(k3a_steps(K, cin))
    assert taps.r == steps * TMA_BK and taps.bk == TMA_BK
    assert (taps.splits - 1) * taps.steps_per_split < steps \
        <= taps.splits * taps.steps_per_split
    if cin % 64 == 0:
        same = ("bm", "bn", "bk", "stages", "splits", "steps_per_split", "m",
                "n", "r")
        assert all(getattr(taps, f) == getattr(k1, f) for f in same)


def test_geometry_of_the_non_square_shape():
    """(4, 16, 12, 64) -> 8 x 6 outputs: SAME pads (1, 2) on both axes, so
    the box runs from -1 to size - 1 + (2 - 4) at stride 2: 8 and 6
    windows; the packed order is the C entry's."""
    geo = tma_geometry((4, 16, 12, 64), (5, 5, 64, 128), 2, 64)
    assert geo.x_dims == (64, 12, 16, 4)
    assert geo.x_strides == (128, 12 * 128, 16 * 12 * 128)
    assert geo.lower == (-1, -1) and geo.upper == (-2, -2)
    assert geo.elem_strides == (1, 2, 2, 1) and geo.out_hw == (8, 6)
    for (lo, up), size, n_out in zip(zip(geo.lower, geo.upper), (12, 16),
                                     (6, 8)):
        assert len(range(lo, size - 1 + up + 1, 2)) == n_out
    packed = geo.packed()
    assert len(packed) == 25
    assert packed[7:11] == (-1, -1, -2, -2) and packed[12] == 64
    assert packed[17:20] == (128, 64, 25) and packed[22:25] == (64, 64, 1)
    # the last pixel of the first tile row, and a tap's offsets
    assert geo.a_load(5, 7, 64) == ((64, 9, -1, 0), (2, 1))
    assert geo.a_load(48, 0, 0) == ((0, -1, -1, 1), (0, 0))


def test_corners_are_per_axis_and_w_first():
    """H 16 pads (1, 2), W 13 pads (2, 2): the corners differ by axis and
    are listed W first, as the map's dims are (CUTLASS's ``*_corner_whd``
    order)."""
    geo = tma_geometry((4, 16, 13, 64), (5, 5, 64, 128), 2, 64)
    assert geo.lower == (-2, -1) and geo.upper == (-2, -2)
    assert geo.out_hw == (8, 7)


def test_geometry_refuses_what_a_4d_map_cannot_hold():
    lo, hi = IM2COL_CORNER
    with pytest.raises(ValueError, match="corners"):
        tma_geometry((1, 8, 8, 8), (2 * -lo + 3, 2 * -lo + 3, 8, 8), 1, 64)
    with pytest.raises(ValueError, match="strides"):
        tma_geometry((1, 32, 32, 8), (5, 5, 8, 8), 9, 64)
    with pytest.raises(ValueError, match="multiples of 8"):
        tma_geometry((1, 8, 8, 12), (5, 5, 12, 8), 2, 64)
    with pytest.raises(ValueError, match="variant"):
        route((1, 8, 8, 8), (5, 5, 8, 8), 2, BF16, "direct")
