"""The operation count behind chip_smoke.py's bound for the fused conv:
only the taps that land inside the input are work the function needs.
Checked against a count made by convolving ones over the zero-padded
input, at the serving sizes and at odd sizes, strides and kernels."""

import os
import sys

import pytest
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from graphical_gan_tpu_torch.ops.kernels.fused_conv import same_pads  # noqa: E402


@pytest.mark.parametrize("n,k,s", [(32, 5, 2), (16, 5, 2), (8, 5, 2),
                                   (7, 5, 2), (9, 3, 1), (8, 1, 1)])
def test_conv_valid_taps_counts_taps_inside_the_input(n, k, s):
    lo, hi = same_pads(n, k, s)
    x = F.pad(torch.ones(1, 1, n), (lo, hi))
    taps = F.conv1d(x, torch.ones(1, 1, k), stride=s)
    assert taps.shape[-1] == -(-n // s)
    assert chip_smoke.conv_valid_taps(n, k, s, lo) == int(taps.sum())


def test_serving_shapes_need_fewer_taps_than_the_full_window():
    # E.1, E.2, E.3: 32 -> 16, 16 -> 8, 8 -> 4 at k5 s2, pads (1, 2)
    share = {n: (chip_smoke.conv_valid_taps(n, 5, 2, 1) / (5 * n // 2)) ** 2
             for n in (32, 16, 8)}
    assert share == pytest.approx({32: 0.92640625, 16: 0.855625,
                                   8: 0.7225})
