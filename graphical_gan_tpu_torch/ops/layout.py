"""Image layout at the network boundary (``graphical_gan_tpu/ops/layout.py``).

Flat image vectors are NCHW-ordered ([B, C*H*W], the reference's layout);
inside the networks images are NHWC, so a JAX checkpoint's HWIO filters load
as they are.
"""

from __future__ import annotations

import torch


def unflatten_image(x_flat: torch.Tensor, channels: int, height: int,
                    width: int) -> torch.Tensor:
    """[B, C*H*W] (NCHW order) -> contiguous [B, H, W, C]."""
    b = x_flat.shape[0]
    x = x_flat.reshape(b, channels, height, width)
    return x.permute(0, 2, 3, 1).contiguous()


def flatten_image(x_nhwc: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, C*H*W] flat in NCHW order."""
    b, h, w, c = x_nhwc.shape
    return x_nhwc.permute(0, 3, 1, 2).reshape(b, c * h * w)


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()
