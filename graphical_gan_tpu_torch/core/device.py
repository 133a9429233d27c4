"""Device resolution and numerics for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU; a missing
card is an error, never a silent fall back to the CPU.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for but CUDA is not available; "
            "pass device='cpu' (--device cpu) to run the plain PyTorch "
            "versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on cuda or cpu, not {dev.type!r}")
    return dev


def set_numerics() -> None:
    """The numerics the server and the trainer both run with: full f32
    products and convolutions (cuDNN runs f32 convolutions, and their
    gradients, in TF32 by default, which keeps about three decimal digits),
    bf16 products summed in f32 as the TPU's matrix unit sums them (cuBLAS
    may otherwise add split-K partial sums in bf16), and deterministic
    cuDNN algorithms, so that the same inputs give the same bits:
    exact-mode requests as in the JAX server, and training steps from one
    seed, as ``tools/determinism.py`` audits for the JAX step."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.deterministic = True
