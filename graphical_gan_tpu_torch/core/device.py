"""Device resolution and numerics for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU; a missing
card is an error, never a silent fall back to the CPU.
"""

from __future__ import annotations

from typing import Dict, Union

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


#: the numerics below as ``torch.backends.<name>: value`` (an exported
#: program's manifest carries them: ``serve/export.py``)
NUMERICS = {"cudnn.allow_tf32": False, "cuda.matmul.allow_tf32": False,
            "cuda.matmul.allow_bf16_reduced_precision_reduction": False,
            "cudnn.deterministic": True}


def apply_numerics(numerics: Dict[str, bool]) -> None:
    """Set ``torch.backends.<name> = value`` for each entry."""
    for name, value in numerics.items():
        obj = torch.backends
        *path, attr = name.split(".")
        for part in path:
            obj = getattr(obj, part)
        setattr(obj, attr, value)


def set_numerics() -> None:
    """The numerics the server and the trainer both run with: full f32
    products and convolutions (cuDNN runs f32 convolutions, and their
    gradients, in TF32 by default, which keeps about three decimal digits),
    bf16 products summed in f32 as the TPU's matrix unit sums them (cuBLAS
    may otherwise add split-K partial sums in bf16), and deterministic
    cuDNN algorithms, so that the same inputs give the same bits:
    exact-mode requests as in the JAX server, and training steps from one
    seed, as ``tools/determinism.py`` audits for the JAX step."""
    apply_numerics(NUMERICS)
