"""Hand-written CUDA kernels of the port (``csrc/``) and their wrappers.

Each wrapper launches its kernel on a CUDA tensor (or raises), computes its
plain PyTorch version on a CPU tensor, and counts its launches in a plain
integer attribute, ``launches``.
"""

# (the module conv_gemm keeps its name here: its function of that name is
# imported from the module)
from graphical_gan_tpu_torch.ops.kernels.conv_gemm import (  # noqa: F401
    conv_gemm_im2col, conv_gemm_taps)
from graphical_gan_tpu_torch.ops.kernels.fused_conv import (  # noqa: F401
    conv2d_bias_act, fused_conv2d_bias_act)
from graphical_gan_tpu_torch.ops.kernels.fused_norm import (  # noqa: F401
    bn_apply, bn_bwd, bn_stats, fused_batchnorm_act)

#: every kernel wrapper, by the name chip_smoke.py reports
WRAPPERS = {
    "fused_conv2d_bias_act": fused_conv2d_bias_act,
    "bn_stats": bn_stats,
    "bn_apply": bn_apply,
    "bn_bwd": bn_bwd,
    "conv_gemm_taps": conv_gemm_taps,
    "conv_gemm_im2col": conv_gemm_im2col,
}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
