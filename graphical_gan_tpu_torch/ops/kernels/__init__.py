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
    bn_apply, bn_apply_q8, bn_apply_split, bn_apply_split_q8, bn_bwd,
    bn_bwd_apply_split, bn_bwd_local, bn_stats, bn_stats_local,
    fused_batchnorm_act)
from graphical_gan_tpu_torch.ops.kernels.quant import (  # noqa: F401
    int8_conv, quantize_int8)

#: every kernel wrapper, by the name chip_smoke.py reports
WRAPPERS = {
    "fused_conv2d_bias_act": fused_conv2d_bias_act,
    "bn_stats": bn_stats,
    "bn_apply": bn_apply,
    "bn_bwd": bn_bwd,
    "conv_gemm_taps": conv_gemm_taps,
    "conv_gemm_im2col": conv_gemm_im2col,
    "quantize_int8": quantize_int8,
    "int8_conv": int8_conv,
    "bn_apply_q8": bn_apply_q8,
}
#: K2a's (with K2b) and K2c+K2d's split modes (batch statistics over several
#: ranks, ``parallel/``), whose launches only a parallel run makes
SPLIT_WRAPPERS = {
    "bn_stats_local": bn_stats_local,
    "bn_apply_split": bn_apply_split,
    "bn_apply_split_q8": bn_apply_split_q8,
    "bn_bwd_local": bn_bwd_local,
    "bn_bwd_apply_split": bn_bwd_apply_split,
}


def reset_launches() -> None:
    for fn in list(WRAPPERS.values()) + list(SPLIT_WRAPPERS.values()):
        fn.launches = 0
    for route in int8_conv.routes:  # Q2's launches per q2_plan route
        int8_conv.routes[route] = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def split_launches() -> dict:
    """The split modes' launches (:data:`SPLIT_WRAPPERS`)."""
    return {name: fn.launches for name, fn in SPLIT_WRAPPERS.items()}
