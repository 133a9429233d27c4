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


def launch_counts() -> dict:
    """Every launch counter: each wrapper's by its name, Q2's per route as
    ``int8_conv/<route>``."""
    out = {**launches(), **split_launches()}
    out.update({f"int8_conv/{r}": n for r, n in int8_conv.routes.items()})
    return out


#: the kernel functions that each training-path wrapper launches once per
#: call (K1's split-K reduction, a second kernel of some calls, is left
#: out), for reading launches off a device trace: a CUDA graph's replay
#: runs its kernels with no wrapper call, so the counters above see only
#: the launches made from Python (eager ones and those a capture records).
#: K3b's im2col route runs K1's kernels and ``bn_apply_q8`` K2b's, so a
#: trace read this way holds neither (the training path calls neither).
DEVICE_SYMBOLS = {
    "fused_conv2d_bias_act": ("conv_k1_mma_kernel", "conv_k1_fma_kernel",
                              "conv_k1_wgmma_kernel"),
    "bn_stats": ("bn_stats_fused_kernel",),
    "bn_apply": ("bn_apply_kernel",),
    "bn_bwd": ("bn_bwd_fused_kernel",),
}


def device_launches(kernel_counts: dict) -> dict:
    """Each :data:`DEVICE_SYMBOLS` wrapper's kernel executions, from
    ``kernel_counts``: device kernel names (a profiler's, demangled, with
    their template arguments) and how often each ran."""
    out = dict.fromkeys(DEVICE_SYMBOLS, 0)
    for name, n in kernel_counts.items():
        for wrapper, symbols in DEVICE_SYMBOLS.items():
            if any(f"{sym}<" in name or f"{sym}(" in name
                   for sym in symbols):
                out[wrapper] += n
    return out
