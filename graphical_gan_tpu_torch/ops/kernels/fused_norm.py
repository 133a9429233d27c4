"""K2: batch-statistics batch norm + activation over channels-last data.

Four kernels in ``csrc/fused_norm.cu``, each behind its own wrapper:

- K2a :func:`bn_stats` replaces ``graphical_gan_tpu/ops/pallas/
  fused_norm.py:_stats``: per-channel mean, biased variance and
  ``inv = 1/sqrt(var + eps)`` of ``[R, C]``, in two deterministic stages
  (per-block Welford partials, then a fixed-order merge by Chan's formula);
- K2b :func:`bn_apply` replaces ``fused_norm.py:_fwd``'s apply pass:
  ``act((x - mean) * (inv * scale) + offset)`` in x's dtype;
- K2c :func:`bn_bwd_reduce` replaces ``fused_norm.py:_bwd``'s reduce pass:
  per channel ``[Σgz, Σgz·xhat]`` in f32, ``gz = g·act'(y)``, with xhat and
  y recomputed from x; two deterministic stages like K2a;
- K2d :func:`bn_bwd_apply` replaces ``_bwd``'s apply pass:
  ``dx = (gz - Σgz/R - xhat·Σ(gz·xhat)/R)·inv·scale`` in x's dtype.

All four are bound by bytes (see the source). :class:`FusedBatchNormAct` is
the JAX ``fused_batchnorm_act`` with its custom VJP: K2a then K2b forward,
K2c then K2d backward. On a CUDA tensor each wrapper launches its kernel or
raises; on a CPU tensor it computes its plain PyTorch version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from graphical_gan_tpu_torch.ops.activations import (
    activation, activation_grad)
from graphical_gan_tpu_torch.ops.kernels import build

EPS = 1e-5
_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
_STATS_CT = 32      # channels per stats block (csrc ST_CT)
_STATS_RY = 8       # row lanes per stats block (csrc ST_RY)
_STATS_BLOCKS = 528  # stage-1 blocks to aim for: 4 per SM of the H100


def bn_stats_plain(x2d: torch.Tensor, eps: float = EPS
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean, biased var, 1/sqrt(var + eps)) per column of [R, C], in f32,
    as ``jnp.mean`` / ``jnp.var`` compute them (two passes)."""
    x32 = x2d.float()
    mean = x32.mean(dim=0)
    var = (x32 - mean).square().mean(dim=0)
    return mean, var, torch.rsqrt(var + eps)


def bn_apply_plain(x2d: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
                   scale: torch.Tensor, offset: torch.Tensor,
                   act: Optional[str] = None) -> torch.Tensor:
    """act((x - mean) * (inv * scale) + offset) in f32, cast to x's dtype."""
    y = (x2d.float() - mean) * (inv * scale.float()) + offset.float()
    return activation(act)(y).to(x2d.dtype)


def _check_2d(x2d: torch.Tensor, name: str) -> None:
    if x2d.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for {x2d.device}")
    if x2d.ndim != 2 or not x2d.is_contiguous():
        raise ValueError(f"{name} needs a contiguous [R, C] tensor, got "
                         f"shape {tuple(x2d.shape)}")
    if x2d.dtype not in _DTYPES:
        raise TypeError(f"{name} takes f32 or bf16, got {x2d.dtype}")
    if x2d.shape[0] == 0 or x2d.shape[1] == 0:
        raise ValueError(f"{name} needs at least one row and one channel")
    if x2d.numel() >= 2 ** 31:
        raise ValueError(f"{name} indexes rows with 32-bit ints")


def stats_split(r: int, c: int) -> Tuple[int, int]:
    """(rows_per_block, n_row_blocks) for stage 1: about ``_STATS_BLOCKS``
    blocks in all, rows a multiple of the row lanes. Depends on the shape
    alone, so the reduction order (and the result's bits) is fixed."""
    ctiles = -(-c // _STATS_CT)
    want = max(1, min(-(-_STATS_BLOCKS // ctiles), -(-r // _STATS_RY)))
    rows = -(-r // want)
    rows = -(-rows // _STATS_RY) * _STATS_RY
    return rows, -(-r // rows)


def bn_stats(x2d: torch.Tensor, eps: float = EPS
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2a: (mean, var, inv) per column of [R, C], f32 [C] each."""
    if x2d.device.type == "cpu":
        return bn_stats_plain(x2d, eps)
    _check_2d(x2d, "bn_stats")
    r, c = x2d.shape
    rows, nrb = stats_split(r, c)
    f32 = dict(dtype=torch.float32, device=x2d.device)
    part = torch.empty((2, nrb, c), **f32)
    out = torch.empty((3, c), **f32)
    code = build.lib().ggan_bn_stats(
        x2d.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        build.DTYPE_CODES[_DTYPES[x2d.dtype]], r, c, rows, nrb, float(eps),
        build.stream_ptr(x2d.device))
    build.check(code, "ggan_bn_stats")
    bn_stats.launches += 1
    return out[0], out[1], out[2]


def bn_apply(x2d: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
             scale: torch.Tensor, offset: torch.Tensor,
             act: Optional[str] = None) -> torch.Tensor:
    """K2b: act((x - mean) * (inv * scale) + offset), output in x's dtype."""
    if x2d.device.type == "cpu":
        return bn_apply_plain(x2d, mean, inv, scale, offset, act)
    _check_2d(x2d, "bn_apply")
    if act not in build.ACT_CODES:
        raise ValueError(f"unknown activation {act!r}")
    r, c = x2d.shape
    chan = [t.to(device=x2d.device, dtype=torch.float32).contiguous()
            for t in (mean, inv, scale, offset)]
    if any(t.shape != (c,) for t in chan):
        raise ValueError(f"bn_apply: per-channel vectors must be [{c}]")
    y = torch.empty_like(x2d)
    aligned = x2d.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    vec = 4 if c % 4 == 0 and aligned else 1
    code = build.lib().ggan_bn_apply(
        x2d.data_ptr(), *[t.data_ptr() for t in chan], y.data_ptr(),
        build.DTYPE_CODES[_DTYPES[x2d.dtype]], x2d.numel(), c,
        build.ACT_CODES[act], vec, build.stream_ptr(x2d.device))
    build.check(code, "ggan_bn_apply")
    bn_apply.launches += 1
    return y


def _gz_xhat(g2d: torch.Tensor, x2d: torch.Tensor, mean: torch.Tensor,
             inv: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor,
             act: Optional[str]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gz, xhat) in f32: xhat = (x - mean) * inv, and gz = g * act'(y) with
    y recomputed as K2b computes it, so the mask matches the forward."""
    d = x2d.float() - mean
    y = d * (inv * scale.float()) + offset.float()
    return g2d.float() * activation_grad(act, y), d * inv


def bn_bwd_reduce_plain(g2d: torch.Tensor, x2d: torch.Tensor,
                        mean: torch.Tensor, inv: torch.Tensor,
                        scale: torch.Tensor, offset: torch.Tensor,
                        act: Optional[str] = None) -> torch.Tensor:
    """[Σgz, Σgz·xhat] per column, f32 [2, C]."""
    gz, xhat = _gz_xhat(g2d, x2d, mean, inv, scale, offset, act)
    return torch.stack([gz.sum(dim=0), (gz * xhat).sum(dim=0)])


def bn_bwd_apply_plain(g2d: torch.Tensor, x2d: torch.Tensor,
                       mean: torch.Tensor, inv: torch.Tensor,
                       scale: torch.Tensor, offset: torch.Tensor,
                       red: torch.Tensor, act: Optional[str] = None
                       ) -> torch.Tensor:
    """dx = (gz - Σgz/R - xhat·Σ(gz·xhat)/R)·inv·scale, in x's dtype."""
    gz, xhat = _gz_xhat(g2d, x2d, mean, inv, scale, offset, act)
    r = x2d.shape[0]
    dx = (gz - red[0] / r - xhat * (red[1] / r)) * inv * scale.float()
    return dx.to(x2d.dtype)


def _chan_f32(x2d: torch.Tensor, *vecs: torch.Tensor):
    c = x2d.shape[1]
    out = [t.to(device=x2d.device, dtype=torch.float32).contiguous()
           for t in vecs]
    if any(t.shape != (c,) for t in out):
        raise ValueError(f"per-channel vectors must be [{c}]")
    return out


def _same_layout(g2d: torch.Tensor, x2d: torch.Tensor, name: str):
    if g2d.shape != x2d.shape:
        raise ValueError(f"{name}: g {tuple(g2d.shape)} and x "
                         f"{tuple(x2d.shape)} differ")
    return g2d.to(x2d.dtype).contiguous()


def bn_bwd_reduce(g2d: torch.Tensor, x2d: torch.Tensor, mean: torch.Tensor,
                  inv: torch.Tensor, scale: torch.Tensor,
                  offset: torch.Tensor, act: Optional[str] = None
                  ) -> torch.Tensor:
    """K2c: [Σgz, Σgz·xhat] per column of [R, C], f32 [2, C]."""
    if x2d.device.type == "cpu":
        return bn_bwd_reduce_plain(g2d, x2d, mean, inv, scale, offset, act)
    _check_2d(x2d, "bn_bwd_reduce")
    if act not in build.ACT_CODES:
        raise ValueError(f"unknown activation {act!r}")
    g2d = _same_layout(g2d, x2d, "bn_bwd_reduce")
    chan = _chan_f32(x2d, mean, inv, scale, offset)
    r, c = x2d.shape
    rows, nrb = stats_split(r, c)
    f32 = dict(dtype=torch.float32, device=x2d.device)
    part = torch.empty((2, nrb, c), **f32)
    red = torch.empty((2, c), **f32)
    code = build.lib().ggan_bn_bwd_reduce(
        g2d.data_ptr(), x2d.data_ptr(), *[t.data_ptr() for t in chan],
        part[0].data_ptr(), part[1].data_ptr(), red[0].data_ptr(),
        red[1].data_ptr(), build.DTYPE_CODES[_DTYPES[x2d.dtype]], r, c, rows,
        nrb, build.ACT_CODES[act], build.stream_ptr(x2d.device))
    build.check(code, "ggan_bn_bwd_reduce")
    bn_bwd_reduce.launches += 1
    return red


def bn_bwd_apply(g2d: torch.Tensor, x2d: torch.Tensor, mean: torch.Tensor,
                 inv: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor,
                 red: torch.Tensor, act: Optional[str] = None
                 ) -> torch.Tensor:
    """K2d: dx of [R, C] from K2c's sums ``red``, output in x's dtype."""
    if x2d.device.type == "cpu":
        return bn_bwd_apply_plain(g2d, x2d, mean, inv, scale, offset, red,
                                  act)
    _check_2d(x2d, "bn_bwd_apply")
    if act not in build.ACT_CODES:
        raise ValueError(f"unknown activation {act!r}")
    g2d = _same_layout(g2d, x2d, "bn_bwd_apply")
    r, c = x2d.shape
    red = red.to(device=x2d.device, dtype=torch.float32).contiguous()
    if red.shape != (2, c):
        raise ValueError(f"bn_bwd_apply: red must be [2, {c}]")
    chan = _chan_f32(x2d, mean, inv, scale, offset)
    dx = torch.empty_like(x2d)
    aligned = all(t.data_ptr() % 16 == 0 for t in (g2d, x2d, dx))
    vec = 4 if c % 4 == 0 and aligned else 1
    code = build.lib().ggan_bn_bwd_apply(
        g2d.data_ptr(), x2d.data_ptr(), *[t.data_ptr() for t in chan],
        red[0].data_ptr(), red[1].data_ptr(), dx.data_ptr(),
        build.DTYPE_CODES[_DTYPES[x2d.dtype]], x2d.numel(), c, r,
        build.ACT_CODES[act], vec, build.stream_ptr(x2d.device))
    build.check(code, "ggan_bn_bwd_apply")
    bn_bwd_apply.launches += 1
    return dx


bn_stats.launches = 0
bn_apply.launches = 0
bn_bwd_reduce.launches = 0
bn_bwd_apply.launches = 0


def bn_act_backward_plain(g: torch.Tensor, x: torch.Tensor,
                          scale: torch.Tensor, offset: torch.Tensor,
                          act: Optional[str] = None, eps: float = EPS):
    """(dx, dscale, doffset) of ``act(batchnorm(x))`` at cotangent g, from
    the statistics up, in plain differentiable PyTorch: what autograd
    differentiates for the second-order term, as JAX differentiates its
    ``jnp`` BN twice (``ops/norm.py:84-89``). act' is piecewise constant,
    so its mask carries no gradient."""
    c = x.shape[-1]
    x2d, g2d = x.reshape(-1, c).float(), g.reshape(-1, c).float()
    mean = x2d.mean(dim=0)
    d = x2d - mean
    inv = torch.rsqrt(d.square().mean(dim=0) + eps)
    xhat = d * inv
    y = xhat * scale.float() + offset.float()
    gz = g2d * activation_grad(act, y.detach())
    dgx = (gz * xhat).mean(dim=0)
    dx = (gz - gz.mean(dim=0) - xhat * dgx) * inv * scale.float()
    return (dx.to(x.dtype).reshape(x.shape),
            (gz * xhat).sum(dim=0).to(scale.dtype),
            gz.sum(dim=0).to(offset.dtype))


class _BatchNormActBackward(torch.autograd.Function):
    """The first-order backward of :class:`FusedBatchNormAct` as a function
    of (g, x, scale, offset): K2c then K2d forward. Its own backward, the
    second-order term, differentiates :func:`bn_act_backward_plain` (plain
    PyTorch on both devices; the JAX package has no Pallas kernel for it
    either). A third order raises."""

    @staticmethod
    def forward(ctx, g, x, scale, offset, mean, inv, act, eps):
        c = x.shape[-1]
        x2d, g2d = x.reshape(-1, c), g.reshape(-1, c)
        red = bn_bwd_reduce(g2d, x2d, mean, inv, scale, offset, act)
        dx = bn_bwd_apply(g2d, x2d, mean, inv, scale, offset, red, act)
        ctx.save_for_backward(g, x, scale, offset)
        ctx.conf = (act, eps)
        return (dx.reshape(x.shape), red[1].to(scale.dtype),
                red[0].to(offset.dtype))

    @staticmethod
    @once_differentiable
    def backward(ctx, gdx, gdscale, gdoffset):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need) for t, need in
                      zip(ctx.saved_tensors, ctx.needs_input_grad[:4])]
            outs = bn_act_backward_plain(*leaves, *ctx.conf)
            pairs = [(o, go) for o, go in zip(outs, (gdx, gdscale, gdoffset))
                     if go is not None and o.requires_grad]
            wrt = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(
                [o for o, _ in pairs], wrt, [go for _, go in pairs],
                allow_unused=True) if wrt else ())
        out = [next(grads) if t.requires_grad else None for t in leaves]
        return (*out, None, None, None, None)


class FusedBatchNormAct(torch.autograd.Function):
    """act(batchnorm(x)) over channels-last x with batch statistics, with the
    JAX package's custom VJP (``fused_norm.py:174-236``).

    Forward: K2a then K2b; saves ``(x, scale, offset, mean, inv)`` as
    ``_fwd`` does. Backward: K2c then K2d (:class:`_BatchNormActBackward`);
    ``dx`` in x's dtype, ``dscale = Σgz·xhat`` and ``doffset = Σgz`` in f32,
    cast to the parameters' dtypes. The backward can be differentiated once
    more, as the mnist discriminator's gradient penalty needs: the
    second-order term is plain PyTorch."""

    @staticmethod
    def forward(ctx, x, scale, offset, act, eps):
        c = x.shape[-1]
        x2d = x.reshape(-1, c)
        mean, _, inv = bn_stats(x2d, eps)
        y = bn_apply(x2d, mean, inv, scale, offset, act)
        ctx.save_for_backward(x, scale, offset, mean, inv)
        ctx.conf = (act, eps)
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        x, scale, offset, mean, inv = ctx.saved_tensors
        dx, dscale, doffset = _BatchNormActBackward.apply(
            g, x, scale, offset, mean, inv, *ctx.conf)
        return dx, dscale, doffset, None, None


def fused_batchnorm_act(x: torch.Tensor, scale: torch.Tensor,
                        offset: torch.Tensor, act: Optional[str] = None,
                        eps: float = EPS) -> torch.Tensor:
    """act(batchnorm(x)) over channels-last x with batch statistics.

    x: [..., C] contiguous; scale/offset: [C]. Output in x's dtype."""
    return FusedBatchNormAct.apply(x, scale, offset, act, eps)
