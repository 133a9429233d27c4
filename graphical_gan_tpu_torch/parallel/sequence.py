"""Sequence parallelism for the video family, SSGAN (``graphical_gan_tpu/
parallel/sequence.py``): a ``(data, seq)`` mesh.

The folded ``B·LEN`` frame networks take most of SSGAN's step, so they are
what SP splits: each video's LEN frames over ``seq``, its batch rows over
``data``. The frame networks (``models/ssgan.py``: the frame generator,
extractor and discriminator, and concat_z's per-frame convs) run on the
rank's block of each video's frames, taken at JAX's fold points
(``core/shard_ctx.py: constrain_frames``), and their outputs are gathered
over ``seq`` again (``gather_frames``): the latent chains, ordered over
LEN and small, run on the gathered codes, as GSPMD gathers the frame codes
over ``seq`` in JAX. Their BNs count the rows of every rank of
``data`` x ``seq``. The raw videos are split over ``data`` only: a rank
holds its rows' whole videos (the global extractor and the video Ds read
every frame).
"""

from __future__ import annotations


def video_batch_spec(ndim: int, data_axis: str = "data",
                     seq_axis: str = "seq"):
    """JAX's PartitionSpec of a stacked raw-video leaf, as a tuple: videos
    ``[(1+k), B, LEN, D]`` shard B over ``data`` and LEN over ``seq``;
    labels ``[(1+k), B, N_C]`` shard B. (The port's frame split happens at
    the fold points; the raw batch is split over ``data``.)"""
    if ndim == 4:
        return (None, data_axis, seq_axis, None)
    spec = [None] * ndim
    if ndim >= 2:
        spec[1] = data_axis
    return tuple(spec)


def make_sp_train_step(model, mesh, data_axis: str = "data",
                       seq_axis: str = "seq", lr_scale=None):
    """SP over a ``(data, seq)`` mesh; needs B % data == 0 and LEN % seq
    == 0. Returns ``(step, init_state, place, gather_state)`` as
    ``parallel/mesh.py: make_sharded_step``."""
    from graphical_gan_tpu_torch.parallel.mesh import make_sharded_step
    seq = mesh.shape.get(seq_axis, 1)
    if model.cfg.seq_len % seq:
        raise ValueError(f"LEN {model.cfg.seq_len} does not split over "
                         f"{seq} seq ranks")
    return make_sharded_step(model, mesh, stats_axes=(data_axis, seq_axis),
                             seq_axis=seq_axis, lr_scale=lr_scale)
