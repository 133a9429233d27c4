"""Parallel training over ``torch.distributed`` (``graphical_gan_tpu/
parallel``): DP, TP, SP, EP, their composition and pipeline parallelism
(``make_pp_train_step``, one stage per rank), one process per rank.

The names are JAX's, loaded at first use: the ops layer imports
``parallel.collectives`` and ``parallel.context`` alone, and a process
that runs ops only (an exported program) loads nothing of the step
factories or the trainer.
"""

import importlib

_EXPORTS = {
    "make_mesh": "mesh", "shard_batch": "mesh", "replicate": "mesh",
    "make_parallel_train_step": "mesh",
    "make_tp_train_step": "sharding_rules",
    "tp_param_shardings": "sharding_rules",
    "make_sp_train_step": "sequence", "video_batch_spec": "sequence",
    "make_composed_train_step": "composed",
    "make_ep_train_step": "expert", "ep_param_shardings": "expert",
    "make_pp_train_step": "pipeline",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
