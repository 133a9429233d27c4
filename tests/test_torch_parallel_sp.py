"""Sequence parallelism of the port (``graphical_gan_tpu_torch/parallel/
sequence.py``) on 2 gloo ranks on the CPU: SSGAN moving-MNIST local_ep
(LEN 4, BN on, so the frame networks' BNs count the rows of both ranks)
on a ``(data 1, seq 2)`` mesh against JAX's own SP mesh step on the same
mesh of virtual CPU devices, and it and ali with concat_z's per-frame D
(LEN 2)
against the port's one-process step (tolerances: ``tests/_torch_parallel.
py``). Each rank runs the frame networks on 2 of each video's 4 frames;
the parameters and Adam moments stay replicated, bit for bit alike.
"""

import pytest

from _torch_parallel import check_against, check_replicas, prepare, run_cases
from _torch_threads import one_thread  # noqa: F401

CASES = {"local_ep": ("local_ep", {"bn": True}, True),
         "ali-concat_z": ("ali", {"ali_mode": "concat_z", "seq_len": 2},
                          False)}


@pytest.fixture(scope="module")
def runs():
    cases = [prepare("ssgan", "moving_mnist", mode, "sp", (1, 2),
                     ("data", "seq"), with_jax=with_jax, **kw)
             for mode, kw, with_jax in CASES.values()]
    return dict(zip(CASES, run_cases(cases, 2)))


def test_sp_matches_jax_mesh_step(runs):
    case, ranks = runs["local_ep"]
    check_against(case, ranks[0]["costs"], ranks[0]["full"], "jax")


@pytest.mark.parametrize("name", list(CASES))
def test_sp_matches_one_process_step(runs, name):
    case, ranks = runs[name]
    check_against(case, ranks[0]["costs"], ranks[0]["full"], "port")


@pytest.mark.parametrize("name", list(CASES))
def test_sp_replicas_bit_identical(runs, name):
    _, ranks = runs[name]
    assert ranks[0]["sharded"] == []
    check_replicas(ranks)


@pytest.mark.parametrize("ndim", [2, 3, 4])
def test_video_batch_spec_is_jax_s(ndim):
    from graphical_gan_tpu.parallel.sequence import (
        video_batch_spec as jax_spec)
    from graphical_gan_tpu_torch.parallel.sequence import video_batch_spec
    assert video_batch_spec(ndim) == tuple(jax_spec(ndim))
