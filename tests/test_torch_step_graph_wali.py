"""The trainer's step graph (``graphical_gan_tpu_torch/train/graph.py``) on
the CPU for mnist wali-gp (k 5, the gradient penalty's double backward, D
clipped after each update) at dim 8, B 8, with ``lr_scale`` (the face
script's linear decay): the graph runner's host prologue, body and host
epilogue per iteration equal the eager dispatch of the same tree bit for
bit over 12 iterations at chunk size 3 and across a resume at a window
boundary, which warms a new graph (``_torch_step_graph``; the rollback:
``test_torch_step_graph_wali_rollback.py``)."""

import pytest

import _torch_step_graph as sg
from _torch_threads import one_thread  # noqa: F401

MODE = "wali-gp"


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return sg.reference(tmp_path_factory.mktemp("eager"), MODE, "plain",
                        sg.decay)


@pytest.mark.parametrize("scenario", ["chunk 3", "resume"])
def test_graph_parts_equal_the_eager_dispatch(tmp_path, ref, scenario):
    sg.check_scenario(tmp_path, MODE, scenario, ref, sg.decay)
