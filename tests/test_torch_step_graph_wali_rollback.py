"""The trainer's step graph (``graphical_gan_tpu_torch/train/graph.py``) on
the CPU for mnist wali-gp at dim 8, B 8, with ``lr_scale`` (the face
script's linear decay): a rollback under ``GGAN_FAULT_NAN_AT`` inside the
window 8-11 at chunk size 3, the graph runner's parts against the eager
dispatch of the same tree, bit for bit; the restored state gets a new
graph, warmed at 8 (``_torch_step_graph``)."""

import _torch_step_graph as sg
from _torch_threads import one_thread  # noqa: F401

MODE = "wali-gp"


def test_graph_parts_equal_the_eager_dispatch_across_a_rollback(tmp_path):
    ref = sg.reference(tmp_path / "eager", MODE, "rollback", sg.decay)
    sg.check_scenario(tmp_path / "graph", MODE, "rollback", ref, sg.decay)
