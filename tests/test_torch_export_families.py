"""Artifact export (``graphical_gan_tpu_torch/serve/export.py``) of
families 2 and 3 on the CPU: each entry of ``ENTRIES["gmgan"]`` and
``ENTRIES["ssgan"]``, and each family's int8 sampler, exported with a
symbolic batch, loaded back and called at batch 3 and batch 8, equal to
the run directory's call bit for bit (SSGAN's chain eps drawn by the loader
outside the program). Family 1, the bare process and the server:
``tests/test_torch_export.py``.
"""

import pytest

from graphical_gan_tpu_torch.serve.export import ENTRIES

import _torch_export as ex
from _torch_threads import one_thread  # noqa: F401

CASES = ([(r, e, None) for r in ("gmgan", "ssgan") for e in ENTRIES[r]]
         + [(r, "sampler", "int8") for r in ("gmgan", "ssgan")])


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    return ex.export_cases(tmp_path_factory.mktemp("export"), CASES)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_exported_entry_equals_the_run_dir_call(exported, case):
    ex.check_case(*exported[case], case)
