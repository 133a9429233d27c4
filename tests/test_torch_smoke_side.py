"""``chip_smoke.py``'s side phases on the CPU: a side process's launches
come back to the parent and its output is logged there; a failed check, a
leaked import, an exception and a hang each fail the join, which names the
phase; every process is ended, those a side process started too."""

import inspect
import json
import os
import sys
import time

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(TESTS))
import chip_smoke  # noqa: E402


def _side(tmp_path, **targets):
    env = dict(os.environ, SIDE_TEST_PID=str(tmp_path / "pid"),
               PYTHONPATH=os.pathsep.join(
                   [TESTS] + [p for p in [os.environ.get("PYTHONPATH")]
                              if p]))
    return chip_smoke.SidePhases(
        {name: f"_torch_smoke_side:{fn}" for name, fn in targets.items()},
        str(tmp_path / "side"), env=env)


def _alive(pid):
    """Whether ``pid`` runs (a zombie does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def test_launches_and_output_come_back(tmp_path, capsys):
    side = _side(tmp_path, first="counts", second="counts")
    side.start()
    got = side.join()
    assert got == {"first": {"fused_conv2d_bias_act": 3},
                   "second": {"fused_conv2d_bias_act": 3}}
    lines = capsys.readouterr().out.splitlines()
    assert lines.count("a line that is not JSON") == 2
    assert lines.count(json.dumps({"phase": "stub",
                                   "note": "from the side"})) == 2
    timed = [json.loads(ln)["phase_seconds"] for ln in lines
             if ln.startswith('{"phase_seconds"')]
    assert timed == ["first", "second"]
    assert all(p.poll() == 0 for p, _, _ in side.procs.values())


@pytest.mark.parametrize("fn, said", [
    ("refuses", "the stub's check missed"),
    ("imports_sklearn", "imported ['sklearn']"),
    ("raises", "RuntimeError: not a check"),
])
def test_a_failed_side_phase_fails_the_join(tmp_path, fn, said):
    side = _side(tmp_path, good="counts", bad=fn)
    side.start()
    with pytest.raises(chip_smoke.SmokeFailure) as e:
        side.join()
    assert "bad (exit code 1)" in str(e.value)
    assert said in str(e.value)
    assert "good" not in str(e.value)


def test_a_hung_side_phase_is_ended(tmp_path):
    side = _side(tmp_path, slow="hangs")
    side.start()
    with pytest.raises(chip_smoke.SmokeFailure, match="slow .exit code None"):
        side.join(timeout=3)
    assert all(p.poll() is not None for p, _, _ in side.procs.values())


def test_stop_ends_the_processes_a_side_phase_started(tmp_path):
    side = _side(tmp_path, a="spawns", b="hangs")
    side.start()
    pid_file = tmp_path / "pid"
    for _ in range(600):
        if pid_file.exists():
            break
        time.sleep(0.1)
    pid = int(pid_file.read_text())
    assert _alive(pid)
    side.stop()
    assert all(p.poll() is not None for p, _, _ in side.procs.values())
    for _ in range(50):
        if not _alive(pid):
            break
        time.sleep(0.1)
    assert not _alive(pid)


@pytest.mark.parametrize("name", sorted(chip_smoke.SIDE_PHASES))
def test_each_side_phase_is_a_phase(name):
    target, key = chip_smoke.SIDE_PHASES[name]
    fn = getattr(chip_smoke, target)
    assert list(inspect.signature(fn).parameters) == ["launch_totals"]
    if key is not None:
        assert name.replace("-", "_") == key
        assert target == "phase_" + key


def test_the_failure_drills_read_the_train_rows():
    """The side phase's save rows are the train phase's first 1024."""
    from graphical_gan_tpu_torch.data.synthetic import images_int
    import numpy as np
    assert np.array_equal(images_int(1024, 3072, seed=0),
                          images_int(4096, 3072, seed=0)[:1024])
