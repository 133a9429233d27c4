"""Phase functions for ``tests/test_torch_smoke_side.py``: each runs as
``chip_smoke.side_main``'s target in a process of its own."""

import os
import subprocess
import sys
import time
import types

import chip_smoke


def counts(launches):
    chip_smoke.log({"phase": "stub", "note": "from the side"})
    print("a line that is not JSON", flush=True)
    launches["fused_conv2d_bias_act"] = 3


def refuses(launches):
    chip_smoke.fail("the stub's check missed")


def imports_sklearn(launches):
    sys.modules["sklearn"] = types.ModuleType("sklearn")


def raises(launches):
    raise RuntimeError("not a check")


def hangs(launches):
    time.sleep(600)


def spawns(launches):
    """Starts a process of its own that sleeps, writes its pid to the file
    ``SIDE_TEST_PID`` names, then hangs."""
    child = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(600)"])
    path = os.environ["SIDE_TEST_PID"]
    with open(path + ".tmp", "w") as f:
        f.write(str(child.pid))
    os.replace(path + ".tmp", path)
    time.sleep(600)
