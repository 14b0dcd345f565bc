"""chip_smoke.py must refuse to run without a GPU: non-zero exit and
no result line, under JAX_PLATFORMS=cpu (the GPU phases themselves
run on the card; see the README)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("args", [[], ["--cards", "4"]])
def test_chip_smoke_refuses_cpu(args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr
