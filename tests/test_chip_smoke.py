"""The GPU entry points refuse to run without a GPU, and the smoke test
refuses to run outside the repository: neither may report a CPU run as a
result."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _run(script: Path, cwd: Path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_exits_nonzero_without_gpu(script):
    r = _run(REPO / script, REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "MP/s" not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    r = _run(tmp_path / "chip_smoke.py", tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
