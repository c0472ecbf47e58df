"""chip_smoke.py refuses to run without a GPU: non-zero exit and no
result line."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_refuses_a_cpu_device():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr
