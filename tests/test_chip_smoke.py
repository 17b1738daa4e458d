"""``chip_smoke.py`` refuses to run without a GPU."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    for line in out.stdout.splitlines():
        try:
            result = json.loads(line)
        except ValueError:
            continue
        assert not (isinstance(result, dict) and result.get("ok"))
