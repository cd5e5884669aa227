"""The repo's lint gate (``tools/lint.py``) over the port: ``mmtraj_torch/``,
``chip_smoke.py`` and the port's tools, which the gate's default paths leave
out.  ``tests/test_lint.py`` covers the defaults, ``experiments/`` among them."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def test_lint_clean_over_the_port():
    tools = sorted(str(p.relative_to(REPO)) for p in (REPO / "tools").glob("torch_*.py"))
    proc = subprocess.run([sys.executable, str(REPO / "tools" / "lint.py"), "mmtraj_torch",
                           "chip_smoke.py", *tools], capture_output=True, text=True, cwd=REPO)
    assert proc.returncode == 0, f"lint findings:\n{proc.stdout}"
