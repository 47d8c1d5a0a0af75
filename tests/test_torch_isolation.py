"""repro_torch stands alone: importing it loads neither JAX nor the JAX package."""
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)\b(?!_torch))", re.M)


def test_import_loads_no_jax_and_no_reference_module():
    code = (
        "import sys, repro_torch, repro_torch.core, repro_torch.core.broker, repro_torch.kernels, repro_torch.data\n"
        "import repro_torch.core.journal, repro_torch.core.delivery, repro_torch.checkpoint, repro_torch.testing\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        cwd=str(SRC), capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_no_source_line_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) >= 20
    offenders = [
        f"{f.relative_to(SRC)}: {m.group(0).strip()}"
        for f in files
        for m in FORBIDDEN.finditer(f.read_text())
    ]
    assert offenders == []


def test_forbidden_pattern_catches_reference_imports():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                 "from repro.core import triples", "import repro", "  from repro import core"):
        assert FORBIDDEN.search(line), line
    for line in ("from repro_torch.core import triples", "import repro_torch", "from . import ops"):
        assert not FORBIDDEN.search(line), line
