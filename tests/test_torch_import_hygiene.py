"""The PyTorch port imports no JAX, and no source file of it names jax."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "difflexmm_tpu_torch"


def test_importing_the_port_imports_no_jax():
    script = f"""
import sys, importlib, pkgutil
sys.path.insert(0, {str(REPO)!r})
import difflexmm_tpu_torch
for info in pkgutil.walk_packages(difflexmm_tpu_torch.__path__, "difflexmm_tpu_torch."):
    importlib.import_module(info.name)
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "difflexmm_tpu.")))
assert not leaked, leaked
print("NO_JAX")
"""
    result = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                            timeout=300)
    assert "NO_JAX" in result.stdout, (result.stdout, result.stderr[-2000:])


def test_no_port_source_imports_jax():
    pattern = re.compile(r"^\s*(import jax|from jax|import difflexmm_tpu\b|from difflexmm_tpu\b)",
                         re.MULTILINE)
    sources = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) > 10
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert not offenders, offenders
    modules = [m.name for m in pkgutil.walk_packages([str(PACKAGE)])]
    assert "solver" in modules and "ops" in modules
