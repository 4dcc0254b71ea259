"""The PyTorch port imports no JAX, and no source file of it names jax;
loading a pickle that the JAX package wrote (with numpy arrays) imports
neither JAX nor the JAX package; and the JAX package imports no torch."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "difflexmm_tpu_torch"
# Modules of the optimizer, solver and analysis slices, which the walk must
# reach.
NEW_MODULES = ("difflexmm_tpu_torch.optim.loops", "difflexmm_tpu_torch.utils.observability",
               "difflexmm_tpu_torch.solver.integrate", "difflexmm_tpu_torch.solver.statics",
               "difflexmm_tpu_torch.solver.continuation", "difflexmm_tpu_torch.solver.bloch",
               "difflexmm_tpu_torch.models.hinge_characterization",
               "difflexmm_tpu_torch.objectives")


def test_importing_the_port_imports_no_jax():
    script = f"""
import sys, importlib, pkgutil
sys.path.insert(0, {str(REPO)!r})
import difflexmm_tpu_torch
for info in pkgutil.walk_packages(difflexmm_tpu_torch.__path__, "difflexmm_tpu_torch."):
    importlib.import_module(info.name)
for name in {NEW_MODULES!r}:
    assert name in sys.modules, name
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "difflexmm_tpu.")))
assert not leaked, leaked
print("NO_JAX")
"""
    result = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                            timeout=300)
    assert "NO_JAX" in result.stdout, (result.stdout, result.stderr[-2000:])


def test_importing_the_jax_package_imports_no_torch():
    script = f"""
import sys, importlib, pkgutil
sys.path.insert(0, {str(REPO)!r})
import difflexmm_tpu
assert "torch" not in sys.modules
for info in pkgutil.walk_packages(difflexmm_tpu.__path__, "difflexmm_tpu."):
    importlib.import_module(info.name)
leaked = sorted(m for m in sys.modules if m == "torch" or m.startswith(("torch.",
                                                                          "difflexmm_tpu_torch")))
assert not leaked, leaked
print("NO_TORCH")
"""
    result = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                            timeout=300)
    assert "NO_TORCH" in result.stdout, (result.stdout, result.stderr[-2000:])


def test_no_port_source_imports_jax():
    pattern = re.compile(r"^\s*(import jax|from jax|import difflexmm_tpu\b|from difflexmm_tpu\b)",
                         re.MULTILINE)
    sources = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) > 10
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert not offenders, offenders
    modules = [m.name for m in pkgutil.walk_packages([str(PACKAGE)])]
    assert "solver" in modules and "ops" in modules


def test_loading_a_jax_written_numpy_pickle_imports_no_jax(tmp_path):
    import numpy as np

    from difflexmm_tpu.models import quads_focusing as jax_quads
    from difflexmm_tpu.utils import types as jax_types

    rng = np.random.default_rng(0)
    arrays = dict(block_centroids=rng.standard_normal((4, 2)),
                  centroid_node_vectors=rng.standard_normal((4, 4, 2)),
                  bond_connectivity=rng.integers(0, 16, (4, 2)),
                  timepoints=np.linspace(0.0, 1.0, 3), fields=rng.standard_normal((3, 2, 4, 3)))
    problem = jax_quads.ForwardProblem(
        n1_blocks=2, n2_blocks=2, spacing=1.0, bond_length=0.1, k_stretch=1.0, k_shear=0.02,
        k_rot=1e-3, density=1.0, damping=0.02, amplitude=0.2, loading_rate=0.5,
        input_delay=0.0, n_excited_blocks=1, loaded_side="left")
    jax_types.save_data(tmp_path / "solution.pkl", jax_types.SolutionData(**arrays))
    jax_types.save_data(tmp_path / "problem.pkl", problem)
    np.savez(tmp_path / "arrays.npz", **arrays)
    script = f"""
import sys
sys.path.insert(0, {str(REPO)!r})
import numpy as np, torch
from difflexmm_tpu_torch.models.quads_focusing import ForwardProblem
from difflexmm_tpu_torch.utils.types import SolutionData, load_data
solution = load_data({str(tmp_path / "solution.pkl")!r}, device="cpu")
assert isinstance(solution, SolutionData), type(solution)
with np.load({str(tmp_path / "arrays.npz")!r}) as arrays:
    for key in arrays.files:
        value = getattr(solution, key)
        assert isinstance(value, torch.Tensor) and np.array_equal(value.numpy(), arrays[key]), key
problem = ForwardProblem.from_data(load_data({str(tmp_path / "problem.pkl")!r}, device="cpu"))
assert isinstance(problem, ForwardProblem) and problem.n1_blocks == 2 and not problem.is_setup
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "difflexmm_tpu.")))
assert not leaked, leaked
print("NO_JAX")
"""
    result = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                            timeout=300)
    assert "NO_JAX" in result.stdout, (result.stdout, result.stderr[-2000:])
