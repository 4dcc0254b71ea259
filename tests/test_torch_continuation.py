"""The port's arc-length continuation (``solver/continuation.py``) against
the JAX package's on the CPU at float64, on the von Mises truss of
``examples/snap_through_continuation.py``: the 60-step path (load factors,
apex drops, stability eigenvalues, both folds) and the limit load over 12
steps with its derivative in the rise (one transposed bordered solve per
step). The JAX results are recorded in ``tests/data/analysis_small.npz``.
"""

import numpy as np
import pytest
import torch

from jax_references import stored

from difflexmm_tpu_torch.models import analysis_configs as ac

torch.set_num_threads(1)

# Equilibria along the path: Newton correctors a few ulps from JAX's (LU).
EQ_TOL = 1e-9
# The limit load's derivative through the implicit adjoint of each step.
IFT_TOL = 1e-7
# The smallest eigenvalue of the tangent stiffness (LAPACK in both).
EIG_TOL = 1e-9


def rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.fixture(scope="module")
def snap():
    return ac.run_snap(device="cpu")


@pytest.fixture(scope="module")
def ref():
    return stored("analysis_small")


def test_snap_through_path_matches_jax(snap, ref):
    assert snap["converged"] and bool(ref["snap_converged"])
    assert rel(snap["load_factor"], ref["snap_load_factor"]) < EQ_TOL
    assert rel(snap["drop"], ref["snap_drop"]) < EQ_TOL
    assert rel(snap["stability"], ref["snap_stability"]) < EIG_TOL
    # The unstable branch lies between the two folds.
    assert list(snap["folds"]) == list(ref["snap_folds"]) and len(snap["folds"]) == 2
    first, second = snap["folds"]
    assert (snap["stability"][first + 1:second] < 0).all()


def test_limit_load_and_its_gradient_match_jax(snap, ref):
    assert rel(snap["limit"], ref["snap_limit"]) < EQ_TOL
    assert rel(snap["limit_grad"], ref["snap_limit_grad"]) < IFT_TOL


def test_path_shapes_and_stability_off():
    trace = ac.snap_tracer()
    cp = ac.snap_control_params(ac.SNAP_H0, device="cpu")
    zeros = torch.zeros((3, 3), dtype=torch.float64)
    path = trace(zeros, 0.0, ds=0.04, n_steps=1, control_params=cp)
    assert path.displacement.shape == (2, 3, 3) and bool(path.converged.all())
    assert torch.isnan(path.stability_eig).all()
