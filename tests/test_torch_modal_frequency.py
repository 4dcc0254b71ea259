"""The port's modal analysis and harmonic response (``solver/modal.py``,
``solver/frequency.py``) against the JAX package's on the CPU at float64:
the transmission of a 3 x 2-cell strip of ``examples/transmission_spectrum.py``
at 12 frequencies and its modes with constrained pairs (the linearized
ligament energy), and the modes of a 4 x 3 quad lattice about a seeded
state with the contact grid energy the flagship's modes use (its Hessian
by ``torch.func.hessian``). Eigenvectors are compared through the
phase-invariant weight of each block (|q|^2), eigenvalues directly. The
JAX results are recorded in ``tests/data/analysis_small.npz``.
"""

import numpy as np
import pytest
import torch

from jax_analysis_references import MODES_SMALL, STRIP_PAIRS, STRIP_SMALL
from jax_references import stored

from difflexmm_tpu_torch.geometry.quad import QuadGeometry, RotatedSquareGeometry
from difflexmm_tpu_torch.models import analysis_configs as ac
from difflexmm_tpu_torch.models import base
from difflexmm_tpu_torch.ops.assembly import build_strain_energy
from difflexmm_tpu_torch.ops.bonds import ligament_energy_linearized
from difflexmm_tpu_torch.ops.grid import build_quad_grid_energy
from difflexmm_tpu_torch.solver.modal import eigenmode_analysis, linear_mode_analysis
from difflexmm_tpu_torch.utils.types import (
    ContactParams,
    ControlParams,
    GeometricalParams,
    LigamentParams,
    MechanicalParams,
)

torch.set_num_threads(1)

# Eigenvalues and mode weights: LAPACK in both, Hessians of the same
# energy by different automatic differentiation.
EIG_TOL = 1e-9
# Transmission: a ratio of complex solves near resonances.
TRANSMISSION_TOL = 1e-8


def rel(a, b):
    a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.fixture(scope="module")
def ref():
    return stored("analysis_small")


def test_strip_transmission_matches_jax(ref):
    got = ac.strip_transmission(device="cpu", **STRIP_SMALL)
    assert rel(got, ref["strip_transmission"]) < TRANSMISSION_TOL


def test_strip_modes_match_jax(ref):
    geo = RotatedSquareGeometry(*STRIP_SMALL["cells"], spacing=1.0, bond_length=0.1)
    bc, cnv, bonds, rbv = geo.get_parametrization()
    angle = torch.tensor(ac.STRIP_ANGLE, dtype=torch.float64)
    s = ac.STRIP_STIFF
    cp = ControlParams(GeometricalParams(bc(angle), cnv(angle)),
                       MechanicalParams(LigamentParams(s["k_stretch"], s["k_shear"], s["k_rot"],
                                                       rbv()), density=1.0, damping=0.05))
    data = eigenmode_analysis(torch.zeros((geo.n_blocks, 3), dtype=torch.float64), geo,
                              build_strain_energy(bonds(), ligament_energy_linearized), cp,
                              constrained_block_DOF_pairs=STRIP_PAIRS)
    assert rel(data.eigenvalues, ref["strip_eigenvalues"]) < EIG_TOL
    assert rel(torch.sum(data.fields**2, dim=-1), ref["strip_mode_weights"]) < EIG_TOL
    # Constrained DOFs carry nothing.
    assert float(torch.abs(data.fields[:, STRIP_PAIRS[:, 0], STRIP_PAIRS[:, 1]]).max()) == 0.0


def test_contact_lattice_modes_match_jax(ref):
    m = MODES_SMALL
    geo = QuadGeometry(m["n1_blocks"], m["n2_blocks"], spacing=1.0, bond_length=0.1)
    bc, cnv, bonds, rbv = geo.get_parametrization()
    h, v = (torch.tensor(ref[k]) for k in ("modes_shifts_h", "modes_shifts_v"))
    cp = ControlParams(
        GeometricalParams(bc(h, v), cnv(h, v)),
        MechanicalParams(LigamentParams(1.0, 0.05, 0.01, rbv()), density=1.0, damping=0.0,
                         contact_params=ContactParams(min_angle=0.0, cutoff_angle=0.6,
                                                      k_contact=0.01)))
    pairs = base.clamped_corner_pairs(m["n1_blocks"], m["n2_blocks"], 1)
    w, modes = linear_mode_analysis(torch.tensor(ref["modes_u0"]), geo,
                                    build_quad_grid_energy(m["n1_blocks"], m["n2_blocks"]), cp,
                                    constrained_block_DOF_pairs=pairs)
    assert rel(w, ref["modes_eigenvalues"]) < EIG_TOL
    assert rel(torch.sum(modes**2, dim=-1), ref["modes_weights"]) < EIG_TOL
