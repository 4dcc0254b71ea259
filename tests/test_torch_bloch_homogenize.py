"""The port's Bloch analysis and homogenization (``solver/bloch.py``,
``solver/homogenize.py``) against the JAX package's on the CPU at
float64, on the cells of ``examples/dispersion_design.py``,
``effective_properties_design.py`` and ``defect_waveguide.py``: the kagome
gap between bands 2 and 3 and its shift gradient at a few wave vectors of
the example's path; the rotated-square cell relaxed under 5% biaxial
compression (``relax_cell``, and the derivative of its rotation in the
strain through the implicit adjoint) and its bands there; group
velocities; the spring chain; the zone grid and the density of states; a
quad supercell; the waveguide's bulk gap, guided branch, its weight on the
defect rows and its derivative in log k_rot; the effective moduli
(condensed and affine), the engineering constants, the stress under
compression, and stage 3's Poisson ratio and gradient. Eigenvectors are
compared only through ``mode_localization`` (phase invariant), and
gradients only of non-degenerate quantities. The JAX results are recorded
in ``tests/data/analysis_small.npz``.
"""

import numpy as np
import pytest
import torch

from jax_analysis_references import KAGOME_KS_SMALL, RELAX_STRAIN, WAVEGUIDE_SMALL
from jax_references import stored

from difflexmm_tpu_torch.models import analysis_configs as ac
from difflexmm_tpu_torch.ops.bonds import simple_spring_energy
from difflexmm_tpu_torch.solver import bloch
from difflexmm_tpu_torch.solver.homogenize import (
    areal_density,
    christoffel_speeds,
    effective_moduli,
    effective_stress,
    engineering_constants,
)

torch.set_num_threads(1)

# Eigenvalues, bands, moduli: LAPACK in both, Hessians by different
# automatic differentiation.
EIG_TOL = 1e-9
# Derivatives of non-degenerate eigenvalues and of implicit solves.
EIG_GRAD_TOL = 1e-7
CPU = dict(device="cpu", dtype=torch.float64)


def rel(a, b):
    a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.fixture(scope="module")
def ref():
    return stored("analysis_small")


def rotated(**stiffness):
    return bloch.rotated_square_cell(0.25, **stiffness, **CPU)


def test_kagome_gap_and_shift_gradient_match_jax(ref):
    ks = ac.kagome_ks(**CPU)[KAGOME_KS_SMALL]
    assert rel(ks, ref["kagome_ks"]) < 1e-14
    shifts = torch.tensor(ref["kagome_shifts"], requires_grad=True)
    gap = ac.kagome_gap(shifts, ks)
    assert rel(gap, ref["kagome_gap"]) < EIG_TOL
    assert rel(torch.autograd.grad(gap, shifts)[0], ref["kagome_gap_grad"]) < EIG_GRAD_TOL


def test_relaxed_cell_and_its_bands_match_jax(ref):
    cell = rotated(k_stretch=1.0, k_shear=0.3, k_rot=0.05)
    F = (1.0 - RELAX_STRAIN) * torch.eye(2, dtype=torch.float64)
    u = bloch.relax_cell(cell, affine=F)
    assert rel(u, ref["relax_u"]) < EIG_TOL
    ks = torch.tensor(ref["rs_ks"])
    assert rel(bloch.band_structure(cell, ks, displacement=u, affine=F),
               ref["relax_bands"]) < EIG_TOL
    strain = torch.tensor(RELAX_STRAIN, dtype=torch.float64, requires_grad=True)
    rotation = bloch.relax_cell(cell, affine=(1.0 - strain) * torch.eye(2, dtype=torch.float64))
    (grad,) = torch.autograd.grad(rotation[0, 2], strain)
    assert rel(grad, ref["relax_grad"]) < EIG_GRAD_TOL


def test_group_velocity_chain_grid_and_supercell_match_jax(ref):
    cell = rotated(k_stretch=1.0, k_shear=0.3, k_rot=0.05)
    ks = torch.tensor(ref["rs_ks"])
    omega, vg = bloch.group_velocity(cell, ks[1:4])
    assert rel(omega, ref["group_omega"]) < EIG_TOL
    assert rel(vg, ref["group_velocity"]) < EIG_GRAD_TOL
    chain = bloch.spring_chain_cell(k_stretch=2.0, **CPU)
    chain_ks = torch.stack([torch.linspace(0.1, 3.0, 5, dtype=torch.float64),
                            torch.zeros(5, dtype=torch.float64)], dim=1)
    bands = bloch.band_structure(chain, chain_ks, bond_energy_fn=simple_spring_energy)
    assert rel(bands, ref["chain_bands"]) < EIG_TOL
    # The textbook chain: omega^2 = 4 k / m sin^2(k a / 2).
    assert rel(bands.max(dim=1).values, 8.0 * torch.sin(chain_ks[:, 0] / 2) ** 2) < 1e-12
    grid = bloch.bz_grid(cell, 4, 4)
    assert rel(grid, ref["bz_grid"]) < 1e-14
    dos = bloch.density_of_states(bloch.frequencies(bloch.band_structure(cell, grid)),
                                  torch.linspace(0.0, 3.0, 9, dtype=torch.float64), 0.2)
    assert rel(dos, ref["dos"]) < EIG_TOL
    shifts = torch.ones((2, 1, 2), dtype=torch.float64)
    sc = bloch.supercell(bloch.quad_periodic_cell(0.01 * shifts, -0.01 * shifts), 1, 2)
    assert rel(bloch.band_structure(sc, ks[:3]), ref["supercell_bands"]) < EIG_TOL


def test_waveguide_matches_jax(ref):
    got = run_waveguide_small()
    for key in ("gap", "guided", "weight", "guided_op"):
        assert rel(got[key], ref[f"waveguide_{key}"]) < EIG_TOL, key
    assert rel(got["guided_op_grad"], ref["waveguide_guided_op_grad"]) < EIG_GRAD_TOL


def run_waveguide_small():
    saved = ac.WAVEGUIDE_KX, ac.WAVEGUIDE_BZ
    ac.WAVEGUIDE_KX, ac.WAVEGUIDE_BZ = WAVEGUIDE_SMALL["kx"], WAVEGUIDE_SMALL["bz"]
    try:
        return ac.run_waveguide(**CPU)
    finally:
        ac.WAVEGUIDE_KX, ac.WAVEGUIDE_BZ = saved


def test_effective_properties_match_jax(ref):
    cell = rotated(k_stretch=1.0, k_shear=1.0, k_rot=1e-2)
    C = effective_moduli(cell)
    assert rel(C, ref["moduli"]) < EIG_TOL
    assert rel(effective_moduli(cell, condense=False), ref["moduli_affine"]) < EIG_TOL
    ec = engineering_constants(C)
    assert rel(torch.stack([ec[k] for k in ("E_x", "E_y", "nu_xy", "nu_yx", "G_xy")]),
               ref["engineering"]) < EIG_TOL
    assert rel(effective_stress(cell, 0.98 * torch.eye(2, dtype=torch.float64)),
               ref["stress"]) < EIG_TOL
    # Christoffel speeds are the square roots of the acoustic tensor's
    # eigenvalues: positive, ascending.
    speeds = christoffel_speeds(C, areal_density(cell), torch.tensor([1.0, 0.0]))
    assert bool((speeds > 0).all()) and float(speeds[0]) <= float(speeds[1])


def test_poisson_ratio_and_gradient_match_jax(ref):
    h = torch.tensor(ref["poisson_h0"], requires_grad=True)
    v = torch.tensor(ref["poisson_v0"], requires_grad=True)
    nu = ac.poisson_ratio(h, v)
    assert rel(nu, ref["poisson_nu"]) < EIG_TOL
    grads = torch.autograd.grad((nu - ac.POISSON_TARGET) ** 2, (h, v))
    assert rel(torch.cat([g.reshape(-1) for g in grads]), ref["poisson_grad"]) < EIG_GRAD_TOL
