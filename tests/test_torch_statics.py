"""The port's static solver (``solver/statics.py``) against the JAX
package's on the CPU at float64: the static compression curve of
``examples/static_compression_curve.py`` on its 4 x 3 cells with contact
(equilibria, reactions, residuals, the Newton iterations of every load
step, and the curve's gradient through the implicit adjoint), a 4 x 3 quad
sample in static tension through ``ForwardProblemQuads``, the solver's
NaN on failure and its zero gradient for the guess.

The JAX results are recorded in ``tests/data/analysis_small.npz`` by
``tests/jax_analysis_references.py`` (its JAX traces take minutes).
"""

import numpy as np
import pytest
import torch

from jax_analysis_references import COMPRESSION, QUADS_SMALL
from jax_references import stored

from difflexmm_tpu_torch.geometry.quad import RotatedSquareGeometry
from difflexmm_tpu_torch.models.hinge_characterization import ForwardProblemQuads
from difflexmm_tpu_torch.ops.assembly import build_strain_energy, combine_block_energies
from difflexmm_tpu_torch.ops.bonds import ligament_energy
from difflexmm_tpu_torch.ops.contact import build_contact_energy
from difflexmm_tpu_torch.solver.statics import setup_static_solver
from difflexmm_tpu_torch.utils.types import (
    ContactParams,
    ControlParams,
    GeometricalParams,
    LigamentParams,
    MechanicalParams,
)

torch.set_num_threads(1)

# Equilibria, reactions and curves: LU factorizations of the two packages
# order their sums differently, so a solution sits a few ulps from JAX's,
# amplified by the conditioning of the Newton matrix.
EQ_TOL = 1e-9
# Gradients through the implicit adjoint: one more solve, and the
# residual's second derivatives.
IFT_TOL = 1e-7


def rel(a, b):
    a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.fixture(scope="module")
def ref():
    return stored("analysis_small")


def compression(angle, k_rot, **solver_options):
    """The example's ``build`` in the port: (solver, control params,
    driven right column, blocks)."""

    c = COMPRESSION
    geo = RotatedSquareGeometry(c["n1_cells"], c["n2_cells"], spacing=1.0, bond_length=0.1)
    bc, cnv, bonds, rbv = geo.get_parametrization()
    k_stretch, k_shear, _ = c["ligament"]
    cmin, ccut, kc = c["contact"]
    cp = ControlParams(
        geometrical_params=GeometricalParams(bc(angle), cnv(angle)),
        mechanical_params=MechanicalParams(
            bond_params=LigamentParams(k_stretch, k_shear, k_rot, rbv()), density=1.0,
            damping=0.0, contact_params=ContactParams(min_angle=cmin, cutoff_angle=ccut,
                                                      k_contact=kc)),
        constraint_params=dict(squeeze=1.0))
    energy = combine_block_energies(build_strain_energy(bonds(), ligament_energy),
                                    build_contact_energy(bonds()))
    left = np.arange(0, geo.n_blocks, geo.n1_blocks)
    right = np.arange(geo.n1_blocks - 1, geo.n_blocks, geo.n1_blocks)
    pairs = np.concatenate([np.array([[b, d] for b in left for d in range(3)]),
                            np.stack([right, np.zeros_like(right)], 1)])
    n_fixed = len(pairs) - len(right)

    def drive(t, squeeze):
        t = torch.as_tensor(t, dtype=torch.float64)
        return torch.cat([t.new_zeros(n_fixed), (-squeeze * t).expand(len(right))])

    solve = setup_static_solver(geo, energy, constrained_block_DOF_pairs=pairs,
                                constrained_DOFs_fn=drive, **solver_options)
    return solve, cp, right, geo.n_blocks


def squeezes():
    lo, hi, n = COMPRESSION["squeezes"]
    return torch.linspace(lo, hi, n, dtype=torch.float64)


def test_compression_curve_matches_jax(ref):
    angle = torch.tensor(COMPRESSION["angle"], dtype=torch.float64, requires_grad=True)
    k_rot = torch.tensor(COMPRESSION["ligament"][2], dtype=torch.float64, requires_grad=True)
    solve, cp, right, nb = compression(angle, k_rot)
    u = torch.zeros((nb, 3), dtype=torch.float64)
    forces, residuals, us = [], [], []
    for s in squeezes():
        u = solve(u.detach(), s, cp)
        forces.append(-solve.reactions(u, s, cp)[-len(right):].sum())
        residuals.append(float(torch.max(torch.abs(solve.residual(u.detach(), s, cp).detach()))))
        us.append(u)
    forces = torch.stack(forces)
    assert solve.iterations == list(ref["compression_iterations"])
    assert max(residuals) < 1e-10 and float(np.max(ref["compression_residuals"])) < 1e-10
    assert rel(torch.stack(us), ref["compression_u"]) < EQ_TOL
    assert rel(forces, ref["compression_forces"]) < EQ_TOL
    grad = torch.autograd.grad(forces.sum(), (angle, k_rot))
    assert rel(torch.stack(grad), ref["compression_grad"]) < IFT_TOL


def test_quads_sample_static_tension_matches_jax(ref):
    q = QUADS_SMALL
    problem = ForwardProblemQuads(
        n1_blocks=q["n1_blocks"], n2_blocks=q["n2_blocks"], spacing=1.0, bond_length=0.1,
        horizontal_shifts=ref["quads_shifts_h"], vertical_shifts=ref["quads_shifts_v"],
        k_stretch=1.0, k_shear=0.05, k_rot=0.01, density=1.0, damping=1.0,
        loading_type="tension", amplitude=q["amplitude"], loading_rate=0.01,
        n_timepoints=q["n_timepoints"], method="static", device="cpu")
    problem.setup()
    k = tuple(torch.tensor(x, dtype=torch.float64, requires_grad=True)
              for x in (1.0, 0.05, 0.01))
    curve = problem.force_displacement(*problem.solve(k))
    assert problem.solve_equilibrium.iterations == list(ref["quads_iterations"])
    assert rel(curve, ref["quads_curve"]) < EQ_TOL
    grad = torch.autograd.grad(curve[1].sum(), k)
    assert rel(torch.stack(grad), ref["quads_grad"]) < IFT_TOL


def test_guess_carries_no_gradient():
    angle = torch.tensor(COMPRESSION["angle"], dtype=torch.float64)
    solve, cp, _, nb = compression(angle, 0.05)
    guess = torch.zeros((nb, 3), dtype=torch.float64, requires_grad=True)
    u = solve(guess, torch.tensor(0.03, dtype=torch.float64), cp)
    (g,) = torch.autograd.grad(u.sum(), guess)
    assert torch.isfinite(u).all() and torch.count_nonzero(g) == 0


def test_stalled_newton_returns_nan():
    # One Newton step cannot reach the tolerance at the largest squeeze.
    angle = torch.tensor(COMPRESSION["angle"], dtype=torch.float64)
    solve, cp, _, nb = compression(angle, 0.05, n_newton_steps=1)
    u = solve(torch.zeros((nb, 3), dtype=torch.float64), torch.tensor(0.3, dtype=torch.float64),
              cp)
    assert solve.iterations == [1]
    # NaN everywhere, as in JAX: the masked kinematics multiply NaN by 0 on
    # the driven DOFs too.
    assert torch.isnan(u).all()


@pytest.mark.slow
def test_analysis_small_references_match_jax():
    import jax_analysis_references
    from jax_references import record_or_check

    record_or_check("analysis_small", jax_analysis_references.analysis_small(), tol=1e-9)
