"""The port's MMA against scipy's SLSQP on the downsized constrained
focusing problem of the JAX package's ``tests/test_mma_crosscheck.py``
(6 x 5 blocks of the paper physics, 25 timepoints), on the CPU at
float64.

Both optimizers run the same objective and constraint functions with the
same bounds; both must land feasible designs that clearly improve the
objective, and MMA must not fall far behind SLSQP (the problem is
nonconvex, so agreement of the designs is not the contract). The forward
problem runs the dense ``method="verlet"`` with ``guard="auto"``, as in
JAX: without the guard both optimizers exploit designs outside the
fixed-step integrator's stability region.
"""

import math

import numpy as np
import pytest
import torch

from difflexmm_tpu_torch.models.quads_focusing import ForwardProblem, OptimizationProblem
from difflexmm_tpu_torch.optim.loops import ravel_pytree
from difflexmm_tpu_torch.optim.mma import run_mma

torch.set_num_threads(1)

SPACING = 15.0  # mm (paper units)


@pytest.fixture(scope="module")
def problem():
    frequency = 30.0
    density = 6.18e-9
    k_shear = 1.19
    forward = ForwardProblem(
        n1_blocks=6, n2_blocks=5, spacing=SPACING, bond_length=0.15 * SPACING,
        k_stretch=120.0, k_shear=k_shear, k_rot=1.50, density=density,
        damping=0.0186 * 2 * (0.36125 * density * SPACING**2 * k_shear) ** 0.5,
        use_contact=True, k_contact=1.50, min_angle=-15 * math.pi / 180,
        cutoff_angle=-10 * math.pi / 180, amplitude=0.5 * SPACING, loading_rate=frequency,
        input_delay=0.1 / frequency, n_excited_blocks=2, loaded_side="left", input_shift=0,
        simulation_time=(2 / frequency) * (24 / 199), n_timepoints=25, n_substeps=10,
        method="verlet", guard="auto", n_blocks_clamped_corner=1, device="cpu",
    )
    optimization = OptimizationProblem(forward, target_size=(2, 2), target_shift=(1, 1))
    optimization.setup_objective()
    design = forward.geometry.get_design_from_rotated_square(25 * math.pi / 180, device="cpu")
    return optimization, design


@pytest.mark.slow
def test_mma_matches_slsqp_on_downsized_problem(problem):
    from scipy.optimize import minimize

    optimization, design = problem
    bounds = (-0.35 * SPACING, 0.35 * SPACING)
    flat0, unflatten = ravel_pytree(design)

    def objective_and_grad(x):
        x = x.detach().requires_grad_()
        value = optimization.objective_fn(unflatten(x))
        (grad,) = torch.autograd.grad(value, x)
        return value.detach(), grad

    fns = [fn for _, fn in optimization._design_constraints(0.0, 0.0, 0.05 * SPACING)]

    def stacked(x):
        return torch.cat([fn(unflatten(x)) for fn in fns])

    jacobian = torch.func.jacrev(stacked)

    def constraints_and_jac(x):
        x = x.detach()
        return stacked(x), jacobian(x)

    n_iters = 12
    x_mma, _ = run_mma(objective_and_grad, flat0.detach(), torch.full_like(flat0, bounds[0]),
                       torch.full_like(flat0, bounds[1]), n_iters,
                       constraints_and_jac=constraints_and_jac, maximize=True, move_limit=0.08)
    mma_obj = float(objective_and_grad(x_mma)[0])
    mma_viol = float(torch.max(stacked(x_mma)))

    def f(x):
        v, g = objective_and_grad(torch.tensor(x))
        return -float(v), -g.numpy()

    res = minimize(
        f, flat0.detach().numpy(), jac=True, method="SLSQP", bounds=[bounds] * flat0.numel(),
        constraints=[{
            "type": "ineq",
            "fun": lambda x: -constraints_and_jac(torch.tensor(x))[0].numpy(),
            "jac": lambda x: -constraints_and_jac(torch.tensor(x))[1].numpy(),
        }],
        options={"maxiter": n_iters, "ftol": 1e-10},
    )
    slsqp_obj = float(objective_and_grad(torch.tensor(res.x))[0])
    slsqp_viol = float(torch.max(stacked(torch.tensor(res.x))))

    initial = float(objective_and_grad(flat0)[0])
    assert initial > 0
    # Both feasible (SLSQP is allowed a hair of slack at its ftol).
    assert mma_viol <= 1e-8, mma_viol
    assert slsqp_viol <= 1e-6, slsqp_viol
    # Both optimize, and MMA is never far behind SLSQP.
    assert mma_obj > 1.5 * initial, (mma_obj, initial)
    assert slsqp_obj > 1.2 * initial, (slsqp_obj, initial)
    assert mma_obj > 0.5 * slsqp_obj, (mma_obj, slsqp_obj)
    assert np.isfinite(mma_obj) and np.isfinite(slsqp_obj)
