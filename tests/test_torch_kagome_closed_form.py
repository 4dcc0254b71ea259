"""The kagome kernels' closed-form bond partials on the CPU at float64: their
CPU mirror (``kernel_checks.kagome_closed_form_force``, ``Kagome::bond_term``
of ``csrc/verlet_kagome.cu`` line for line, gathered in ``Kagome::gather``'s
order) against autograd of the port's plain kagome energy
(``verlet_kagome.kagome_grid_energy_planes``) and against the JAX package's
``jax.vmap(jax.grad(kagome_grid_energy_planes))``.

Inputs: the 4 x 3-cell lattice of ``kernel_checks.small_kagome`` with two
random designs and a random state, made with numpy from a seed. The cases
mirror the quad mirror's (``tests/test_torch_force.py``): the contact
barrier off; its window set around the smallest void angle of each design
(one void engaged); up to the smaller of the two voids of the bond where
that is smallest (both voids of a bond engaged); cmin exactly at the
smallest void angle (the clamp of x = -1 binds there); rotations near
+-pi/2 of opposite sign on the two triangles of a cell (their difference
near +-pi, where the void angles wrap); rotations near 3.3 rad, where the
nonlinear shear's atan2 wraps. Each linearized and not.

Tolerance: 1e-12 of the field's largest entry against both references. The
same gradient by another sequence of operations: the void angles'
rotation partials exactly +-1, the barrier's slope in one quotient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difflexmm_tpu.ops.pallas.verlet_kagome import (
    kagome_grid_energy_planes as jax_kagome_grid_energy_planes,
)
from difflexmm_tpu_torch import kernel_checks as kc
from difflexmm_tpu_torch.ops.kernels.verlet_kagome import kagome_grid_energy_planes

torch.set_num_threads(1)

TIGHT = 1e-12
N1, N2, B = 4, 3, 2
CASES = ["contact off", "one void", "both voids", "clamp binds", "near pi/2", "past the wrap"]


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _window(U, fixed, case):
    """The fixed leaves with the barrier's window [cmin, ccut) of each
    design set for ``case`` from the void angles at ``U``."""

    voids = kc.void_angles_planes(U, fixed)
    pairs = torch.cat([torch.stack(voids[k:k + 2], 1).flatten(2) for k in (0, 2, 4)], 2)
    ordered = pairs.flatten(1).sort(1).values  # (B, 2 nbond)
    if case == "both voids":
        upper = pairs.max(1).values.min(1).values
        above = torch.where(ordered > upper[:, None], ordered, float("inf")).min(1).values
        cmin, ccut = ordered[:, 0] - 0.1, (upper + above) / 2
    elif case == "clamp binds":
        cmin, ccut = ordered[:, 0], ordered[:, 0] + 0.3
    else:
        cmin, ccut = ordered[:, 0] - 0.1, (ordered[:, 0] + ordered[:, 1]) / 2
    return fixed[:14] + (cmin.reshape(B, 1, 1), ccut.reshape(B, 1, 1)) + fixed[16:]


def _case(case, seed=11):
    """``(U_eff, fixed leaves, use_contact)`` of one case."""

    rng = np.random.default_rng(seed)
    problem = kc.small_kagome(device="cpu")
    args = kc.batched_args(problem, [kc.random_kagome_design(problem, rng) for _ in range(B)])
    fixed = args.fixed[:17]
    scale = np.array([0.05, 0.05, 0.1] * 2)[None, :, None, None]
    U = torch.as_tensor(rng.normal(0, scale, size=(B, 6, N2, N1)))
    if case == "near pi/2":
        sign = torch.tensor([[(-1.0) ** (i + j) for i in range(N1)] for j in range(N2)],
                            dtype=torch.float64)
        U[:, 2] += sign * (np.pi / 2)
        U[:, 5] -= sign * (np.pi / 2)
    elif case == "past the wrap":
        U[:, 2] += 3.3
        U[:, 5] += 3.3
    if case == "contact off":
        return U, fixed, False
    return U, _window(U, fixed, case), True


def _autograd_force(U, fixed, linearized, use_contact):
    u = U.clone().requires_grad_()
    energy = kagome_grid_energy_planes(u, *fixed, linearized=linearized,
                                       use_contact=use_contact)
    return torch.autograd.grad(energy, u)[0]


def _jax_force(U, fixed, linearized, use_contact):
    def energy(u, *leaves):
        return jax_kagome_grid_energy_planes(u, *leaves, linearized=linearized,
                                             use_contact=use_contact)

    return jax.vmap(jax.grad(energy))(*(jnp.asarray(x.numpy()) for x in (U,) + fixed))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("linearized", [False, True])
def test_kagome_closed_form_partials_match_autograd_and_jax(linearized, case):
    U, fixed, use_contact = _case(case)
    bonds, voids = kc.engaged_voids(U, fixed)
    if case == "contact off":
        assert not use_contact
    elif case == "both voids":
        assert voids > bonds >= B  # both voids of one bond of each design
    elif case == "clamp binds":
        assert voids >= B  # the smallest void of each design sits at cmin
    else:
        assert (bonds, voids) == (B, B)  # one void of each design
    partials = kc.kagome_closed_form_partials(U, fixed, linearized, use_contact)
    assert partials.shape == (B, 6, N1 * N2 + (N2 - 1) * N1 + N2 * (N1 - 1))
    got = kc.kagome_closed_form_force(U, fixed, linearized, use_contact)
    assert torch.isfinite(got).all()
    assert rel(got, _autograd_force(U, fixed, linearized, use_contact)) <= TIGHT
    assert rel(got, _jax_force(U, fixed, linearized, use_contact)) <= TIGHT


def test_kagome_trajectory_bound_counts_the_closed_form():
    """The kagome trajectory's operations: each bond's closed form every
    substep (its engaged void angles beside it), each DOF's update, and the
    void angles at rest once a launch."""

    problem = kc.small_kagome(device="cpu", n_timepoints=3)
    rng = np.random.default_rng(3)
    args = kc.batched_args(problem, [kc.random_kagome_design(problem, rng) for _ in range(B)])
    outU = args.U0[:, None].expand(B, 2, 6, N2, N1)
    nbond = N1 * N2 + (N2 - 1) * N1 + N2 * (N1 - 1)
    steps = args.dts.shape[0] * args.spec.n_substeps
    _, voids = kc.engaged_voids(outU, args.fixed)
    bound = kc.trajectory_bound(args, outU)
    assert bound["ops"] == (steps * B * (nbond * kc.OPS_BOND_KAGOME + 6 * N1 * N2
                                         * kc.OPS_DOF_KAGOME)
                            + voids * kc.OPS_VOID_CONTACT_KAGOME * args.spec.n_substeps
                            + B * nbond * kc.OPS_REST_KAGOME)
    assert bound["bound_ms"] == max(bound["ops"] / kc.H100_FLOPS[torch.float64],
                                    bound["bytes"] / kc.H100_BYTES_PER_S) * 1e3
