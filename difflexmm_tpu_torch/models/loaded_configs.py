"""The force-loaded and rotated-square configurations that the repository
runs, copied into the port so that it needs nothing of the JAX package's
tree (tests check that the copies agree with the files):

- the force pulse of ``examples/pulse_rotated_squares.py`` (the JAX
  package's counterpart of the reference's ``scripts/pulse_RS.py``): a
  ``sin^2`` force pulse on the two middle left-edge blocks of a 10 x 5-cell
  rotated-square lattice, ligaments only;
- the tensile oracle of ``tools/tpu_parity_check.py:450-546``: a 5 x 1-cell
  rotated-square chain pulled by a force ramp on its right end, whose final
  strain must equal the applied strain;
- ``examples/configs/pulse_forward.json``: the ``reference_design`` forward
  problem that ``python -m difflexmm_tpu.run`` takes.

The reference values were made with the JAX package at float64 on the CPU
(method ``"verlet_ckpt"``, the fused path's XLA twin, so the same
operations as the port's fused path); the slow tests of
``tests/test_torch_rotated_square.py`` make them again and check these
constants. Summaries ``(|v|, sum v, v . r)`` are
``models/flagship.vector_stats``'s.
"""

import math
import time

import numpy as np
import torch

from difflexmm_tpu_torch.geometry.quad import RotatedSquareGeometry
from difflexmm_tpu_torch.models.reference_design import ForwardProblem
from difflexmm_tpu_torch.ops.assembly import build_strain_energy
from difflexmm_tpu_torch.ops.bonds import ligament_energy
from difflexmm_tpu_torch.ops.observables import kinetic_energy
from difflexmm_tpu_torch.geometry.polygon import compute_inertia
from difflexmm_tpu_torch.solver.dynamics import setup_dynamic_solver
from difflexmm_tpu_torch.utils.types import (
    ControlParams,
    GeometricalParams,
    LigamentParams,
    MechanicalParams,
)

# ---------------------------------------------------------------------------
# The force pulse of examples/pulse_rotated_squares.py
# ---------------------------------------------------------------------------

#: The example's problem: lattice, design angle, ligaments (k_stretch,
#: k_shear, k_rot), density, damping, the pulse's amplitude and rate, and
#: the time grid (numpy's ``linspace``; the example's ``jnp.linspace``
#: rounds a few timepoints differently, by up to 4e-15).
PULSE = dict(n1_cells=10, n2_cells=5, spacing=1.0, angle=0.25, bond_params=(1.0, 0.02, 1e-3),
             density=1.0, damping=0.02, amplitude=0.5, rate=0.5, simulation_time=20.0,
             n_timepoints=100, n_substeps=16)

#: JAX float64 kinetic energy of all blocks at the last timepoint, and its
#: gradient with respect to (angle, amplitude, rate).
JAX_F64_PULSE_KE = 0.007398104778147041
JAX_F64_PULSE_GRAD = (-228.59262040332084, -61.08944037700053, -147.41123845137017)


def pulse_loading(state, t, amplitude, rate):
    """The example's force: ``amplitude sin^2(pi rate t)`` for ``0 < t <
    1 / rate``, else 0 (time only)."""

    active = (t > 0) & (t < 1 / rate)
    return amplitude * torch.where(active, torch.sin(math.pi * rate * t) ** 2,
                                   torch.zeros_like(t))


def pulse_problem(device="cuda", dtype=torch.float64, method="verlet_pallas"):
    """The example through ``setup_dynamic_solver``: ``(solve, control_params,
    state0, timepoints)`` where ``control_params(angle, amplitude, rate)``
    takes tensors. ``method="verlet_pallas"`` runs the quad grid fast path
    without contact (the fused loading kernel on CUDA tensors);
    ``"verlet"`` the dense path on the bond-list ligament energy, as the
    example does."""

    like = dict(device=torch.device(device), dtype=dtype)
    geometry = RotatedSquareGeometry(PULSE["n1_cells"], PULSE["n2_cells"],
                                     spacing=PULSE["spacing"])
    bc, cnv, bonds, rbv = geometry.get_parametrization()
    rows = np.array([geometry.n2_blocks // 2 - 1, geometry.n2_blocks // 2])
    loaded_pairs = np.stack([rows * geometry.n1_blocks, np.zeros_like(rows)], axis=1)
    grid = dict(n1=geometry.n1_blocks, n2=geometry.n2_blocks, use_contact=False)
    solve = setup_dynamic_solver(
        geometry=geometry,
        energy_fn=build_strain_energy(bonds(), ligament_energy),
        loaded_block_DOF_pairs=loaded_pairs,
        loading_fn=pulse_loading,
        damped_blocks=np.arange(geometry.n_blocks),
        method=method,
        n_substeps=PULSE["n_substeps"],
        quad_grid=None if method == "verlet" else grid,
    )
    ref = rbv().to(**like)

    def control_params(angle, amplitude, rate):
        return ControlParams(
            geometrical_params=GeometricalParams(bc(angle), cnv(angle)),
            mechanical_params=MechanicalParams(
                bond_params=LigamentParams(*(torch.tensor(k, **like)
                                             for k in PULSE["bond_params"]), ref),
                density=torch.tensor(PULSE["density"], **like),
                damping=torch.tensor(PULSE["damping"], **like),
            ),
            loading_params=dict(amplitude=amplitude, rate=rate),
        )

    timepoints = torch.as_tensor(
        np.linspace(0.0, PULSE["simulation_time"], PULSE["n_timepoints"]), **like)
    state0 = torch.zeros((2, geometry.n_blocks, 3), **like)
    return solve, control_params, state0, timepoints


def pulse_inputs(device="cuda", dtype=torch.float64):
    """The example's (angle, amplitude, rate) as tensors."""

    return tuple(torch.tensor(PULSE[k], device=device, dtype=dtype)
                 for k in ("angle", "amplitude", "rate"))


def pulse_kinetic_energy(problem, angle, amplitude, rate):
    """The check quantity of the pulse: the kinetic energy of all blocks at
    the last timepoint, ``(value, fields)``."""

    solve, control_params, state0, timepoints = problem
    cp = control_params(angle, amplitude, rate)
    fields = solve(state0, timepoints, cp)
    inertia = compute_inertia(cp.geometrical_params.centroid_node_vectors,
                              cp.mechanical_params.density)
    return kinetic_energy(fields[-1, 1], inertia), fields


# ---------------------------------------------------------------------------
# The tensile oracle of tools/tpu_parity_check.py
# ---------------------------------------------------------------------------

#: The applied strains, and the oracle's limit on the tip strain's relative
#: error (``TOL_TENSILE_STRAIN_F32`` there) and on the fused trajectory's
#: distance from the dense one (displacements are O(1)).
TENSILE_STRAINS = (0.2, 0.4, 0.6)
TENSILE_STRAIN_TOL = 1e-3
TENSILE_TRAJECTORY_TOL = 1e-3


def tensile_problem(device="cuda", dtype=torch.float32, method="verlet_pallas"):
    """The force-controlled tensile chain: ``(solve, control_params,
    state0, timepoints, tip_strain)`` where ``control_params(strain)`` and
    ``tip_strain(fields)`` is the chain's final strain (tip displacement
    over the gauge length)."""

    like = dict(device=torch.device(device), dtype=dtype)
    geometry = RotatedSquareGeometry(n1_cells=5, n2_cells=1, spacing=1.0)
    bc, cnv, bonds, rbv = geometry.get_parametrization()
    n1, nb, spacing = geometry.n1_blocks, geometry.n_blocks, geometry.spacing
    k_stretch, mass = 1.0, 1.0
    damping = 0.05 * torch.tensor([1.0, 1.0, spacing**2 / 4], **like).expand(nb, 3) \
        * (k_stretch * mass) ** 0.5
    inertia = torch.tensor([mass, mass, 1.815**-2 / 4 * mass * spacing**2], **like).expand(nb, 3)
    loading_rate = 0.001 * (k_stretch / mass) ** 0.5

    def loading(state, t, final_load):
        return final_load * torch.where(t < loading_rate**-1, t * loading_rate,
                                        torch.ones_like(t))

    solve = setup_dynamic_solver(
        geometry=geometry,
        energy_fn=build_strain_energy(bonds(), ligament_energy),
        loaded_block_DOF_pairs=np.array([[n1 - 1, 0], [nb - 1, 0]]),
        loading_fn=loading,
        constrained_block_DOF_pairs=np.array([[0, 0], [n1, 0]]),
        damped_blocks=np.arange(nb),
        method=method,
        n_substeps=128,
        quad_grid=None if method == "verlet" else dict(n1=n1, n2=geometry.n2_blocks,
                                                       use_contact=False),
    )
    angle = torch.tensor(0.0, **like)
    ref = rbv().to(**like)

    def control_params(strain):
        return ControlParams(
            geometrical_params=GeometricalParams(bc(angle), cnv(angle)),
            mechanical_params=MechanicalParams(
                bond_params=LigamentParams(
                    torch.tensor(k_stretch, **like), torch.tensor(1.851e-2 * k_stretch, **like),
                    torch.tensor(1.534e-4 / 4 * k_stretch * spacing**2, **like), ref),
                density=torch.tensor(1.0, **like),
                inertia=inertia,
                damping=damping,
            ),
            loading_params=dict(final_load=torch.tensor(strain * spacing * k_stretch, **like)),
        )

    timepoints = torch.as_tensor(np.linspace(0.0, 3 / loading_rate, 100), **like)
    state0 = torch.zeros((2, nb, 3), **like)
    gauge = spacing * (n1 - 1)

    def tip_strain(fields):
        return float(fields[-1, 0, n1 - 1, 0]) / gauge

    return solve, control_params, state0, timepoints, tip_strain


# ---------------------------------------------------------------------------
# examples/configs/pulse_forward.json: reference_design
# ---------------------------------------------------------------------------

#: examples/configs/pulse_forward.json.
PULSE_FORWARD_CONFIG = {
    "problem": "reference_design",
    "forward": {
        "n1_cells": 10, "n2_cells": 5, "spacing": 1.0, "bond_length": 0.1,
        "initial_angle": 0.4363323129985824, "k_stretch": 1.0, "k_shear": 0.02,
        "k_rot": 0.001, "density": 1.0, "damping": 0.02, "amplitude": 0.2,
        "loading_rate": 0.5, "input_delay": 0.0, "n_excited_blocks": 2,
        "loaded_side": "left", "simulation_time": 15.0, "n_timepoints": 100,
        "n_substeps": 10,
    },
    "optimize": {"method": "forward"},
}

#: JAX float64 summary of the configuration's fields (T, 2, n_blocks, 3) at
#: the initial angle.
JAX_F64_REFERENCE_DESIGN_STATS = (5.230798732094517, 114.04958021920929, -7.572560119427797)


def reference_design_problem(device="cuda", dtype=torch.float64, method="verlet_pallas",
                             **overrides) -> ForwardProblem:
    """The configuration's ``reference_design.ForwardProblem``, set up;
    ``method`` replaces the configuration's default (the dense
    ``"verlet"``), ``overrides`` any other field."""

    kwargs = dict(PULSE_FORWARD_CONFIG["forward"], method=method, **overrides)
    problem = ForwardProblem(**kwargs, device=device, dtype=dtype)
    problem.setup()
    return problem


# ---------------------------------------------------------------------------
# Dense reference runs (for worker processes)
# ---------------------------------------------------------------------------


def dense_reference(name: str, strain=None):
    """The dense ``method="verlet"`` run of ``"pulse"`` (fields at the
    example's inputs) or ``"tensile"`` (at ``strain``) on the CPU at float64,
    on one thread: ``(fields as numpy, seconds)``. A worker process of
    ``chip_smoke.py`` runs it beside the card's fused runs."""

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    with torch.no_grad():
        if name == "pulse":
            _, fields = pulse_kinetic_energy(pulse_problem("cpu", torch.float64, "verlet"),
                                             *pulse_inputs("cpu", torch.float64))
        else:
            solve, control_params, state0, timepoints, _ = tensile_problem(
                "cpu", torch.float64, "verlet")
            fields = solve(state0, timepoints, control_params(strain))
    return fields.numpy(), time.perf_counter() - t0
