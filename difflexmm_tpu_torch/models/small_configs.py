"""Small configurations shared by the CPU tests of the optimizer and of the
solver remnants and by ``chip_smoke.py`` main path 13.

``CHECKPOINT_PROBLEM``: the 6 x 6 quads focusing problem of the JAX
package's checkpoint/resume test (``tests/test_observability.py:43-80``),
and ``CHECKPOINT_MMA``, its constrained MMA: two iterations with a metrics
logger and a checkpoint every iteration, then a fresh problem resuming for
one more. The JAX history of that run (method ``"verlet_ckpt"``, the plane
layout kernel 1g runs; the runner's ``guard="auto"``) was recorded at
float64 on the CPU by ``tests/jax_optimizer_references.py``; the slow test
``tests/test_torch_observability.py::test_optimizer_references_match_jax``
makes it again and checks these constants.

``remnant_problem``: a 4 x 3 quad lattice on the dense path with
distance-based contact, a pulse on its left column and node loads on its
right column (``ops.loading.build_node_loading``), for the dense ``"rk4"``,
``"semi_implicit"`` and guarded ``"verlet"``.
"""

import numpy as np
import torch

from difflexmm_tpu_torch.geometry.quad import QuadGeometry
from difflexmm_tpu_torch.models import base
from difflexmm_tpu_torch.models.quads_focusing import ForwardProblem, OptimizationProblem
from difflexmm_tpu_torch.ops.assembly import build_strain_energy, combine_block_energies
from difflexmm_tpu_torch.ops.bonds import ligament_energy
from difflexmm_tpu_torch.ops.contact import build_contact_energy
from difflexmm_tpu_torch.ops.loading import build_node_loading
from difflexmm_tpu_torch.solver.dynamics import setup_dynamic_solver
from difflexmm_tpu_torch.utils.types import (
    ContactParams,
    ControlParams,
    GeometricalParams,
    LigamentParams,
    MechanicalParams,
)

#: The 6 x 6 problem (``ForwardProblem`` keywords without method, device
#: and dtype) and its target patch.
CHECKPOINT_PROBLEM = dict(
    n1_blocks=6, n2_blocks=6, spacing=1.0, bond_length=0.1, k_stretch=1.0, k_shear=0.02,
    k_rot=1e-3, density=1.0, damping=0.02, amplitude=0.15, loading_rate=2.0, input_delay=0.0,
    n_excited_blocks=2, loaded_side="left", simulation_time=2.0, n_timepoints=6,
    n_substeps=16,
)
CHECKPOINT_TARGET = (2, 2)
#: Its design: the rotated square at 0.25 rad.
CHECKPOINT_ANGLE = 0.25
#: ``run_optimization_mma`` keywords of both runs (the runner's default
#: ``guard="auto"``), with the fabrication constraints of the JAX package's
#: expiry test so that per-group violations are recorded.
CHECKPOINT_MMA = dict(lower_bound=-0.3, upper_bound=0.3, min_void_angle=0.0,
                      min_block_angle=0.0, min_edge_length=0.05, verbose=False)
#: Iterations of the first run and of the resumed one.
CHECKPOINT_ITERATIONS = (2, 1)

#: The JAX history of the three entries: objectives, each design as
#: ``flagship.vector_stats`` of its change from the start, and each
#: group's largest constraint value.
#: The resumed run starts from the snapshot's design, the last evaluated,
#: with a fresh MMA state, so its first entry repeats the second.
JAX_F64_CHECKPOINT_VALUES = (1.6888037460022092e-05, 0.0001296304564428818,
                             0.0001296304564428818)
JAX_F64_CHECKPOINT_DESIGN_STATS = (
    (0.0, 0.0, 0.0),
    (0.3281222222046852, -0.3836512622861606, 0.30122328526394787),
    (0.3281222222046852, -0.3836512622861606, 0.30122328526394787),
)
JAX_F64_CHECKPOINT_VIOLATIONS = {
    "angles": (-1.0707963267948966, -0.7613303918548984, -0.7613303918548984),
    "edge_lengths": (-0.6068148872983957, -0.40821095281415315, -0.40821095281415315),
}


def checkpoint_problem(method="auto", device="cuda", dtype=torch.float64):
    """(OptimizationProblem of the 6 x 6 problem with its objective set up,
    its design)."""

    problem = ForwardProblem(**CHECKPOINT_PROBLEM, method=method, device=device, dtype=dtype)
    optimization = OptimizationProblem(problem, target_size=CHECKPOINT_TARGET)
    optimization.setup_objective()
    design = problem.geometry.get_design_from_rotated_square(CHECKPOINT_ANGLE, device=device,
                                                             dtype=dtype)
    return optimization, design


#: The remnant lattice: 4 x 3 quads, the pulse on the left column's x,
#: node forces on the right column's corners 0 (x) and 1 (y).
REMNANT_N1, REMNANT_N2 = 4, 3
REMNANT_TIMEPOINTS = np.linspace(0.0, 1.2, 5)
REMNANT_SUBSTEPS = 4
#: Distance-based barrier: asymptote at 0, cutoff at 0.12 (a bond is 0.1
#: long), stiffness 1e-3, so that it acts at every hinge.
REMNANT_CONTACT = (0.0, 0.12, 1e-3)
#: Guards of the dense "verlet", each firing on a part of the substeps:
#: travel only, two levels deep; and gated on the void angles' proximity
#: (the hard term forced on at five times the threshold).
REMNANT_GUARDS = {
    "travel_levels2": dict(threshold=3e-3, refine=2, levels=2, length_scale=1.0),
    "proximity": dict(threshold=2e-3, proximity=0.66, refine=4),
}

#: The remnant runs: name -> (method, key of REMNANT_GUARDS or None).
REMNANT_RUNS = {"rk4": ("rk4", None), "semi_implicit": ("semi_implicit", None),
                "verlet": ("verlet", None),
                "verlet_travel_levels2": ("verlet", "travel_levels2"),
                "verlet_proximity": ("verlet", "proximity")}


def remnant_design(seed=5):
    """The remnant lattice's design (numpy): hinge shifts of 0.03 standard
    deviation about the rotated square at 0.3 rad."""

    geometry = QuadGeometry(REMNANT_N1, REMNANT_N2)
    rng = np.random.default_rng(seed)
    return [x.numpy() + 0.03 * rng.standard_normal(tuple(x.shape))
            for x in geometry.get_design_from_rotated_square(0.3, device="cpu")]


def remnant_problem(design, method="rk4", guard=None, device="cuda", dtype=torch.float64):
    """``(solve, control_params, state0, timepoints)`` of the remnant
    lattice at ``design`` (two tensors; the node loads act on its corner
    vectors, so the gradient reaches them through the loads too).
    ``method=None`` leaves the solver's default."""

    n1, n2 = REMNANT_N1, REMNANT_N2
    like = dict(device=device, dtype=dtype)
    geometry = QuadGeometry(n1, n2)
    bc, cnv, bonds, rbv = geometry.get_parametrization()
    energy = combine_block_energies(build_strain_energy(bonds(), ligament_energy),
                                    build_contact_energy(bonds(), angle_based=False))
    left = np.arange(n2) * n1
    right = left + n1 - 1
    driven = np.stack([left, 0 * left], axis=1)
    triples = np.concatenate([np.stack([right, 0 * right, 0 * right], axis=1),
                              np.stack([right, 1 + 0 * right, 1 + 0 * right], axis=1)])
    loaded = base.all_dofs_pairs(right)
    node_vectors = cnv(*design)
    node_loading = build_node_loading(geometry, triples, lambda state, t, force: force * t)

    def loading_fn(state, t, force):
        forces = node_loading(state, t, dict(force=force), node_vectors)
        return forces[loaded[:, 0], loaded[:, 1]]

    def drive(t, amplitude, rate):
        return base.pulse(t, amplitude, rate)

    solve = setup_dynamic_solver(
        geometry=geometry, energy_fn=energy, loaded_block_DOF_pairs=loaded,
        loading_fn=loading_fn, constrained_block_DOF_pairs=driven, constrained_DOFs_fn=drive,
        damped_blocks=np.arange(geometry.n_blocks), n_substeps=REMNANT_SUBSTEPS, guard=guard,
        **({} if method is None else dict(method=method)))

    def scalar(x):
        return torch.tensor(x, **like)

    control_params = ControlParams(
        geometrical_params=GeometricalParams(bc(*design), node_vectors),
        mechanical_params=MechanicalParams(
            bond_params=LigamentParams(scalar(1.0), scalar(0.02), scalar(1e-3), rbv().to(**like)),
            density=scalar(1.0), damping=scalar(0.05),
            contact_params=ContactParams(*(scalar(x) for x in REMNANT_CONTACT))),
        loading_params=dict(force=scalar(0.02)),
        constraint_params=dict(amplitude=scalar(0.05), rate=scalar(1.5)),
    )
    state0 = torch.zeros((2, geometry.n_blocks, 3), **like)
    return solve, control_params, state0, torch.tensor(REMNANT_TIMEPOINTS, **like)


def remnant_run(name, device="cuda", dtype=torch.float64, default_method=False):
    """Run ``name`` of REMNANT_RUNS at :func:`remnant_design`: ``(solve,
    fields, value, design gradient)``, the value ``sum V^2`` over the
    trajectory. ``default_method``: leave the solver's default method."""

    method, guard = REMNANT_RUNS[name]
    design = [torch.tensor(x, device=device, dtype=dtype, requires_grad=True)
              for x in remnant_design()]
    spec = None if guard is None else REMNANT_GUARDS[guard]
    solve, control_params, state0, timepoints = remnant_problem(
        design, None if default_method else method, spec, device, dtype)
    fields = solve(state0, timepoints, control_params)
    value = torch.sum(fields[:, 1] ** 2)
    return solve, fields, value, torch.autograd.grad(value, design)
