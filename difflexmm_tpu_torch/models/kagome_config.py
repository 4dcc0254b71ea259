"""The documented kagome configuration: 16 x 16 kagome cells focusing a
raised-cosine pulse onto a 3 x 3 target patch, and its guarded constrained
MMA run.

``KAGOME_CONFIG`` is a copy of ``examples/configs/kagome_focusing.json``
(the file ``python -m difflexmm_tpu.run`` takes; a test checks that the two
agree), copied rather than read so that the port needs nothing of the JAX
package's tree. The reference values below were made with the JAX package
at float64 on the CPU (method "verlet_ckpt"); the slow test
``tests/test_torch_kagome.py::test_kagome_references_match_jax`` makes them
again and checks these constants. Summaries ``(|v|, sum v, v . r)`` are
``models/flagship.vector_stats``'s.
"""

import numpy as np
import torch

from difflexmm_tpu_torch.geometry.kagome import KagomePeriodicGeometry
from difflexmm_tpu_torch.geometry.polygon import compute_inertia
from difflexmm_tpu_torch.models.kagome_focusing import ForwardProblem, OptimizationProblem
from difflexmm_tpu_torch.ops.observables import trajectory_kinetic_energy
from difflexmm_tpu_torch.utils.types import GeometricalParams

#: examples/configs/kagome_focusing.json.
KAGOME_CONFIG = {
    "problem": "kagome_focusing",
    "forward": {
        "n1_cells": 16, "n2_cells": 16, "cell_size": 1.0,
        "cell_angle": 1.0471975511965976, "bond_length": 0.05,
        "k_stretch": 1.0, "k_shear": 0.02, "k_rot": 1e-3, "density": 1.0,
        "damping": 0.02, "amplitude": 0.2, "loading_rate": 0.5,
        "input_delay": 0.0, "n_excited_blocks": 4,
        "simulation_time": 20.0, "n_timepoints": 200, "n_substeps": 10,
        "method": "verlet_pallas",
    },
    "optimization": {"target_size": [3, 3]},
    "initial_design": {"zero": True},
    "optimize": {
        "method": "mma", "n_iterations": 10,
        "lower_bound": -0.2, "upper_bound": 0.2,
        "min_edge_length": 0.05, "move_limit": 0.05,
    },
}

#: The configuration's ``run_optimization_mma`` keywords (its "optimize"
#: section without the method and the iteration count), with the runner's
#: default ``guard="auto"`` written out. With ``"auto"`` the guard has
#: window 5 degrees (contact between 0 and 5 degrees), threshold 0.02
#: window, proximity 2 windows, hard 0.1 window and length_scale cell_size.
KAGOME_MMA_SETTINGS = dict(
    lower_bound=-0.2,
    upper_bound=0.2,
    min_edge_length=0.05,
    move_limit=0.05,
    guard="auto",
)

#: JAX float64 objective at the zero design (the regular kagome), unguarded
#: and with ``guard="auto"``; and the design gradient of the unguarded one.
JAX_F64_OBJECTIVE = 0.015506990205992116
JAX_F64_GUARDED_OBJECTIVE = 0.015530548649130007
JAX_F64_GRAD_STATS = (0.19989447728615325, 1.1102230246251565e-16, 0.2529890542078798)

#: The JAX package's float64 ``run_optimization_mma`` from the zero design
#: with KAGOME_MMA_SETTINGS for 2 iterations: the objective of each
#: iteration, each iterate's change from the zero design and the guarded
#: design gradient at each iterate as summaries, and the number of output
#: intervals (of 199) in which the guard fired at each iterate.
JAX_F64_MMA_VALUES = (0.015530548649130007, 0.028705547152275343)
JAX_F64_MMA_DESIGN_STATS = (
    (0.0, 0.0, 0.0),
    (0.6065862121728233, -0.4523318701469635, -0.03997090044243706),
)
JAX_F64_MMA_GRAD_STATS = (
    (0.11137376458597598, 0.0, -0.047790282682519405),
    (0.1782173903840901, 1.3877787807814457e-17, 0.07879581539254485),
)
JAX_F64_MMA_FIRED = (18, 20)


def kagome_config(device="cuda", dtype=torch.float64, guard=None, method=None) -> dict:
    """The configuration's ForwardProblem kwargs, on ``device`` in
    ``dtype``; ``method`` replaces the configuration's where given."""

    kwargs = dict(KAGOME_CONFIG["forward"], device=device, dtype=dtype, guard=guard)
    if method is not None:
        kwargs["method"] = method
    return kwargs


def build_kagome(device="cuda", dtype=torch.float64, guard=None, method=None):
    """(OptimizationProblem with its objective set up, initial design): the
    configuration at the zero design."""

    problem = ForwardProblem(**kagome_config(device, dtype, guard, method))
    optimization = OptimizationProblem(
        problem, target_size=tuple(KAGOME_CONFIG["optimization"]["target_size"])
    )
    optimization.setup_objective()
    return optimization, problem.geometry.zero_design(device=device, dtype=dtype)


#: The periodic kagome (``KagomePeriodicGeometry``, one (3, 2) shift triple
#: for every cell) under the configuration's physics, drive and target
#: (:func:`build_periodic_kagome`), at the shift triple
#: PERIODIC_SHIFTS_SCALE * standard normal from numpy's
#: ``default_rng(PERIODIC_SHIFTS_SEED)``: the JAX package's float64
#: objective (method "verlet_ckpt") and its gradient with respect to the
#: triple (row-major), made by ``tests/jax_optimizer_references.py``.
PERIODIC_SHIFTS_SEED = 11
PERIODIC_SHIFTS_SCALE = 0.02
JAX_F64_PERIODIC_OBJECTIVE = 0.018814646559642136
JAX_F64_PERIODIC_GRAD = (-0.04468650410220183, 0.04854945698622869, -0.07592448037457301,
                         -0.1029425317813825, 0.12061098447677486, 0.05439307479515379)


def periodic_shifts(device="cuda", dtype=torch.float64):
    """The shift triple of JAX_F64_PERIODIC_OBJECTIVE."""

    rng = np.random.default_rng(PERIODIC_SHIFTS_SEED)
    return torch.tensor(PERIODIC_SHIFTS_SCALE * rng.standard_normal((3, 2)), device=device,
                        dtype=dtype)


def build_periodic_kagome(device="cuda", dtype=torch.float64, guard=None, method=None,
                          **changes):
    """``objective(shifts) -> scalar`` (or ``(B,)`` for ``(B, 3, 2)``
    triples): the configuration's target kinetic energy with the lattice
    made by ``KagomePeriodicGeometry`` (the same basis and bond length)
    from one shift triple. It runs through the configuration's solver, the
    kagome grid's fast path (kernel 1K on the card): the grid energy is the
    same, only the geometry's leaves differ. ``changes``: ForwardProblem
    keywords that cut the configuration to size."""

    kwargs = dict(kagome_config(device, dtype, guard, method), **changes)
    problem = ForwardProblem(**kwargs)
    optimization = OptimizationProblem(
        problem, target_size=tuple(KAGOME_CONFIG["optimization"]["target_size"]))
    optimization.setup_objective()
    geometry = KagomePeriodicGeometry(problem.n1_cells, problem.n2_cells,
                                      direct_basis=problem.geometry.direct_basis,
                                      bond_length=problem.bond_length)
    block_centroids, centroid_node_vectors, _, _ = geometry.get_parametrization()
    physics = problem.control_params(problem.geometry.zero_design(device=device, dtype=dtype))
    target = torch.as_tensor(optimization.target_blocks, device=torch.device(device))

    def objective(shifts):
        cnv = centroid_node_vectors(shifts)
        control_params = physics._replace(
            geometrical_params=GeometricalParams(block_centroids(shifts), cnv))
        fields = problem.solve_dynamics(problem.state0, problem.timepoints, control_params)
        inertia = compute_inertia(cnv, problem.density)
        return trajectory_kinetic_energy(fields[..., 1, target, :],
                                         inertia[..., None, target, :])

    return objective
