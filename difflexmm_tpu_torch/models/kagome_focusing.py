"""Energy focusing on a free (non-periodic) kagome lattice (counterpart of
``difflexmm_tpu/models/kagome_focusing.py:40-324``).

The same solver path as quads focusing on another geometry: the design is
the three hinge-shift grids of ``KagomeGeometry``. Block ``2 * cell`` is the
"down" triangle and ``2 * cell + 1`` the "up" one; the left-edge drive acts
on the down triangles of the first column, and the target is both
triangles of each target cell.
"""

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from difflexmm_tpu_torch.geometry.kagome import KagomeGeometry
from difflexmm_tpu_torch.geometry.polygon import compute_inertia
from difflexmm_tpu_torch.models import base
from difflexmm_tpu_torch.models.runner import OptimizationRunnerMixin
from difflexmm_tpu_torch.ops.kagome_grid import build_kagome_grid_energy
from difflexmm_tpu_torch.ops.observables import trajectory_kinetic_energy
from difflexmm_tpu_torch.solver.dynamics import FAST_METHODS, setup_dynamic_solver
from difflexmm_tpu_torch.utils.types import (
    ContactParams,
    ControlParams,
    GeometricalParams,
    LigamentParams,
    MechanicalParams,
    SolutionData,
)


def _kagome_corner_pairs(n1: int, n2: int, n_clamped: int) -> np.ndarray:
    """All-DOF pairs clamping the four corner fans of a kagome lattice.

    Down triangles (2c) along the bottom-left row and column; at the
    bottom-right the row takes down triangles and the column up triangles;
    mirrored at the top.
    """

    n = n_clamped
    n_cells = n1 * n2
    bl = np.concatenate([np.arange(n) * 2, np.arange(1, n) * n1 * 2])
    br = np.concatenate([np.arange(n1 - n, n1) * 2, (np.arange(0, n) + 1) * 2 * n1 - 1])
    tr = np.concatenate([np.arange(n_cells - n, n_cells) * 2 + 1,
                         (n_cells - np.arange(1, n) * n1 - 1) * 2 + 1])
    tl = np.concatenate([np.arange(n_cells - n1, n_cells - n1 + n) * 2 + 1,
                         (n_cells - n1 - np.arange(0, n) * n1) * 2])
    return base.all_dofs_pairs(np.concatenate([bl, br, tr, tl]))


@dataclass
class ForwardProblem:
    """Pulse-driven kagome lattice with clamped corners.

    ``setup()`` installs ``self.solve(design) -> SolutionData`` where
    ``design = (shifts_1, shifts_2, shifts_3)``, tensors on ``device`` in
    ``dtype`` (every physical parameter is cast to them). A population of
    B designs, each shift grid with a leading dimension B, solves in one
    call on the fast path. ``device`` is the CUDA device unless the caller
    asks for the CPU. ``method``: one of ``solver.dynamics.FAST_METHODS``
    (the grid fast path) or the dense ``"verlet"`` on the gridded energy
    (``grid_energy``) or the bond-list energy. ``guard``: None, ``"auto"``
    or a spec dict (``base.resolve_model_guard``, travel scaled by
    ``cell_size``; the dense ``"verlet"`` takes it on the dense layout,
    translation "absolute").
    ``setup(excited_blocks_fn)`` replaces the pulse by
    ``excited_blocks_fn(t)`` of a scalar time.
    """

    # Geometry
    n1_cells: int
    n2_cells: int
    cell_size: Any
    cell_angle: Any
    bond_length: Any

    # Mechanical
    k_stretch: Any
    k_shear: Any
    k_rot: Any
    density: Any
    damping: Any

    # Dynamic loading
    amplitude: Any
    loading_rate: Any
    input_delay: Any
    n_excited_blocks: int
    loaded_side: str = "left"
    input_shift: int = 0

    # Analysis
    simulation_time: Any = 1.0
    n_timepoints: int = 100
    linearized_strains: bool = False

    # Contact
    use_contact: bool = True
    k_contact: Any = 1.0
    min_angle: Any = 0.0
    cutoff_angle: Any = 5.0 * math.pi / 180

    n_blocks_clamped_corner: int = 2

    solution_data: Optional[Union[SolutionData, List[SolutionData]]] = None

    # Solver configuration.
    method: str = "auto"
    n_substeps: int = 20
    # The dense "verlet" path's energy: gather-free on the cell grid, or
    # assembled over the bond list (the fast path has its own).
    grid_energy: bool = True
    guard: Any = None
    device: Any = "cuda"
    dtype: Any = torch.float64

    is_setup: bool = False
    name: str = "kagome_focusing"

    def setup(self, excited_blocks_fn: Optional[Callable] = None) -> None:
        like = dict(device=torch.device(self.device), dtype=self.dtype)
        geometry = KagomeGeometry(
            n1_cells=self.n1_cells,
            n2_cells=self.n2_cells,
            direct_basis=float(self.cell_size) * np.array(
                [[1.0, 0.0], [math.cos(self.cell_angle), math.sin(self.cell_angle)]]
            ),
            bond_length=self.bond_length,
        )
        block_centroids, centroid_node_vectors, bond_connectivity, reference_bond_vectors = (
            geometry.get_parametrization()
        )
        bonds = bond_connectivity()
        ref_bond_vectors = reference_bond_vectors().to(**like)

        if self.loaded_side != "left":
            raise ValueError(
                f"Unknown loaded_side: {self.loaded_side}. Only 'left' is implemented."
            )
        k = self.n_excited_blocks
        rows = np.arange((self.n2_cells - k) // 2 + self.input_shift,
                         (self.n2_cells + k) // 2 + self.input_shift)
        driven_blocks = rows * 2 * self.n1_cells  # down triangle, first column
        driven_pairs = base.all_dofs_pairs(driven_blocks)
        clamped_pairs = _kagome_corner_pairs(
            self.n1_cells, self.n2_cells, self.n_blocks_clamped_corner
        )
        base.check_disjoint_constrained_pairs(
            driven=driven_pairs, clamped_corners=clamped_pairs
        )
        constrained_pairs = np.concatenate([driven_pairs, clamped_pairs])
        drive_vector = torch.as_tensor(
            np.concatenate([np.ones(k), np.zeros(2 * k), np.zeros(len(clamped_pairs))]), **like
        )

        if excited_blocks_fn is None:
            def constrained_DOFs_fn(t, amplitude, loading_rate, input_delay):
                return base.pulse(t - input_delay, amplitude, loading_rate) * drive_vector
        else:
            def constrained_DOFs_fn(t, **kwargs):
                return excited_blocks_fn(t) * drive_vector

        energy = base.dense_energy(build_kagome_grid_energy, self.n1_cells, self.n2_cells,
                                   bonds, self.linearized_strains, self.use_contact,
                                   self.grid_energy)
        kagome_grid = (
            dict(
                n1=self.n1_cells,
                n2=self.n2_cells,
                linearized=self.linearized_strains,
                use_contact=self.use_contact,
            )
            if self.method in FAST_METHODS else None
        )
        solve_dynamics = setup_dynamic_solver(
            geometry=geometry,
            energy_fn=energy,
            constrained_block_DOF_pairs=constrained_pairs,
            constrained_DOFs_fn=constrained_DOFs_fn,
            damped_blocks=np.arange(geometry.n_blocks),
            method=self.method,
            n_substeps=self.n_substeps,
            kagome_grid=kagome_grid,
            guard=base.resolve_model_guard(
                self.guard, self.min_angle, self.cutoff_angle, self.cell_size
            ),
        )

        timepoints = torch.as_tensor(
            np.linspace(0.0, float(self.simulation_time), self.n_timepoints), **like
        )
        state0 = torch.zeros((2, geometry.n_blocks, 3), **like)

        def scalar(x):
            return torch.as_tensor(x, **like)

        bond_params = LigamentParams(
            k_stretch=scalar(self.k_stretch),
            k_shear=scalar(self.k_shear),
            k_rot=scalar(self.k_rot),
            reference_vector=ref_bond_vectors,
        )
        contact_params = ContactParams(
            min_angle=scalar(self.min_angle),
            cutoff_angle=scalar(self.cutoff_angle),
            k_contact=scalar(self.k_contact),
        )
        damping = torch.as_tensor(np.array(self.damping, dtype=np.float64), **like)

        def control_params(design) -> ControlParams:
            """The solver's parameters for a design (or a population)."""

            return ControlParams(
                geometrical_params=GeometricalParams(
                    block_centroids(*design), centroid_node_vectors(*design)
                ),
                mechanical_params=MechanicalParams(
                    bond_params=bond_params,
                    density=scalar(self.density),
                    damping=damping,
                    contact_params=contact_params,
                ),
                constraint_params=dict(
                    amplitude=scalar(self.amplitude),
                    loading_rate=scalar(self.loading_rate),
                    input_delay=scalar(self.input_delay),
                ),
            )

        def forward(design: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]) -> SolutionData:
            cp = control_params(design)
            gp = cp.geometrical_params
            return SolutionData(
                block_centroids=gp.block_centroids,
                centroid_node_vectors=gp.centroid_node_vectors,
                bond_connectivity=bonds,
                timepoints=timepoints,
                fields=solve_dynamics(state0, timepoints, cp),
            )

        self.solve = forward
        self.control_params = control_params
        self.solve_dynamics = solve_dynamics
        self.timepoints = timepoints
        self.state0 = state0
        self.geometry = geometry
        self.clamped_blocks_ids = np.unique(clamped_pairs[:, 0])
        self.driven_blocks_ids = np.unique(driven_pairs[:, 0])
        self.is_setup = True

    def to_dict(self) -> dict:
        return base.problem_to_dict(self)

    @staticmethod
    def from_dict(dict_in: dict) -> "ForwardProblem":
        return base.forward_problem_from_dict(ForwardProblem, dict_in)

    def to_data(self) -> "ForwardProblem":
        return base.problem_to_data(self)

    @staticmethod
    def from_data(problem_data) -> "ForwardProblem":
        problem_data.is_setup = False
        return problem_data


@dataclass
class OptimizationProblem(OptimizationRunnerMixin):
    """Maximize target-cell kinetic energy over the kagome hinge shifts
    (``run_optimization_mma`` and ``run_multistart_mma`` from the runner
    mixin). ``setup_objective()`` installs ``objective_fn(design) ->
    scalar`` and ``population_objective_fn(designs) -> (B,)``."""

    forward_problem: ForwardProblem
    target_size: Tuple[int, int]
    target_shift: Tuple[int, int] = (0, 0)
    objective_values: Optional[List[Any]] = None
    design_values: Optional[List[Any]] = None
    constraints_violation: Optional[Dict[str, List[Any]]] = None
    name: str = "kagome_focusing"
    is_setup: bool = False

    def __post_init__(self):
        self.objective_values = self.objective_values or []
        self.design_values = self.design_values or []
        self.constraints_violation = self.constraints_violation or {
            "angles": [], "edge_lengths": []
        }

    def _boundary_node_ids(self):
        raise NotImplementedError("Boundary angle constraints are quad-lattice specific.")

    def setup_objective(self) -> None:
        if not self.forward_problem.is_setup:
            self.forward_problem.setup()
        fp = self.forward_problem
        cells = base.target_patch_ids(fp.n1_cells, fp.n2_cells, self.target_size,
                                      self.target_shift)
        # Both triangles of each target cell.
        target_blocks = np.stack([2 * cells, 2 * cells + 1], axis=1).reshape(-1)
        target = torch.as_tensor(target_blocks, device=torch.device(fp.device))

        def target_kinetic_energy(designs):
            """Of one design (a scalar) or of a population (each design
            tensor with a leading dimension B, ``(B,)``)."""

            solution = fp.solve(designs)
            inertia = compute_inertia(solution.centroid_node_vectors, fp.density)
            return trajectory_kinetic_energy(solution.fields[..., 1, target, :],
                                             inertia[..., None, target, :])

        self.objective_fn = self.population_objective_fn = target_kinetic_energy
        self.target_blocks = target_blocks
        self.is_setup = True

    def to_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out["forward_problem"] = self.forward_problem.to_dict()
        return out

    @staticmethod
    def from_dict(dict_in: dict) -> "OptimizationProblem":
        return base.optimization_problem_from_dict(OptimizationProblem, ForwardProblem, dict_in)

    def to_data(self) -> "OptimizationProblem":
        return base.problem_to_data(self)

    @staticmethod
    def from_data(optimization_data) -> "OptimizationProblem":
        return base.optimization_problem_from_data(optimization_data, ForwardProblem)
