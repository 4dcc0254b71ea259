"""Multi-tasking by static pre-compression (counterpart of
``difflexmm_tpu/models/quads_static_tuning.py``): the lattice is
compressed quasi-statically between its clamped bottom and top edges,
then a delayed pulse is driven from the left edge; the design is
optimized for a weighted sum of per-scenario target kinetic energies
(negative weights protect a region).

Each scenario integrates two fixed-step phases, the static ramp on its own
timepoints and then the dynamics from the compressed state. The ramp's
timepoints depend on the scenario's compression, and the trajectory
kernels take one substep size a step for every row of a batch, so the
scenarios run one after another: two solves each (ROADMAP "static-tuning
scenarios as one launch").
"""

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from difflexmm_tpu_torch.geometry.polygon import compute_inertia
from difflexmm_tpu_torch.geometry.quad import QuadGeometry
from difflexmm_tpu_torch.models import base
from difflexmm_tpu_torch.models.runner import OptimizationRunnerMixin
from difflexmm_tpu_torch.ops.grid import build_quad_grid_energy
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


def linspace(start, stop, num: int, like: dict) -> torch.Tensor:
    """``num`` points from ``start`` to ``stop`` with the JAX package's
    arithmetic (``start (1 - i / d) + stop i / d``, the last point
    ``stop``)."""

    start, stop = (torch.as_tensor(x, **like) for x in (start, stop))
    div = num - 1
    step = torch.arange(div, **like) / div
    return torch.cat([start * (1 - step) + stop * step, stop.reshape(1)])


@dataclass
class ForwardInput:
    """Per-scenario loading inputs (tuples of equal length, one entry a
    scenario)."""

    horizontal_shifts: Any
    vertical_shifts: Any
    amplitude: Tuple[Any, ...]
    loading_rate: Tuple[Any, ...]
    compressive_strain: Tuple[Any, ...]
    compressive_strain_rate: Tuple[Any, ...]


@dataclass
class ForwardProblem:
    """Compression-then-pulse quad lattice with clamped top and bottom
    edges. ``setup()`` installs ``solve_dynamic(design, amplitude,
    loading_rate, compressive_strain, compressive_strain_rate)`` (the
    dynamic phase, times relative to the pulse's start) and
    ``solve_full`` (both phases, absolute times; also ``solve``). A
    population of B designs (each shift grid ``(B, ...)``) solves in one
    call of each phase. ``device``, ``dtype``, ``method`` and ``guard`` as
    for quads focusing."""

    # Geometry
    n1_blocks: int
    n2_blocks: int
    spacing: Any
    bond_length: Any

    # Mechanical
    k_stretch: Any
    k_shear: Any
    k_rot: Any
    density: Any
    damping: Any

    # Dynamic loading
    n_excited_blocks: int
    input_shift: int = 0

    # Analysis
    simulation_time_dynamic: Any = 1.0
    n_timepoints: int = 100
    n_timepoints_static: int = 17
    linearized_strains: bool = False

    # Contact
    use_contact: bool = True
    k_contact: Any = 1.0
    min_angle: Any = 0.0
    cutoff_angle: Any = 5.0 * math.pi / 180

    solution_data: Optional[Union[SolutionData, List[SolutionData]]] = None

    method: str = "auto"
    n_substeps: int = 20
    grid_energy: bool = True
    guard: Any = None
    device: Any = "cuda"
    dtype: Any = torch.float64

    is_setup: bool = False
    name: str = "quads_kinetic_energy_static_tuning"

    def setup(self, excited_blocks_fn: Optional[Callable] = None) -> None:
        like = dict(device=torch.device(self.device), dtype=self.dtype)
        geometry = QuadGeometry(
            n1_blocks=self.n1_blocks,
            n2_blocks=self.n2_blocks,
            spacing=self.spacing,
            bond_length=self.bond_length,
        )
        bc_fn, cnv_fn, bond_fn, rbv_fn = geometry.get_parametrization()
        bonds = bond_fn()
        ref_bond_vectors = rbv_fn().to(**like)
        n1, n2 = self.n1_blocks, self.n2_blocks

        driven_pairs, _ = base.driven_side_pairs(
            n1, n2, self.n_excited_blocks, "left", self.input_shift
        )
        k = self.n_excited_blocks
        bottom_blocks = np.arange(n1)
        top_blocks = np.arange(n1 * (n2 - 1), n1 * n2)

        def edge_pairs(blocks):
            # The y DOF first, so that the compression drives a contiguous run.
            return np.stack([np.tile(blocks, 3), np.repeat([1, 0, 2], len(blocks))], axis=1)

        bottom_pairs = edge_pairs(bottom_blocks)
        top_pairs = edge_pairs(top_blocks)
        base.check_disjoint_constrained_pairs(
            driven=driven_pairs, bottom_edge=bottom_pairs, top_edge=top_pairs
        )
        constrained_pairs = np.concatenate([driven_pairs, bottom_pairs, top_pairs])

        n_con = len(constrained_pairs)
        dynamic_vector = np.zeros(n_con)
        dynamic_vector[:k] = 1.0
        static_vector = np.zeros(n_con)
        static_vector[3 * k:3 * k + n1] = 0.5  # bottom edge: +y
        static_vector[3 * k + 3 * n1:3 * k + 4 * n1] = -0.5  # top edge: -y
        dynamic_vector = torch.as_tensor(dynamic_vector, **like)
        static_vector = torch.as_tensor(static_vector, **like)
        gauge = (n2 - 1) * self.spacing

        if excited_blocks_fn is None:
            def drive_dynamic(t, amplitude, loading_rate):
                return base.pulse(t, amplitude, loading_rate) * dynamic_vector
        else:
            def drive_dynamic(t, *args, **kwargs):
                return excited_blocks_fn(t) * dynamic_vector

        def drive_static(t, compressive_strain, compressive_strain_rate):
            ramp = torch.where(t < compressive_strain / compressive_strain_rate,
                               t * compressive_strain_rate, compressive_strain)
            return gauge * ramp * static_vector

        def constrained_DOFs_fn(t, amplitude, loading_rate, compressive_strain,
                                compressive_strain_rate, input_delay):
            t_dynamic = t - compressive_strain / compressive_strain_rate - input_delay
            return (drive_static(t, compressive_strain, compressive_strain_rate)
                    + drive_dynamic(t_dynamic, amplitude, loading_rate))

        energy = base.dense_energy(build_quad_grid_energy, n1, n2, bonds,
                                   self.linearized_strains, self.use_contact, self.grid_energy)
        quad_grid = (
            dict(n1=n1, n2=n2, linearized=self.linearized_strains,
                 use_contact=self.use_contact)
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
            quad_grid=quad_grid,
            guard=base.resolve_model_guard(
                self.guard, self.min_angle, self.cutoff_angle, self.spacing
            ),
        )

        state0 = torch.zeros((2, geometry.n_blocks, 3), **like)

        def scalar(x):
            return torch.as_tensor(x, **like)

        mechanical_params = MechanicalParams(
            bond_params=LigamentParams(
                k_stretch=scalar(self.k_stretch),
                k_shear=scalar(self.k_shear),
                k_rot=scalar(self.k_rot),
                reference_vector=ref_bond_vectors,
            ),
            density=scalar(self.density),
            damping=torch.as_tensor(np.array(self.damping, dtype=np.float64), **like),
            contact_params=ContactParams(
                min_angle=scalar(self.min_angle),
                cutoff_angle=scalar(self.cutoff_angle),
                k_contact=scalar(self.k_contact),
            ),
        )

        def control_params(design, amplitude, loading_rate, compressive_strain,
                           compressive_strain_rate, input_delay) -> ControlParams:
            h, v = design
            return ControlParams(
                geometrical_params=GeometricalParams(bc_fn(h, v), cnv_fn(h, v)),
                mechanical_params=mechanical_params,
                constraint_params=dict(
                    amplitude=scalar(amplitude),
                    loading_rate=scalar(loading_rate),
                    compressive_strain=scalar(compressive_strain),
                    compressive_strain_rate=scalar(compressive_strain_rate),
                    input_delay=scalar(input_delay),
                ),
            )

        def phases(design, amplitude, loading_rate, compressive_strain,
                   compressive_strain_rate):
            """The static ramp on its own timepoints, then the dynamics from
            its last state: (t_start, static times, static fields, dynamic
            times, dynamic fields)."""

            input_delay = 0.1 / scalar(loading_rate)
            t_start = scalar(compressive_strain) / scalar(compressive_strain_rate) + input_delay
            cp = control_params(design, amplitude, loading_rate, compressive_strain,
                                compressive_strain_rate, input_delay)
            ts_static = linspace(0.0, t_start, self.n_timepoints_static, like)
            static_fields = solve_dynamics(state0, ts_static, cp)
            ts_dynamic = t_start + linspace(0.0, self.simulation_time_dynamic,
                                            self.n_timepoints, like)
            fields = solve_dynamics(static_fields[..., -1, :, :, :], ts_dynamic, cp)
            return t_start, ts_static, static_fields, ts_dynamic, fields

        def solution(design, timepoints, fields) -> SolutionData:
            h, v = design
            return SolutionData(
                block_centroids=bc_fn(h, v),
                centroid_node_vectors=cnv_fn(h, v),
                bond_connectivity=bonds,
                timepoints=timepoints,
                fields=fields,
            )

        def solve_dynamic(design, amplitude, loading_rate, compressive_strain,
                          compressive_strain_rate) -> SolutionData:
            """The dynamic phase only (the optimization's path), its times
            relative to the pulse's start."""

            t_start, _, _, ts_dynamic, fields = phases(
                design, amplitude, loading_rate, compressive_strain, compressive_strain_rate)
            return solution(design, ts_dynamic - t_start, fields)

        def solve_full(design, amplitude, loading_rate, compressive_strain,
                       compressive_strain_rate) -> SolutionData:
            """Both phases, absolute times."""

            _, ts_static, static_fields, ts_dynamic, fields = phases(
                design, amplitude, loading_rate, compressive_strain, compressive_strain_rate)
            return solution(design, torch.cat([ts_static, ts_dynamic[1:]]),
                            torch.cat([static_fields, fields[..., 1:, :, :, :]], dim=-4))

        self.solve_dynamic = solve_dynamic
        self.solve_full = solve_full
        self.solve = solve_full
        self.solve_dynamics = solve_dynamics
        self.geometry = geometry
        self.clamped_blocks_ids = np.unique(np.concatenate([bottom_pairs, top_pairs])[:, 0])
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
    """The weighted sum over ``forward_input``'s scenarios of each one's
    target kinetic energy in the dynamic phase, on one shared design.
    ``objective_fn(design)`` and ``population_objective_fn(designs) ->
    (B,)`` are one function; ``objective_fn_individual`` gives each
    scenario's value."""

    forward_problem: ForwardProblem
    forward_input: ForwardInput
    target_sizes: Tuple[Tuple[int, int], ...]
    target_shifts: Tuple[Tuple[int, int], ...]
    weights: Tuple[float, ...]
    objective_values: Optional[List[Any]] = None
    objective_values_individual: Optional[List[Any]] = None
    design_values: Optional[List[Any]] = None
    constraints_violation: Optional[Dict[str, List[Any]]] = None
    name: str = "quads_kinetic_energy_static_tuning"
    is_setup: bool = False

    def __post_init__(self):
        self.objective_values = self.objective_values or []
        self.objective_values_individual = self.objective_values_individual or []
        self.design_values = self.design_values or []
        self.constraints_violation = self.constraints_violation or {
            "angles": [], "edge_lengths": []
        }

    def _scenarios(self):
        fi = self.forward_input
        return list(zip(fi.amplitude, fi.loading_rate, fi.compressive_strain,
                        fi.compressive_strain_rate))

    def setup_objective(self, mesh=None) -> None:
        """Install the weighted multi-scenario objective; ``mesh``
        (scenarios sharded over several cards) is ROADMAP A11."""

        if mesh is not None:
            raise NotImplementedError("scenarios sharded over several cards are ROADMAP A11")
        if not self.forward_problem.is_setup:
            self.forward_problem.setup()
        fp = self.forward_problem
        like = dict(device=torch.device(fp.device), dtype=fp.dtype)
        target_blocks = np.asarray([
            base.target_patch_ids(fp.n1_blocks, fp.n2_blocks, size, shift)
            for size, shift in zip(self.target_sizes, self.target_shifts)
        ])
        targets = [torch.as_tensor(t, device=like["device"]) for t in target_blocks]
        scenarios = self._scenarios()
        weights = torch.as_tensor(self.weights, **like)

        def individual(design):
            values = []
            for scenario, target in zip(scenarios, targets):
                solution = fp.solve_dynamic(design, *scenario)
                inertia = compute_inertia(solution.centroid_node_vectors, fp.density)
                values.append(trajectory_kinetic_energy(solution.fields[..., 1, target, :],
                                                        inertia[..., None, target, :]))
            return torch.stack(values)

        def total_objective(design):
            return torch.tensordot(weights, individual(design), dims=1)

        self.objective_fn = self.population_objective_fn = total_objective
        self.objective_fn_individual = individual
        self.target_blocks = target_blocks
        self.is_setup = True

    def compute_best_forward(self):
        """Both phases of every scenario at the last design of the history
        (a list of solutions)."""

        if not self.design_values:
            raise ValueError("No design has been optimized yet.")
        if not self.forward_problem.is_setup:
            self.forward_problem.setup()
        best = self.design_values[-1]
        with torch.no_grad():
            self.forward_problem.solution_data = [
                self.forward_problem.solve_full(best, *scenario) for scenario in self._scenarios()
            ]
        return self.forward_problem.solution_data

    def to_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out["forward_problem"] = self.forward_problem.to_dict()
        return out

    @staticmethod
    def from_dict(dict_in: dict) -> "OptimizationProblem":
        return base.optimization_problem_from_dict(OptimizationProblem, ForwardProblem, dict_in,
                                                   forward_input=ForwardInput)

    def to_data(self) -> "OptimizationProblem":
        return base.problem_to_data(self)

    @staticmethod
    def from_data(optimization_data) -> "OptimizationProblem":
        return base.optimization_problem_from_data(optimization_data, ForwardProblem)
