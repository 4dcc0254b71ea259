"""Energy focusing on a quad lattice: the flagship inverse-design problem
(counterpart of ``difflexmm_tpu/models/quads_focusing.py``).

A pulse enters from one side of an aperiodic quad lattice; the design
(hinge shift grids) is optimized to maximize the kinetic energy delivered
to a target patch. This module ports the forward problem, its loading
scenarios (B pulse amplitudes and rates in one solve), the response data,
the objective and its population form (B designs in one solve) and the
robustness map; the constraints, the MMA loop and the multistart loop
come from ``models/runner.py``.
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
from difflexmm_tpu_torch.ops.observables import (
    compute_ligament_strains_history,
    trajectory_kinetic_energy,
)
from difflexmm_tpu_torch.solver.dynamics import FAST_METHODS, setup_dynamic_solver
from difflexmm_tpu_torch.utils.types import (
    ContactParams,
    ControlParams,
    GeometricalParams,
    LigamentParams,
    MechanicalParams,
    SolutionData,
)


@dataclass
class ForwardProblem:
    """Pulse-driven quad lattice with clamped corners.

    ``setup()`` installs ``self.solve(design) -> SolutionData`` where
    ``design = (horizontal_shifts, vertical_shifts)``, tensors on
    ``device`` in ``dtype`` (every physical parameter is cast to them).
    A population of B designs, each shift grid with a leading dimension B,
    solves in one call on the fast path (fields ``(B, T, 2, n_blocks,
    3)``). ``self.solve_scenario(design, amplitude, loading_rate)`` takes
    the pulse's amplitude and rate: tensors of shape ``(B,)`` make B
    scenarios, solved in one call on the fast path (one kernel launch on
    the card). ``setup(excited_blocks_fn)`` replaces the pulse by
    ``excited_blocks_fn(t)`` of a scalar time. ``device`` is the CUDA
    device unless the caller asks for the CPU. ``method``: one of
    ``solver.dynamics.FAST_METHODS`` (the grid fast path) or the dense
    ``"verlet"`` on the gridded energy (``grid_energy``) or the bond-list
    energy. ``guard``: None, ``"auto"``
    or a spec dict (``base.resolve_model_guard``; the dense ``"verlet"``
    takes it on the dense layout, translation "absolute").
    """

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
    amplitude: Any
    loading_rate: Any
    input_delay: Any
    n_excited_blocks: int
    loaded_side: str
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
    # The dense "verlet" path's energy: gather-free on the block grid, or
    # assembled over the bond list (the fast path has its own).
    grid_energy: bool = True
    guard: Any = None
    device: Any = "cuda"
    dtype: Any = torch.float64

    is_setup: bool = False
    name: str = "quads_focusing"

    def setup(self, excited_blocks_fn: Optional[Callable] = None) -> None:
        like = dict(device=torch.device(self.device), dtype=self.dtype)
        geometry = QuadGeometry(
            n1_blocks=self.n1_blocks,
            n2_blocks=self.n2_blocks,
            spacing=self.spacing,
            bond_length=self.bond_length,
        )
        block_centroids, centroid_node_vectors, bond_connectivity, reference_bond_vectors = (
            geometry.get_parametrization()
        )
        bonds = bond_connectivity()
        ref_bond_vectors = reference_bond_vectors().to(**like)

        driven_pairs, drive_mask = base.driven_side_pairs(
            self.n1_blocks, self.n2_blocks, self.n_excited_blocks,
            self.loaded_side, self.input_shift,
        )
        clamped_pairs = base.clamped_corner_pairs(
            self.n1_blocks, self.n2_blocks, self.n_blocks_clamped_corner
        )
        base.check_disjoint_constrained_pairs(
            driven=driven_pairs, clamped_corners=clamped_pairs
        )
        constrained_pairs = np.concatenate([driven_pairs, clamped_pairs])
        drive_vector = torch.as_tensor(
            np.concatenate([drive_mask, np.zeros(len(clamped_pairs))]), **like
        )

        if excited_blocks_fn is None:
            def constrained_DOFs_fn(t, amplitude, loading_rate, input_delay):
                return base.pulse(t - input_delay, amplitude, loading_rate) * drive_vector
        else:
            def constrained_DOFs_fn(t, **kwargs):
                return excited_blocks_fn(t) * drive_vector

        energy = base.dense_energy(build_quad_grid_energy, self.n1_blocks, self.n2_blocks,
                                   bonds, self.linearized_strains, self.use_contact,
                                   self.grid_energy)
        quad_grid = (
            dict(
                n1=self.n1_blocks,
                n2=self.n2_blocks,
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
            quad_grid=quad_grid,
            guard=base.resolve_model_guard(
                self.guard, self.min_angle, self.cutoff_angle, self.spacing
            ),
        )

        timepoints = torch.as_tensor(
            np.linspace(0.0, float(self.simulation_time), self.n_timepoints), **like
        )
        state0 = torch.zeros((2, geometry.n_blocks, 3), **like)
        # Push inward from whichever side is loaded.
        sign = 1.0 if self.loaded_side in ("left", "bottom") else -1.0

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

        def control_params(design, amplitude=None, loading_rate=None) -> ControlParams:
            """The solver's parameters for a design (or a population), with
            the problem's pulse or the one given (a scenario batch where
            ``(B,)``)."""

            amplitude = self.amplitude if amplitude is None else amplitude
            loading_rate = self.loading_rate if loading_rate is None else loading_rate
            horizontal_shifts, vertical_shifts = design
            return ControlParams(
                geometrical_params=GeometricalParams(
                    block_centroids(horizontal_shifts, vertical_shifts),
                    centroid_node_vectors(horizontal_shifts, vertical_shifts),
                ),
                mechanical_params=MechanicalParams(
                    bond_params=bond_params,
                    density=scalar(self.density),
                    damping=damping,
                    contact_params=contact_params,
                ),
                constraint_params=dict(
                    amplitude=sign * scalar(amplitude),
                    loading_rate=scalar(loading_rate),
                    input_delay=scalar(self.input_delay),
                ),
            )

        def forward_scenario(design: Tuple[torch.Tensor, torch.Tensor], amplitude,
                             loading_rate) -> SolutionData:
            """Forward solve with the pulse's amplitude and rate given (the
            robustness sweep's entry point; ``(B,)`` of each for B
            scenarios)."""

            cp = control_params(design, amplitude, loading_rate)
            gp = cp.geometrical_params
            return SolutionData(
                block_centroids=gp.block_centroids,
                centroid_node_vectors=gp.centroid_node_vectors,
                bond_connectivity=bonds,
                timepoints=timepoints,
                fields=solve_dynamics(state0, timepoints, cp),
            )

        def forward(design: Tuple[torch.Tensor, torch.Tensor]) -> SolutionData:
            return forward_scenario(design, self.amplitude, self.loading_rate)

        self.solve = forward
        self.solve_scenario = forward_scenario
        self.control_params = control_params
        self.solve_dynamics = solve_dynamics
        self.timepoints = timepoints
        self.state0 = state0
        self.geometry = geometry
        self.clamped_blocks_ids = np.unique(clamped_pairs[:, 0])
        self.driven_blocks_ids = np.unique(driven_pairs[:, 0])
        self.moving_blocks_ids = np.setdiff1d(np.arange(geometry.n_blocks),
                                              self.clamped_blocks_ids)
        self.is_setup = True

    def compute_response_data(self, solution_data: Optional[SolutionData] = None) -> dict:
        """The solution's fields plus each bond's strain-energy histories
        (stretch, shear, bending; ``(..., T, n_bonds)``) and each block's
        kinetic-energy history (``(..., T, n_blocks)``); a scenario or
        design batch keeps its leading dimension."""

        if not self.is_setup:
            self.setup()
        if solution_data is None:
            solution_data = self.solution_data
        if not isinstance(solution_data, SolutionData):
            raise ValueError("Solution data is not of type SolutionData!")
        out = solution_data._asdict()
        fields = solution_data.fields
        displacement, velocity = fields[..., 0, :, :], fields[..., 1, :, :]
        axial, shear, bending = compute_ligament_strains_history(
            displacement, solution_data.centroid_node_vectors, solution_data.bond_connectivity,
            self.geometry.reference_bond_vectors().to(displacement),
        )
        out["strain_energy_stretch"] = 0.5 * self.k_stretch * (axial * self.bond_length) ** 2
        out["strain_energy_shear"] = 0.5 * self.k_shear * (shear * self.bond_length) ** 2
        out["strain_energy_bending"] = 0.5 * self.k_rot * bending**2
        inertia = compute_inertia(solution_data.centroid_node_vectors, self.density)
        if inertia.dim() > 2:  # a population of designs: broadcast over time
            inertia = inertia.unsqueeze(-3)
        out["kinetic_energy"] = torch.sum(0.5 * velocity**2 * inertia, dim=-1)
        return out

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
    """Maximize target-patch kinetic energy over the hinge-shift design
    (``run_optimization_mma`` and ``run_multistart_mma`` from the runner
    mixin). ``setup_objective()`` installs ``objective_fn(design) ->
    scalar`` and ``population_objective_fn(designs) -> (B,)``, whose
    designs carry a leading dimension B and solve as one population."""

    forward_problem: ForwardProblem
    target_size: Tuple[int, int]
    target_shift: Tuple[int, int] = (0, 0)
    objective_values: Optional[List[Any]] = None
    design_values: Optional[List[Any]] = None
    constraints_violation: Optional[Dict[str, List[Any]]] = None
    name: str = "quads_focusing"
    is_setup: bool = False

    def __post_init__(self):
        self.objective_values = self.objective_values or []
        self.design_values = self.design_values or []
        self.constraints_violation = self.constraints_violation or {
            "angles": [], "edge_lengths": []
        }

    def setup_objective(self) -> None:
        if not self.forward_problem.is_setup:
            self.forward_problem.setup()
        fp = self.forward_problem
        target_blocks = base.target_patch_ids(
            fp.n1_blocks, fp.n2_blocks, self.target_size, self.target_shift
        )
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

    def compute_robustness_map(self, design, amplitudes, loading_rates,
                               mesh=None) -> torch.Tensor:
        """Target kinetic energy of ``design`` over the grid of pulse
        ``amplitudes`` x ``loading_rates``: ``(len(amplitudes),
        len(loading_rates))``, every scenario of the grid in one
        ``solve_scenario`` call (one kernel launch on the card)."""

        if mesh is not None:
            raise NotImplementedError("scenarios sharded over several cards are ROADMAP A11")
        if not self.is_setup:
            self.setup_objective()
        fp = self.forward_problem
        like = dict(device=torch.device(fp.device), dtype=fp.dtype)
        A, R = torch.meshgrid(torch.as_tensor(amplitudes, **like),
                              torch.as_tensor(loading_rates, **like), indexing="ij")
        target = torch.as_tensor(self.target_blocks, device=like["device"])
        inertia = compute_inertia(fp.geometry.centroid_node_vectors(*design), fp.density)
        solution = fp.solve_scenario(design, A.reshape(-1), R.reshape(-1))
        values = trajectory_kinetic_energy(solution.fields[..., 1, target, :],
                                           inertia[target])
        return values.reshape(A.shape)

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
