"""Hinge characterization (counterpart of
``difflexmm_tpu/models/hinge_characterization.py``): fit ligament
stiffnesses to force-displacement curves of quasi-static tension,
compression or shear tests.

The sample (rotated-square or quad lattice) is loaded in displacement
control: the bottom row clamped, the top row driven by a linear ramp
(all three DOFs of both rows constrained). The reaction force is the
energy gradient summed over the driven DOFs, and the objective the mean
squared error against resampled experimental curves of every loading type.

The sample runs through the grid fast path (``method`` in
``solver.dynamics.FAST_METHODS``: kernel 1 on CUDA tensors, every block
damped), the dense ``"verlet"``, or ``method="static"``: one warm-started
Newton equilibrium per output time (``solver/statics.py``), whose
gradient is the implicit adjoint, not a reverse time integration.
"""

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Literal, Optional, Union

import numpy as np
import torch

from difflexmm_tpu_torch.geometry.quad import QuadGeometry, RotatedSquareGeometry
from difflexmm_tpu_torch.models import base
from difflexmm_tpu_torch.ops.grid import build_quad_grid_energy
from difflexmm_tpu_torch.optim.loops import naive_gd, ravel_pytree
from difflexmm_tpu_torch.optim.mma import run_mma
from difflexmm_tpu_torch.solver.dynamics import FAST_METHODS, setup_dynamic_solver
from difflexmm_tpu_torch.solver.statics import setup_static_solver
from difflexmm_tpu_torch.utils.types import (
    ContactParams,
    ControlParams,
    GeometricalParams,
    LigamentParams,
    MechanicalParams,
    SolutionData,
)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear interpolation of ``fp(xp)`` (``xp`` increasing) at
    ``x``, held at ``fp[0]`` left of ``xp[0]`` and ``fp[-1]`` right of
    ``xp[-1]``: ``jnp.interp``'s operations in its order."""

    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    epsilon = np.spacing(np.finfo(np.float64 if xp.dtype == torch.float64
                                  else np.float32).eps)
    dx0 = torch.abs(dx) <= epsilon
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, torch.ones_like(dx),
                                                                      dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def resample(x: torch.Tensor, y: torch.Tensor, n_timepoints: int) -> torch.Tensor:
    """Resample y(x) onto a uniform grid spanning [min(x), max(x)]
    (``jnp.linspace``'s arithmetic: ``lo (1 - s) + hi s``, the last point
    ``hi``)."""

    x, y = torch.as_tensor(x), torch.as_tensor(y)
    lo, hi = torch.min(x), torch.max(x)
    step = torch.arange(n_timepoints - 1, dtype=x.dtype, device=x.device) / (n_timepoints - 1)
    grid = torch.cat([lo * (1 - step) + hi * step, hi.reshape(1)])
    return interp(grid, x, y)


def _characterization_setup(self, geometry, block_centroids, centroid_node_vectors):
    """Shared set-up of both sample geometries; ``block_centroids`` and
    ``centroid_node_vectors`` are the sample's (constant) geometry tensors."""

    like = dict(device=torch.device(self.device), dtype=self.dtype)
    bonds = geometry.bond_connectivity()
    ref_bond_vectors = geometry.reference_bond_vectors().to(**like)
    n1 = geometry.n1_blocks
    nb = geometry.n_blocks

    # Top row first, then bottom row; all three DOFs per block, DOF-major.
    constrained_blocks = np.concatenate([np.arange(nb - n1, nb), np.arange(n1)])
    constrained_pairs = base.all_dofs_pairs(constrained_blocks)
    n_c = len(constrained_blocks)

    loading_vector = np.zeros(3 * n_c)
    if self.loading_type == "tension":
        loading_vector[n_c:n_c + n1] = 1.0  # top row, y
    elif self.loading_type == "compression":
        loading_vector[n_c:n_c + n1] = -1.0
    elif self.loading_type == "shear":
        loading_vector[:n1] = 1.0  # top row, x
    else:
        raise ValueError("Loading type should be either tension, compression, or shear!")
    reaction_pairs = constrained_pairs[np.where(loading_vector != 0)[0]]
    loading_vector = torch.as_tensor(loading_vector, **like)

    def applied_displacement(t, amplitude, loading_rate):
        return amplitude * torch.where(t < 1.0 / loading_rate, t * loading_rate,
                                       torch.ones_like(t))

    def constrained_DOFs_fn(t, amplitude, loading_rate):
        return loading_vector * applied_displacement(t, amplitude, loading_rate)

    k_ref = self.k_stretch
    mass_ref = self.density * geometry.spacing**2
    damping_values = torch.as_tensor(
        self.damping * np.array([(k_ref * mass_ref) ** 0.5, (k_ref * mass_ref) ** 0.5,
                                 (k_ref * mass_ref) ** 0.5 * geometry.spacing**2])
        * np.ones((nb, 3)), **like)

    potential_energy = base.dense_energy(build_quad_grid_energy, n1, geometry.n2_blocks, bonds,
                                         self.linearized_strains, self.use_contact,
                                         self.grid_energy)
    if self.method == "static":
        # One warm-started Newton equilibrium per output time: the
        # rate-independent limit of the damped ramp, with the implicit
        # adjoint for gradients.
        solve_equilibrium = setup_static_solver(
            geometry=geometry,
            energy_fn=potential_energy,
            constrained_block_DOF_pairs=constrained_pairs,
            constrained_DOFs_fn=constrained_DOFs_fn,
        )

        def solve_dynamics(state0, timepoints, control_params):
            u, trajectory = state0[0], []
            for t in timepoints:
                u = solve_equilibrium(u.detach(), t, control_params)
                trajectory.append(u)
            trajectory = torch.stack(trajectory)
            return torch.stack([trajectory, torch.zeros_like(trajectory)], dim=1)

        self.solve_equilibrium = solve_equilibrium
    else:
        quad_grid = (dict(n1=n1, n2=geometry.n2_blocks, linearized=self.linearized_strains,
                          use_contact=self.use_contact)
                     if self.method in FAST_METHODS else None)
        solve_dynamics = setup_dynamic_solver(
            geometry=geometry,
            energy_fn=potential_energy,
            constrained_block_DOF_pairs=constrained_pairs,
            constrained_DOFs_fn=constrained_DOFs_fn,
            damped_blocks=np.arange(nb),
            method=self.method,
            n_substeps=self.n_substeps,
            quad_grid=quad_grid,
            guard=base.resolve_model_guard(self.guard, self.min_angle, self.cutoff_angle,
                                           self.spacing),
        )

    timepoints = torch.as_tensor(np.linspace(0.0, 1.0 / self.loading_rate, self.n_timepoints),
                                 **like)
    state0 = torch.zeros((2, nb, 3), **like)

    def scalar(x):
        return torch.as_tensor(x, **like)

    def forward(k_values):
        k_stretch, k_shear, k_rot = (scalar(k) for k in k_values)
        control_params = ControlParams(
            geometrical_params=GeometricalParams(block_centroids, centroid_node_vectors),
            mechanical_params=MechanicalParams(
                bond_params=LigamentParams(k_stretch=k_stretch, k_shear=k_shear, k_rot=k_rot,
                                           reference_vector=ref_bond_vectors),
                density=scalar(self.density),
                damping=damping_values,
                contact_params=ContactParams(min_angle=scalar(self.min_angle),
                                             cutoff_angle=scalar(self.cutoff_angle),
                                             k_contact=scalar(self.k_contact)),
            ),
            constraint_params=dict(amplitude=scalar(self.amplitude),
                                   loading_rate=scalar(self.loading_rate)),
        )
        fields = solve_dynamics(state0, timepoints, control_params)
        return (
            SolutionData(block_centroids=block_centroids,
                         centroid_node_vectors=centroid_node_vectors,
                         bond_connectivity=bonds, timepoints=timepoints, fields=fields),
            control_params,
        )

    self.solve = forward
    self.solve_dynamics = solve_dynamics
    self.geometry = geometry
    self.potential_energy = potential_energy
    self.elastic_forces = torch.func.grad(potential_energy)
    self.applied_displacement = applied_displacement
    self.reaction_block_DOF_pairs = reaction_pairs
    self.timepoints = timepoints
    self.is_setup = True


class _CharacterizationForwardMixin:
    """Shared force-displacement extraction and serialization."""

    def force_displacement(self, solution_data: SolutionData,
                           control_params: ControlParams) -> torch.Tensor:
        """[applied displacement, reaction force] histories, ``(2, T)``: the
        reaction is the energy gradient summed over the driven top-row DOFs
        at every output time (``torch.func.vmap`` over the times)."""

        pairs = self.reaction_block_DOF_pairs
        fields = solution_data.fields
        index = tuple(torch.as_tensor(pairs[:, i], device=fields.device) for i in range(2))

        def reaction(u):
            return torch.sum(self.elastic_forces(u, control_params)[index])

        forces = torch.func.vmap(reaction)(fields[:, 0])
        applied = self.applied_displacement(solution_data.timepoints,
                                            **control_params.constraint_params)
        return torch.stack([applied, forces * self.force_multiplier])

    def to_dict(self) -> dict:
        return base.problem_to_dict(self)

    @classmethod
    def from_dict(cls, dict_in: dict):
        return base.forward_problem_from_dict(cls, dict_in)

    def to_data(self):
        return base.problem_to_data(self)

    @staticmethod
    def from_data(problem_data):
        problem_data.is_setup = False
        return problem_data


@dataclass
class ForwardProblem(_CharacterizationForwardMixin):
    """Displacement-controlled test on a rotated-square sample.
    ``setup()`` installs ``self.solve(k_values) -> (SolutionData,
    ControlParams)`` for ``k_values = (k_stretch, k_shear, k_rot)``
    (numbers or tensors; the dataclass's stiffnesses are placeholders, as
    in JAX, except ``k_stretch``, which scales the damping). ``device``
    is the CUDA device unless the caller asks for the CPU."""

    # Geometry
    n1_cells: int
    n2_cells: int
    spacing: Any
    bond_length: Any
    initial_angle: Any

    # Mechanical
    k_stretch: Any
    k_shear: Any
    k_rot: Any
    density: Any
    damping: Any

    # Loading
    loading_type: Literal["tension", "compression", "shear"] = "tension"
    amplitude: Any = 0.1
    loading_rate: Any = 0.01

    # Analysis
    n_timepoints: int = 100
    linearized_strains: bool = False
    force_multiplier: float = 1.0

    # Contact
    use_contact: bool = True
    k_contact: Any = 1.0
    min_angle: Any = 0.0
    cutoff_angle: Any = 5.0 * math.pi / 180

    solution_data: Optional[Union[SolutionData, List[SolutionData]]] = None

    # "static": warm-started Newton equilibria instead of damped dynamics.
    method: str = "verlet"
    n_substeps: int = 32
    grid_energy: bool = True
    guard: Any = None
    device: Any = "cuda"
    dtype: Any = torch.float64

    name: str = "hinge_characterization"
    is_setup: bool = False

    def setup(self) -> None:
        like = dict(device=torch.device(self.device), dtype=self.dtype)
        geometry = RotatedSquareGeometry(n1_cells=self.n1_cells, n2_cells=self.n2_cells,
                                         spacing=self.spacing, bond_length=self.bond_length)
        geometry.compute_geometry()
        angle = torch.as_tensor(self.initial_angle, **like)
        _characterization_setup(self, geometry, geometry.block_centroids(angle),
                                geometry.centroid_node_vectors(angle))


@dataclass
class ForwardProblemQuads(_CharacterizationForwardMixin):
    """Displacement-controlled test on a quad (shift-designed) sample; as
    :class:`ForwardProblem`, the design's shift grids as fields."""

    # Geometry
    n1_blocks: int
    n2_blocks: int
    spacing: Any
    bond_length: Any
    horizontal_shifts: Any
    vertical_shifts: Any

    # Mechanical
    k_stretch: Any
    k_shear: Any
    k_rot: Any
    density: Any
    damping: Any

    # Loading
    loading_type: Literal["tension", "compression", "shear"] = "tension"
    amplitude: Any = 0.1
    loading_rate: Any = 0.01

    # Analysis
    n_timepoints: int = 100
    linearized_strains: bool = False
    force_multiplier: float = 1.0

    # Contact
    use_contact: bool = True
    k_contact: Any = 1.0
    min_angle: Any = 0.0
    cutoff_angle: Any = 5.0 * math.pi / 180

    solution_data: Optional[Union[SolutionData, List[SolutionData]]] = None

    method: str = "verlet"
    n_substeps: int = 32
    grid_energy: bool = True
    guard: Any = None
    device: Any = "cuda"
    dtype: Any = torch.float64

    name: str = "hinge_characterization_quads"
    is_setup: bool = False

    def setup(self) -> None:
        like = dict(device=torch.device(self.device), dtype=self.dtype)
        geometry = QuadGeometry(n1_blocks=self.n1_blocks, n2_blocks=self.n2_blocks,
                                spacing=self.spacing, bond_length=self.bond_length)
        geometry.compute_geometry()
        h = torch.as_tensor(self.horizontal_shifts, **like)
        v = torch.as_tensor(self.vertical_shifts, **like)
        _characterization_setup(self, geometry, geometry.block_centroids(h, v),
                                geometry.centroid_node_vectors(h, v))


@dataclass
class OptimizationProblem:
    """Least-squares stiffness identification against experimental
    curves: ``target_responses[loading_type]`` is ``[displacement history,
    force history, force std]`` (arrays or tensors)."""

    forward_problems: List[Any]
    target_responses: Dict[str, Any]
    fitted_responses: Optional[Dict[str, Any]] = None
    objective_values: Optional[List[Any]] = None
    design_values: Optional[List[Any]] = None
    name: str = "hinge_characterization"
    is_setup: bool = False

    def __post_init__(self):
        self.objective_values = self.objective_values or []
        self.design_values = self.design_values or []

    def compute_fitted_responses(self, k_values):
        for problem in self.forward_problems:
            if not problem.is_setup:
                problem.setup()
        return {problem.loading_type: problem.force_displacement(*problem.solve(k_values))
                for problem in self.forward_problems}

    def setup_objective(self) -> None:
        for problem in self.forward_problems:
            if not problem.is_setup:
                problem.setup()
        first = self.forward_problems[0]
        like = dict(device=torch.device(first.device), dtype=first.dtype)
        n_timepoints = first.n_timepoints
        # The simulated displacement is a linear ramp, so resampling the
        # experimental curves onto a uniform grid aligns the two.
        target_forces = torch.stack([
            resample(torch.as_tensor(target[0], **like), torch.as_tensor(target[1], **like),
                     n_timepoints)
            for target in self.target_responses.values()
        ])

        def response_squared_error(k_values):
            fitted = self.compute_fitted_responses(k_values)
            reaction_forces = torch.stack([f for _, f in fitted.values()])
            return torch.mean((reaction_forces - target_forces) ** 2)

        self.objective_fn = response_squared_error
        self.target_forces = target_forces
        self.is_setup = True

    def _value_and_grad(self, objective):
        def value_and_grad(design):
            leaves = tuple(torch.as_tensor(x, dtype=self.forward_problems[0].dtype,
                                           device=torch.device(self.forward_problems[0].device))
                           .detach().requires_grad_() for x in design)
            value = objective(leaves)
            return value.detach(), torch.autograd.grad(value, leaves)

        return value_and_grad

    def run_optimization_GD(self, initial_guess, n_iterations: int, step_size: float,
                            lower_bound=None, upper_bound=None):
        if not self.is_setup:
            self.setup_objective()
        like = dict(dtype=self.forward_problems[0].dtype,
                    device=torch.device(self.forward_problems[0].device))
        design, values, designs = naive_gd(
            self._value_and_grad(self.objective_fn),
            tuple(torch.as_tensor(k, **like) for k in initial_guess),
            n_iterations=n_iterations, learning_rate=step_size,
            lower_bound=lower_bound, upper_bound=upper_bound,
        )
        self.objective_values = values
        self.design_values = designs
        self.fitted_responses = self.compute_fitted_responses(design)
        return design

    def run_optimization_mma(self, initial_guess, n_iterations: int, lower_bound=None,
                             upper_bound=None):
        """Bound-constrained fit with the MMA optimizer."""

        if not self.is_setup:
            self.setup_objective()
        like = dict(dtype=self.forward_problems[0].dtype,
                    device=torch.device(self.forward_problems[0].device))
        flat0, unflatten = ravel_pytree(tuple(torch.as_tensor(k, **like)
                                              for k in initial_guess))

        def objective_and_grad(x):
            x = x.detach().requires_grad_()
            value = self.objective_fn(unflatten(x))
            return value.detach(), torch.autograd.grad(value, x)[0]

        span = float(torch.max(torch.abs(flat0))) + 1.0
        xmin = torch.full_like(flat0, lower_bound if lower_bound is not None else 0.0)
        xmax = torch.full_like(flat0, upper_bound if upper_bound is not None else 100 * span)

        def callback(it, x, value, violation, fi):
            self.objective_values.append(float(value))
            self.design_values.append(unflatten(x))

        x_final, _ = run_mma(objective_and_grad, flat0, xmin, xmax, n_iterations=n_iterations,
                             maximize=False, callback=callback)
        design = unflatten(x_final)
        self.fitted_responses = self.compute_fitted_responses(design)
        return design

    def to_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out["forward_problems"] = [p.to_dict() for p in self.forward_problems]
        return out

    @staticmethod
    def from_dict(dict_in: dict, forward_cls=ForwardProblem) -> "OptimizationProblem":
        return base.optimization_problem_from_dict(OptimizationProblem, forward_cls, dict_in)
