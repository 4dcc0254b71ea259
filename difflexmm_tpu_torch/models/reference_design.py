"""Reference (non-optimized) rotated-square design: forward dynamics only
(counterpart of ``difflexmm_tpu/models/reference_design.py``).

A pulse is driven into a rotated-square lattice at a fixed initial angle,
the baseline configuration the optimized designs are compared against:
the same driven side and clamped corners as the quads problems, but the
design is the single rotated-square angle.
"""

import math
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Union

import numpy as np
import torch

from difflexmm_tpu_torch.geometry.quad import RotatedSquareGeometry
from difflexmm_tpu_torch.models import base
from difflexmm_tpu_torch.ops.grid import build_quad_grid_energy
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
    """Pulse-driven rotated-square lattice with clamped corners.

    ``setup()`` installs ``self.solve(angle=None) -> SolutionData`` (the
    initial angle where None; a tensor angle is differentiable). Every
    physical parameter is cast to ``device`` and ``dtype``; ``device`` is
    the CUDA device unless the caller asks for the CPU. ``method``: the
    dense ``"verlet"`` (the JAX default) on the gridded quad energy
    (``grid_energy``) or the bond-list energy, or one of
    ``solver.dynamics.FAST_METHODS`` (the quad trajectory kernel on CUDA
    tensors). ``guard``: None, ``"auto"`` or a spec dict
    (``base.resolve_model_guard``; the fast path only).
    """

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

    method: str = "verlet"
    n_substeps: int = 20
    grid_energy: bool = True
    guard: Any = None
    device: Any = "cuda"
    dtype: Any = torch.float64

    is_setup: bool = False
    name: str = "reference_design"

    def setup(self, excited_blocks_fn: Optional[Callable] = None) -> None:
        like = dict(device=torch.device(self.device), dtype=self.dtype)
        geometry = RotatedSquareGeometry(
            n1_cells=self.n1_cells,
            n2_cells=self.n2_cells,
            spacing=self.spacing,
            bond_length=self.bond_length,
        )
        bc_fn, cnv_fn, bond_fn, rbv_fn = geometry.get_parametrization()
        bonds = bond_fn()
        ref_bond_vectors = rbv_fn().to(**like)
        n1, n2 = geometry.n1_blocks, geometry.n2_blocks

        driven_pairs, drive_mask = base.driven_side_pairs(
            n1, n2, self.n_excited_blocks, self.loaded_side, self.input_shift,
        )
        clamped_pairs = base.clamped_corner_pairs(n1, n2, self.n_blocks_clamped_corner)
        base.check_disjoint_constrained_pairs(driven=driven_pairs, clamped_corners=clamped_pairs)
        constrained_pairs = np.concatenate([driven_pairs, clamped_pairs])
        drive_vector = torch.as_tensor(
            np.concatenate([drive_mask, np.zeros(len(clamped_pairs))]), **like
        )

        if excited_blocks_fn is None:
            def constrained_DOFs_fn(t, amplitude, loading_rate, input_delay):
                pulse = base.pulse(t - input_delay, amplitude, loading_rate)
                return pulse[..., None] * drive_vector
        else:
            def constrained_DOFs_fn(t, **kwargs):
                return torch.as_tensor(excited_blocks_fn(t))[..., None] * drive_vector

        energy = base.dense_energy(build_quad_grid_energy, n1, n2, bonds,
                                   self.linearized_strains, self.use_contact, self.grid_energy)

        # The rotated-square lattice is an n1 x n2 grid of 4-gons, so the
        # quad-grid fast path applies unchanged.
        quad_grid = (
            dict(n1=n1, n2=n2, linearized=self.linearized_strains, use_contact=self.use_contact)
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

        def control_params(angle) -> ControlParams:
            """The solver's parameters at a design angle."""

            return ControlParams(
                geometrical_params=GeometricalParams(bc_fn(angle), cnv_fn(angle)),
                mechanical_params=MechanicalParams(
                    bond_params=bond_params,
                    density=scalar(self.density),
                    damping=damping,
                    contact_params=contact_params,
                ),
                constraint_params=dict(
                    amplitude=sign * scalar(self.amplitude),
                    loading_rate=scalar(self.loading_rate),
                    input_delay=scalar(self.input_delay),
                ),
            )

        def forward(angle=None) -> SolutionData:
            angle = scalar(self.initial_angle) if angle is None else angle
            cp = control_params(angle)
            gp = cp.geometrical_params
            return SolutionData(
                block_centroids=gp.block_centroids,
                centroid_node_vectors=gp.centroid_node_vectors,
                bond_connectivity=bonds,
                timepoints=timepoints,
                fields=solve_dynamics(state0, timepoints, cp),
            )

        self.solve = forward
        self.solve_dynamics = solve_dynamics
        self.control_params = control_params
        self.state0 = state0
        self.timepoints = timepoints
        self.geometry = geometry
        self.clamped_blocks_ids = np.unique(clamped_pairs[:, 0])
        self.driven_blocks_ids = np.unique(driven_pairs[:, 0])
        self.moving_blocks_ids = np.setdiff1d(np.arange(geometry.n_blocks),
                                              self.clamped_blocks_ids)
        self.is_setup = True

    def to_dict(self) -> dict:
        return base.problem_to_dict(self)

    @staticmethod
    def from_dict(dict_in: dict) -> "ForwardProblem":
        return base.forward_problem_from_dict(ForwardProblem, dict_in)
