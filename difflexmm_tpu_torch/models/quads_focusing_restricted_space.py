"""Focusing over a restricted design space: only the hinges inside a patch
around the target move, the rest stay at the initial guess (counterpart of
``difflexmm_tpu/models/quads_focusing_restricted_space.py``). The
optimizer sees the reduced design, the two shift grids' entries inside the
patch; the forward problem is quads focusing's.
"""

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from difflexmm_tpu_torch.geometry.polygon import compute_inertia
from difflexmm_tpu_torch.models import base
from difflexmm_tpu_torch.models.quads_focusing import ForwardProblem
from difflexmm_tpu_torch.models.runner import OptimizationRunnerMixin
from difflexmm_tpu_torch.ops.observables import trajectory_kinetic_energy


@dataclass
class OptimizationProblem(OptimizationRunnerMixin):
    """Target kinetic energy over the reduced (patch-masked) design.
    ``objective_fn(reduced_design)`` and ``population_objective_fn`` (each
    reduced grid ``(B, n)``) are one function."""

    forward_problem: ForwardProblem
    target_size: Tuple[int, int]
    target_shift: Tuple[int, int]
    initial_guess_all: Tuple[Any, Any]
    design_patch_size: Optional[int] = None
    objective_values: Optional[List[Any]] = None
    design_values: Optional[List[Any]] = None
    constraints_violation: Optional[Dict[str, List[Any]]] = None
    name: str = "quads_focusing_restricted_space"
    is_setup: bool = False

    def __post_init__(self):
        self.objective_values = self.objective_values or []
        self.design_values = self.design_values or []
        self.constraints_violation = self.constraints_violation or {
            "angles": [], "edge_lengths": []
        }
        fp = self.forward_problem
        n1, n2 = fp.n1_blocks, fp.n2_blocks
        if self.design_patch_size is None:
            self.design_patch_size = max(n1, n2)
        ps = self.design_patch_size
        x0 = int(np.clip((n1 - ps) // 2 + self.target_shift[0], 0, n1))
        x1 = int(np.clip((n1 + ps) // 2 + self.target_shift[0], 0, n1))
        y0 = int(np.clip((n2 - ps) // 2 + self.target_shift[1], 0, n2))
        y1 = int(np.clip((n2 + ps) // 2 + self.target_shift[1], 0, n2))
        h_mask = np.zeros(tuple(np.shape(self.initial_guess_all[0])), dtype=bool)
        h_mask[x0:x1 + 1, y0:y1] = True
        v_mask = np.zeros(tuple(np.shape(self.initial_guess_all[1])), dtype=bool)
        v_mask[x0:x1, y0:y1 + 1] = True
        device = torch.device(fp.device)
        self.horizontal_shifts_mask = torch.as_tensor(h_mask, device=device)
        self.vertical_shifts_mask = torch.as_tensor(v_mask, device=device)

    # -- reduced <-> full design maps ----------------------------------------

    def all_to_reduced_shifts(self, all_shifts):
        """The full shift grids (``(..., n1 + 1, n2)`` and ``(..., n1, n2 +
        1)``) -> the reduced design, ``(..., n_h)`` and ``(..., n_v)``."""

        h, v = all_shifts
        return h[..., self.horizontal_shifts_mask], v[..., self.vertical_shifts_mask]

    def reduced_to_all_shifts(self, reduced_shifts):
        """The reduced design (with any leading batch) -> the full shift
        grids, the initial guess outside the patch."""

        fp = self.forward_problem
        like = dict(device=torch.device(fp.device), dtype=fp.dtype)
        out = []
        for reduced, initial, mask in zip(reduced_shifts, self.initial_guess_all,
                                          (self.horizontal_shifts_mask,
                                           self.vertical_shifts_mask)):
            initial = torch.as_tensor(initial, **like)
            full = torch.broadcast_to(initial, reduced.shape[:-1] + initial.shape).clone()
            full[..., mask] = reduced
            out.append(full)
        return tuple(out)

    def setup_objective(self) -> None:
        if not self.forward_problem.is_setup:
            self.forward_problem.setup()
        fp = self.forward_problem
        target_blocks = base.target_patch_ids(
            fp.n1_blocks, fp.n2_blocks, self.target_size, self.target_shift
        )
        target = torch.as_tensor(target_blocks, device=torch.device(fp.device))

        def target_kinetic_energy_reduced(reduced_design):
            solution = fp.solve(self.reduced_to_all_shifts(reduced_design))
            inertia = compute_inertia(solution.centroid_node_vectors, fp.density)
            return trajectory_kinetic_energy(solution.fields[..., 1, target, :],
                                             inertia[..., None, target, :])

        self.objective_fn = self.population_objective_fn = target_kinetic_energy_reduced
        self.target_blocks = target_blocks
        self.is_setup = True

    def _design_constraints(self, min_void_angle, min_block_angle, min_edge_length,
                            boundary_angle_constraint=False):
        """The fabrication constraints of the full design made from the
        reduced one."""

        constraints = super()._design_constraints(
            min_void_angle, min_block_angle, min_edge_length, boundary_angle_constraint,
        )
        return [(name, lambda rd, fn=fn: fn(self.reduced_to_all_shifts(rd)))
                for name, fn in constraints]

    def compute_best_forward(self):
        """Solve the forward problem at the full design of the last reduced
        design of the history."""

        if not self.design_values:
            raise ValueError("No design has been optimized yet.")
        if not self.forward_problem.is_setup:
            self.forward_problem.setup()
        with torch.no_grad():
            full = self.reduced_to_all_shifts(self.design_values[-1])
            self.forward_problem.solution_data = self.forward_problem.solve(full)
        return self.forward_problem.solution_data

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
