"""Energy splitting: one input and several weighted target patches
(counterpart of ``difflexmm_tpu/models/quads_energy_splitting.py``).

Weights may be negative to protect a region while focusing energy
elsewhere. One solve of the quads-focusing forward problem serves every
target.
"""

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from difflexmm_tpu_torch.geometry.polygon import compute_inertia
from difflexmm_tpu_torch.models import base
from difflexmm_tpu_torch.models.quads_focusing import ForwardProblem
from difflexmm_tpu_torch.models.runner import OptimizationRunnerMixin
from difflexmm_tpu_torch.ops.observables import trajectory_kinetic_energy


@dataclass
class OptimizationProblem(OptimizationRunnerMixin):
    """Maximize a weighted sum of target kinetic energies.
    ``objective_fn(design)`` and ``population_objective_fn(designs) ->
    (B,)`` are one function; ``objective_fn_individual`` gives each
    target's value (``(n_targets,)``, or ``(n_targets, B)``)."""

    forward_problem: ForwardProblem
    target_sizes: Tuple[Tuple[int, int], ...]
    target_shifts: Tuple[Tuple[int, int], ...]
    weights: Tuple[float, ...]
    objective_values: Optional[List[Any]] = None
    objective_values_individual: Optional[List[Any]] = None
    design_values: Optional[List[Any]] = None
    constraints_violation: Optional[Dict[str, List[Any]]] = None
    name: str = "quads_energy_splitting"
    is_setup: bool = False

    def __post_init__(self):
        self.objective_values = self.objective_values or []
        self.objective_values_individual = self.objective_values_individual or []
        self.design_values = self.design_values or []
        self.constraints_violation = self.constraints_violation or {
            "angles": [], "edge_lengths": []
        }

    def setup_objective(self) -> None:
        if not self.forward_problem.is_setup:
            self.forward_problem.setup()
        fp = self.forward_problem
        target_blocks_list = [
            base.target_patch_ids(fp.n1_blocks, fp.n2_blocks, size, shift)
            for size, shift in zip(self.target_sizes, self.target_shifts)
        ]
        like = dict(device=torch.device(fp.device), dtype=fp.dtype)
        targets = [torch.as_tensor(t, device=like["device"]) for t in target_blocks_list]
        weights = torch.as_tensor(self.weights, **like)

        def target_kinetic_energies(design):
            solution = fp.solve(design)
            inertia = compute_inertia(solution.centroid_node_vectors, fp.density)
            return torch.stack([
                trajectory_kinetic_energy(solution.fields[..., 1, target, :],
                                          inertia[..., None, target, :])
                for target in targets
            ])

        def total_objective(design):
            return torch.tensordot(weights, target_kinetic_energies(design), dims=1)

        self.objective_fn = self.population_objective_fn = total_objective
        self.objective_fn_individual = target_kinetic_energies
        self.target_blocks_list = target_blocks_list
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
