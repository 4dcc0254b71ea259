"""Multi-input focusing: several forward problems (one per driven side)
on one shared design and one target patch (counterpart of
``difflexmm_tpu/models/quads_focusing_multi_input.py``).

The objective is the weighted sum of the target's kinetic energy under
each input: one solve per forward problem (one kernel launch each on the
card), as the JAX objective runs one per problem.
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
    """Maximize the weighted target kinetic energy across several inputs.
    ``objective_fn(design)`` and ``population_objective_fn(designs) ->
    (B,)`` are one function; ``objective_fn_individual`` gives each
    input's value (``(n_inputs,)``, or ``(n_inputs, B)``)."""

    forward_problems: List[ForwardProblem]
    target_size: Tuple[int, int]
    target_shift: Tuple[int, int]
    weights: Tuple[float, ...]
    objective_values: Optional[List[Any]] = None
    objective_values_individual: Optional[List[Any]] = None
    design_values: Optional[List[Any]] = None
    constraints_violation: Optional[Dict[str, List[Any]]] = None
    name: str = "quads_focusing_multi_input"
    is_setup: bool = False

    def __post_init__(self):
        self.objective_values = self.objective_values or []
        self.objective_values_individual = self.objective_values_individual or []
        self.design_values = self.design_values or []
        self.constraints_violation = self.constraints_violation or {
            "angles": [], "edge_lengths": []
        }

    def setup_objective(self) -> None:
        for problem in self.forward_problems:
            if not problem.is_setup:
                problem.setup()
        fp0 = self.forward_problems[0]
        geometry = fp0.geometry
        target_blocks = base.target_patch_ids(
            geometry.n1_blocks, geometry.n2_blocks, self.target_size, self.target_shift
        )
        like = dict(device=torch.device(fp0.device), dtype=fp0.dtype)
        target = torch.as_tensor(target_blocks, device=like["device"])
        weights = torch.as_tensor(self.weights, **like)

        def target_kinetic_energies(design):
            inertia = compute_inertia(geometry.centroid_node_vectors(*design), fp0.density)
            inertia = inertia[..., None, target, :]
            return torch.stack([
                trajectory_kinetic_energy(problem.solve(design).fields[..., 1, target, :],
                                          inertia)
                for problem in self.forward_problems
            ])

        def total_objective(design):
            return torch.tensordot(weights, target_kinetic_energies(design), dims=1)

        self.objective_fn = self.population_objective_fn = total_objective
        self.objective_fn_individual = target_kinetic_energies
        self.target_blocks = target_blocks
        self.is_setup = True

    def to_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out["forward_problems"] = [p.to_dict() for p in self.forward_problems]
        return out

    @staticmethod
    def from_dict(dict_in: dict) -> "OptimizationProblem":
        return base.optimization_problem_from_dict(OptimizationProblem, ForwardProblem, dict_in)

    def to_data(self) -> "OptimizationProblem":
        return base.problem_to_data(self)

    @staticmethod
    def from_data(optimization_data) -> "OptimizationProblem":
        return base.optimization_problem_from_data(optimization_data, ForwardProblem)
