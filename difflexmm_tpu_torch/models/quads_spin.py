"""Spin focusing: maximize the time-summed angular momentum of a target
patch about a spin center (counterpart of
``difflexmm_tpu/models/quads_spin.py``). ``spin_center="center"`` takes
the mean centroid of the target blocks of the ``forward_input`` design.
"""

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from difflexmm_tpu_torch.geometry.polygon import compute_inertia
from difflexmm_tpu_torch.models import base
from difflexmm_tpu_torch.models.quads_focusing import ForwardProblem
from difflexmm_tpu_torch.models.runner import OptimizationRunnerMixin
from difflexmm_tpu_torch.ops.observables import angular_momentum


@dataclass
class ForwardInput:
    """The initial design, which anchors the spin center."""

    horizontal_shifts: Any
    vertical_shifts: Any


@dataclass
class OptimizationProblem(OptimizationRunnerMixin):
    """Maximize the target's angular momentum about the spin center.
    ``objective_fn(design)`` and ``population_objective_fn(designs) ->
    (B,)`` are one function."""

    forward_problem: ForwardProblem
    forward_input: ForwardInput
    target_size: Tuple[int, int]
    target_shift: Tuple[int, int]
    spin_center: Union[str, Any] = "center"
    objective_values: Optional[List[Any]] = None
    design_values: Optional[List[Any]] = None
    constraints_violation: Optional[Dict[str, List[Any]]] = None
    name: str = "quads_spin"
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
        like = dict(device=torch.device(fp.device), dtype=fp.dtype)
        target_blocks = base.target_patch_ids(
            fp.n1_blocks, fp.n2_blocks, self.target_size, self.target_shift
        )
        target = torch.as_tensor(target_blocks, device=like["device"])
        if isinstance(self.spin_center, str) and self.spin_center == "center":
            anchor = (torch.as_tensor(self.forward_input.horizontal_shifts, **like),
                      torch.as_tensor(self.forward_input.vertical_shifts, **like))
            spin_center = fp.geometry.block_centroids(*anchor)[target].mean(dim=0)
        else:
            spin_center = torch.as_tensor(self.spin_center, **like)

        def target_angular_momentum(design):
            solution = fp.solve(design)
            inertia = compute_inertia(solution.centroid_node_vectors[..., target, :, :],
                                      fp.density)
            positions = (solution.block_centroids[..., None, target, :]
                         + solution.fields[..., 0, target, :2])
            L = angular_momentum(positions, solution.fields[..., 1, target, :],
                                 inertia[..., None, :, :], reference_point=spin_center)
            return torch.sum(L, dim=(-2, -1))

        self.objective_fn = self.population_objective_fn = target_angular_momentum
        self.target_blocks = target_blocks
        self._spin_center = spin_center
        self.is_setup = True

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
