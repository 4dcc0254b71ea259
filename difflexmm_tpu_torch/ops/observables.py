"""Observables on solutions (counterpart of ``kinetic_energy`` in
``difflexmm_tpu/ops/observables.py``)."""

import torch


def kinetic_energy(block_velocity: torch.Tensor, inertia: torch.Tensor) -> torch.Tensor:
    """Total kinetic energy: sum over blocks and DOFs of m v^2 / 2."""

    return torch.sum(inertia * block_velocity**2 / 2)
