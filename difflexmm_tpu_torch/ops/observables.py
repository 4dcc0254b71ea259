"""Observables on solutions (counterpart of ``kinetic_energy`` in
``difflexmm_tpu/ops/observables.py``, and its population form)."""

import torch


def kinetic_energy(block_velocity: torch.Tensor, inertia: torch.Tensor) -> torch.Tensor:
    """Total kinetic energy: sum over blocks and DOFs of m v^2 / 2."""

    return torch.sum(inertia * block_velocity**2 / 2)


def trajectory_kinetic_energy(block_velocity: torch.Tensor, inertia: torch.Tensor) -> torch.Tensor:
    """:func:`kinetic_energy` summed over the last three dimensions of
    ``block_velocity`` ``(..., T, n_blocks, 3)`` (timepoints, blocks,
    DOFs), with ``inertia`` broadcastable to it: a scalar for one design,
    ``(B,)`` for a population."""

    return torch.sum(inertia * block_velocity**2 / 2, dim=(-3, -2, -1))
