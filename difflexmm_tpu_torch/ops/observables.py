"""Observables on solutions (counterpart of
``difflexmm_tpu/ops/observables.py``): kinetic energy, angular momentum and
the ligament strains, each broadcasting over leading dimensions (time, and
a scenario or design batch before it)."""

import torch

from difflexmm_tpu_torch.ops.bonds import ligament_strains
from difflexmm_tpu_torch.ops.kinematics import block_to_node_kinematics


def kinetic_energy(block_velocity: torch.Tensor, inertia: torch.Tensor) -> torch.Tensor:
    """Total kinetic energy: sum over blocks and DOFs of m v^2 / 2."""

    return torch.sum(inertia * block_velocity**2 / 2)


def trajectory_kinetic_energy(block_velocity: torch.Tensor, inertia: torch.Tensor) -> torch.Tensor:
    """:func:`kinetic_energy` summed over the last three dimensions of
    ``block_velocity`` ``(..., T, n_blocks, 3)`` (timepoints, blocks,
    DOFs), with ``inertia`` broadcastable to it: a scalar for one design,
    ``(B,)`` for a population."""

    return torch.sum(inertia * block_velocity**2 / 2, dim=(-3, -2, -1))


def angular_momentum(block_position: torch.Tensor, block_velocity: torch.Tensor,
                     inertia: torch.Tensor, reference_point=(0.0, 0.0)) -> torch.Tensor:
    """Per-block angular momentum about ``reference_point``: positions
    ``(..., n_blocks, 2+)``, velocities and inertia ``(..., n_blocks, 3)``
    -> ``(..., n_blocks)``."""

    point = torch.as_tensor(reference_point, dtype=block_position.dtype,
                            device=block_position.device)
    r = block_position[..., :2] - point
    p = block_velocity[..., :2] * inertia[..., :2]
    orbital = r[..., 0] * p[..., 1] - r[..., 1] * p[..., 0]
    spin = block_velocity[..., 2] * inertia[..., 2]
    return orbital + spin


def compute_ligament_strains(block_displacement: torch.Tensor,
                             centroid_node_vectors: torch.Tensor, bond_connectivity,
                             reference_bond_vectors):
    """Nonlinear (axial, shear, rotational) strains of every bond:
    ``block_displacement (..., n_blocks, 3)`` with ``centroid_node_vectors``
    ``(..., n_blocks, V, 2)`` broadcastable to it -> three ``(...,
    n_bonds)``."""

    nodes = block_to_node_kinematics(block_displacement, centroid_node_vectors)
    nodes = nodes.reshape(nodes.shape[:-3] + (-1, 3))
    bonds = torch.as_tensor(bond_connectivity, dtype=torch.long, device=nodes.device)
    return ligament_strains(nodes[..., bonds[:, 0], :], nodes[..., bonds[:, 1], :],
                            reference_vector=reference_bond_vectors)


def compute_ligament_strains_history(displacement_history: torch.Tensor,
                                     centroid_node_vectors: torch.Tensor, bond_connectivity,
                                     reference_bond_vectors):
    """Strain histories: ``displacement_history (..., T, n_blocks, 3)`` and
    ``centroid_node_vectors`` of one design ``(n_blocks, V, 2)`` or of a
    batch ``(..., n_blocks, V, 2)`` -> three ``(..., T, n_bonds)``."""

    cnv = centroid_node_vectors
    if cnv.dim() > 3:  # a batch of designs: broadcast over time
        cnv = cnv.unsqueeze(-4)
    return compute_ligament_strains(displacement_history, cnv, bond_connectivity,
                                    reference_bond_vectors)
