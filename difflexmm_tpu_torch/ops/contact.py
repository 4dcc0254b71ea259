"""Angle-based contact barrier (counterpart of ``contact_energy``,
``void_angles`` and the angle-based ``build_contact_energy`` of
``difflexmm_tpu/ops/contact.py``; the distance-based variant is ROADMAP
A3)."""

import torch

from difflexmm_tpu_torch.geometry.edges import compute_edge_angles
from difflexmm_tpu_torch.ops.kinematics import current_node_positions


def void_angles(current_block_nodes: torch.Tensor, bond_connectivity) -> torch.Tensor:
    """The two void angles of every bond, all first ones then all second
    ones: ``(2 * n_bonds,)``."""

    v1, v2, _, _ = compute_edge_angles(current_block_nodes, bond_connectivity)
    return torch.cat([v1, v2])


def contact_energy(current_void_angles: torch.Tensor, min_angle, cutoff_angle, k_contact):
    """C^1 ~1/x barrier with asymptote at min_angle, zero beyond cutoff.

    With x = (phi - cutoff)/(cutoff - min): E = k/4 (cutoff-min)^2
    (1/(x+1) - 1/(x-1) - 2) on [min, cutoff), else 0.

    x is clamped to the active window before the reciprocals, with a margin
    of 64 machine epsilons of the compute dtype: a fixed margin such as
    1e-12 rounds away in float32, and a void angle at or below min_angle
    would then divide by zero and poison the gradient with 0 * inf.
    """

    span = cutoff_angle - min_angle
    x = (current_void_angles - cutoff_angle) / span
    eps = torch.finfo(x.dtype).eps
    x_safe = torch.clamp(x, -1.0 + 64.0 * eps, 0.0)
    barrier = k_contact / 4 * span**2 * (
        1.0 / (x_safe + 1.0) - 1.0 / (x_safe - 1.0) - 2.0
    )
    active = (current_void_angles >= min_angle) & (current_void_angles < cutoff_angle)
    return torch.where(active, barrier, torch.zeros_like(barrier))


def build_contact_energy(bond_connectivity, angle_based: bool = True):
    """Total contact energy ``contact_energy_fn(block_displacement,
    control_params)`` over the bond list: the barrier on both void angles
    of every bond."""

    if not angle_based:
        raise NotImplementedError("distance-based contact is not ported yet: ROADMAP A3.")

    def contact_energy_fn(block_displacement: torch.Tensor, control_params):
        gp = control_params.geometrical_params
        cp = control_params.mechanical_params.contact_params
        nodes = current_node_positions(block_displacement, gp.block_centroids,
                                       gp.centroid_node_vectors)
        return torch.sum(contact_energy(void_angles(nodes, bond_connectivity), cp.min_angle,
                                        cp.cutoff_angle, cp.k_contact))

    return contact_energy_fn
