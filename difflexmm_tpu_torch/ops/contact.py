"""Energy-based contact between blocks sharing a bond (counterpart of
``difflexmm_tpu/ops/contact.py``): a C^1 barrier on the two void angles
flanking each bond hinge (angle-based, the default), or on the distances
between the facing block edges next to each bond (distance-based)."""

import numpy as np
import torch

from difflexmm_tpu_torch.geometry.edges import compute_edge_angles
from difflexmm_tpu_torch.ops.kinematics import current_node_positions


def void_angles(current_block_nodes: torch.Tensor, bond_connectivity) -> torch.Tensor:
    """The two void angles of every bond, all first ones then all second
    ones: ``(2 * n_bonds,)``."""

    v1, v2, _, _ = compute_edge_angles(current_block_nodes, bond_connectivity)
    return torch.cat([v1, v2])


def point_to_edge_distance(point: torch.Tensor, edge: torch.Tensor) -> torch.Tensor:
    """Distance from points ``(..., 2)`` to segments ``(..., 2, 2)`` (their
    two end points), broadcast over the leading dimensions.

    The structure is JAX's as it is: both branches of each ``where`` are
    computed, and the unselected one gets a zero cotangent."""

    x0, x1 = edge[..., 0, :], edge[..., 1, :]
    d = x1 - x0
    p = point - x0
    t = torch.sum(p * d, dim=-1) / torch.sum(d * d, dim=-1)
    on_segment = (t >= 0) & (t <= 1)
    d_perp_sq = torch.sum(p * p, dim=-1) - t**2 * torch.sum(d * d, dim=-1)
    d_end_sq = torch.where(t < 0, torch.sum(p * p, dim=-1), torch.sum((point - x1) ** 2, dim=-1))
    return torch.sqrt(torch.where(on_segment, torch.maximum(d_perp_sq, d_perp_sq.new_zeros(())),
                                  d_end_sq))


def edges_distance(edge_1: torch.Tensor, edge_2: torch.Tensor) -> torch.Tensor:
    """Least distance between two segments, batched: ``(..., 2, 2)`` each ->
    ``(...)`` (ties share the gradient, as ``jnp.min``'s do)."""

    d = torch.stack([
        point_to_edge_distance(edge_2[..., 0, :], edge_1),
        point_to_edge_distance(edge_2[..., 1, :], edge_1),
        point_to_edge_distance(edge_1[..., 0, :], edge_2),
        point_to_edge_distance(edge_1[..., 1, :], edge_2),
    ], dim=-1)
    return torch.amin(d, dim=-1)


def build_void_edge_distance(bond_connectivity):
    """``fn(current_block_nodes (n_blocks, V, 2)) -> (2 * n_bonds,)``: the
    distances between the two pairs of facing edges next to each bond, all
    first sides then all second sides."""

    if isinstance(bond_connectivity, torch.Tensor):
        bond_connectivity = bond_connectivity.cpu().numpy()
    bonds = np.asarray(bond_connectivity, dtype=np.int64)

    def void_edge_distance(current_block_nodes: torch.Tensor) -> torch.Tensor:
        V = current_block_nodes.shape[-2]
        n1, n2 = bonds[:, 0], bonds[:, 1]
        # numpy's % is floor modulo, as jnp's: (k - 1) % V wraps to V - 1.
        b1, k1 = n1 // V, n1 % V
        b2, k2 = n2 // V, n2 % V

        def node(b, k):
            return current_block_nodes[torch.as_tensor(b, device=current_block_nodes.device),
                                       torch.as_tensor(k, device=current_block_nodes.device)]

        p1, p1_prev, p1_next = node(b1, k1), node(b1, (k1 - 1) % V), node(b1, (k1 + 1) % V)
        p2, p2_prev, p2_next = node(b2, k2), node(b2, (k2 - 1) % V), node(b2, (k2 + 1) % V)
        side1 = edges_distance(torch.stack([p1, p1_next], dim=-2),
                               torch.stack([p2, p2_prev], dim=-2))
        side2 = edges_distance(torch.stack([p1, p1_prev], dim=-2),
                               torch.stack([p2, p2_next], dim=-2))
        return torch.cat([side1, side2])

    return void_edge_distance


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
    of every bond, or (``angle_based=False``) on the distances between both
    pairs of facing edges, the contact parameters then read as distances."""

    void_edge_distance = build_void_edge_distance(bond_connectivity)

    def gaps(nodes):
        if angle_based:
            return void_angles(nodes, bond_connectivity)
        return void_edge_distance(nodes)

    def contact_energy_fn(block_displacement: torch.Tensor, control_params):
        gp = control_params.geometrical_params
        cp = control_params.mechanical_params.contact_params
        nodes = current_node_positions(block_displacement, gp.block_centroids,
                                       gp.centroid_node_vectors)
        return torch.sum(contact_energy(gaps(nodes), cp.min_angle, cp.cutoff_angle,
                                        cp.k_contact))

    return contact_energy_fn
