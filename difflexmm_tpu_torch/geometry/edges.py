"""Batched block-edge utilities of the fabrication constraints (counterpart
of ``difflexmm_tpu/geometry/edges.py``, same operations in the same
order)."""

from typing import Tuple

import torch

from difflexmm_tpu_torch.geometry.polygon import signed_angle


def edge_unit_vectors(current_block_nodes: torch.Tensor,
                      node_ids) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unit vectors from each node to its next and previous neighbour on
    its block.

    ``current_block_nodes`` (n_blocks, V, 2); ``node_ids`` (...,) global
    node indices ``block_id * V + local_id``. Returns ``(u_next, u_prev)``,
    each (..., 2).
    """

    V = current_block_nodes.shape[-2]
    node_ids = torch.as_tensor(node_ids, dtype=torch.int64, device=current_block_nodes.device)
    b, k = node_ids // V, node_ids % V
    node = current_block_nodes[b, k]
    e_next = current_block_nodes[b, (k + 1) % V] - node
    e_prev = current_block_nodes[b, (k - 1) % V] - node
    u_next = e_next / torch.linalg.norm(e_next, dim=-1, keepdim=True)
    u_prev = e_prev / torch.linalg.norm(e_prev, dim=-1, keepdim=True)
    return u_next, u_prev


def compute_edge_angles(current_block_nodes: torch.Tensor, bonds):
    """``(void_1, void_2, block_1, block_2)`` at each bond hinge: the two
    void wedges between the facing block edges and the two block wedges at
    the bond's nodes, signed angles in [-pi, pi]. ``bonds`` (n_bonds, 2)
    global node index pairs."""

    bonds = torch.as_tensor(bonds, dtype=torch.int64, device=current_block_nodes.device)
    n1, n2 = bonds[..., 0], bonds[..., 1]
    u1_next, u1_prev = edge_unit_vectors(current_block_nodes, n1)
    u2_next, u2_prev = edge_unit_vectors(current_block_nodes, n2)
    void_1 = signed_angle(u2_prev, u1_next)
    void_2 = signed_angle(u1_prev, u2_next)
    block_1 = signed_angle(u1_next, u1_prev)
    block_2 = signed_angle(u2_next, u2_prev)
    return void_1, void_2, block_1, block_2


def compute_block_angles(current_block_nodes: torch.Tensor, node_ids) -> torch.Tensor:
    """Interior wedge angle of each block at the given nodes, (...,)."""

    u_next, u_prev = edge_unit_vectors(current_block_nodes, node_ids)
    return signed_angle(u_next, u_prev)
