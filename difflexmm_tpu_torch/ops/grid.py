"""Gather-free gridded energy of quad-grid lattices (counterpart of
``difflexmm_tpu/ops/grid.py``).

For QuadGeometry and RotatedSquareGeometry the connectivity is a regular
(n2, n1) grid of 4-node blocks: horizontal bonds join corner 0 of block
(j, i) to corner 2 of block (j, i+1), vertical bonds corner 1 of (j, i) to
corner 3 of (j+1, i). Reshaping the node arrays to (n2, n1, 4, .) turns
every bond gather into a shifted slice. Bond parameter arrays ordered like
the general connectivity (all horizontal bonds n2-major, then all
vertical) are reshaped to the grid.
"""

from typing import Callable

import torch

from difflexmm_tpu_torch.geometry.polygon import signed_angle
from difflexmm_tpu_torch.ops.bonds import ligament_energy
from difflexmm_tpu_torch.ops.contact import contact_energy, edges_distance
from difflexmm_tpu_torch.ops.kinematics import block_to_node_kinematics
from difflexmm_tpu_torch.utils.types import ControlParams, LigamentParams


def _unit(v):
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def _grid_bond_params(value, n1: int, n2: int):
    """Split scalar-or-(n_bonds,) stiffness into (horizontal, vertical) grids."""

    value = torch.as_tensor(value)
    if value.ndim == 0:
        return value, value
    n_h = (n1 - 1) * n2
    return value[:n_h].reshape(n2, n1 - 1), value[n_h:].reshape(n2 - 1, n1)


def split_grid_bond_data(bond_params, n1: int, n2: int):
    """(ref_h, ref_v, ks_h, ks_v, ksh_h, ksh_v, kr_h, kr_v) grids from a
    LigamentParams whose bond arrays follow the general connectivity order
    (all horizontal bonds n2-major, then all vertical)."""

    n_h = (n1 - 1) * n2
    ref = torch.as_tensor(bond_params.reference_vector)
    if ref.ndim == 1:
        ref_h = ref_v = ref
    else:
        ref_h = ref[:n_h].reshape(n2, n1 - 1, 2)
        ref_v = ref[n_h:].reshape(n2 - 1, n1, 2)
    ks_h, ks_v = _grid_bond_params(bond_params.k_stretch, n1, n2)
    ksh_h, ksh_v = _grid_bond_params(bond_params.k_shear, n1, n2)
    kr_h, kr_v = _grid_bond_params(bond_params.k_rot, n1, n2)
    return ref_h, ref_v, ks_h, ks_v, ksh_h, ksh_v, kr_h, kr_v


def quad_grid_energy_core(
    block_displacement: torch.Tensor,
    cnv: torch.Tensor,
    block_centroids: torch.Tensor,
    ref_h, ref_v,
    ks_h, ks_v, ksh_h, ksh_v, kr_h, kr_v,
    contact_min, contact_cutoff, k_contact,
    n1: int, n2: int,
    bond_energy_fn: Callable = ligament_energy,
    use_contact: bool = True,
    angle_based: bool = True,
):
    """Total strain (plus, with ``use_contact``, contact) energy of a quad
    grid from block DOFs ``(n_blocks, 3)``, corner vectors ``(n_blocks, 4,
    2)`` and centroids ``(n_blocks, 2)``. The barrier acts on the void
    angles at each bond, or (``angle_based=False``) on the distances
    between the facing edges."""

    node_DOFs = block_to_node_kinematics(block_displacement, cnv).reshape(n2, n1, 4, 3)
    h1 = node_DOFs[:, :-1, 0, :]
    h2 = node_DOFs[:, 1:, 2, :]
    v1 = node_DOFs[:-1, :, 1, :]
    v2 = node_DOFs[1:, :, 3, :]
    strain = torch.sum(
        bond_energy_fn((h1, h2), reference_vector=ref_h, k_stretch=ks_h, k_shear=ksh_h,
                       k_rot=kr_h)
    ) + torch.sum(
        bond_energy_fn((v1, v2), reference_vector=ref_v, k_stretch=ks_v, k_shear=ksh_v,
                       k_rot=kr_v)
    )
    if not use_contact:
        return strain

    positions = (block_centroids[:, None] + cnv).reshape(n2, n1, 4, 2) + node_DOFs[..., :2]

    def corner_edges(p_block, corner):
        node = p_block[..., corner, :]
        return (p_block[..., (corner + 1) % 4, :] - node,
                p_block[..., (corner - 1) % 4, :] - node, node)

    def gaps(p1_block, c1, p2_block, c2):
        """Void angles (or edge distances) at bonds joining corner c1 of
        the first block set to corner c2 of the second."""

        e1_next, e1_prev, node1 = corner_edges(p1_block, c1)
        e2_next, e2_prev, node2 = corner_edges(p2_block, c2)
        if angle_based:
            return (signed_angle(_unit(e2_prev), _unit(e1_next)),
                    signed_angle(_unit(e1_prev), _unit(e2_next)))
        return (edges_distance(torch.stack([node1, node1 + e1_next], dim=-2),
                               torch.stack([node2, node2 + e2_prev], dim=-2)),
                edges_distance(torch.stack([node1, node1 + e1_prev], dim=-2),
                               torch.stack([node2, node2 + e2_next], dim=-2)))

    vh1, vh2 = gaps(positions[:, :-1], 0, positions[:, 1:], 2)
    vv1, vv2 = gaps(positions[:-1, :], 1, positions[1:, :], 3)
    contact = sum(
        torch.sum(contact_energy(g, contact_min, contact_cutoff, k_contact))
        for g in (vh1, vh2, vv1, vv2)
    )
    return strain + contact


def build_quad_grid_energy(n1_blocks: int, n2_blocks: int,
                           bond_energy_fn: Callable = ligament_energy,
                           use_contact: bool = True, angle_based: bool = True) -> Callable:
    """Strain (plus contact) energy on the quad grid with the
    ``energy_fn(block_displacement, control_params)`` contract of
    :func:`ops.assembly.build_strain_energy`."""

    n1, n2 = n1_blocks, n2_blocks

    def energy_fn(block_displacement: torch.Tensor, control_params: ControlParams):
        gp = control_params.geometrical_params
        mp = control_params.mechanical_params
        like = dict(dtype=block_displacement.dtype, device=block_displacement.device)
        bond_params = LigamentParams(*(torch.as_tensor(x, **like) for x in mp.bond_params))
        bond_data = split_grid_bond_data(bond_params, n1, n2)
        contact_on = use_contact and mp.contact_params is not None
        if contact_on:
            cmin, ccut, kc = mp.contact_params
        else:
            cmin = ccut = kc = 0.0
        return quad_grid_energy_core(
            block_displacement, gp.centroid_node_vectors, gp.block_centroids, *bond_data,
            cmin, ccut, kc, n1, n2, bond_energy_fn=bond_energy_fn, use_contact=contact_on,
            angle_based=angle_based,
        )

    return energy_fn
