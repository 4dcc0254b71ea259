"""Gather-free gridded energy of kagome lattices (counterpart of
``difflexmm_tpu/ops/kagome_grid.py``, same operations in the same order).

Kagome cells tile an (n2, n1) grid with two triangular blocks per cell
(block ``2 * cell`` "down", ``2 * cell + 1`` "up"; local nodes 0-2 per
block). The three bond families are shifted slices over the cell grid
(``geometry/kagome.py``):

- internal: node 1 of the down triangle <-> node 0 of the up triangle of
  the same cell;
- boundary-1: node 0 of the down triangle of cell (j+1, i) <-> node 2 of
  the up triangle of cell (j, i);
- boundary-2: node 2 of the down triangle of cell (j, i+1) <-> node 1 of
  the up triangle of cell (j, i).

Contact neighbours are static corner indices within each triangle. This is
the dense energy of the kagome models' ``method="verlet"``; the fast path
has its own plane energy (``ops/kernels/verlet_kagome.py``).
"""

from typing import Callable

import torch

from difflexmm_tpu_torch.geometry.polygon import signed_angle
from difflexmm_tpu_torch.ops.bonds import ligament_energy
from difflexmm_tpu_torch.ops.contact import contact_energy
from difflexmm_tpu_torch.ops.kernels.verlet_kagome import split_bond_planes
from difflexmm_tpu_torch.ops.kinematics import block_to_node_kinematics
from difflexmm_tpu_torch.utils.types import ControlParams, LigamentParams


def _unit(v):
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def _split_ref(ref, n1: int, n2: int):
    """(n_bonds, 2) reference vectors -> (internal, boundary1, boundary2)
    grids ``(..., 2)``."""

    n_int, n_b1 = n1 * n2, n1 * (n2 - 1)
    return (ref[:n_int].reshape(n2, n1, 2), ref[n_int:n_int + n_b1].reshape(n2 - 1, n1, 2),
            ref[n_int + n_b1:].reshape(n2, n1 - 1, 2))


def build_kagome_grid_energy(n1_cells: int, n2_cells: int,
                             bond_energy_fn: Callable = ligament_energy,
                             use_contact: bool = True) -> Callable:
    """Strain (plus angle-based contact) energy of a kagome lattice with the
    ``energy_fn(block_displacement, control_params)`` contract of
    :func:`ops.assembly.build_strain_energy`."""

    n1, n2 = n1_cells, n2_cells

    def energy_fn(block_displacement: torch.Tensor, control_params: ControlParams):
        gp = control_params.geometrical_params
        mp = control_params.mechanical_params
        like = dict(dtype=block_displacement.dtype, device=block_displacement.device)
        bp = LigamentParams(*(torch.as_tensor(x, **like) for x in mp.bond_params))
        cnv = gp.centroid_node_vectors  # (2 * n_cells, 3, 2)

        node_DOFs = block_to_node_kinematics(block_displacement, cnv).reshape(n2, n1, 2, 3, 3)
        down = node_DOFs[:, :, 0]  # (n2, n1, 3, 3)
        up = node_DOFs[:, :, 1]

        ref = bp.reference_vector
        refs = _split_ref(ref, n1, n2) if ref.ndim > 1 else (ref,) * 3
        ks, ksh, kr = (split_bond_planes(k, n1, n2) for k in (bp.k_stretch, bp.k_shear,
                                                                bp.k_rot))
        ends = (
            (down[:, :, 1], up[:, :, 0]),
            (down[1:, :, 0], up[:-1, :, 2]),
            (down[:, 1:, 2], up[:, :-1, 1]),
        )
        strain = sum(
            torch.sum(bond_energy_fn(ends[f], reference_vector=refs[f], k_stretch=ks[f],
                                     k_shear=ksh[f], k_rot=kr[f]))
            for f in range(3)
        )

        if not use_contact or mp.contact_params is None:
            return strain

        cp = mp.contact_params
        positions = ((gp.block_centroids[:, None] + cnv).reshape(n2, n1, 2, 3, 2)
                     + node_DOFs[..., :2])
        p_down = positions[:, :, 0]  # (n2, n1, 3, 2)
        p_up = positions[:, :, 1]

        def corner_edges(p_block, corner):
            node = p_block[..., corner, :]
            e_next = p_block[..., (corner + 1) % 3, :] - node
            e_prev = p_block[..., (corner - 1) % 3, :] - node
            return _unit(e_next), _unit(e_prev)

        def voids(p1, c1, p2, c2):
            u1_next, u1_prev = corner_edges(p1, c1)
            u2_next, u2_prev = corner_edges(p2, c2)
            return signed_angle(u2_prev, u1_next), signed_angle(u1_prev, u2_next)

        gaps = []
        gaps += voids(p_down, 1, p_up, 0)  # internal
        gaps += voids(p_down[1:, :], 0, p_up[:-1, :], 2)  # boundary 1
        gaps += voids(p_down[:, 1:], 2, p_up[:, :-1], 1)  # boundary 2
        contact = sum(
            torch.sum(contact_energy(g, cp.min_angle, cp.cutoff_angle, cp.k_contact))
            for g in gaps
        )
        return strain + contact

    return energy_fn
