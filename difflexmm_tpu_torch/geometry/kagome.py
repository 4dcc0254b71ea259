"""Kagome lattice geometries (counterpart of ``KagomeGeometry``,
``KagomePeriodicGeometry`` and ``_kagome_bond_data`` in
``difflexmm_tpu/geometry/kagome.py``).

Each unit cell holds two triangular blocks: block ``2 * cell`` ("down",
local nodes 0-2) and ``2 * cell + 1`` ("up", cell nodes 3-5). Cells are
ordered n2-major with n1 fastest (``cell = j * n1_cells + i``). Bonds:
internal [1, 3] of each cell, then boundary-1 [0 of cell (i, j+1), 5 of
cell (i, j)], then boundary-2 [2 of cell (i+1, j), 4 of cell (i, j)].
"""

import math
from typing import Tuple

import numpy as np
import torch

from difflexmm_tpu_torch.geometry.base import LatticeGeometry
from difflexmm_tpu_torch.geometry.polygon import polygon_centroid

_DEFAULT_BASIS = np.array([[1.0, 0.0], [np.cos(np.pi / 3), np.sin(np.pi / 3)]])


def _kagome_bond_data(n1: int, n2: int, bond_length: float):
    """Static connectivity, reference bond vectors and the three families'
    reference vectors (numpy float64) of a kagome grid."""

    npc = 6  # nodes per cell

    def cell_ids(i, j):
        return (j * n1 + i) * npc

    I, J = np.meshgrid(np.arange(n1), np.arange(n2), indexing="ij")
    c = cell_ids(I.T, J.T).ravel()  # n2-major order
    internal = np.stack([c + 1, c + 3], axis=1)

    I, J = np.meshgrid(np.arange(n1), np.arange(n2 - 1), indexing="ij")
    c0 = cell_ids(I.T, J.T).ravel()
    c_up = cell_ids(I.T, J.T + 1).ravel()
    boundary1 = np.stack([c_up + 0, c0 + 5], axis=1)

    I, J = np.meshgrid(np.arange(n1 - 1), np.arange(n2), indexing="ij")
    c0 = cell_ids(I.T, J.T).ravel()
    c_right = cell_ids(I.T + 1, J.T).ravel()
    boundary2 = np.stack([c_right + 2, c0 + 4], axis=1)

    bonds = np.concatenate([internal, boundary1, boundary2]).astype(np.int32)

    ref_internal = bond_length * np.array([np.cos(np.pi / 6), np.sin(np.pi / 6)])
    ref_boundary1 = bond_length * np.array([0.0, -1.0])
    ref_boundary2 = bond_length * np.array([-np.cos(np.pi / 6), np.sin(np.pi / 6)])
    ref_vectors = np.concatenate([
        np.tile(ref_internal, (len(internal), 1)),
        np.tile(ref_boundary1, (len(boundary1), 1)),
        np.tile(ref_boundary2, (len(boundary2), 1)),
    ])
    return bonds, ref_vectors, ref_internal, ref_boundary1, ref_boundary2


class KagomeGeometry(LatticeGeometry):
    """Non-periodic kagome: every hinge node moves independently.

    The design is three shift grids placing the three families of hinge
    points: ``shifts_1`` (n1+1, n2, 2) nodes 2 (of cell i, j) and 4 (of cell
    i-1, j); ``shifts_2`` (n1, n2+1, 2) nodes 0 (of cell i, j) and 5 (of
    cell i, j-1); ``shifts_3`` (n1, n2, 2) the internal hinge, nodes 1 and
    3. Design maps follow the shifts' device and dtype, and keep leading
    batch dimensions of a population of designs.
    """

    def __init__(
        self,
        n1_cells: int,
        n2_cells: int,
        direct_basis=_DEFAULT_BASIS,
        bond_length: float = 0.1,
    ):
        super().__init__(n1_cells=n1_cells, n2_cells=n2_cells, n_bpc=2,
                         direct_basis=np.asarray(direct_basis, dtype=np.float64))
        self.bond_length = bond_length
        self.n_npb = 3
        self.n_nodes = self.n_npb * self.n_blocks

    def _base_blocks(self):
        """Unshifted node positions of the two cell triangles, with bond
        gaps (numpy float64)."""

        a1, a2 = self.direct_basis
        _, _, ref_int, ref_b1, ref_b2 = _kagome_bond_data(1, 1, self.bond_length)
        block_1 = np.stack([a1 / 2, a1 / 2 + a2 / 2, a2 / 2]) - 0.5 * np.stack(
            [ref_b1, ref_int, ref_b2]
        )
        block_2 = np.stack([a1 / 2 + a2 / 2, a1 + a2 / 2, a1 / 2 + a2]) + 0.5 * np.stack(
            [ref_int, ref_b2, ref_b1]
        )
        return block_1, block_2

    def compute_geometry(self) -> None:
        n1 = self.n1_cells
        a1, a2 = self.direct_basis
        block_1_np, block_2_np = self._base_blocks()

        # Cell grid coordinates in cell-id order (n2-major, n1 fastest).
        cell = np.arange(self.n_cells)
        I_np, J_np = cell % n1, cell // n1
        origins_np = np.repeat(I_np[:, None] * a1 + J_np[:, None] * a2, 2, axis=0)

        def reference_node_vectors(shifts_1, shifts_2, shifts_3):
            """Node positions relative to each cell origin, (n_blocks, 3, 2)."""

            like = dict(dtype=shifts_1.dtype, device=shifts_1.device)
            I = torch.as_tensor(I_np, device=shifts_1.device)
            J = torch.as_tensor(J_np, device=shifts_1.device)
            b1 = torch.as_tensor(block_1_np, **like) + torch.stack(
                [shifts_2[..., I, J, :], shifts_3[..., I, J, :], shifts_1[..., I, J, :]], dim=-2
            )
            b2 = torch.as_tensor(block_2_np, **like) + torch.stack(
                [shifts_3[..., I, J, :], shifts_1[..., I + 1, J, :], shifts_2[..., I, J + 1, :]],
                dim=-2,
            )
            # Interleave per cell: (..., n_cells, 2, 3, 2) -> (..., n_blocks, 3, 2)
            cells = torch.stack([b1, b2], dim=-3)
            return cells.reshape(cells.shape[:-4] + (self.n_blocks, 3, 2))

        def centroid_node_vectors(shifts_1, shifts_2, shifts_3):
            ref = reference_node_vectors(shifts_1, shifts_2, shifts_3)
            return ref - polygon_centroid(ref)[..., None, :]

        def block_centroids(shifts_1, shifts_2, shifts_3):
            ref = reference_node_vectors(shifts_1, shifts_2, shifts_3)
            origins = torch.as_tensor(origins_np, dtype=ref.dtype, device=ref.device)
            return origins + polygon_centroid(ref)

        bonds, ref_vectors, *_ = _kagome_bond_data(n1, self.n2_cells, self.bond_length)
        ref_bond_vecs = torch.as_tensor(ref_vectors)

        self.centroid_node_vectors = centroid_node_vectors
        self.block_centroids = block_centroids
        self.bond_connectivity = lambda: bonds
        self.reference_bond_vectors = lambda: ref_bond_vecs

    def zero_design(self, device=None, dtype=torch.float64) -> Tuple[torch.Tensor, ...]:
        """Zero shifts (the regular kagome) with the right shapes."""

        n1, n2 = self.n1_cells, self.n2_cells
        like = dict(device=device, dtype=dtype)
        return (
            torch.zeros((n1 + 1, n2, 2), **like),
            torch.zeros((n1, n2 + 1, 2), **like),
            torch.zeros((n1, n2, 2), **like),
        )


class KagomePeriodicGeometry(LatticeGeometry):
    """Periodic kagome: one ``(3, 2)`` shift triple shared by every cell.

    Block 2 of each cell is block 1 rotated by -60 degrees; the shifts move
    block 1's nodes in the order (0, 1, 2) and block 2's in the order (1,
    2, 0). The design maps take the shift triple (zero by default), follow
    its device and dtype, and keep leading batch dimensions ``(..., 3,
    2)`` of a population of designs. The bonds and reference bond vectors
    are :class:`KagomeGeometry`'s, so the kagome grid energy and its
    kernels take this geometry as they are; only the leaves differ.
    """

    def __init__(
        self,
        n1_cells: int,
        n2_cells: int,
        direct_basis=_DEFAULT_BASIS,
        bond_length: float = 0.1,
    ):
        super().__init__(n1_cells=n1_cells, n2_cells=n2_cells, n_bpc=2,
                         direct_basis=np.asarray(direct_basis, dtype=np.float64))
        self.bond_length = bond_length
        self.n_npb = 3
        self.n_nodes = self.n_npb * self.n_blocks

    def compute_geometry(self) -> None:
        n1 = self.n1_cells
        a1, a2 = torch.as_tensor(self.direct_basis, dtype=torch.float64)
        _, _, ref_int, ref_b1, ref_b2 = (torch.as_tensor(x) for x in
                                         _kagome_bond_data(1, 1, self.bond_length))
        block_1_base = torch.stack([a1 / 2, a1 / 2 + a2 / 2, a2 / 2]) - 0.5 * torch.stack(
            [ref_b1, ref_int, ref_b2])
        block_1_centered = block_1_base - polygon_centroid(block_1_base)
        c, s = math.cos(-math.pi / 3), math.sin(-math.pi / 3)
        rotation = torch.tensor([[c, -s], [s, c]], dtype=torch.float64)
        block_2_centered = block_1_centered @ rotation.T
        centroid_1 = polygon_centroid(torch.stack([a1 / 2, a1 / 2 + a2 / 2, a2 / 2]))
        centroid_2 = polygon_centroid(torch.stack([a1 / 2 + a2 / 2, a1 + a2 / 2, a1 / 2 + a2]))
        base_centroids = torch.stack([centroid_1, centroid_2])  # (2, 2)
        cell = np.arange(self.n_cells)
        I, J = cell % n1, cell // n1
        cell_origins = (torch.as_tensor(I[:, None] * 1.0) * a1
                        + torch.as_tensor(J[:, None] * 1.0) * a2)  # (n_cells, 2)
        order_2 = [1, 2, 0]

        def default(shifts):
            return torch.zeros((3, 2), dtype=torch.float64) if shifts is None else shifts

        def cell_node_vectors(shifts):
            """The shifted cell triangles, ``(..., 2, 3, 2)``."""

            like = dict(dtype=shifts.dtype, device=shifts.device)
            b1 = block_1_centered.to(**like) + shifts
            b2 = block_2_centered.to(**like) + shifts[..., order_2, :]
            return torch.stack([b1, b2], dim=-3)

        def centroid_node_vectors(shifts=None):
            cell_blocks = cell_node_vectors(default(shifts))
            cnv = cell_blocks - polygon_centroid(cell_blocks)[..., None, :]
            lead = cnv.shape[:-3]
            return cnv[..., None, :, :, :].expand(lead + (self.n_cells, 2, 3, 2)).reshape(
                lead + (self.n_blocks, 3, 2))

        def block_centroids(shifts=None):
            cell_blocks = cell_node_vectors(default(shifts))
            like = dict(dtype=cell_blocks.dtype, device=cell_blocks.device)
            shifted = base_centroids.to(**like) + polygon_centroid(cell_blocks)  # (..., 2, 2)
            out = cell_origins.to(**like)[:, None, :] + shifted[..., None, :, :]
            return out.reshape(out.shape[:-3] + (self.n_blocks, 2))

        bonds, ref_vectors, *_ = _kagome_bond_data(n1, self.n2_cells, self.bond_length)
        ref_bond_vecs = torch.as_tensor(ref_vectors)

        self.centroid_node_vectors = centroid_node_vectors
        self.block_centroids = block_centroids
        self.bond_connectivity = lambda: bonds
        self.reference_bond_vectors = lambda: ref_bond_vecs
