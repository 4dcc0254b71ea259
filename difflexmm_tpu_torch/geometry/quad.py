"""Quadrilateral lattice geometries (counterpart of
``difflexmm_tpu/geometry/quad.py``): ``QuadGeometry`` and
``RotatedSquareGeometry``.

Block numbering is row-major with n1 fastest (``block = j * n1 + i``);
local nodes are ordered (0: right, 1: top, 2: left, 3: bottom).
Horizontal bonds join node 0 of block (i, j) to node 2 of block (i+1, j);
vertical bonds node 1 of (i, j) to node 3 of (i, j+1).
"""

import math
from typing import Tuple

import numpy as np
import torch

from difflexmm_tpu_torch.geometry.base import LatticeGeometry
from difflexmm_tpu_torch.geometry.polygon import polygon_centroid


def _rot(angle: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 2) by angles (broadcastable to v[..., 0])."""

    c, s = torch.cos(angle), torch.sin(angle)
    return torch.stack(
        [c * v[..., 0] - s * v[..., 1], s * v[..., 0] + c * v[..., 1]], dim=-1
    )


def _grid_indices(n1: int, n2: int) -> Tuple[np.ndarray, np.ndarray]:
    """(I, J) block grid coordinates in block-id order (n1 fastest)."""

    b = np.arange(n1 * n2)
    return b % n1, b // n1


def _grid_bonds(n1: int, n2: int) -> np.ndarray:
    """Connectivity of a quad grid: horizontal bonds then vertical bonds."""

    I, J = np.meshgrid(np.arange(n1 - 1), np.arange(n2), indexing="ij")
    bh = (J.T * n1 + I.T).ravel()
    horizontal = np.stack([bh * 4 + 0, (bh + 1) * 4 + 2], axis=1)
    I, J = np.meshgrid(np.arange(n1), np.arange(n2 - 1), indexing="ij")
    bv = (J.T * n1 + I.T).ravel()
    vertical = np.stack([bv * 4 + 1, (bv + n1) * 4 + 3], axis=1)
    return np.concatenate([horizontal, vertical]).astype(np.int32)


def _grid_reference_bond_vectors(n1: int, n2: int, bond_length: float) -> np.ndarray:
    n_h = (n1 - 1) * n2
    n_v = n1 * (n2 - 1)
    out = np.zeros((n_h + n_v, 2))
    out[:n_h, 0] = bond_length
    out[n_h:, 1] = bond_length
    return out


class QuadGeometry(LatticeGeometry):
    """Aperiodic lattice of quadrangles with finite-length bonds.

    The design moves every hinge node: ``horizontal_shift`` (n1+1, n2, 2)
    the horizontally aligned hinges, ``vertical_shift`` (n1, n2+1, 2) the
    vertically aligned ones. Node offsets of block (i, j): node 0 takes
    horizontal_shift[i+1, j], node 1 vertical_shift[i, j+1], node 2
    horizontal_shift[i, j], node 3 vertical_shift[i, j]. A population of
    designs carries leading batch dimensions on both shift grids; the
    parametrization keeps them (``(B, n_blocks, 4, 2)`` corner vectors).
    """

    def __init__(
        self,
        n1_blocks: int,
        n2_blocks: int,
        spacing: float = 1.0,
        bond_length: float = 0.1,
    ):
        super().__init__(n1_cells=n1_blocks, n2_cells=n2_blocks, n_bpc=1)
        self.spacing = spacing
        self.bond_length = bond_length
        self.n1_blocks = n1_blocks
        self.n2_blocks = n2_blocks
        self.n_npb = 4
        self.n_nodes = self.n_npb * self.n_blocks

    def compute_geometry(self) -> None:
        n1, n2 = self.n1_blocks, self.n2_blocks
        I_np, J_np = _grid_indices(n1, n2)
        half = (self.spacing - self.bond_length) / 2
        v0s_np = half * np.array([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]])
        basis = self.spacing * np.eye(2)
        ref_points_np = I_np[:, None] * basis[0] + J_np[:, None] * basis[1]

        def reference_node_vectors(horizontal_shift, vertical_shift):
            like = dict(device=horizontal_shift.device)
            I = torch.as_tensor(I_np, **like)
            J = torch.as_tensor(J_np, **like)
            offsets = torch.stack(
                [
                    horizontal_shift[..., I + 1, J, :],
                    vertical_shift[..., I, J + 1, :],
                    horizontal_shift[..., I, J, :],
                    vertical_shift[..., I, J, :],
                ],
                dim=-2,
            )  # (..., n_blocks, 4, 2)
            v0s = torch.as_tensor(v0s_np, dtype=horizontal_shift.dtype, **like)
            return v0s + offsets

        def centroid_node_vectors(horizontal_shift, vertical_shift):
            ref = reference_node_vectors(horizontal_shift, vertical_shift)
            return ref - polygon_centroid(ref)[..., None, :]

        def block_centroids(horizontal_shift, vertical_shift):
            ref = reference_node_vectors(horizontal_shift, vertical_shift)
            ref_points = torch.as_tensor(
                ref_points_np, dtype=ref.dtype, device=ref.device
            )
            return ref_points + polygon_centroid(ref)

        bonds = _grid_bonds(n1, n2)
        ref_bond_vecs = torch.as_tensor(
            _grid_reference_bond_vectors(n1, n2, self.bond_length)
        )

        self.centroid_node_vectors = centroid_node_vectors
        self.block_centroids = block_centroids
        self.bond_connectivity = lambda: bonds
        self.reference_bond_vectors = lambda: ref_bond_vecs

    def get_design_from_rotated_square(
        self, angle, device=None, dtype=torch.float64
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Shifts reproducing a rotated-square lattice at the given angle
        (the standard initial guess for inverse design)."""

        n1, n2 = self.n1_blocks, self.n2_blocks
        half = (self.spacing - self.bond_length) / 2
        like = dict(device=device, dtype=dtype)
        angle = torch.as_tensor(angle, **like)

        def hinge_vector(sign):
            a = sign * angle
            return (half / torch.cos(a))[..., None] * torch.stack(
                [torch.cos(a), torch.sin(a)], dim=-1
            )

        def sign_grid(nx, ny):
            I, J = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
            return torch.as_tensor((-1.0) ** (I + J), **like)

        offset = torch.tensor([half, 0.0], **like)
        horizontal = hinge_vector(sign_grid(n1 + 1, n2)) - offset
        vertical = _rot(
            torch.tensor(math.pi / 2, **like),
            hinge_vector(sign_grid(n1, n2 + 1)) - offset,
        )
        return horizontal, vertical


class RotatedSquareGeometry(LatticeGeometry):
    """Rotated-square lattice: one global design angle, checkerboard parity.

    ``n1_cells x n2_cells`` cells of 2 x 2 blocks. The block at grid
    position (i, j) sits at ``spacing * (i, j)`` for any angle; its node
    vectors are the four quarter-turn rotations of
    ``(s - l) / (2 cos(p * angle)) * (cos(p * angle), sin(p * angle))``
    with parity ``p = (-1)^(i + j)``. The design is the angle: a tensor
    (its dtype and device are the parametrization's) or a Python number
    (float64 on the CPU).
    """

    def __init__(
        self,
        n1_cells: int,
        n2_cells: int,
        spacing: float = 1.0,
        bond_length: float = 0.1,
    ):
        super().__init__(n1_cells=n1_cells, n2_cells=n2_cells, n_bpc=4)
        self.spacing = spacing
        self.bond_length = bond_length
        self.n1_blocks = 2 * n1_cells
        self.n2_blocks = 2 * n2_cells
        self.n_npb = 4
        self.n_nodes = self.n_npb * self.n_blocks

    def compute_geometry(self) -> None:
        n1, n2 = self.n1_blocks, self.n2_blocks
        I_np, J_np = _grid_indices(n1, n2)
        parity_np = (-1.0) ** (I_np + J_np)
        half = (self.spacing - self.bond_length) / 2
        basis = self.spacing * np.eye(2)
        ref_points_np = I_np[:, None] * basis[0] + J_np[:, None] * basis[1]

        def as_angle(angle):
            if isinstance(angle, torch.Tensor):
                return angle
            return torch.tensor(float(angle), dtype=torch.float64)

        def centroid_node_vectors(angle):
            angle = as_angle(angle)
            like = dict(dtype=angle.dtype, device=angle.device)
            a = torch.as_tensor(parity_np, **like) * angle  # (n_blocks,)
            v0 = (half / torch.cos(a))[:, None] * torch.stack(
                [torch.cos(a), torch.sin(a)], dim=-1
            )  # (n_blocks, 2)
            quarter_turns = torch.tensor([0.0, 0.5, 1.0, 1.5], **like) * math.pi
            return _rot(quarter_turns[None, :], v0[:, None, :])

        def block_centroids(angle):
            angle = as_angle(angle)  # the centroids do not depend on it
            return torch.as_tensor(ref_points_np, dtype=angle.dtype, device=angle.device)

        bonds = _grid_bonds(n1, n2)
        ref_bond_vecs = torch.as_tensor(
            _grid_reference_bond_vectors(n1, n2, self.bond_length)
        )

        self.centroid_node_vectors = centroid_node_vectors
        self.block_centroids = block_centroids
        self.bond_connectivity = lambda: bonds
        self.reference_bond_vectors = lambda: ref_bond_vecs
