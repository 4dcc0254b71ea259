"""Geometry plugin contract (counterpart of ``difflexmm_tpu/geometry/base.py``).

A geometry maps a design to ``block_centroids(design) -> (n_blocks, 2)``,
``centroid_node_vectors(design) -> (n_blocks, n_npb, 2)``, the static
``bond_connectivity() -> (n_bonds, 2)`` node-index pairs and
``reference_bond_vectors() -> (n_bonds, 2)``. Design maps are torch
functions of the design tensors and follow their device and dtype;
connectivity is numpy host data, and reference bond vectors are float64
CPU tensors that callers move where they need them.
"""

from typing import Callable, Optional, Tuple

import numpy as np


class Geometry:
    """Template class for geometric design parametrizations."""

    n_blocks: int
    n_npb: int
    n_nodes: int
    block_centroids: Callable
    centroid_node_vectors: Callable
    bond_connectivity: Callable
    reference_bond_vectors: Callable

    def compute_geometry(self) -> None:
        """Install the four parametrization callables on ``self``."""

        raise NotImplementedError("Geometry subclasses must implement this.")

    def get_parametrization(self) -> Tuple[Callable, Callable, Callable, Callable]:
        """(block_centroids, centroid_node_vectors, bond_connectivity,
        reference_bond_vectors)."""

        self.compute_geometry()
        return (
            self.block_centroids,
            self.centroid_node_vectors,
            self.bond_connectivity,
            self.reference_bond_vectors,
        )


class LatticeGeometry(Geometry):
    """A geometry tiled from unit cells on a 2D Bravais grid whose lattice
    vectors are the rows of ``direct_basis`` (2, 2) (identity by default)."""

    def __init__(self, n1_cells: int, n2_cells: int, n_bpc: int,
                 direct_basis: Optional[np.ndarray] = None):
        self.n1_cells = n1_cells
        self.n2_cells = n2_cells
        self.n_bpc = n_bpc
        self.n_cells = n1_cells * n2_cells
        self.n_blocks = self.n_cells * n_bpc
        self.direct_basis = direct_basis if direct_basis is not None else np.eye(2)
