"""Rigid-block kinematics and driven constraints (counterpart of
``difflexmm_tpu/ops/kinematics.py``): block DOFs to node DOFs, the dense
free/constrained DOF bookkeeping, and the constrained kinematics map."""

from typing import Callable, Dict

import numpy as np
import torch


def block_to_node_kinematics(block_displacement: torch.Tensor,
                             centroid_node_vectors: torch.Tensor) -> torch.Tensor:
    """Node displacements and rotations from block DOFs:
    ``u + (R(theta) - I) r`` for each centroid-to-node vector r, the third
    component carrying the block rotation. ``(..., n_blocks, 3)`` and
    ``(n_blocks, V, 2)`` -> ``(..., n_blocks, V, 3)``."""

    u = block_displacement[..., :2].unsqueeze(-2)  # (..., nb, 1, 2)
    theta = block_displacement[..., 2:3]  # (..., nb, 1)
    cm1 = torch.cos(theta) - 1.0
    s = torch.sin(theta)
    vx = centroid_node_vectors[..., 0]  # (nb, V)
    vy = centroid_node_vectors[..., 1]
    dx = u[..., 0] + cm1 * vx - s * vy
    dy = u[..., 1] + s * vx + cm1 * vy
    rot = torch.broadcast_to(theta, dx.shape)
    return torch.stack([dx, dy, rot], dim=-1)


def current_node_positions(block_displacement: torch.Tensor, block_centroids: torch.Tensor,
                           centroid_node_vectors: torch.Tensor) -> torch.Tensor:
    """Absolute current node positions ``(..., n_blocks, V, 2)``."""

    disp = block_to_node_kinematics(block_displacement, centroid_node_vectors)
    return block_centroids[:, None] + centroid_node_vectors + disp[..., :2]


class DOFSet:
    """Static free/constrained DOF bookkeeping as host (numpy) data.

    Attrs:
        free_mask: (n_blocks, 3) float64, 1 on free DOFs, 0 on constrained.
        constrained_blocks / constrained_dofs: (k,) int64 pair indices, in
            the order the pairs were given.
        n_constrained: number of constrained [block, DOF] pairs.
    """

    def __init__(self, n_blocks: int, constrained_block_DOF_pairs):
        pairs = np.asarray(constrained_block_DOF_pairs, dtype=np.int64).reshape(-1, 2)
        mask = np.ones((n_blocks, 3))
        mask[pairs[:, 0], pairs[:, 1]] = 0.0
        self.n_blocks = int(n_blocks)
        self.n_constrained = len(pairs)
        self.free_mask = mask
        self.constrained_blocks = pairs[:, 0].copy()
        self.constrained_dofs = pairs[:, 1].copy()
        self._tensors = {}

    def tensors(self, dtype, device):
        """``(free_mask, (blocks, dofs, pair_ids) of last_write_pairs)`` as
        tensors on ``device``, made once per dtype and device."""

        key = (dtype, torch.device(device))
        if key not in self._tensors:
            self._tensors[key] = (
                torch.as_tensor(self.free_mask, dtype=dtype, device=device),
                tuple(torch.as_tensor(x, device=device) for x in self.last_write_pairs()),
            )
        return self._tensors[key]

    def last_write_pairs(self):
        """Deduplicated ``(blocks, dofs, pair_ids)``: for each constrained
        [block, DOF] slot, the index of the LAST pair that targets it — the
        last-write-wins rule of the JAX scatter (``.at[].set``, and
        ``combine="last"`` of the Pallas drive scatter). Sorted by slot."""

        last = {}
        for c, (b, d) in enumerate(zip(self.constrained_blocks, self.constrained_dofs)):
            last[(int(b), int(d))] = c
        slots = sorted(last)
        blocks = np.array([b for b, _ in slots], dtype=np.int64)
        dofs = np.array([d for _, d in slots], dtype=np.int64)
        ids = np.array([last[s] for s in slots], dtype=np.int64)
        return blocks, dofs, ids

    def scatter_constrained(self, values: torch.Tensor) -> torch.Tensor:
        """Dense (n_blocks, 3) tensor (``values``' dtype and device) with
        ``values`` (scalar or (n_constrained,)) on the constrained DOFs and
        zero elsewhere; a slot named twice takes the last pair's value."""

        dense = values.new_zeros((self.n_blocks, 3))
        if self.n_constrained == 0:
            return dense
        values = torch.broadcast_to(values, (self.n_constrained,))
        blocks, dofs, ids = self.tensors(values.dtype, values.device)[1]
        return dense.index_put((blocks, dofs), values[ids])

    def gather_constrained(self, dense: torch.Tensor) -> torch.Tensor:
        """(n_constrained,) values of a dense (n_blocks, 3) field, in pair
        order."""

        index = tuple(torch.as_tensor(x, device=dense.device)
                      for x in (self.constrained_blocks, self.constrained_dofs))
        return dense[index]


def build_constrained_kinematics(geometry, constrained_block_DOF_pairs=np.zeros((0, 2)),
                                 constrained_DOFs_fn: Callable = lambda t, **kwargs: 0.0):
    """``constrained_kinematics(free_DOFs, t, constraint_params)``: the free
    state ``(n_blocks, 3)`` masked, plus the driven DOFs' values
    ``constrained_DOFs_fn(t, **constraint_params)`` on the constrained
    slots; its :class:`DOFSet` is the attribute ``dof_set``."""

    n_blocks = geometry if isinstance(geometry, int) else geometry.n_blocks
    dof_set = DOFSet(n_blocks, constrained_block_DOF_pairs)

    def constrained_kinematics(free_DOFs: torch.Tensor, t, constraint_params: Dict = {}):
        like = dict(dtype=free_DOFs.dtype, device=free_DOFs.device)
        u = free_DOFs.reshape(n_blocks, 3) * dof_set.tensors(**like)[0]
        if dof_set.n_constrained:
            values = torch.as_tensor(constrained_DOFs_fn(t, **constraint_params), **like)
            u = u + dof_set.scatter_constrained(values)
        return u

    constrained_kinematics.dof_set = dof_set
    return constrained_kinematics
