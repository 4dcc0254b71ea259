"""Magnetic dipole-dipole interaction energy between blocks (counterpart
of ``difflexmm_tpu/ops/magnetic.py``).

Each block carries one dipole at its centroid whose in-plane direction
co-rotates with the block; the pairwise energy over all block pairs is

    E_ij = C [ m_i . m_j - 3 (m_i . r_hat)(m_j . r_hat) ] / r^3

with C = mu0 / (4 pi) (``prefactor``) and r the current centre-to-centre
vector. ``dipole_angles = (in_plane_angle, pitch)``: the in-plane moment
is ``strength * cos(pitch)`` at angle ``in_plane_angle + theta_block``,
the out-of-plane one ``strength * sin(pitch)``. Every pair is evaluated
densely, an ``(n_blocks, n_blocks)`` computation.
"""

from typing import Callable

import torch

from difflexmm_tpu_torch.utils.types import ControlParams


def magnetic_dipole_energy(
    positions: torch.Tensor,
    rotations: torch.Tensor,
    dipole_angles: torch.Tensor,
    dipole_strengths,
    prefactor: float = 1.0,
    min_distance: float = 0.1,
) -> torch.Tensor:
    """Total dipole-dipole energy of blocks at ``positions`` ``(n, 2)``
    with rotations ``(n,)``, ``dipole_angles`` ``(n, 2)`` [in-plane angle,
    pitch] and scalar or ``(n,)`` strengths; ``min_distance`` is a
    saturation core radius that keeps energies and gradients finite
    through a collapse."""

    n = positions.shape[0]
    like = dict(dtype=positions.dtype, device=positions.device)
    strengths = torch.broadcast_to(torch.as_tensor(dipole_strengths, **like), (n,))
    phi = dipole_angles[:, 0] + rotations
    pitch = dipole_angles[:, 1]
    m_inplane = strengths * torch.cos(pitch)
    mx = m_inplane * torch.cos(phi)
    my = m_inplane * torch.sin(phi)
    mz = strengths * torch.sin(pitch)

    dx = positions[:, None, 0] - positions[None, :, 0]
    dy = positions[:, None, 1] - positions[None, :, 1]
    r2 = dx * dx + dy * dy
    r = torch.sqrt(torch.maximum(r2, torch.as_tensor(min_distance**2, **like)))
    rx, ry = dx / r, dy / r

    mm = mx[:, None] * mx[None, :] + my[:, None] * my[None, :] + mz[:, None] * mz[None, :]
    mr_i = mx[:, None] * rx + my[:, None] * ry
    mr_j = mx[None, :] * rx + my[None, :] * ry

    pair_energy = prefactor * (mm - 3.0 * mr_i * mr_j) / r**3
    off_diagonal = 1.0 - torch.eye(n, **like)
    return 0.5 * torch.sum(pair_energy * off_diagonal)


def build_magnetic_energy(prefactor: float = 1.0, min_distance: float = 0.1) -> Callable:
    """The magnetic energy as a ``(block_displacement, control_params)``
    functional (composable with ``combine_block_energies``): reads
    ``control_params.magnetic_params`` (:class:`MagneticParams`; zero
    where None) and the current block centroids."""

    def magnetic_energy_fn(block_displacement: torch.Tensor, control_params: ControlParams):
        mp = control_params.magnetic_params
        if mp is None:
            return block_displacement.new_zeros(())
        centroids = control_params.geometrical_params.block_centroids
        positions = centroids + block_displacement[:, :2]
        rotations = block_displacement[:, 2]
        like = dict(dtype=block_displacement.dtype, device=block_displacement.device)
        return magnetic_dipole_energy(
            positions, rotations, torch.as_tensor(mp.dipole_angles, **like),
            mp.dipole_strengths, prefactor=prefactor, min_distance=min_distance)

    return magnetic_energy_fn
