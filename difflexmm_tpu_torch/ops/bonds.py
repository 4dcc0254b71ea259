"""Per-bond ligament energies on the general bond list (counterpart of
``difflexmm_tpu/ops/bonds.py``, same operations in the same order).

Each energy takes ``nodal_DOFs = (DOFs1, DOFs2)``, each ``(n_bonds, 3)``
node (ux, uy, theta) at the bond's two ends, and per-bond (or scalar)
parameters, and returns the per-bond energies ``(n_bonds,)``.
"""

from typing import Tuple

import torch

_UNIT_X = (1.0, 0.0)


def vdot(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Row-wise dot product over the last axis."""

    return torch.sum(v1 * v2, dim=-1)


def _cross2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def _reference(reference_vector, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(reference_vector, dtype=like.dtype, device=like.device)


def simple_spring_energy(nodal_DOFs: Tuple[torch.Tensor, torch.Tensor],
                         reference_vector=_UNIT_X, k_stretch=1.0) -> torch.Tensor:
    """Linear spring on the change of the bond's length, per bond."""

    DOFs1, DOFs2 = nodal_DOFs
    r0 = _reference(reference_vector, DOFs1)
    dU = DOFs2[..., :2] - DOFs1[..., :2]
    length = torch.linalg.norm(dU + r0, dim=-1)
    length0 = torch.linalg.norm(r0, dim=-1)
    return k_stretch * (length - length0) ** 2 / 2


def stretching_torsional_spring_energy(nodal_DOFs: Tuple[torch.Tensor, torch.Tensor],
                                       k_stretch=1.0, k_rot=1.0) -> torch.Tensor:
    """Zero-length spring: the stretching of the gap plus the relative
    rotation, per bond."""

    DOFs1, DOFs2 = nodal_DOFs
    dU = DOFs2[..., :2] - DOFs1[..., :2]
    dRot = DOFs2[..., 2] - DOFs1[..., 2]
    return k_stretch * vdot(dU, dU) / 2 + k_rot * dRot**2 / 2


def ligament_strains_linearized(DOFs1: torch.Tensor, DOFs2: torch.Tensor,
                                reference_vector=_UNIT_X):
    """Linearized beam strains (axial, shear, rotational), per bond:
    ``axial = dU . r0 / |r0|^2``, ``shear = r0 x dU / |r0|^2 - (th1 +
    th2) / 2``, ``rotational = th2 - th1``."""

    r0 = _reference(reference_vector, DOFs1)
    dU = DOFs2[..., :2] - DOFs1[..., :2]
    dRot = DOFs2[..., 2] - DOFs1[..., 2]
    inv_l0_sq = 1.0 / vdot(r0, r0)
    axial = vdot(dU, r0) * inv_l0_sq
    shear = _cross2(r0, dU) * inv_l0_sq - (DOFs1[..., 2] + DOFs2[..., 2]) / 2
    return axial, shear, dRot


def ligament_strains(DOFs1: torch.Tensor, DOFs2: torch.Tensor, reference_vector=_UNIT_X):
    """Nonlinear (finite-rotation) beam strains, per bond: ``axial = |r| /
    |r0| - 1`` with r the current bond vector, ``shear`` the signed angle
    from the reference vector pushed forward by the mean rotation to r, in
    (-pi, pi], and ``rotational = th2 - th1``."""

    r0 = _reference(reference_vector, DOFs1)
    dU = DOFs2[..., :2] - DOFs1[..., :2]
    dRot = DOFs2[..., 2] - DOFs1[..., 2]
    mean_rot = (DOFs1[..., 2] + DOFs2[..., 2]) / 2
    r = dU + r0
    c, s = torch.cos(mean_rot), torch.sin(mean_rot)
    r0x = torch.broadcast_to(r0[..., 0], mean_rot.shape)
    r0y = torch.broadcast_to(r0[..., 1], mean_rot.shape)
    pushed_x = c * r0x - s * r0y
    pushed_y = s * r0x + c * r0y
    axial = torch.sqrt(vdot(r, r) / vdot(r0, r0)) - 1.0
    shear = torch.atan2(pushed_x * r[..., 1] - pushed_y * r[..., 0],
                        pushed_x * r[..., 0] + pushed_y * r[..., 1])
    return axial, shear, dRot


def _ligament_energy_from_strains(axial, shear, dRot, reference_vector, k_stretch, k_shear,
                                  k_rot) -> torch.Tensor:
    l0_sq = vdot(reference_vector, reference_vector)
    return (k_stretch * axial**2 * l0_sq / 2 + k_shear * shear**2 * l0_sq / 2
            + k_rot * dRot**2 / 2)


def ligament_energy_linearized(nodal_DOFs: Tuple[torch.Tensor, torch.Tensor],
                               reference_vector=_UNIT_X, k_stretch=1.0, k_shear=1.0,
                               k_rot=1.0) -> torch.Tensor:
    """Ligament energy with linearized strains (moderate rotations)."""

    r0 = _reference(reference_vector, nodal_DOFs[0])
    axial, shear, dRot = ligament_strains_linearized(*nodal_DOFs, reference_vector=r0)
    return _ligament_energy_from_strains(axial, shear, dRot, r0, k_stretch, k_shear, k_rot)


def ligament_energy(nodal_DOFs: Tuple[torch.Tensor, torch.Tensor], reference_vector=_UNIT_X,
                    k_stretch=1.0, k_shear=1.0, k_rot=1.0) -> torch.Tensor:
    """Ligament energy with nonlinear strains (arbitrary rotations)."""

    r0 = _reference(reference_vector, nodal_DOFs[0])
    axial, shear, dRot = ligament_strains(*nodal_DOFs, reference_vector=r0)
    return _ligament_energy_from_strains(axial, shear, dRot, r0, k_stretch, k_shear, k_rot)
