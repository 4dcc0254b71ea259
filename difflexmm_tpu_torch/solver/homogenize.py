"""Homogenized effective elasticity of periodic block-spring
metamaterials (counterpart of ``difflexmm_tpu/solver/homogenize.py``).

The 2D elasticity tensor of a :class:`solver.bloch.BlochCell` by static
condensation of the cell's micro-DOFs,

    C_ijkl = (1/V) * ( E_FF  -  E_Fu K^+ E_uF )_ijkl

where ``E(u, F)`` is :func:`solver.bloch.cell_strain_energy` (cell-periodic
block DOFs ``u`` under a homogeneous deformation gradient ``F``), every
second derivative by ``torch.func`` at the (relaxed) state; the
condensation lets the micro-structure relax against the imposed strain,
which makes rotating-square lattices auxetic. Differentiable with
respect to the cell.
"""

from typing import Callable, Optional

import torch

from difflexmm_tpu_torch.ops.bonds import ligament_energy
from difflexmm_tpu_torch.solver.bloch import BlochCell, cell_strain_energy, relax_cell


def _state(cell: BlochCell, affine, bond_energy_fn, displacement, relax):
    cnv = cell.centroid_node_vectors
    like = dict(dtype=cnv.dtype, device=cnv.device)
    B = int(cnv.shape[0])
    F0 = torch.eye(2, **like) if affine is None else torch.as_tensor(affine, **like)
    if displacement is not None:
        u0 = torch.as_tensor(displacement, **like)
    elif relax:
        u0 = relax_cell(cell, affine=F0, bond_energy_fn=bond_energy_fn)
    else:
        u0 = torch.zeros((B, 3), **like)
    V = torch.abs(torch.linalg.det(torch.as_tensor(cell.direct_basis, **like)))
    return F0, u0, V, B, like


def effective_moduli(cell: BlochCell, affine: Optional[torch.Tensor] = None,
                     bond_energy_fn: Callable = ligament_energy,
                     displacement: Optional[torch.Tensor] = None, relax: bool = True,
                     condense: bool = True) -> torch.Tensor:
    """``(2, 2, 2, 2)`` homogenized tangent elasticity tensor ``C_ijkl``
    about the state ``(displacement, affine)``; with ``relax`` and no
    ``displacement`` the cell's equilibrium under ``affine`` is solved first
    (:func:`relax_cell`). ``condense=False`` returns the affine
    (Cauchy-Born) estimate ``E_FF / V``, an upper bound."""

    F0, u0, V, B, like = _state(cell, affine, bond_energy_fn, displacement, relax)
    u0_flat = u0.reshape(-1)

    def E(u_flat, F_flat):
        return cell_strain_energy(cell, u_flat.reshape(B, 3), F_flat.reshape(2, 2),
                                  bond_energy_fn)

    F0_flat = F0.reshape(-1)
    E_FF = torch.func.hessian(E, argnums=1)(u0_flat, F0_flat)
    if not condense:
        return (E_FF / V).reshape(2, 2, 2, 2)
    E_uu = torch.func.hessian(E, argnums=0)(u0_flat, F0_flat)
    E_uF = torch.func.jacfwd(torch.func.grad(E, argnums=0), argnums=1)(u0_flat, F0_flat)

    # Static condensation on the free micro-DOFs: block 0's two
    # translations (the periodic energy's null space) pinned by an identity
    # fill, as in relax_cell.
    n = 3 * B
    mask = torch.ones(n, **like)
    mask[:2] = 0.0
    K = E_uu * mask[:, None] * mask[None, :] - torch.diag(1.0 - mask)
    rhs = E_uF * mask[:, None]
    du_dF = -torch.linalg.solve(K, rhs)  # (n, 4)

    C = (E_FF + rhs.T @ du_dF) / V
    return C.reshape(2, 2, 2, 2)


def effective_stress(cell: BlochCell, affine: torch.Tensor,
                     bond_energy_fn: Callable = ligament_energy,
                     displacement: Optional[torch.Tensor] = None,
                     relax: bool = True) -> torch.Tensor:
    """``(2, 2)`` homogenized first-Piola stress ``P_ij = (1/V) dE/dF_ij``
    at the (relaxed) state under ``affine``: by the envelope theorem the
    micro-relaxation adds nothing to the first derivative at equilibrium."""

    F, u0, V, _, _ = _state(cell, affine, bond_energy_fn, displacement, relax)
    return torch.func.grad(lambda F_: cell_strain_energy(cell, u0, F_, bond_energy_fn))(F) / V


def voigt(C: torch.Tensor) -> torch.Tensor:
    """``(3, 3)`` stiffness Voigt matrix (strains ``(exx, eyy, 2exy)`` to
    stresses ``(sxx, syy, sxy)``) of the minor-symmetrized tensor."""

    Cs = 0.25 * (C + C.transpose(0, 1) + C.transpose(2, 3) + C.transpose(0, 1).transpose(2, 3))
    idx = ((0, 0), (1, 1), (0, 1))
    return torch.stack([torch.stack([Cs[a + b] for b in idx]) for a in idx])


def engineering_constants(C: torch.Tensor) -> dict:
    """In-plane engineering constants from ``C_ijkl``: ``E_x, E_y``
    (Young), ``nu_xy, nu_yx`` (Poisson), ``G_xy`` (shear)."""

    S = torch.linalg.inv(voigt(C))
    return dict(E_x=1.0 / S[0, 0], E_y=1.0 / S[1, 1], nu_xy=-S[1, 0] / S[0, 0],
                nu_yx=-S[0, 1] / S[1, 1], G_xy=1.0 / S[2, 2])


def christoffel_speeds(C: torch.Tensor, density, direction) -> torch.Tensor:
    """Ascending plane-wave speeds along ``direction`` from the acoustic
    tensor ``Gamma_jk = n_i C_ijkl n_l / rho`` (``density`` the areal mass
    density): the long-wavelength limit of the Bloch acoustic branches."""

    n = torch.as_tensor(direction, dtype=C.dtype, device=C.device)
    n = n / torch.linalg.norm(n)
    Gamma = torch.einsum("i,ijkl,l->jk", n, C, n) / density
    return torch.sqrt(torch.clamp(torch.linalg.eigvalsh(Gamma), min=0.0))


def areal_density(cell: BlochCell) -> torch.Tensor:
    """Cell translational mass per unit area."""

    V = torch.abs(torch.linalg.det(torch.as_tensor(cell.direct_basis)))
    return torch.sum(torch.as_tensor(cell.inertia)[:, 0]) / V
