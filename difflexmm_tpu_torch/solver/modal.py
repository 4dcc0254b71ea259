"""Linear modal analysis (counterpart of ``difflexmm_tpu/solver/modal.py``).

Solves the generalized eigenproblem ``K q = w^2 M q`` about a
configuration, symmetrized with the diagonal mass matrix: with ``y =
M^{1/2} q``, ``M^{-1/2} K M^{-1/2} y = w^2 y`` is a standard symmetric
problem for ``torch.linalg.eigh`` on the tensors' device. K is
``torch.func.hessian`` of the constrained energy.
"""

from typing import Tuple

import numpy as np
import torch

from difflexmm_tpu_torch.ops.assembly import constrain_energy
from difflexmm_tpu_torch.ops.kinematics import build_constrained_kinematics
from difflexmm_tpu_torch.solver.dynamics import _resolve_inertia
from difflexmm_tpu_torch.utils.types import ControlParams, EigenmodeData

_EMPTY_PAIRS = np.zeros((0, 2), dtype=np.int64)


def reduced_stiffness_inertia(displacement, geometry, energy_fn, control_params: ControlParams,
                              constrained_block_DOF_pairs=_EMPTY_PAIRS, constrained_DOFs_fn=None,
                              t=0.0):
    """Free-DOF-reduced tangent stiffness about a (possibly driven) state,
    the linearization shared by modal analysis and the harmonic response.

    Returns ``(K (n_free, n_free), m (n_free,), free_idx (n_free,) numpy,
    dof_set)``."""

    n_blocks = geometry if isinstance(geometry, int) else geometry.n_blocks
    kin_kwargs = ({} if constrained_DOFs_fn is None
                  else dict(constrained_DOFs_fn=constrained_DOFs_fn))
    kinematics = build_constrained_kinematics(
        n_blocks, constrained_block_DOF_pairs=constrained_block_DOF_pairs, **kin_kwargs)
    dof_set = kinematics.dof_set
    constrained_energy = constrain_energy(energy_fn, kinematics)

    cnv = control_params.geometrical_params.centroid_node_vectors
    like = dict(dtype=cnv.dtype, device=cnv.device)
    mask = dof_set.tensors(**like)[0]
    u0 = torch.as_tensor(displacement, **like).reshape(n_blocks, 3) * mask
    t = torch.as_tensor(t, **like)
    K_full = torch.func.hessian(lambda u: constrained_energy(u, t, control_params))(u0).reshape(
        3 * n_blocks, 3 * n_blocks)
    inertia = torch.as_tensor(_resolve_inertia(control_params), **like).reshape(-1)

    free_idx = np.where(np.asarray(dof_set.free_mask).reshape(-1) > 0)[0]
    index = torch.as_tensor(free_idx, device=cnv.device)
    K = K_full[index][:, index]
    m = inertia[index]
    return K, m, free_idx, dof_set


def linear_mode_analysis(displacement, geometry, energy_fn, control_params: ControlParams,
                         constrained_block_DOF_pairs=_EMPTY_PAIRS, constrained_DOFs_fn=None,
                         t=0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Squared eigenfrequencies and mode shapes about ``displacement``
    (the driven DOFs at ``constrained_DOFs_fn(t)``, e.g. a static
    equilibrium's drive; by default undriven).

    Returns ``(eigenvalues (n_free,), modes (n_free, n_blocks, 3))``: modes
    of unit Euclidean norm, zero on constrained DOFs."""

    n_blocks = geometry if isinstance(geometry, int) else geometry.n_blocks
    K, m, free_idx, _ = reduced_stiffness_inertia(
        displacement, n_blocks, energy_fn, control_params,
        constrained_block_DOF_pairs=constrained_block_DOF_pairs,
        constrained_DOFs_fn=constrained_DOFs_fn, t=t)

    inv_sqrt_m = 1.0 / torch.sqrt(m)
    K_sym = K * inv_sqrt_m[:, None] * inv_sqrt_m[None, :]
    eigenvalues, Y = torch.linalg.eigh(K_sym)

    modes_free = Y.T * inv_sqrt_m[None, :]  # rows are modes
    modes_free = modes_free / torch.linalg.norm(modes_free, dim=1, keepdim=True)

    index = torch.as_tensor(free_idx, device=K.device)
    modes = K.new_zeros((len(free_idx), 3 * n_blocks)).index_copy(1, index, modes_free)
    return eigenvalues, modes.reshape(len(free_idx), n_blocks, 3)


def eigenmode_analysis(displacement, geometry, energy_fn, control_params: ControlParams,
                       constrained_block_DOF_pairs=_EMPTY_PAIRS, constrained_DOFs_fn=None,
                       t=0.0) -> EigenmodeData:
    """Modal analysis packaged as :class:`EigenmodeData`."""

    eigenvalues, modes = linear_mode_analysis(
        displacement, geometry, energy_fn, control_params,
        constrained_block_DOF_pairs=constrained_block_DOF_pairs,
        constrained_DOFs_fn=constrained_DOFs_fn, t=t)
    gp = control_params.geometrical_params
    return EigenmodeData(block_centroids=gp.block_centroids,
                         centroid_node_vectors=gp.centroid_node_vectors,
                         eigenvalues=eigenvalues, fields=modes)
