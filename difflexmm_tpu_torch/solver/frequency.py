"""Frequency-domain harmonic response (counterpart of
``difflexmm_tpu/solver/frequency.py``).

The steady-state response of the linearized lattice to time-harmonic
forcing ``f e^{i omega t}`` solves ``(K - omega^2 M + i omega C) u = f``
for a batch of drive frequencies as one batched complex
``torch.linalg.solve``. K is the Hessian of the same energy the dynamic
solver integrates, M the same polygon inertia and C the same per-block
viscous damping, so frequency- and time-domain results agree by
construction; the response is differentiable with respect to the design.
"""

import numpy as np
import torch

from difflexmm_tpu_torch.ops.loading import build_damping_coefficients
from difflexmm_tpu_torch.solver.modal import reduced_stiffness_inertia
from difflexmm_tpu_torch.utils.types import ControlParams

_EMPTY_PAIRS = np.zeros((0, 2), dtype=np.int64)


def harmonic_response(displacement, geometry, energy_fn, control_params: ControlParams,
                      forcing, omegas, constrained_block_DOF_pairs=_EMPTY_PAIRS,
                      damped_blocks=None, constrained_DOFs_fn=None, t=0.0) -> torch.Tensor:
    """Complex steady-state displacement per drive frequency.

    ``displacement``: the ``(n_blocks, 3)`` linearization state;
    ``forcing``: ``(n_blocks, 3)`` real or complex force amplitudes
    (ignored on constrained DOFs); ``omegas``: ``(n_omega,)`` angular
    frequencies; ``damped_blocks``: per-block viscous damping ids as for
    ``setup_dynamic_solver`` (None: undamped). Returns ``(n_omega,
    n_blocks, 3)`` complex amplitudes, zero on constrained DOFs."""

    n_blocks = geometry if isinstance(geometry, int) else geometry.n_blocks
    K, m, free_idx, _ = reduced_stiffness_inertia(
        displacement, n_blocks, energy_fn, control_params,
        constrained_block_DOF_pairs=constrained_block_DOF_pairs,
        constrained_DOFs_fn=constrained_DOFs_fn, t=t)
    like = dict(dtype=K.dtype, device=K.device)
    index = torch.as_tensor(free_idx, device=K.device)

    if damped_blocks is not None:
        damping_coeffs = build_damping_coefficients(n_blocks, damped_blocks)(
            torch.as_tensor(control_params.mechanical_params.damping, **like)).reshape(-1)
    else:
        damping_coeffs = K.new_zeros(3 * n_blocks)
    c = damping_coeffs[index]
    cplx = torch.complex128 if K.dtype == torch.float64 else torch.complex64
    f = torch.as_tensor(forcing, device=K.device).reshape(-1)[index].to(cplx)

    omegas = torch.as_tensor(omegas, **like)
    w = omegas[:, None, None]
    A = (K.to(cplx) - (w**2) * torch.diag(m).to(cplx) + 1j * w * torch.diag(c).to(cplx))
    u_free = torch.linalg.solve(A, torch.broadcast_to(f, (omegas.shape[0],) + f.shape))

    out = torch.zeros((u_free.shape[0], 3 * n_blocks), dtype=cplx, device=K.device)
    out = out.index_copy(1, index, u_free)
    return out.reshape(-1, n_blocks, 3)


def transmission(response: torch.Tensor, input_blocks, output_blocks) -> torch.Tensor:
    """``|output| / |input|`` amplitude ratio per frequency: the rms of the
    translational DOFs of the output blocks over that of the input
    blocks, ``(n_omega,)``."""

    def rms(blocks):
        u = response[:, torch.as_tensor(np.asarray(blocks), device=response.device), :2]
        return torch.sqrt(torch.mean(torch.abs(u) ** 2, dim=(1, 2)))

    return rms(output_blocks) / rms(input_blocks)
