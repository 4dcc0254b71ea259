"""Viscous damping coefficients (counterpart of
``build_damping_coefficients`` in ``difflexmm_tpu/ops/loading.py``; force
loading is ROADMAP A10)."""

import numpy as np
import torch


def build_damping_coefficients(geometry, damped_blocks):
    """Dense (n_blocks, 3) viscous coefficient field from per-block values.

    Returns ``coefficients(damping)``: ``damping`` is a scalar or an
    (n_damped, 3) tensor; duplicate damped blocks add, as in JAX.
    """

    n_blocks = geometry if isinstance(geometry, int) else geometry.n_blocks
    damped = np.asarray(damped_blocks, dtype=np.int64).reshape(-1)
    n_damped = len(damped)

    def coefficients(damping: torch.Tensor) -> torch.Tensor:
        coeffs = torch.broadcast_to(damping, (n_damped, 3))
        idx = torch.as_tensor(damped, device=coeffs.device)
        dense = coeffs.new_zeros((n_blocks, 3))
        return dense.index_add(0, idx, coeffs)

    return coefficients
