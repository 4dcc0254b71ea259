"""External loading and viscous damping as dense (n_blocks, 3) force
fields (counterpart of ``difflexmm_tpu/ops/loading.py``;
``build_node_loading`` is ROADMAP A3). The solver multiplies forces by the
free-DOF mask, so a load on a constrained DOF has no effect."""

from typing import Callable, Dict

import numpy as np
import torch


def build_loading(geometry, loaded_block_DOF_pairs, loading_fn: Callable,
                  constrained_block_DOF_pairs=None):
    """Scatter a user loading function onto [block, DOF] pairs.

    ``loading_fn(state, t, **loading_params)`` returns a scalar or
    ``(n_loaded,)`` force values; the returned ``fn(state, t,
    loading_params)`` gives the dense ``(n_blocks, 3)`` force field, where a
    pair named twice adds its values (as ``.at[].add`` does).
    ``constrained_block_DOF_pairs`` is accepted as in JAX and unused.
    """

    del constrained_block_DOF_pairs
    n_blocks = geometry if isinstance(geometry, int) else geometry.n_blocks
    pairs = np.asarray(loaded_block_DOF_pairs, dtype=np.int64).reshape(-1, 2)
    flat = pairs[:, 0] * 3 + pairs[:, 1]
    n_loaded = len(pairs)
    index = {}  # the flat indices on each device

    def global_loading_fn(state, t, loading_params: Dict) -> torch.Tensor:
        values = loading_fn(state, t, **loading_params)
        if not isinstance(values, torch.Tensor):  # a number: t's dtype and device
            like = (dict(dtype=t.dtype, device=t.device) if isinstance(t, torch.Tensor)
                    else dict(dtype=torch.float64))
            values = torch.as_tensor(values, **like)
        values = torch.broadcast_to(values, (n_loaded,))
        if values.device not in index:
            index[values.device] = torch.as_tensor(flat, device=values.device)
        dense = values.new_zeros((n_blocks * 3,)).index_add(0, index[values.device], values)
        return dense.view(n_blocks, 3)

    return global_loading_fn


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


def build_viscous_damping(geometry, damped_blocks, constrained_block_DOF_pairs=None):
    """Per-block viscous force ``-c * v`` on the damped blocks:
    ``fn(state, t, damping) -> (n_blocks, 3)`` with ``state = (u, v)`` and
    ``damping`` a scalar or (n_damped, 3) tensor of coefficients."""

    del constrained_block_DOF_pairs
    coefficients = build_damping_coefficients(geometry, damped_blocks)

    def damping_fn(state, t, damping) -> torch.Tensor:
        _, velocity = state
        return -coefficients(torch.as_tensor(damping, dtype=velocity.dtype,
                                             device=velocity.device)) * velocity

    return damping_fn
