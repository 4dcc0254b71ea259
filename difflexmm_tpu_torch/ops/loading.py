"""External loading and viscous damping as dense (n_blocks, 3) force
fields (counterpart of ``difflexmm_tpu/ops/loading.py``): loads on block
DOFs, loads at block nodes reduced to block DOFs by virtual work, and
viscous damping. The solver multiplies forces by the free-DOF mask, so a
load on a constrained DOF has no effect."""

from typing import Callable, Dict

import numpy as np
import torch

from difflexmm_tpu_torch.ops.kinematics import block_to_node_kinematics


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


def build_node_loading(geometry, loaded_block_node_DOF_triples, loading_fn: Callable,
                       constrained_block_DOF_pairs=None):
    """Forces applied at block nodes, reduced to block DOFs by virtual work.

    Each row of ``loaded_block_node_DOF_triples`` is ``[block, node, DOF]``
    with DOF 0 or 1 (a nodal x or y force); ``loading_fn(state, t,
    **loading_params)`` gives a scalar or ``(n_loaded,)`` values, and
    triples named twice add. The block force is the transpose of the
    block-to-node Jacobian applied to the nodal forces: one
    ``torch.func.vjp`` of :func:`block_to_node_kinematics` at the current
    displacement ``state[0]`` (exact, and configuration dependent through
    the block rotations). Returns ``fn(state, t, loading_params,
    centroid_node_vectors) -> (n_blocks, 3)``. ``constrained_block_DOF_pairs``
    is accepted as in JAX and unused.
    """

    del constrained_block_DOF_pairs
    n_blocks = geometry if isinstance(geometry, int) else geometry.n_blocks
    triples = np.asarray(loaded_block_node_DOF_triples, dtype=np.int64).reshape(-1, 3)
    n_loaded = len(triples)

    def node_loading_fn(state, t, loading_params: Dict, centroid_node_vectors):
        displacement = state[0]
        values = loading_fn(state, t, **loading_params)
        values = values.to(displacement.dtype) if isinstance(values, torch.Tensor) \
            else torch.as_tensor(values, dtype=displacement.dtype, device=displacement.device)
        values = torch.broadcast_to(values, (n_loaded,))
        V = centroid_node_vectors.shape[-2]
        index = tuple(torch.as_tensor(triples[:, i], device=values.device) for i in range(3))
        node_forces = values.new_zeros((n_blocks, V, 3)).index_put(index, values,
                                                                    accumulate=True)
        _, vjp = torch.func.vjp(
            lambda u: block_to_node_kinematics(u, centroid_node_vectors), displacement)
        (block_forces,) = vjp(node_forces)
        return block_forces

    return node_loading_fn


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
