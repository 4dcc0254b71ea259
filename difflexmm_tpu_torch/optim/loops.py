"""Optimization drivers on a design (counterpart of
``difflexmm_tpu/optim/loops.py``): a gradient loop with a ``torch.optim``
optimizer in place of an optax transformation, plain projected gradient
descent, box projection and the flattening of a design.

A design is a tensor or a tuple (or list) of tensors. The optimizer is a
factory ``params -> torch.optim.Optimizer`` over the design's tensors; the
default, Adam at a learning rate of 1e-2, is ``optax.adam(1e-2)``: the
same elementwise update with eps outside the square root, so the two agree
to rounding.
"""

from typing import Callable, NamedTuple, Optional, Tuple

import torch


def _leaves(design):
    """The tensors of a design: one tensor, or a tuple or list."""

    return (design,) if isinstance(design, torch.Tensor) else tuple(design)


def _rebuild(design, leaves):
    """``leaves`` in the structure of ``design``."""

    return leaves[0] if isinstance(design, torch.Tensor) else type(design)(leaves)


def _snapshot(design, leaves):
    """Detached copies of ``leaves`` in the structure of ``design``: a
    history entry that the optimizer's in-place steps leave as it was."""

    return _rebuild(design, [x.detach().clone() for x in leaves])


def ravel_pytree(design):
    """A design -> ``(flat (n,) tensor, unflatten)``, ``unflatten`` mapping
    a flat vector back to the design's structure and shapes."""

    leaves = _leaves(design)
    shapes = [x.shape for x in leaves]
    sizes = [x.numel() for x in leaves]

    def unflatten(flat):
        return _rebuild(design, [part.reshape(shape)
                                 for part, shape in zip(torch.split(flat, sizes), shapes)])

    return torch.cat([x.reshape(-1) for x in leaves]), unflatten


def population_unflatten(design):
    """For a design's structure: ``(B, n)`` flat candidates -> the design
    with a leading dimension B on each tensor."""

    leaves = _leaves(design)
    shapes = [tuple(x.shape) for x in leaves]
    sizes = [x.numel() for x in leaves]

    def unflatten(xs):
        return _rebuild(design, [part.reshape((xs.shape[0],) + shape)
                                 for part, shape in zip(torch.split(xs, sizes, dim=1), shapes)])

    return unflatten


def adam(params) -> torch.optim.Optimizer:
    """The default optimizer: Adam at a learning rate of 1e-2
    (``optax.adam(1e-2)``)."""

    return torch.optim.Adam(params, lr=1e-2)


class OptLoopResult(NamedTuple):
    """``design``: the design after the last step (never evaluated);
    ``objective_values`` and ``design_values``: the value and the design
    of each iteration, the design before that iteration's step."""

    design: object
    objective_values: list
    design_values: list


def _clamped(leaves, bound, extreme):
    """Each leaf against its bound with ``torch.maximum`` or
    ``torch.minimum`` (ties split the gradient, as ``jnp.maximum`` does):
    ``bound`` a scalar for every leaf, or a tuple or list of per-leaf
    bounds."""

    bounds = bound if isinstance(bound, (tuple, list)) else [bound] * len(leaves)
    return [extreme(x, torch.as_tensor(b, dtype=x.dtype, device=x.device))
            for x, b in zip(leaves, bounds)]


def project_box(design, lower_bound=None, upper_bound=None):
    """A design clamped to box bounds. Each bound is None, a scalar (for
    every tensor of the design) or a tuple or list of per-tensor bounds
    (tensors broadcasting against the design's)."""

    leaves = list(_leaves(design))
    if lower_bound is not None:
        leaves = _clamped(leaves, lower_bound, torch.maximum)
    if upper_bound is not None:
        leaves = _clamped(leaves, upper_bound, torch.minimum)
    return _rebuild(design, leaves)


def optimizer_step(optimizer, leaves, grads, sign, lower_bound, upper_bound) -> None:
    """One step of ``optimizer`` on its ``leaves`` with gradients ``sign *
    grads``, then the leaves projected onto the box, in place and outside
    autograd: the leaves stay leaf tensors."""

    with torch.no_grad():
        for x, g in zip(leaves, grads):
            x.grad = sign * g
        optimizer.step()
        for x, y in zip(leaves, _leaves(project_box(tuple(leaves), lower_bound, upper_bound))):
            if y is not x:
                x.copy_(y)


def run_optimization_optax(
    objective_fn: Callable,
    initial_design,
    n_iterations: int,
    optimizer: Optional[Callable] = None,
    maximize: bool = True,
    lower_bound=None,
    upper_bound=None,
    callback: Optional[Callable] = None,
) -> OptLoopResult:
    """Gradient loop on a design with a box projection after each step
    (the JAX package's optax loop).

    Args:
        objective_fn: design -> scalar tensor.
        initial_design: a tensor or a tuple of tensors (not changed).
        optimizer: ``params -> torch.optim.Optimizer``; default
            :func:`adam`.
        maximize: ascend (the inverse-design convention) or descend.
        lower_bound, upper_bound: as for :func:`project_box`.
        callback: ``callback(iteration, design, value)`` with the design
            evaluated at that iteration.

    Returns:
        :class:`OptLoopResult`; as in JAX the value and design recorded at
        iteration k are those before step k, and the returned design is the
        one after the last step, which was never evaluated.
    """

    sign = -1.0 if maximize else 1.0
    leaves = [x.detach().clone().requires_grad_() for x in _leaves(initial_design)]
    opt = (optimizer or adam)(leaves)
    objective_values, design_values = [], []
    for it in range(n_iterations):
        value = objective_fn(_rebuild(initial_design, leaves))
        grads = torch.autograd.grad(value, leaves)
        evaluated = _snapshot(initial_design, leaves)
        optimizer_step(opt, leaves, grads, sign, lower_bound, upper_bound)
        objective_values.append(float(value.detach()))
        design_values.append(evaluated)
        if callback is not None:
            callback(it, evaluated, objective_values[-1])
    return OptLoopResult(_snapshot(initial_design, leaves), objective_values, design_values)


def naive_gd(
    objective_and_grad: Callable,
    initial_guess,
    n_iterations: int,
    learning_rate: float,
    lower_bound=None,
    upper_bound=None,
    maximize: bool = False,
    callback: Optional[Callable] = None,
) -> Tuple[object, list, list]:
    """Plain projected gradient descent: ``design - sign * learning_rate *
    grad``, then the box. ``objective_and_grad(design) -> (value, grads in
    the design's structure)``. Returns ``(design, objective_values,
    design_values)``; as in JAX, the design recorded at iteration k is the
    one after step k."""

    sign = -1.0 if maximize else 1.0
    design = initial_guess
    objective_values, design_values = [], []
    for it in range(n_iterations):
        value, grad = objective_and_grad(design)
        with torch.no_grad():
            design = _rebuild(design, [d - sign * learning_rate * g
                                       for d, g in zip(_leaves(design), _leaves(grad))])
            design = project_box(design, lower_bound, upper_bound)
        objective_values.append(float(value.detach() if torch.is_tensor(value) else value))
        design_values.append(design)
        if callback is not None:
            callback(it, design, objective_values[-1])
    return design, objective_values, design_values
