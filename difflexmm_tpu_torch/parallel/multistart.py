"""Batched multistart inverse design: a population of candidates per update
step (counterpart of ``difflexmm_tpu/parallel/multistart.py``:
``population_value_and_grad``, ``run_multistart_optax``,
``run_multistart_mma``, ``reevaluate_finalists`` and
``random_initial_designs``).

A population is explicit: objectives take B designs at once (each design
tensor with a leading dimension B) and return ``(B,)`` values, and one
solve of the population is one trajectory of B designs, the batch on the
kernel's grid. The JAX package reaches the same by ``vmap`` and a custom
batching rule that tiles designs onto the TPU's lanes; the port's adjoint
captures CUDA graphs and calls ``torch.autograd.grad`` inside its
backward, which ``torch.func`` transforms do not compose with, so the
batch is written out instead. Designs do not interact, so one backward of
the population's values is the stack of per-design gradients, as JAX's
vjp of the vmapped objective is.

Screening runs unguarded and only the top few candidates are re-evaluated
guarded, forward only (:func:`reevaluate_finalists`): a guarded population
gradient replays an interval eagerly wherever any design fired.

``mesh=`` sharding waits for multi-GPU (ROADMAP A11).
"""

import math
from typing import Callable, NamedTuple, Optional

import torch

from difflexmm_tpu_torch.optim.loops import _leaves, _rebuild, adam, optimizer_step
from difflexmm_tpu_torch.optim.mma import mma_init, mma_update

#: The backward chunk of ``grad_chunk="auto"``: a population larger than
#: this and divisible by it takes its value and gradient in chunks of this
#: many designs. The adjoint's graph replay costs about the same at any
#: population size, so chunks only add replays: on an NVIDIA H100 80GB HBM3
#: (700 W) the flagship's value and gradient took 9.77 s for 528 designs
#: and 8.04 s for 264 at float32 (11.01 and 9.63 s at float64), so two
#: chunks of 264 cost 1.6-1.8 times the whole (``chip_smoke.py``'s
#: designs/s curve). Memory is the reason to chunk: the value and gradient
#: peaked at 2.81 GB for 128 designs at float64 (22 MB a design), so
#: chunks of 2048 stay near 45 GB of the card's 80 GB.
GRAD_CHUNK = 2048


class MultistartResult(NamedTuple):
    """Result of :func:`run_multistart_optax`.

    Attrs:
        designs: the last evaluated iterate of each candidate, in the
            structure of the initial designs (leading dimension B).
        objective_values: (n_iterations, B) objective at each evaluated
            iterate.
        best_index: population index of the best final candidate among
            those whose final value is finite.
        best_design: its design (no leading dimension).
    """

    designs: object
    objective_values: torch.Tensor
    best_index: int
    best_design: object


class MultistartMMAResult(NamedTuple):
    """Result of :func:`run_multistart_mma`.

    Attrs:
        designs: (B, n) the last evaluated iterate of each candidate.
        objective_values: (n_iterations, B) objective at each evaluated
            iterate (a rejected step records its retreat's value).
        constraints_violation: (n_iterations, B) largest constraint value
            (0 without constraints).
        rejected: (n_iterations, B) full-rejection flags.
        best_index: population index of the best final candidate among
            those whose final evaluation was finite.
        best_design: (n,) its design.
        finalists: the guarded re-ranking (:class:`FinalistResult`) when the
            model's driver made one, else None.
    """

    designs: torch.Tensor
    objective_values: torch.Tensor
    constraints_violation: torch.Tensor
    rejected: torch.Tensor
    best_index: int
    best_design: torch.Tensor
    finalists: Optional["FinalistResult"] = None


class FinalistResult(NamedTuple):
    """Result of :func:`reevaluate_finalists`.

    Attrs:
        indices: (k,) population indices of the finalists, best screening
            value first.
        values: (k,) their re-evaluated objectives, in the same order.
        screen_values: (k,) their screening objectives.
        best_index: population index of the re-ranked winner.
        best_design: its design (no leading dimension).
        best_value: its re-evaluated objective (NaN where no finalist's
            re-evaluation was finite).
    """

    indices: torch.Tensor
    values: torch.Tensor
    screen_values: torch.Tensor
    best_index: int
    best_design: object
    best_value: float


def _take(designs, index):
    """Every leaf of ``designs`` indexed along its leading dimension."""

    return _rebuild(designs, [x[index] for x in _leaves(designs)])


def population_value_and_grad(objective_fn: Callable, designs, grad_chunk="auto"):
    """Values and per-design gradients of a population: ``(values (B,),
    grads)``, ``grads`` in the structure of ``designs``.

    ``objective_fn(designs) -> (B,)`` takes the whole population (each
    design tensor with the leading dimension B) and solves it at once; one
    backward of its values with unit cotangents gives every design's
    gradient (designs do not interact). ``grad_chunk``: ``"auto"`` takes
    chunks of :data:`GRAD_CHUNK` designs for a larger population that it
    divides; an int takes chunks of that many designs where it divides B
    and is smaller; None takes the whole population at once, as does a
    chunk that does not divide B (the JAX package's rule).
    """

    leaves = _leaves(designs)
    B = leaves[0].shape[0]
    if grad_chunk == "auto":
        grad_chunk = GRAD_CHUNK
    if not grad_chunk or B <= grad_chunk or B % grad_chunk:
        grad_chunk = B

    values, grads = [], []
    for start in range(0, B, grad_chunk):
        xs = [x[start:start + grad_chunk].detach().requires_grad_() for x in leaves]
        with torch.enable_grad():
            v = objective_fn(_rebuild(designs, xs))
            g = torch.autograd.grad(v, xs, torch.ones_like(v))
        values.append(v.detach())
        grads.append(g)
    if len(values) == 1:
        return values[0], _rebuild(designs, list(grads[0]))
    return torch.cat(values), _rebuild(designs, [torch.cat(g) for g in zip(*grads)])


def _ranked(values, maximize: bool):
    """Non-finite values as the worst: -inf when maximizing, +inf when
    minimizing."""

    worst = torch.full_like(values, -math.inf if maximize else math.inf)
    return torch.where(torch.isfinite(values), values, worst)


def run_multistart_optax(
    objective_fn: Callable,
    initial_designs,
    n_iterations: int,
    optimizer: Optional[Callable] = None,
    maximize: bool = True,
    lower_bound=None,
    upper_bound=None,
    mesh=None,
    grad_chunk="auto",
) -> MultistartResult:
    """Advance a population of design candidates with one optimizer, all
    at once.

    Each iteration evaluates the whole population once
    (:func:`population_value_and_grad`: on the card one launch of the
    trajectory kernel with the batch on the grid) and takes one step of one
    ``torch.optim`` optimizer over the stacked ``(B, ...)`` tensors, which
    for an elementwise optimizer such as Adam is JAX's per-candidate
    ``vmap(optimizer.update)``; then the box.

    Args:
        objective_fn: ``designs -> (B,)``, the whole population at once.
        initial_designs: a tensor or a tuple of tensors, each with a
            leading candidate dimension B.
        optimizer: ``params -> torch.optim.Optimizer``; default Adam at a
            learning rate of 1e-2 (``optax.adam(1e-2)``).
        lower_bound, upper_bound: scalars (or per-tensor bounds).
        mesh: sharding over several cards is not ported (ROADMAP A11).
        grad_chunk: as for :func:`population_value_and_grad`.

    Returns:
        :class:`MultistartResult`. As in JAX, the designs returned are the
        iterates that were evaluated, not the final proposal, and a
        candidate whose final value is not finite never ranks best.
    """

    if mesh is not None:
        raise NotImplementedError("mesh= (candidates sharded over several cards) is not "
                                  "ported yet: ROADMAP A11.")
    sign = -1.0 if maximize else 1.0
    leaves = [x.detach().clone().requires_grad_() for x in _leaves(initial_designs)]
    opt = (optimizer or adam)(leaves)
    values = []
    for _ in range(n_iterations):
        evaluated = _rebuild(initial_designs, [x.detach().clone() for x in leaves])
        value, grads = population_value_and_grad(objective_fn, evaluated, grad_chunk)
        optimizer_step(opt, leaves, _leaves(grads), sign, lower_bound, upper_bound)
        values.append(value)
    values = torch.stack(values)
    ranked = _ranked(values[-1], maximize)
    best = int(torch.argmax(ranked) if maximize else torch.argmin(ranked))
    return MultistartResult(evaluated, values, best, _take(evaluated, best))


def run_multistart_mma(
    objective_fn: Callable,
    initial_designs: torch.Tensor,
    xmin,
    xmax,
    n_iterations: int,
    constraints_and_jac: Optional[Callable] = None,
    maximize: bool = False,
    move_limit: float = 0.5,
    n_dual_iters: int = 100,
    mesh=None,
) -> MultistartMMAResult:
    """A population of constrained MMA runs, one update of every candidate
    per iteration.

    Each iteration evaluates the whole population once
    (:func:`population_value_and_grad`), then updates every candidate with
    :func:`optim.mma.mma_update` under ``torch.func.vmap``: per-candidate
    constraint Jacobians and trust-region scales. A candidate whose value or
    gradient is not finite retreats to its last accepted iterate, reuses
    that iterate's value and gradient, and shrinks its move scale fourfold
    (else it grows by 1.25, up to 1), as in JAX (``multistart.py:285-311``).

    Args:
        objective_fn: ``xs (B, n) -> (B,)``, the whole population at once.
        initial_designs: (B, n) flat candidates.
        xmin, xmax: (n,) or scalar bounds.
        constraints_and_jac: optional ``x (n,) -> (fi (m,), dfi (m, n))`` of
            ONE candidate, feasible where ``fi <= 0``; vmapped over the
            candidates.
        mesh: sharding over several cards is not ported (ROADMAP A11).

    Raises:
        FloatingPointError: a candidate's first evaluation is not finite
            (it has no iterate to retreat to), as in JAX.

    Returns:
        :class:`MultistartMMAResult`.
    """

    if mesh is not None:
        raise NotImplementedError("mesh= (candidates sharded over several cards) is not "
                                  "ported yet: ROADMAP A11.")
    x0 = initial_designs.detach()
    B, n = x0.shape
    xmin = torch.broadcast_to(torch.as_tensor(xmin, dtype=x0.dtype, device=x0.device), (n,))
    xmax = torch.broadcast_to(torch.as_tensor(xmax, dtype=x0.dtype, device=x0.device), (n,))
    sign = -1.0 if maximize else 1.0

    def candidate_iter(state, move_scale, acc_value, acc_grad, value, grad):
        finite = torch.isfinite(value) & torch.all(torch.isfinite(grad))
        fresh = state.iteration == 0
        # Full reject: retreat to the last accepted iterate and reuse its
        # value and gradient (computed the iteration before).
        reject = ~finite & ~fresh
        x_eval = torch.where(reject, state.x_prev1, state.x)
        value = torch.where(reject, acc_value, value)
        grad = torch.where(reject, acc_grad, grad)
        state = state._replace(x=x_eval)
        move_scale = torch.where(reject, torch.clamp(move_scale / 4, min=1e-4),
                                 torch.clamp(move_scale * 1.25, max=1.0))
        if constraints_and_jac is not None:
            fi, dfi = constraints_and_jac(x_eval)
            violation = torch.max(fi) if fi.numel() else value.new_zeros(())
        else:
            fi, dfi = None, None
            violation = value.new_zeros(())
        state = mma_update(state, sign * grad, fi, dfi, xmin, xmax,
                           n_dual_iters=n_dual_iters, move_limit=move_limit * move_scale)
        return state, move_scale, value, grad, violation, reject

    update = torch.func.vmap(candidate_iter)
    states = torch.func.vmap(mma_init, in_dims=(0, None, None))(x0, xmin, xmax)
    move_scale = x0.new_ones((B,))
    acc_value, acc_grad = x0.new_zeros((B,)), torch.zeros_like(x0)
    values, violations, rejected = [], [], []
    for it in range(n_iterations):
        value, grad = population_value_and_grad(objective_fn, states.x)
        if it == 0:
            bad = torch.nonzero(~torch.isfinite(value)).flatten().tolist()
            if bad:
                raise FloatingPointError(
                    f"run_multistart_mma: objective non-finite at the initial design for "
                    f"candidate(s) {bad}. Check solver stability (substeps) for designs "
                    "within the bounds.")
        with torch.no_grad():
            states, move_scale, acc_value, acc_grad, violation, reject = update(
                states, move_scale, acc_value, acc_grad, value, grad)
        values.append(acc_value)
        violations.append(violation)
        rejected.append(reject)
    # states.x is the last, unevaluated proposal; x_prev1 the last
    # evaluated iterate (run_mma's convention).
    designs = states.x_prev1
    values = torch.stack(values)
    best = int(torch.argmax(_ranked(values[-1], True)) if maximize
               else torch.argmin(_ranked(values[-1], False)))
    return MultistartMMAResult(designs, values, torch.stack(violations), torch.stack(rejected),
                               best, designs[best])


def reevaluate_finalists(objective_fn: Callable, designs, screen_values, k: int,
                         maximize: bool = True) -> FinalistResult:
    """Re-rank a screened population's top ``k`` under a costlier objective
    (the guarded one): the production multistart recipe of screening the
    population unguarded and re-evaluating only its best candidates.

    ``objective_fn(designs) -> (k,)`` takes the ``k`` finalists at once,
    forward only: through the guarded kernel that is one launch of ``k``
    designs in which each design's block decides on its own where to
    refine, so that no finalist pays for another's refinement. Non-finite
    screening values rank last; non-finite re-evaluations never win (where
    none is finite, the first finalist is named, with a NaN value).
    ``designs``: a tensor or a tuple of tensors with a leading population
    dimension. The port compiles nothing per call and keeps no cache of
    objectives (the JAX package's ``_FINALIST_MAPS`` grew by one entry per
    call).
    """

    screen_values = torch.as_tensor(screen_values)
    B = screen_values.shape[0]
    k = int(min(k, B))
    if k < 1:
        raise ValueError("reevaluate_finalists needs k >= 1")
    # A stable sort ranks ties by population index, as lax.top_k does.
    order = torch.sort(_ranked(screen_values, maximize), descending=maximize,
                       stable=True).indices
    idx = order[:k]
    finalists = _take(designs, idx.to(_leaves(designs)[0].device))
    with torch.no_grad():
        values = objective_fn(finalists).detach()
    revalued = _ranked(values, maximize)
    pos = int(torch.argmax(revalued) if maximize else torch.argmin(revalued))
    return FinalistResult(
        indices=idx,
        values=values,
        screen_values=screen_values[idx],
        best_index=int(idx[pos]),
        best_design=_take(finalists, pos),
        best_value=float(values[pos]),
    )


def random_initial_designs(generator: torch.Generator, base_design, n_candidates: int,
                           scale: float):
    """Jittered candidates around ``base_design`` (a tensor or a tuple of
    tensors): each leaf gets a leading candidate dimension and ``scale``
    times standard normal noise from ``generator``. Not the same numbers
    as ``jax.random`` for any seed: tests hand both packages the same
    numpy designs."""

    def jitter(leaf):
        noise = torch.randn((n_candidates,) + tuple(leaf.shape), generator=generator,
                            dtype=leaf.dtype, device=generator.device)
        return leaf[None] + scale * noise.to(leaf.device)

    return _rebuild(base_design, [jitter(x) for x in _leaves(base_design)])
