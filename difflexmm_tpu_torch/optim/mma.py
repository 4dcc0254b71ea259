"""Method of Moving Asymptotes (MMA) in PyTorch, on the device of the design
(counterpart of ``difflexmm_tpu/optim/mma.py``: same constants, update
math and operation order).

Svanberg's MMA (K. Svanberg, "The method of moving asymptotes - a new
method for structural optimization", IJNME 24:359-373, 1987): separable
approximations ``f_i(x) ~ sum_j p_ij / (U_j - x_j) + q_ij / (x_j - L_j)``
around the iterate with moving asymptotes L < x < U, asymptotes adapted per
variable from the oscillation of the last two steps, and the convex
subproblem solved in the dual with projected Adam. The dual gradient is
autograd of the dual value (``torch.func.grad``), as ``jax.grad`` gives it
in the JAX package, so the clip inside it is differentiated the same way.
"""

import time
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch


class MMAState(NamedTuple):
    """Per-iteration optimizer state: (n,) tensors and an int counter."""

    x: torch.Tensor
    x_prev1: torch.Tensor
    x_prev2: torch.Tensor
    low: torch.Tensor
    upp: torch.Tensor
    iteration: torch.Tensor


# Standard MMA constants (the JAX package's values).
_ASY_INIT = 0.5
_ASY_INCR = 1.2
_ASY_DECR = 0.7
_ASY_MIN_FACTOR = 1e-8
_ASY_MAX_FACTOR = 10.0
_MOVE = 0.5
_ALBEFA = 0.1
_RAAMIN = 1e-6


def _clip(x, lo, hi):
    """``jnp.clip``: ``minimum(hi, maximum(lo, x))``, whose gradient splits
    ties in half as JAX's does."""

    return torch.minimum(hi, torch.maximum(lo, x))


def _as(x, like):
    """``x`` (tensor or number) as a tensor of ``like``'s dtype and device."""

    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def mma_init(x0: torch.Tensor, xmin: torch.Tensor, xmax: torch.Tensor) -> MMAState:
    span = xmax - xmin
    return MMAState(
        x=x0,
        x_prev1=x0,
        x_prev2=x0,
        low=x0 - _ASY_INIT * span,
        upp=x0 + _ASY_INIT * span,
        iteration=torch.zeros((), dtype=torch.int64, device=x0.device),
    )


def _update_asymptotes(state: MMAState, xmin, xmax) -> Tuple[torch.Tensor, torch.Tensor]:
    span = torch.clamp(xmax - xmin, min=_RAAMIN)
    x, x1, x2 = state.x, state.x_prev1, state.x_prev2

    osc = (x - x1) * (x1 - x2)
    one = torch.ones_like(osc)
    factor = torch.where(osc > 0, one * _ASY_INCR, torch.where(osc < 0, one * _ASY_DECR, one))
    low = x - factor * (x1 - state.low)
    upp = x + factor * (state.upp - x1)

    low = _clip(low, x - _ASY_MAX_FACTOR * span, x - _ASY_MIN_FACTOR * span)
    upp = _clip(upp, x + _ASY_MIN_FACTOR * span, x + _ASY_MAX_FACTOR * span)

    fresh = state.iteration < 2
    low = torch.where(fresh, x - _ASY_INIT * span, low)
    upp = torch.where(fresh, x + _ASY_INIT * span, upp)
    return low, upp


def _solve_dual(p0, q0, P, Q, b, low, upp, alpha, beta, n_dual_iters, lam_max):
    """Maximize the MMA dual with projected Adam; return the primal minimizer
    and the multipliers."""

    def x_of(lam):
        pl = p0 + lam @ P
        ql = q0 + lam @ Q
        sp, sq = torch.sqrt(pl), torch.sqrt(ql)
        xs = (low * sp + upp * sq) / (sp + sq)
        return _clip(xs, alpha, beta)

    def dual_value(lam):
        xs = x_of(lam)
        pl = p0 + lam @ P
        ql = q0 + lam @ Q
        return torch.sum(pl / (upp - xs) + ql / (xs - low)) - torch.dot(lam, b)

    dual_grad = torch.func.grad(dual_value)

    m = P.shape[0]
    lam = torch.full((m,), 1.0, dtype=p0.dtype, device=p0.device)
    mom, vel = torch.zeros_like(lam), torch.zeros_like(lam)
    adam_b1, adam_b2, adam_eps, lr = 0.9, 0.999, 1e-8, 0.5
    zero, top = _as(0.0, lam), _as(lam_max, lam)
    for i in range(n_dual_iters):
        g = dual_grad(lam)
        mom = adam_b1 * mom + (1 - adam_b1) * g
        vel = adam_b2 * vel + (1 - adam_b2) * g**2
        mhat = mom / (1 - adam_b1 ** (i + 1.0))
        vhat = vel / (1 - adam_b2 ** (i + 1.0))
        lam = lam + lr * mhat / (torch.sqrt(vhat) + adam_eps)  # ascent
        lam = _clip(lam, zero, top)
    return x_of(lam), lam


def mma_update(
    state: MMAState,
    df0: torch.Tensor,
    fi: Optional[torch.Tensor],
    dfi: Optional[torch.Tensor],
    xmin: torch.Tensor,
    xmax: torch.Tensor,
    n_dual_iters: int = 100,
    lam_max: float = 1e4,
    move_limit=_MOVE,
) -> MMAState:
    """One MMA design update (minimization form).

    ``df0`` (n,) objective gradient at ``state.x``; ``fi`` (m,) constraint
    values (feasible iff <= 0) and ``dfi`` (m, n) their Jacobian, or None;
    ``move_limit``: per-iteration step cap as a fraction of the bound span
    (a number or a 0-dim tensor). Returns the state with the new iterate in
    ``.x``.
    """

    x = state.x
    low, upp = _update_asymptotes(state, xmin, xmax)

    u_x = upp - x
    x_l = x - low
    span = torch.clamp(xmax - xmin, min=_RAAMIN)

    alpha = torch.maximum(xmin, torch.maximum(low + _ALBEFA * x_l, x - move_limit * span))
    beta = torch.minimum(xmax, torch.minimum(upp - _ALBEFA * u_x, x + move_limit * span))

    eps_term = 1e-5 / span
    pos, neg = torch.clamp(df0, min=0), torch.clamp(-df0, min=0)
    p0 = u_x**2 * (pos + 1e-3 * neg + eps_term)
    q0 = x_l**2 * (neg + 1e-3 * pos + eps_term)

    if fi is None or dfi is None or dfi.shape[0] == 0:
        sp, sq = torch.sqrt(p0), torch.sqrt(q0)
        x_new = _clip((low * sp + upp * sq) / (sp + sq), alpha, beta)
    else:
        # Row-normalize each constraint by its gradient norm: the feasible
        # set is unchanged and the dual stays well-conditioned when the
        # constraint scales span orders of magnitude.
        row_scale = torch.clamp(torch.linalg.norm(dfi, dim=1, keepdim=True), min=1e-30)
        fi = fi / row_scale[:, 0]
        dfi = dfi / row_scale
        P = u_x[None, :] ** 2 * torch.clamp(dfi, min=0)
        Q = x_l[None, :] ** 2 * torch.clamp(-dfi, min=0)
        b = P @ (1.0 / u_x) + Q @ (1.0 / x_l) - fi
        x_new, _ = _solve_dual(p0, q0, P, Q, b, low, upp, alpha, beta, n_dual_iters, lam_max)

    return MMAState(
        x=x_new,
        x_prev1=x,
        x_prev2=state.x_prev1,
        low=low,
        upp=upp,
        iteration=state.iteration + 1,
    )


def _restore_feasibility(
    x,
    constraints_and_jac,
    xmin,
    xmax,
    feasibility_tol: float,
    n_dual_iters: int,
    move_limit: float,
    max_restore_iterations: int = 10,
):
    """Constraint-only MMA iterations (zero objective gradient) until
    ``max(fi) <= feasibility_tol``, at most ``max_restore_iterations``.

    Returns ``(x_restored, record)``: the record holds the violations
    before and after and the iterations spent; ``x`` comes back unchanged
    when it is already feasible.
    """

    fi, dfi = constraints_and_jac(x)
    before = float(torch.max(fi)) if fi.numel() else 0.0
    record = {
        "feasibility_tol": float(feasibility_tol),
        "violation_before": before,
        "iterations": 0,
    }
    if before <= feasibility_tol:
        record["violation_after"] = before
        return x, record

    state = mma_init(x, xmin, xmax)
    zero = torch.zeros_like(x)
    violation = before
    for it in range(max_restore_iterations):
        state = mma_update(state, zero, fi, dfi, xmin, xmax,
                           n_dual_iters=n_dual_iters, move_limit=move_limit)
        fi, dfi = constraints_and_jac(state.x)
        violation = float(torch.max(fi))
        record["iterations"] = it + 1
        if violation <= feasibility_tol:
            break
    record["violation_after"] = violation
    return (state.x if record["iterations"] else x), record


def _bounds(x0, xmin, xmax):
    x0 = torch.as_tensor(x0)
    return (x0, torch.broadcast_to(_as(xmin, x0), x0.shape),
            torch.broadcast_to(_as(xmax, x0), x0.shape))


def _restore_and_append(history, x_final, constraints_and_jac, xmin, xmax, feasibility_tol,
                        n_dual_iters, move_limit, evaluate, callback):
    """The drivers' feasibility restoration at termination: when the final
    design violates a constraint beyond ``feasibility_tol``, restore it
    and, when its objective is finite, append the restored design as one
    extra history entry. Returns the final design."""

    x_restored, record = _restore_feasibility(
        x_final, constraints_and_jac, xmin, xmax, feasibility_tol, n_dual_iters, move_limit,
    )
    history["restoration"] = record
    if not record["iterations"]:
        return x_final
    value, finite = evaluate(x_restored)
    if not finite:
        record["discarded"] = "objective non-finite at restored design"
        return x_final
    fi, _ = constraints_and_jac(x_restored)
    history["objective_values"].append(value)
    history["design_values"].append(x_restored)
    history["constraints_violation"].append(record["violation_after"])
    history["rejected"].append(False)
    if callback is not None:
        callback(len(history["objective_values"]) - 1, x_restored, value,
                 record["violation_after"], fi)
    return x_restored


def _new_history():
    return {"objective_values": [], "design_values": [], "constraints_violation": [],
            "rejected": []}


def run_mma(
    objective_and_grad: Callable,
    x0: torch.Tensor,
    xmin,
    xmax,
    n_iterations: int,
    constraints_and_jac: Optional[Callable] = None,
    maximize: bool = False,
    callback: Optional[Callable] = None,
    n_dual_iters: int = 100,
    move_limit: float = _MOVE,
    max_backtracks: int = 8,
    max_seconds: Optional[float] = None,
    feasibility_tol: Optional[float] = None,
):
    """MMA on flat design vectors, one host round trip per iteration.

    ``objective_and_grad(x) -> (value, grad)``; ``constraints_and_jac(x) ->
    (fi (m,), dfi (m, n))`` with feasibility ``fi <= 0``. A non-finite
    objective or gradient at a new iterate is bisected toward the last
    finite iterate up to ``max_backtracks`` times, then rejected (the run
    retreats and the move limit shrinks 4x); the move limit shrinks 2x
    after backtracks and grows 1.25x (to at most 1) after a clean step.
    ``max_seconds`` stops the loop before an iteration once the budget is
    spent (``history["stopped_early"] = "max_seconds"``).
    ``feasibility_tol``: restore feasibility at termination (see
    :func:`_restore_feasibility`), appending the restored design.
    ``callback(iteration, x, value, max_violation, fi)`` runs per iteration.

    Returns ``(x_final, history)``: the last evaluated iterate and the
    per-iteration objective values, designs, max violations and
    ``rejected`` flags (a rejected iteration re-logs the last accepted
    iterate).
    """

    sign = -1.0 if maximize else 1.0
    deadline = None if max_seconds is None else time.monotonic() + max_seconds
    x0, xmin, xmax = _bounds(x0, xmin, xmax)
    state = mma_init(x0, xmin, xmax)
    history = _new_history()

    def evaluate(x):
        """(value, grad, finite) with one device-to-host readback."""

        value, grad = objective_and_grad(x)
        finite = torch.isfinite(value) & torch.all(torch.isfinite(grad))
        summary = torch.stack([value, finite.to(value.dtype)]).cpu()
        return float(summary[0]), grad, bool(summary[1])

    move_scale = 1.0
    accepted = None  # (value, grad) at x_prev1: a rejection's retreat is free
    for it in range(n_iterations):
        if deadline is not None and time.monotonic() > deadline:
            history["stopped_early"] = "max_seconds"
            break
        rejected = False
        value, grad, finite = evaluate(state.x)
        backtracks = 0
        while not finite and backtracks < max_backtracks and it > 0:
            state = state._replace(x=(state.x + state.x_prev1) / 2)
            value, grad, finite = evaluate(state.x)
            backtracks += 1
        if not finite and it > 0:
            state = state._replace(x=state.x_prev1)
            value, grad = accepted
            finite = True
            rejected = True
            move_scale = max(move_scale / 4, 1e-4)
        elif backtracks:
            move_scale = max(move_scale / 2, 1e-4)
        else:
            move_scale = min(move_scale * 1.25, 1.0)
        accepted = (value, grad)
        if not finite:
            raise FloatingPointError(
                f"MMA iteration {it}: objective/gradient non-finite at the "
                f"{'initial design' if it == 0 else 'last accepted iterate'}."
                f" Check solver stability (substeps) for designs within the "
                f"bounds, or lower move_limit."
            )

        if constraints_and_jac is not None:
            fi, dfi = constraints_and_jac(state.x)
            state = mma_update(state, sign * grad, fi, dfi, xmin, xmax,
                               n_dual_iters=n_dual_iters, move_limit=move_limit * move_scale)
            violation = torch.max(fi) if fi.numel() else 0.0
        else:
            fi = x0.new_zeros((0,))
            state = mma_update(state, sign * grad, None, None, xmin, xmax,
                               n_dual_iters=n_dual_iters, move_limit=move_limit * move_scale)
            violation = 0.0

        history["objective_values"].append(value)
        history["design_values"].append(state.x_prev1)
        history["constraints_violation"].append(violation)
        history["rejected"].append(rejected)
        if callback is not None:
            callback(it, state.x_prev1, value, violation, fi)

    if history["constraints_violation"]:
        # One readback for all the violations.
        history["constraints_violation"] = torch.stack(
            [_as(v, x0) for v in history["constraints_violation"]]
        ).cpu().tolist()

    x_final = state.x_prev1 if n_iterations > 0 else state.x
    if feasibility_tol is not None and constraints_and_jac is not None \
            and history["objective_values"]:
        x_final = _restore_and_append(
            history, x_final, constraints_and_jac, xmin, xmax, feasibility_tol, n_dual_iters,
            move_limit, lambda x: evaluate(x)[::2], callback,
        )
    return x_final, history


def run_mma_fused(
    objective_and_grad: Callable,
    x0: torch.Tensor,
    xmin,
    xmax,
    n_iterations: int,
    constraints_and_jac: Optional[Callable] = None,
    maximize: bool = False,
    callback: Optional[Callable] = None,
    n_dual_iters: int = 100,
    move_limit: float = _MOVE,
    max_seconds: Optional[float] = None,
    chunk: int = 10,
    feasibility_tol: Optional[float] = None,
):
    """:func:`run_mma` with the trust-region bookkeeping on the device.

    Each iteration's reject decision, trust-region scale and update are
    tensor operations (``torch.where``), so the loop never waits for the
    device within a chunk; the history's scalars come back to the host in
    one readback per ``chunk`` iterations, followed by the ``callback``
    replay. A non-finite iterate is fully rejected at once (retreat to the
    last accepted iterate, move scale / 4; otherwise x 1.25, at most 1):
    there are no bisection backtracks. ``max_seconds`` is checked before
    every iteration, so the loop stops within one iteration of the
    deadline. Returns the same ``(x_final, history)`` as :func:`run_mma`.
    """

    sign = -1.0 if maximize else 1.0
    deadline = None if max_seconds is None else time.monotonic() + max_seconds
    x0, xmin, xmax = _bounds(x0, xmin, xmax)
    has_constraints = constraints_and_jac is not None

    def one_iter(state, move_scale, acc_v, acc_g):
        value, grad = objective_and_grad(state.x)
        finite = torch.isfinite(value) & torch.all(torch.isfinite(grad))
        fresh = state.iteration == 0
        # A non-finite first iterate has nothing to retreat to: it
        # propagates NaN and the host check below raises.
        reject = (~finite) & (~fresh)
        x_eval = torch.where(reject, state.x_prev1, state.x)
        value = torch.where(reject, acc_v, value)
        grad = torch.where(reject, acc_g, grad)
        state = state._replace(x=x_eval)
        move_scale = torch.where(
            reject,
            torch.clamp(move_scale / 4, min=1e-4),
            torch.clamp(move_scale * 1.25, max=1.0),
        )
        if has_constraints:
            fi, dfi = constraints_and_jac(x_eval)
            violation = torch.max(fi) if fi.numel() else value.new_zeros(())
        else:
            fi, dfi = value.new_zeros((0,)), None
            violation = value.new_zeros(())
        state = mma_update(
            state, sign * grad, fi if has_constraints else None, dfi, xmin, xmax,
            n_dual_iters=n_dual_iters, move_limit=move_limit * move_scale,
        )
        return (state, move_scale, value, grad), (value, x_eval, violation, reject, fi)

    carry = (mma_init(x0, xmin, xmax), x0.new_ones(()), x0.new_zeros(()), torch.zeros_like(x0))
    history = _new_history()

    done = 0
    while done < n_iterations and "stopped_early" not in history:
        outs = []
        for _ in range(min(chunk, n_iterations - done)):
            if deadline is not None and time.monotonic() > deadline:
                history["stopped_early"] = "max_seconds"
                break
            carry, out = one_iter(*carry)
            outs.append(out)
        if not outs:
            break
        # One readback of the chunk's scalars.
        values, violations, rejected = torch.stack(
            [torch.stack([v, viol, r.to(v.dtype)]) for v, _, viol, r, _ in outs]
        ).cpu().T.tolist()
        if done == 0 and not np.isfinite(values[0]):
            raise FloatingPointError(
                "MMA iteration 0: objective/gradient non-finite at the "
                "initial design. Check solver stability (substeps) for "
                "designs within the bounds, or lower move_limit."
            )
        for k, (_, x_k, _, _, fi_k) in enumerate(outs):
            history["objective_values"].append(values[k])
            history["design_values"].append(x_k)
            history["constraints_violation"].append(violations[k])
            history["rejected"].append(bool(rejected[k]))
            if callback is not None:
                callback(done + k, x_k, values[k], violations[k], fi_k)
        done += len(outs)

    if done == 0:
        return x0, history
    x_final = history["design_values"][-1]
    if feasibility_tol is not None and has_constraints:

        def evaluate(x):
            value, grad = objective_and_grad(x)
            finite = torch.isfinite(value) & torch.all(torch.isfinite(grad))
            summary = torch.stack([value, finite.to(value.dtype)]).cpu()
            return float(summary[0]), bool(summary[1])

        x_final = _restore_and_append(
            history, x_final, constraints_and_jac, xmin, xmax, feasibility_tol, n_dual_iters,
            move_limit, evaluate, callback,
        )
    return x_final, history
