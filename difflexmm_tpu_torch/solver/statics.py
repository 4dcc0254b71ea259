"""Static equilibrium solver with implicit-function-theorem gradients
(counterpart of ``difflexmm_tpu/solver/statics.py``).

Finds block displacements where internal elastic forces balance external
loads and driven-boundary constraints, ``r(u) = -dE/du + f_ext(u) = 0`` on
the free DOFs, by damped Newton iterations with a halving line search.
Differentiation does not unroll the Newton loop: a
``torch.autograd.Function`` solves one adjoint system ``J^T lambda =
u_bar`` at the equilibrium (the implicit function theorem), so a gradient
costs one extra dense solve whatever the number of Newton steps.

The state stays dense and masked, ``(n_blocks, 3)``; the Newton system
keeps its shape by filling the constrained rows and columns of the
Jacobian with the identity (their residual entries are zero, so the step
is zero there). The Newton loop runs on the host: one read of the
residual's norm per iteration and per line-search trial. The Jacobian is
``torch.func.jacfwd`` of the residual, itself ``torch.func.grad`` of the
constrained energy.
"""

from typing import Callable, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from difflexmm_tpu_torch.ops.assembly import constrain_energy
from difflexmm_tpu_torch.ops.kinematics import build_constrained_kinematics
from difflexmm_tpu_torch.ops.loading import build_loading
from difflexmm_tpu_torch.utils.types import ControlParams

_EMPTY_PAIRS = np.zeros((0, 2), dtype=np.int64)


def default_tol(dtype) -> float:
    """The Newton tolerance at a working precision: 1e-10 at float64; at
    float32, where Newton bottoms out near 1e-6, 1e-6."""

    return 1e-10 if dtype == torch.float64 else 1e-6


class TensorLeaves:
    """A pytree (control parameters) split into its floating-point tensor
    leaves, which an ``autograd.Function`` takes as inputs, and the rest
    (numbers, index tensors, None), kept as they are; ``rebuild(tensors)``
    makes the tree again from (other) tensors."""

    def __init__(self, tree):
        leaves, self.spec = pytree.tree_flatten(tree)
        self.positions = [i for i, x in enumerate(leaves)
                          if isinstance(x, torch.Tensor) and x.is_floating_point()]
        self.leaves = leaves
        self.tensors = tuple(leaves[i] for i in self.positions)

    def rebuild(self, tensors):
        leaves = list(self.leaves)
        for i, x in zip(self.positions, tensors):
            leaves[i] = x
        return pytree.tree_unflatten(leaves, self.spec)


def newton_solve(residual: Callable, jacobian: Callable, x0: torch.Tensor, tol: float,
                 n_steps: int, n_backtrack: int):
    """Damped Newton on ``residual(x) = 0`` (flat vectors) from ``x0``.

    Each iteration solves ``jacobian(x) step = -r`` and halves the step
    until the residual's largest entry decreases (a NaN trial compares
    false and is rejected); an iteration whose line search fails stops the
    loop, as do ``tol`` and ``n_steps``. Returns ``(x, rnorm, iterations)``
    with ``rnorm`` the residual's largest entry at ``x`` (a Python float).
    """

    def norm(r):
        return float(torch.max(torch.abs(r)))

    x = x0
    rnorm = norm(residual(x))
    it = 0
    while rnorm > tol and it < n_steps:
        r = residual(x)
        step = torch.linalg.solve(jacobian(x), -r)
        alpha, accepted = 1.0, False
        for _ in range(n_backtrack):
            trial = norm(residual(x + alpha * step))
            if trial < rnorm:
                accepted = True
                break
            alpha *= 0.5
        it += 1
        if not accepted:
            break
        x = x + alpha * step
        rnorm = trial
    return x, rnorm, it


def setup_static_solver(
    geometry,
    energy_fn: Callable,
    loaded_block_DOF_pairs=None,
    loading_fn: Optional[Callable] = None,
    constrained_block_DOF_pairs=_EMPTY_PAIRS,
    constrained_DOFs_fn: Callable = lambda t, **kwargs: 0.0,
    n_newton_steps: int = 40,
    tol: Optional[float] = None,
    n_backtrack: int = 30,
    nan_on_failure: bool = True,
):
    """Set up the static solver.

    Arguments as for :func:`solver.dynamics.setup_dynamic_solver` (loads on
    [block, DOF] pairs; driven constraints from ``constrained_DOFs_fn(t,
    **constraint_params)``, where ``t`` is the load-path parameter, e.g. a
    ramp amplitude).

    Returns ``solve_static(u_guess, t, control_params) -> (n_blocks, 3)``:
    the equilibrium displacement (driven DOFs at their constraint values),
    differentiable with respect to ``t`` and every tensor of
    ``control_params`` through the implicit adjoint; the guess carries no
    gradient. Its attributes: ``residual(u, t, control_params)`` (the
    free-DOF force residual), ``reactions(u_eq, t, control_params)`` (the
    ``(n_constrained,)`` reaction forces conjugate to the driven DOFs,
    internal minus external force), ``dof_set``, and ``iterations``, the
    Newton iterations of each solve since set-up (a list; clear it at
    will). With ``nan_on_failure`` (default) a solve whose residual does
    not reach 10x the tolerance returns NaN displacements (a
    ``torch.where``, no host read).
    """

    n_blocks = geometry if isinstance(geometry, int) else geometry.n_blocks
    kinematics = build_constrained_kinematics(
        n_blocks,
        constrained_block_DOF_pairs=constrained_block_DOF_pairs,
        constrained_DOFs_fn=constrained_DOFs_fn,
    )
    dof_set = kinematics.dof_set
    constrained_energy = constrain_energy(energy_fn, kinematics)
    has_loading = loaded_block_DOF_pairs is not None and loading_fn is not None
    loading = build_loading(n_blocks, loaded_block_DOF_pairs, loading_fn) if has_loading \
        else None
    iterations = []

    def residual(free_DOFs, t, control_params: ControlParams) -> torch.Tensor:
        """Out-of-balance force on the free DOFs, (n_blocks, 3)."""

        u = free_DOFs.reshape(n_blocks, 3)
        free_mask = dof_set.tensors(u.dtype, u.device)[0]
        force = -torch.func.grad(lambda uu: constrained_energy(uu, t, control_params))(u)
        if loading is not None:
            u_full = kinematics(u, t, control_params.constraint_params)
            state = torch.stack([u_full, torch.zeros_like(u_full)])
            force = force + loading(state, t, control_params.loading_params)
        return force * free_mask

    def newton_matrix(free_flat, t, control_params):
        """Dense residual Jacobian with the identity filled in (negated, as
        the residual's) on the constrained DOFs."""

        J = torch.func.jacfwd(lambda f: residual(f, t, control_params).reshape(-1))(free_flat)
        flat_mask = dof_set.tensors(free_flat.dtype, free_flat.device)[0].reshape(-1)
        return J - torch.diag(1.0 - flat_mask)

    def as_t(t, like):
        return t if isinstance(t, torch.Tensor) else torch.as_tensor(t, **like)

    class _SolveFree(torch.autograd.Function):
        """The Newton solve with the implicit adjoint: inputs ``(free0, t,
        *tensor leaves of the control parameters)``."""

        @staticmethod
        def forward(ctx, leaves: TensorLeaves, free0, t, *tensors):
            control_params = leaves.rebuild(tensors)
            mask = dof_set.tensors(free0.dtype, free0.device)[0]
            u0 = (free0.reshape(n_blocks, 3) * mask).reshape(-1)
            eff_tol = tol if tol is not None else default_tol(u0.dtype)
            u_star, _, n_it = newton_solve(
                lambda x: residual(x, t, control_params).reshape(-1),
                lambda x: newton_matrix(x, t, control_params),
                u0, eff_tol, n_newton_steps, n_backtrack)
            iterations.append(n_it)
            ctx.leaves = leaves
            ctx.free_shape = free0.shape
            ctx.save_for_backward(u_star, t, *tensors)
            return u_star.reshape(n_blocks, 3)

        @staticmethod
        def backward(ctx, cotangent):
            u_star, t, *tensors = ctx.saved_tensors
            leaves = ctx.leaves
            with torch.enable_grad():
                control_params = leaves.rebuild(tensors)
                A = newton_matrix(u_star, t, control_params)
                mask = dof_set.tensors(u_star.dtype, u_star.device)[0].reshape(-1)
                lam = torch.linalg.solve(A.T, cotangent.reshape(-1) * mask)
                # r(u*, t, theta) = 0  =>  du*/dtheta = -J^{-1} dr/dtheta: the
                # parameter cotangent is the residual's vjp at -lambda.
                _, vjp = torch.func.vjp(
                    lambda tt, *xs: residual(u_star, tt, leaves.rebuild(xs)), t, *tensors)
                grads = vjp(-lam.reshape(n_blocks, 3))
            # The equilibrium does not depend on the initial guess.
            return (None, torch.zeros(ctx.free_shape, dtype=u_star.dtype,
                                      device=u_star.device)) + tuple(grads)

    def solve_static(u_guess, t, control_params: ControlParams) -> torch.Tensor:
        leaves = TensorLeaves(control_params)
        cnv = control_params.geometrical_params.centroid_node_vectors
        like = dict(dtype=cnv.dtype, device=cnv.device)
        free0 = torch.as_tensor(u_guess, **like)
        tt = as_t(t, like)
        free_star = _SolveFree.apply(leaves, free0, tt, *leaves.tensors)
        if nan_on_failure:
            # A stalled Newton (a NaN residual at the guess, a descent
            # failure) would return a non-equilibrium: poison it instead.
            # Gradients flow through the converged branch only.
            with torch.no_grad():
                rnorm = torch.max(torch.abs(residual(free_star.detach(), tt, control_params)))
                eff_tol = tol if tol is not None else default_tol(free_star.dtype)
                ok = (rnorm < 10 * eff_tol) & torch.all(torch.isfinite(free_star))
            free_star = torch.where(ok, free_star, torch.full_like(free_star, float("nan")))
        return kinematics(free_star, tt, control_params.constraint_params)

    def reactions(u_eq, t, control_params: ControlParams) -> torch.Tensor:
        f_int = torch.func.grad(lambda u: energy_fn(u, control_params))(u_eq)
        if loading is not None:
            state = torch.stack([u_eq, torch.zeros_like(u_eq)])
            f_int = f_int - loading(state, t, control_params.loading_params)
        return dof_set.gather_constrained(f_int)

    solve_static.residual = residual
    solve_static.reactions = reactions
    solve_static.dof_set = dof_set
    solve_static.iterations = iterations
    solve_static.newton_matrix = newton_matrix
    return solve_static
