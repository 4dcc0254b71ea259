"""Differentiable arc-length (Riks) continuation for snap-through paths
(counterpart of ``difflexmm_tpu/solver/continuation.py``).

Traces equilibrium branches ``(u(s), lambda(s))`` of ``r(u, lambda) =
-dE/du + f_ext(u, lambda) = 0`` through limit points, with ``lambda`` a
scalar load factor that parametrizes both the external loads and the
driven constraints. Predictor-corrector with Riks' normal-plane
corrector: at each accepted point the path tangent comes from one
bordered linear solve (the border row is the previous tangent, so the
system stays nonsingular at folds and the orientation continuous); the
predictor steps ``ds`` along it; the corrector runs Newton on the
augmented residual ``[r(u, lambda); t . (x - x_pred)]`` with the halving
line search of ``solver/statics.py``.

The corrector is a ``torch.autograd.Function`` whose backward solves one
transposed bordered system (the implicit function theorem), so a traced
path's gradient costs one extra solve per continuation step. The step loop
is a Python loop on the host.
"""

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from difflexmm_tpu_torch.ops.assembly import constrain_energy
from difflexmm_tpu_torch.ops.kinematics import build_constrained_kinematics
from difflexmm_tpu_torch.ops.loading import build_loading
from difflexmm_tpu_torch.solver.statics import TensorLeaves, default_tol, newton_solve
from difflexmm_tpu_torch.utils.types import ControlParams

_EMPTY_PAIRS = np.zeros((0, 2), dtype=np.int64)


class ContinuationPath(NamedTuple):
    """An equilibrium branch traced by arc-length continuation; the leading
    axis is the continuation step (element 0 the converged start).
    ``stability_eig`` is the smallest eigenvalue of the symmetrized
    free-DOF tangent stiffness (negative on unstable segments), NaN where
    stability was not asked for."""

    displacement: torch.Tensor  # (n_steps + 1, n_blocks, 3)
    load_factor: torch.Tensor  # (n_steps + 1,)
    converged: torch.Tensor  # (n_steps + 1,) bool
    residual_norm: torch.Tensor  # (n_steps + 1,)
    stability_eig: torch.Tensor  # (n_steps + 1,)


def fold_points(path: ContinuationPath):
    """Indices i where the load factor's direction reverses between steps
    i-1 -> i -> i+1 (limit points); on the host."""

    lam = path.load_factor.detach().cpu().numpy() if torch.is_tensor(path.load_factor) \
        else np.asarray(path.load_factor)
    d = np.sign(np.diff(lam))
    return np.nonzero(d[1:] * d[:-1] < 0)[0] + 1


def setup_arclength_solver(
    geometry,
    energy_fn: Callable,
    loaded_block_DOF_pairs=None,
    loading_fn: Optional[Callable] = None,
    constrained_block_DOF_pairs=_EMPTY_PAIRS,
    constrained_DOFs_fn: Callable = lambda t, **kwargs: 0.0,
    n_corrector_steps: int = 25,
    tol: Optional[float] = None,
    n_backtrack: int = 25,
    lambda_scale: float = 1.0,
):
    """Set up the arc-length path tracer.

    Arguments as for :func:`solver.statics.setup_static_solver`, the load
    path parameter promoted to the continuation variable ``lambda``:
    ``loading_fn(state, lambda, **params)`` and ``constrained_DOFs_fn(lambda,
    **params)`` see the current load factor. ``lambda_scale`` weights the
    load factor in the arc-length metric ``|du|^2 + lambda_scale^2
    dlambda^2``.

    Returns ``trace_path(u0, lambda0, ds, n_steps, control_params,
    compute_stability=False) -> ContinuationPath``: ``ds > 0`` starts
    towards increasing ``lambda``; a step whose corrector does not converge
    keeps the previous point and flags ``converged=False``. The path is
    differentiable with respect to every tensor of ``control_params``.
    Attributes: ``residual(u, lam, control_params)`` and ``dof_set``.
    """

    n_blocks = geometry if isinstance(geometry, int) else geometry.n_blocks
    kinematics = build_constrained_kinematics(
        n_blocks, constrained_block_DOF_pairs=constrained_block_DOF_pairs,
        constrained_DOFs_fn=constrained_DOFs_fn)
    dof_set = kinematics.dof_set
    constrained_energy = constrain_energy(energy_fn, kinematics)
    n_dofs = 3 * n_blocks
    psi2 = float(lambda_scale) ** 2
    has_loading = loaded_block_DOF_pairs is not None and loading_fn is not None
    loading = build_loading(n_blocks, loaded_block_DOF_pairs, loading_fn) if has_loading \
        else None

    def masks(like):
        free_mask = dof_set.tensors(like.dtype, like.device)[0]
        return free_mask, free_mask.reshape(-1)

    def residual_field(u, lam, control_params: ControlParams) -> torch.Tensor:
        """Out-of-balance force on the free DOFs, (n_blocks, 3)."""

        u = u.reshape(n_blocks, 3)
        force = -torch.func.grad(lambda uu: constrained_energy(uu, lam, control_params))(u)
        if loading is not None:
            u_full = kinematics(u, lam, control_params.constraint_params)
            state = torch.stack([u_full, torch.zeros_like(u_full)])
            force = force + loading(state, lam, control_params.loading_params)
        return force * masks(u)[0]

    def residual_flat(u_flat, lam, control_params):
        return residual_field(u_flat, lam, control_params).reshape(-1)

    def jac_u(u_flat, lam, control_params):
        """Filled residual Jacobian: -1 on the constrained diagonal keeps the
        bordered system nonsingular with an exactly zero step there."""

        J = torch.func.jacrev(residual_flat, argnums=0)(u_flat, lam, control_params)
        return J - torch.diag(1.0 - masks(u_flat)[1])

    def jac_lam(u_flat, lam, control_params):
        return torch.func.jacrev(residual_flat, argnums=1)(u_flat, lam, control_params)

    def bordered_matrix(u_flat, lam, border_u, border_lam, control_params):
        """``[[J, r_lam], [border_u^T, border_lam]]``, (n_dofs+1, n_dofs+1)."""

        J = jac_u(u_flat, lam, control_params)
        r_l = jac_lam(u_flat, lam, control_params)
        top = torch.cat([J, r_l[:, None]], dim=1)
        bottom = torch.cat([border_u, border_lam.reshape(1)])[None, :]
        return torch.cat([top, bottom], dim=0)

    def tangent(x, t_prev, control_params):
        """Unit path tangent at ``x = (u_flat, lam)`` oriented along
        ``t_prev``: one bordered solve."""

        A = bordered_matrix(x[:-1], x[-1], t_prev[:-1], psi2 * t_prev[-1], control_params)
        rhs = torch.zeros(n_dofs + 1, dtype=x.dtype, device=x.device)
        rhs[-1] = 1.0
        t = torch.linalg.solve(A, rhs)
        norm = torch.sqrt(torch.sum(t[:-1] ** 2) + psi2 * t[-1] ** 2)
        return t / norm

    def metric_normal(t):
        """The arc-metric-weighted tangent: the corrector's plane normal."""

        return torch.cat([t[:-1], psi2 * t[-1:]])

    def augmented_residual(x, x_pred, normal, control_params):
        r = residual_flat(x[:-1], x[-1], control_params)
        plane = torch.dot(normal, x - x_pred)
        return torch.cat([r, plane.reshape(1)])

    def eff_tol(dtype):
        return tol if tol is not None else default_tol(dtype)

    class _Correct(torch.autograd.Function):
        """The Newton corrector with the implicit adjoint: inputs
        ``(x_pred, normal, *tensor leaves of the control parameters)``;
        outputs ``(x_star, rnorm)`` (``rnorm`` carries no gradient)."""

        @staticmethod
        def forward(ctx, leaves: TensorLeaves, x_pred, normal, *tensors):
            control_params = leaves.rebuild(tensors)
            x_star, rnorm, _ = newton_solve(
                lambda x: augmented_residual(x, x_pred, normal, control_params),
                lambda x: bordered_matrix(x[:-1], x[-1], normal[:-1], normal[-1],
                                          control_params),
                x_pred, eff_tol(x_pred.dtype), n_corrector_steps, n_backtrack)
            ctx.leaves = leaves
            ctx.save_for_backward(x_star, x_pred, normal, *tensors)
            rnorm = torch.as_tensor(rnorm, dtype=x_pred.dtype, device=x_pred.device)
            ctx.mark_non_differentiable(rnorm)
            return x_star, rnorm

        @staticmethod
        def backward(ctx, x_bar, _rnorm_bar):
            x_star, x_pred, normal, *tensors = ctx.saved_tensors
            leaves = ctx.leaves
            with torch.enable_grad():
                control_params = leaves.rebuild(tensors)
                A = bordered_matrix(x_star[:-1], x_star[-1], normal[:-1], normal[-1],
                                    control_params)
                # Constrained entries of x carry no information (their step
                # is pinned to zero): drop their cotangents.
                mask = torch.cat([masks(x_star)[1], x_star.new_ones(1)])
                mu = torch.linalg.solve(A.T, x_bar * mask)
                # R(x*, p) = 0  =>  dx*/dp = -A^{-1} dR/dp.
                _, vjp = torch.func.vjp(
                    lambda xp, nrm, *xs: augmented_residual(x_star, xp, nrm, leaves.rebuild(xs)),
                    x_pred, normal, *tensors)
                grads = vjp(-mu)
            return (None,) + tuple(grads)

    def correct(x_pred, normal, control_params):
        leaves = TensorLeaves(control_params)
        return _Correct.apply(leaves, x_pred, normal, *leaves.tensors)

    def _stability_eig(u_flat, lam, control_params):
        """Smallest eigenvalue of the symmetrized free tangent stiffness
        (constrained DOFs contribute +1). A diagnostic, detached: the
        eigen-derivative divides by eigenvalue gaps, which a degenerate
        pair would make infinite."""

        with torch.no_grad():
            J = jac_u(u_flat.detach(), lam.detach(), control_params)
            S = -(J + J.T) / 2.0
            return torch.linalg.eigvalsh(S)[0]

    def trace_path(u0, lambda0, ds, n_steps: int, control_params: ControlParams,
                   compute_stability: bool = False) -> ContinuationPath:
        cnv = control_params.geometrical_params.centroid_node_vectors
        like = dict(dtype=cnv.dtype, device=cnv.device)
        u0_flat = (torch.as_tensor(u0, **like).reshape(n_blocks, 3)
                   * dof_set.tensors(**like)[0]).reshape(-1)
        accept_tol = 10 * eff_tol(u0_flat.dtype)
        lam0 = torch.as_tensor(lambda0, **like)

        # Land on the curve at lambda0: a corrector whose plane normal is
        # the lambda axis is a Newton static solve at that load factor.
        e_lam = torch.zeros(n_dofs + 1, **like)
        e_lam[-1] = 1.0
        x0, rnorm0 = correct(torch.cat([u0_flat, lam0.reshape(1)]), e_lam, control_params)
        t0 = tangent(x0, e_lam, control_params)  # oriented: dlambda > 0

        def maybe_eig(x):
            if not compute_stability:
                return torch.full((), float("nan"), **like)
            return _stability_eig(x[:-1], x[-1], control_params)

        def full_displacement(x):
            """The driven DOFs' values scattered back (what is measured)."""

            return kinematics(x[:-1].reshape(n_blocks, 3), x[-1], control_params.constraint_params)

        def ok_of(rnorm, x):
            return bool(rnorm < accept_tol) and bool(torch.isfinite(x).all())

        us, lams, oks, rnorms, eigs = ([full_displacement(x0)], [x0[-1]],
                                       [ok_of(rnorm0, x0)], [rnorm0], [maybe_eig(x0)])
        x, t_prev = x0, t0
        for _ in range(n_steps):
            t = tangent(x, t_prev, control_params)
            x_new, rnorm = correct(x + ds * t, metric_normal(t), control_params)
            ok = ok_of(rnorm, x_new)
            if ok:
                x, t_prev = x_new, t
            us.append(full_displacement(x))
            lams.append(x[-1])
            oks.append(ok)
            rnorms.append(rnorm)
            eigs.append(maybe_eig(x))
        return ContinuationPath(
            displacement=torch.stack(us),
            load_factor=torch.stack(lams),
            converged=torch.as_tensor(oks, device=cnv.device),
            residual_norm=torch.stack(rnorms),
            stability_eig=torch.stack(eigs),
        )

    trace_path.residual = residual_field
    trace_path.dof_set = dof_set
    return trace_path
