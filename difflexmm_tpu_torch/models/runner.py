"""The optimization-runner mixin of the model families (counterpart of
``difflexmm_tpu/models/runner.py``: ``_ensure_guarded``,
``_guarded_objective_fn``, ``_design_constraints``,
``run_optimization_mma`` with its metrics, checkpoint and resume,
``run_multistart_mma``, ``run_optimization_optax``, ``_history_extras``
and ``compute_best_forward``).

A model's ``OptimizationProblem`` supplies ``setup_objective`` (installing
``self.objective_fn``, maximized, and ``self.population_objective_fn`` for
a population of designs) and inherits the constrained MMA driver, the
batched multistart driver, the gradient loop (``torch.optim`` in place of
optax), the fabrication-constraint wiring and the iteration histories from
here.
"""

import copy
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from difflexmm_tpu_torch.models import base
from difflexmm_tpu_torch.optim.loops import (
    _leaves,
    _rebuild,
    population_unflatten,
    ravel_pytree,
    run_optimization_optax,
)
from difflexmm_tpu_torch.optim.mma import run_mma, run_mma_fused
from difflexmm_tpu_torch.parallel.multistart import reevaluate_finalists
from difflexmm_tpu_torch.parallel.multistart import run_multistart_mma as _run_multistart


class OptimizationRunnerMixin:
    """Drives ``self.objective_fn`` (maximized) with MMA or a gradient loop.

    Requires on self: ``objective_fn``, ``objective_values``,
    ``design_values``, ``constraints_violation``, ``is_setup`` and either
    ``forward_problem`` or ``forward_problems`` (several forward problems
    on one design).
    """

    def _forward_problems(self) -> list:
        if hasattr(self, "forward_problem"):
            return [self.forward_problem]
        return list(self.forward_problems)

    def _set_forward_problems(self, problems: list) -> None:
        if hasattr(self, "forward_problem"):
            (self.forward_problem,) = problems
        else:
            self.forward_problems = problems

    def _geometry(self):
        return self._forward_problems()[0].geometry

    def _boundary_node_ids(self):
        geometry = self._geometry()
        return base.quad_boundary_node_ids(geometry.n1_blocks, geometry.n2_blocks)

    def _design_constraints(
        self,
        min_void_angle: Optional[float],
        min_block_angle: Optional[float],
        min_edge_length: Optional[float],
        boundary_angle_constraint: bool = False,
    ) -> List:
        """``[(name, design -> g(design)), ...]`` of the fabrication
        constraints asked for (feasible where ``g <= 0``)."""

        geometry = self._geometry()
        constraints = []
        if min_void_angle is not None and min_block_angle is not None:
            boundary_ids = self._boundary_node_ids() if boundary_angle_constraint else None
            self.angle_constraints = base.build_angle_constraints(
                geometry.centroid_node_vectors,
                geometry.bond_connectivity(),
                min_void_angle,
                min_block_angle,
                boundary_ids,
            )
            constraints.append(("angles", self.angle_constraints))
        if min_edge_length is not None:
            self.edge_length_constraints = base.build_edge_length_constraints(
                geometry.centroid_node_vectors, min_edge_length
            )
            constraints.append(("edge_lengths", self.edge_length_constraints))
        return constraints

    # Solver methods whose fixed-step integrator takes the substep guard.
    _GUARDABLE_METHODS = ("verlet", "verlet_pallas", "verlet_ckpt", "auto")

    def _guardable(self, fp) -> bool:
        return (dataclasses.is_dataclass(fp) and hasattr(fp, "guard")
                and getattr(fp, "method", None) in self._GUARDABLE_METHODS)

    def _ensure_guarded(self, guard):
        """Re-arm the forward problem's substep guard for an optimization:
        an unguarded fixed-step objective is exploitable under optimization
        pressure (the optimizer chases integrator error). A guardable
        forward problem built without a guard is rebuilt with ``guard``;
        ``guard=None`` keeps it exactly as configured."""

        if guard is None:
            return
        problems = self._forward_problems()
        rearmed = [dataclasses.replace(fp, guard=guard, is_setup=False)
                   if self._guardable(fp) and fp.guard is None else fp for fp in problems]
        if any(new is not old for new, old in zip(rearmed, problems)):
            self.is_setup = False
            self._set_forward_problems(rearmed)

    def _guarded_sibling(self, guard):
        """A guarded sibling of this problem (set up) without changing self:
        self when the forward problem is already guarded, None when it
        cannot take a guard."""

        problems = self._forward_problems()
        if not all(self._guardable(fp) for fp in problems):
            return None
        if all(fp.guard is not None for fp in problems):
            return self
        clone = copy.copy(self)
        clone._set_forward_problems([
            fp if fp.guard is not None else dataclasses.replace(fp, guard=guard, is_setup=False)
            for fp in problems])
        clone.is_setup = False
        clone.setup_objective()
        return clone

    def _guarded_objective_fn(self, guard):
        """A guarded sibling's ``objective_fn`` without changing self: the
        existing objective when the forward problem is already guarded,
        None when it cannot take a guard."""

        sibling = self._guarded_sibling(guard)
        return None if sibling is None else sibling.objective_fn

    def run_optimization_mma(
        self,
        initial_guess,
        n_iterations: int,
        lower_bound: Optional[float] = None,
        upper_bound: Optional[float] = None,
        min_void_angle: Optional[float] = None,
        min_block_angle: Optional[float] = None,
        min_edge_length: Optional[float] = None,
        boundary_angle_constraint: bool = False,
        verbose: bool = True,
        metrics_logger=None,
        checkpoint=None,
        resume: bool = False,
        move_limit: float = 0.2,
        max_seconds: Optional[float] = None,
        guard="auto",
        device_loop: bool = True,
        chunk: int = 10,
        feasibility_tol: Optional[float] = 1e-6,
    ):
        """Constrained inverse design with MMA; returns the final design.

        ``guard``: re-arm the forward solver's substep guard (default
        "auto"; ``None`` keeps the problem as configured). ``device_loop``:
        :func:`run_mma_fused` (trust-region bookkeeping on the device, one
        readback per ``chunk`` iterations) instead of the host loop
        :func:`run_mma` with its bisection backtracks. ``feasibility_tol``:
        restore feasibility at termination (``None`` disables). The
        objective values, designs and per-group constraint maxima of every
        iteration are appended to ``self.objective_values``,
        ``self.design_values`` and ``self.constraints_violation`` (and each
        target's objective to ``self.objective_values_individual`` where the
        model has ``objective_fn_individual``).

        ``metrics_logger``: a ``utils.observability.MetricsLogger``; each
        iteration logs ``objective`` and ``constraint_violation`` at step
        ``len(self.objective_values)``. ``checkpoint``: a
        ``utils.observability.OptimizationCheckpoint``, saved when its
        ``every`` divides that step, and forced when ``max_seconds``
        stops the run. ``resume``: where ``checkpoint`` holds a snapshot,
        restore the histories (and ``_history_extras``) and start from its
        design with a fresh MMA state, as JAX does; a resumed run is
        therefore not the uninterrupted one.
        """

        self._ensure_guarded(guard)
        if not self.is_setup:
            self.setup_objective()

        if resume and checkpoint is not None and checkpoint.exists():
            fp = self._forward_problems()[0]
            saved = checkpoint.restore(device=torch.device(fp.device))

            def cast(design):  # in the problem's dtype
                return _rebuild(design, [x.to(fp.dtype) for x in _leaves(design)])

            initial_guess = cast(saved["design"])
            self.objective_values = list(saved["objective_values"])
            self.design_values = [cast(d) for d in saved["design_values"]]
            # The auxiliary histories too, index-aligned with the objective.
            extras = saved.get("extras") or {}
            if getattr(self, "constraints_violation", None) is not None:
                for name, values in extras.get("constraints_violation", {}).items():
                    self.constraints_violation[name] = list(values)
            if hasattr(self, "objective_values_individual"):
                self.objective_values_individual = list(
                    extras.get("objective_values_individual", []))

        flat0, unflatten = ravel_pytree(initial_guess)
        flat0 = flat0.detach()

        def objective_and_grad(x):
            x = x.detach().requires_grad_()
            value = self.objective_fn(unflatten(x))
            (grad,) = torch.autograd.grad(value, x)
            return value.detach(), grad

        constraint_fns = self._design_constraints(
            min_void_angle, min_block_angle, min_edge_length, boundary_angle_constraint,
        )
        if constraint_fns:
            names = [name for name, _ in constraint_fns]
            fns = [fn for _, fn in constraint_fns]

            def stacked(x):
                return torch.cat([fn(unflatten(x)) for fn in fns])

            jacobian = torch.func.jacrev(stacked)

            def constraints_and_jac(x):
                x = x.detach()
                return stacked(x), jacobian(x)

            sizes = [len(fn(initial_guess)) for fn in fns]
            offsets = np.cumsum([0] + sizes)

            def group_max(fi):
                """Each group's largest violation, in one readback."""

                return torch.stack([
                    torch.max(fi[offsets[k]:offsets[k + 1]]) for k in range(len(sizes))
                ]).cpu().numpy()
        else:
            constraints_and_jac = None
            names = []

        span = float(torch.max(torch.abs(flat0))) + 1.0
        xmin = torch.full_like(flat0, lower_bound if lower_bound is not None else -10 * span)
        xmax = torch.full_like(flat0, upper_bound if upper_bound is not None else 10 * span)

        individual = getattr(self, "objective_fn_individual", None)

        def snapshot(force=False):
            checkpoint.save(len(self.objective_values), self.design_values[-1],
                            objective_values=self.objective_values,
                            design_values=self.design_values, extras=self._history_extras(),
                            force=force)

        def callback(it, x, value, violation, fi):
            self.objective_values.append(float(value))
            self.design_values.append(unflatten(x.detach().clone()))
            if individual is not None:
                with torch.no_grad():
                    self.objective_values_individual.append(individual(unflatten(x)))
            if constraints_and_jac is not None:
                maxima = group_max(fi)
                for name, m in zip(names, maxima):
                    self.constraints_violation[name].append(float(m))
                violation = float(maxima.max())
            if metrics_logger is not None:
                metrics_logger.log(
                    len(self.objective_values), objective=float(value),
                    constraint_violation=float(violation) if constraints_and_jac is not None
                    else 0.0)
            if checkpoint is not None:
                snapshot()
            if verbose:
                print(f"Iteration: {len(self.objective_values)}\n"
                      f"Objective = {self.objective_values[-1]}")

        driver = run_mma_fused if device_loop else run_mma
        x_final, history = driver(
            objective_and_grad,
            flat0,
            xmin=xmin,
            xmax=xmax,
            n_iterations=n_iterations,
            constraints_and_jac=constraints_and_jac,
            maximize=True,
            callback=callback,
            move_limit=move_limit,
            max_seconds=max_seconds,
            feasibility_tol=feasibility_tol,
            **(dict(chunk=chunk) if device_loop else {}),
        )
        if history.get("stopped_early") and checkpoint is not None and self.design_values:
            snapshot(force=True)
        if self.design_values:
            self.compute_best_forward()
        return unflatten(x_final)

    def run_multistart_mma(
        self,
        initial_guesses,
        n_iterations: int,
        lower_bound: Optional[float] = None,
        upper_bound: Optional[float] = None,
        min_void_angle: Optional[float] = None,
        min_block_angle: Optional[float] = None,
        min_edge_length: Optional[float] = None,
        boundary_angle_constraint: bool = False,
        move_limit: float = 0.2,
        mesh=None,
        final_guard="auto",
        n_finalists: int = 8,
    ):
        """Batched constrained restarts: every candidate runs an MMA
        optimization at once, one population solve and one vmapped update
        per iteration (``parallel.run_multistart_mma``).

        ``initial_guesses`` is a list of designs. The candidates are
        screened with the problem as configured (unguarded unless it was
        built guarded); then the top ``n_finalists`` by their last value are
        re-evaluated, forward only, by the guarded sibling objective
        (``final_guard``, default "auto"; ``None`` skips the re-ranking)
        through ``parallel.reevaluate_finalists``, in one population solve,
        and the winner is re-ranked by that value: integrator error that
        screens well cannot win. One (value, design) pair lands in the
        histories, so that ``compute_best_forward`` works as usual: the
        winner's own re-evaluated value (the JAX package records the
        largest finalist value, NaN when any finalist is not finite), or its
        screening value without a re-ranking. Returns the
        ``MultistartMMAResult`` (with ``.finalists``). ``mesh``: ROADMAP
        A11.
        """

        if not self.is_setup:
            self.setup_objective()
        designs = torch.stack([ravel_pytree(guess)[0] for guess in initial_guesses]).detach()
        _, unflatten = ravel_pytree(initial_guesses[0])
        unflatten_population = population_unflatten(initial_guesses[0])

        def objective(xs):
            return self.population_objective_fn(unflatten_population(xs))

        constraint_fns = self._design_constraints(
            min_void_angle, min_block_angle, min_edge_length, boundary_angle_constraint,
        )
        if constraint_fns:
            fns = [fn for _, fn in constraint_fns]

            def stacked(x):
                return torch.cat([fn(unflatten(x)) for fn in fns])

            jacobian = torch.func.jacrev(stacked)

            def constraints_and_jac(x):
                return stacked(x), jacobian(x)
        else:
            constraints_and_jac = None

        span = float(torch.max(torch.abs(designs))) + 1.0
        xmin = torch.full(designs.shape[1:], lower_bound if lower_bound is not None else -10 * span,
                          dtype=designs.dtype, device=designs.device)
        xmax = torch.full(designs.shape[1:], upper_bound if upper_bound is not None else 10 * span,
                          dtype=designs.dtype, device=designs.device)
        result = _run_multistart(
            objective, designs, xmin, xmax, n_iterations=n_iterations,
            constraints_and_jac=constraints_and_jac, maximize=True, move_limit=move_limit,
            mesh=mesh,
        )
        best_value = float(result.objective_values[-1, result.best_index])
        sibling = None if final_guard is None else self._guarded_sibling(final_guard)
        if sibling is not None:
            finalists = reevaluate_finalists(
                lambda xs: sibling.population_objective_fn(unflatten_population(xs)),
                result.designs, result.objective_values[-1], k=n_finalists, maximize=True,
            )
            result = result._replace(best_index=finalists.best_index,
                                     best_design=finalists.best_design, finalists=finalists)
            best_value = finalists.best_value
        # One (value, design) pair: histories stay index-aligned; the full
        # per-candidate, per-iteration curves live on the result.
        self.objective_values.append(best_value)
        self.design_values.append(unflatten(result.best_design))
        return result

    def run_optimization_optax(
        self,
        initial_guess,
        n_iterations: int,
        optimizer=None,
        lower_bound=None,
        upper_bound=None,
        verbose: bool = True,
        guard="auto",
    ):
        """Unconstrained (box-projected) inverse design with a gradient
        loop (``optim.loops.run_optimization_optax``; ``optimizer`` a
        factory ``params -> torch.optim.Optimizer``, Adam at 1e-2 by
        default); returns the design after the last step. ``guard``: as
        for :meth:`run_optimization_mma`. Each iteration's value and design
        (the one it evaluated) are appended to the histories, and the last
        of them is solved by :meth:`compute_best_forward`."""

        self._ensure_guarded(guard)
        if not self.is_setup:
            self.setup_objective()

        def callback(it, design, value):
            self.objective_values.append(value)
            self.design_values.append(design)
            if verbose:
                print(f"Iteration: {len(self.objective_values)}\n"
                      f"Objective = {value}")

        result = run_optimization_optax(
            self.objective_fn, initial_guess, n_iterations=n_iterations, optimizer=optimizer,
            maximize=True, lower_bound=lower_bound, upper_bound=upper_bound, callback=callback,
        )
        if self.design_values:  # zero-iteration runs have no best design
            self.compute_best_forward()
        return result.design

    def _history_extras(self):
        """Auxiliary per-iteration histories kept beside the objective (and
        saved with checkpoints)."""

        extras = {}
        if getattr(self, "constraints_violation", None) is not None:
            extras["constraints_violation"] = {
                name: list(values) for name, values in self.constraints_violation.items()
            }
        if getattr(self, "objective_values_individual", None) is not None:
            extras["objective_values_individual"] = list(self.objective_values_individual)
        return extras

    def compute_best_forward(self):
        """Solve the forward problem (each of ``forward_problems``, a list
        of solutions) at the last design of the history."""

        if not self.design_values:
            raise ValueError("No design has been optimized yet.")
        for fp in self._forward_problems():
            if not fp.is_setup:
                fp.setup()
            with torch.no_grad():
                fp.solution_data = fp.solve(self.design_values[-1])
        if hasattr(self, "forward_problem"):
            return self.forward_problem.solution_data
        return [fp.solution_data for fp in self.forward_problems]
