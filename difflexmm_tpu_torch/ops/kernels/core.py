"""Lattice-agnostic Verlet machinery: the plain interval body, the
reactive substep guard and the stored-boundary-state trajectory
``autograd.Function``.

Counterpart of ``difflexmm_tpu/ops/pallas/core.py`` (``make_force_fn``,
``resolve_guard``, ``guard_travel``, ``make_risk_predicate``,
``make_guarded_stepper``, ``make_interval_body``, and
``build_verlet_trajectory``'s custom vjp). A lattice family plugs in with a
:class:`TrajectorySpec`: its plane energy, the forward that integrates the
whole trajectory (a hand-written kernel for CUDA tensors), the drive
slots and, when guarded, the resolved guard and the barrier gap.

Layouts: states are ``(B, C, n2, n1)`` component planes with the design
batch B leading. The fixed leaves are a tuple of per-design tensors whose
last three entries are, by convention, the ``(inertia, damping, mask)``
planes. The drive is a table ``(B, (T-1) * n_substeps, k)``: row
``k * n_substeps + i`` holds the constrained values at the END time of
substep i of interval k, where the force of that substep is evaluated.
JAX traces ``drive_values_fn(t)`` inside the kernel instead; a table keeps
the kernel free of user code and lets autograd reach the drive parameters.
A guarded trajectory also takes one micro-step table per guard level:
table ``l`` (1-based) has ``refine**l`` rows per substep, row
``(.. (k * n_substeps + i) * refine + j ..)`` holding the values at the end
of that (micro-)step.

External loads (JAX ``make_force_fn``'s ``load_values_fn``) come the same
way: a load table ``(B, (T-1) * n_substeps, k_load)`` of the values of the
k_load loaded (block, DOF) pairs at each substep's end time, plus one
micro-step table per guard level. Pairs that name the same slot are summed
in pair order into one column per loaded slot (:func:`slot_loads`, as
``.at[].add`` sums them), and each slot's sum is added to the force after
``-mask * dE/dU_eff``; a load on a constrained DOF has no effect (the
acceleration is masked).
"""

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


class LoadMap(NamedTuple):
    """Where the loaded (block, DOF) pairs enter the force planes
    (:func:`load_map`).

    Attrs:
        pairs: (k_load,) int64 flat ``C * n2 * n1`` plane index of each
            loaded pair, in pair order (duplicates kept: they add).
        slots: (n_slots,) int64 flat plane index of each loaded slot, the
            columns of :func:`slot_loads`.
        ranks: ``((pair indices, slot columns), ...)`` int64: rank r holds
            every slot's r-th pair, so that :func:`slot_loads` adds a slot's
            pairs in pair order, one rank at a time, without atomics.
        columns: (C, n2, n1) int32 slot column of each plane element, -1
            where nothing is loaded: the kernel's map, read as the drive
            map is.
    """

    pairs: torch.Tensor
    slots: torch.Tensor
    ranks: tuple
    columns: torch.Tensor

    def to(self, device) -> "LoadMap":
        return LoadMap(self.pairs.to(device), self.slots.to(device),
                       tuple((p.to(device), c.to(device)) for p, c in self.ranks),
                       self.columns.to(device))


def load_map(pairs, plane_shape, device) -> LoadMap:
    """The :class:`LoadMap` of loaded pairs at flat plane indices ``pairs``
    (in pair order) on planes of shape ``plane_shape`` ``(C, n2, n1)``."""

    pairs = np.asarray(torch.as_tensor(pairs).cpu(), dtype=np.int64).reshape(-1)
    slots, column = np.unique(pairs, return_inverse=True)
    rank = np.zeros_like(pairs)
    seen = {}
    for j, slot in enumerate(pairs.tolist()):
        rank[j] = seen.get(slot, 0)
        seen[slot] = rank[j] + 1
    columns = np.full(int(np.prod(plane_shape)), -1, dtype=np.int32)
    columns[slots] = np.arange(len(slots), dtype=np.int32)

    def tensor(x, dtype=torch.int64):
        return torch.as_tensor(x, dtype=dtype, device=device)

    ranks = tuple((tensor(np.flatnonzero(rank == r)), tensor(column[rank == r]))
                  for r in range(int(rank.max(initial=-1)) + 1))
    return LoadMap(tensor(pairs), tensor(slots), ranks,
                   tensor(columns, torch.int32).view(*plane_shape))


def slot_loads(table: torch.Tensor, loads: LoadMap) -> torch.Tensor:
    """A load table ``(..., k_load)`` summed into its loaded slots, ``(...,
    n_slots)``: each slot's pairs added in pair order to zero, as
    ``.at[].add`` adds them. The plain body and the kernel wrapper share
    it, so the kernel adds the very sums the plain body adds."""

    out = table.new_zeros(table.shape[:-1] + loads.slots.shape)
    for pairs, columns in loads.ranks:
        out = out.index_add(-1, columns, table.index_select(-1, pairs))
    return out


class TrajectorySpec(NamedTuple):
    """Static description of one trajectory family.

    Attrs:
        n_substeps: Verlet substeps per output interval.
        energy_of: ``(U_eff (B, C, n2, n1), fixed) -> scalar`` total energy
            of all B designs (designs do not interact, so its gradient is
            per-design).
        forward: ``(U0, V0, A0, dts, drive, fixed, spec, micro) -> (outU,
            outV, outA)``, each ``(B, T-1, C, n2, n1)``, followed when
            guarded by the per-interval flags ``(B, T-1)``, the per-substep
            decisions ``(B, (T-1) * n_substeps)`` (bool) and the decisions
            of the micro-steps at each depth ``d`` that decides (``1 <= d <
            levels``), ``(B, (T-1) * n_substeps * refine**d)`` each
            (``n_deep`` tables, indexed as micro-step table ``d``'s rows;
            False where the micro-step did not run); the kernel wrapper, or
            the quad lattice's ``verlet_ckpt`` forward
            (:func:`stepped_trajectory` on CUDA tensors).
        drive_slots: (s,) int64 flat ``C * n2 * n1`` plane index of each
            driven slot (one per slot: duplicates already resolved).
        drive_cols: (s,) int64 drive-table column written to that slot.
        guard: resolved guard spec (:func:`resolve_guard`) or None.
        gap_of: ``(U (B, C, n2, n1), fixed) -> (B,)`` barrier gap for the
            guard's proximity term, or None where the family has none.
        load_map: where the external loads enter (:class:`LoadMap`), or
            None without them.
        force_of: ``(U_eff (B, C, n2, n1), fixed) -> dE/dU_eff`` per design,
            the lattice's force kernel wrapper (its plain version for CPU
            tensors), which :func:`stepped_trajectory` calls once a
            (micro-)step; None where the lattice has no force kernel.
    """

    n_substeps: int
    energy_of: Callable
    forward: Callable
    drive_slots: torch.Tensor
    drive_cols: torch.Tensor
    guard: Optional[dict] = None
    gap_of: Optional[Callable] = None
    load_map: Optional[LoadMap] = None
    force_of: Optional[Callable] = None

    @property
    def n_micro(self) -> int:
        """Number of micro-step drive tables (one per guard level)."""

        return 0 if self.guard is None else self.guard["levels"]

    @property
    def n_deep(self) -> int:
        """Number of micro-step decision tables a guarded forward returns
        after the substeps' decisions: one per depth below ``levels``
        whose micro-steps decide (0 unguarded and at one level)."""

        return 0 if self.guard is None else self.guard["levels"] - 1

    @property
    def n_loads(self) -> int:
        """Number of load tables: 0 without loads, else the substep table
        and one micro-step table per guard level."""

        return 0 if self.load_map is None else 1 + self.n_micro


class TrajectoryArgs(NamedTuple):
    """Inputs of one trajectory; run it with :func:`trajectory_forward`
    (no autograd) or :func:`apply` (differentiable). ``loads``: the load
    tables (``spec.n_loads`` of them), empty without loads."""

    spec: TrajectorySpec
    U0: torch.Tensor
    V0: torch.Tensor
    A0: torch.Tensor
    dts: torch.Tensor
    drive: torch.Tensor
    fixed: tuple
    micro: tuple = ()
    loads: tuple = ()


def trajectory_forward(args: TrajectoryArgs):
    """``args.spec.forward`` on ``args``: the kernel for CUDA tensors."""

    return args.spec.forward(args.U0, args.V0, args.A0, args.dts, args.drive,
                             args.fixed, args.spec, args.micro, args.loads)


def apply(args: TrajectoryArgs):
    """The differentiable trajectory (:class:`VerletTrajectory`)."""

    return VerletTrajectory.apply(args.spec, args.U0, args.V0, args.A0, args.dts,
                                  args.drive, *args.micro, *args.loads, *args.fixed)


# ---------------------------------------------------------------------------
# Reactive substep guard
# ---------------------------------------------------------------------------


def resolve_guard(guard, theta_channels, default_translation="relative"):
    """Normalize a reactive-substep-guard spec into static fields.

    Same keys, defaults and errors as ``resolve_guard`` of the JAX package
    (``ops/pallas/core.py:184-327``): ``threshold`` or ``window`` (with
    ``fraction``, default 0.02), ``proximity``/``proximity_windows``,
    ``hard``/``hard_fraction`` (forced on at 5x threshold with proximity),
    ``refine`` (16), ``levels`` (1), ``length_scale``, ``translation``.
    """

    if guard is None:
        return None
    g = dict(guard)
    threshold = g.pop("threshold", None)
    window = g.pop("window", None)
    fraction = float(g.pop("fraction", 0.02))
    if threshold is None:
        if window is None:
            raise ValueError(
                "guard spec needs 'threshold' (rad/substep) or 'window' "
                "(the contact barrier window cutoff_angle - min_angle)."
            )
        threshold = fraction * float(window)

    def _windows(key_abs, key_rel, default=None):
        """A radians-or-window-multiples pair of spec keys."""

        value = g.pop(key_abs, None)
        rel = g.pop(key_rel, None)
        if value is not None and rel is not None:
            raise ValueError(f"give '{key_abs}' or '{key_rel}', not both")
        if rel is not None:
            if window is None:
                raise ValueError(f"'{key_rel}' needs 'window' in the spec")
            return float(rel) * float(window)
        return float(value) if value is not None else default

    proximity = _windows("proximity", "proximity_windows")
    # With the travel term gated on proximity, a NaN state far from any
    # barrier would never refine without the unconditional hard term.
    hard = _windows(
        "hard", "hard_fraction",
        default=5.0 * float(threshold) if proximity is not None else None,
    )
    resolved = dict(
        threshold=float(threshold),
        proximity=proximity,
        hard=hard,
        refine=int(g.pop("refine", 16)),
        levels=int(g.pop("levels", 1)),
        length_scale=g.pop("length_scale", None),
        translation=str(g.pop("translation", default_translation)),
        theta_channels=tuple(theta_channels),
    )
    if g:
        raise ValueError(f"unknown guard spec keys: {sorted(g)}")
    if proximity is not None and proximity <= 0:
        raise ValueError("guard proximity must be positive")
    if hard is not None and hard <= resolved["threshold"]:
        raise ValueError("guard hard threshold must exceed 'threshold'")
    if resolved["translation"] not in ("relative", "absolute"):
        raise ValueError(
            "guard translation must be 'relative' or 'absolute'; got "
            f"{resolved['translation']!r}"
        )
    if resolved["refine"] < 2 or resolved["levels"] < 1:
        raise ValueError("guard needs refine >= 2 and levels >= 1")
    if resolved["length_scale"] is not None:
        resolved["length_scale"] = float(resolved["length_scale"])
    return resolved


def guard_travel(V, A, dt, guard):
    """Predicted max travel of each design in one substep of dt, ``(B,)``.

    ``V``/``A`` are ``(B, C, n2, n1)``. The rotational channels count
    ``|v| dt + dt^2/2 |a|`` as they are; with ``length_scale`` the
    translational channels add their maximum over neighbour differences
    (``translation="relative"``: along n1, along n2, and between the same
    DOF of cell-mates) or over the channels themselves ("absolute"),
    divided by ``length_scale``. NaN propagates, as with ``jnp.max``.
    """

    theta = set(guard["theta_channels"])

    def travel(v, a):
        return torch.amax(v.abs() * dt + (0.5 * dt * dt) * a.abs(), dim=(-2, -1))

    def max_of(parts):
        out = parts[0]
        for p in parts[1:]:
            out = torch.maximum(out, p)
        return out

    t = max_of([travel(V[:, c], A[:, c]) for c in sorted(theta)])
    if guard["length_scale"] is not None:
        trans = [c for c in range(V.shape[1]) if c not in theta]
        if guard["translation"] == "absolute":
            tt = max_of([travel(V[:, c], A[:, c]) for c in trans])
        else:
            parts = []
            for c in trans:
                v, a = V[:, c], A[:, c]
                if v.shape[-1] > 1:
                    parts.append(travel(v[..., :, 1:] - v[..., :, :-1],
                                        a[..., :, 1:] - a[..., :, :-1]))
                if v.shape[-2] > 1:
                    parts.append(travel(v[..., 1:, :] - v[..., :-1, :],
                                        a[..., 1:, :] - a[..., :-1, :]))
            for i, c1 in enumerate(trans):
                for c2 in trans[i + 1:]:
                    if (c1 - c2) % 3 == 0:
                        parts.append(travel(V[:, c1] - V[:, c2], A[:, c1] - A[:, c2]))
            if not parts:  # single-cell lattice: nothing to move relative to
                parts = [V.new_zeros(V.shape[0])]
            tt = max_of(parts)
        t = t + tt / guard["length_scale"]
    return t


def make_risk_predicate(guard, travel_fn, gap_fn):
    """The guard's per-substep risk predicate ``risk((U, V, A), dt)``:

        risky = (travel > threshold AND gap < proximity) OR travel > hard

    written as ``~(travel <= threshold)`` so that NaN travel fires through
    either term; a NaN gap switches off only the proximity term.
    ``travel_fn(V, A, dt)``; ``gap_fn(U)`` or None where the layout has no
    gap (then ``proximity`` must not be set).
    """

    threshold = guard["threshold"]
    proximity = guard.get("proximity")
    hard = guard.get("hard")
    if proximity is not None and gap_fn is None:
        raise ValueError(
            "guard 'proximity' needs a lattice gap function; this layout "
            "has none (use the grid backends, or drop the proximity gate)."
        )

    def risk(carry, dt):
        U, V, A = carry
        travel = travel_fn(V, A, dt)
        risky = ~(travel <= threshold)
        if proximity is not None:
            risky = risky & (gap_fn(U) < proximity)
        if hard is not None:
            risky = risky | ~(travel <= hard)
        return risky

    return risk


def spec_risk(spec: "TrajectorySpec", fixed):
    """:func:`make_risk_predicate` of a guarded spec at its fixed leaves."""

    guard = spec.guard
    gap = None if spec.gap_of is None else (lambda U: spec.gap_of(U, fixed))
    return make_risk_predicate(guard, lambda V, A, dt: guard_travel(V, A, dt, guard), gap)


def drive_planes(drive_row: torch.Tensor, spec: TrajectorySpec, like: torch.Tensor):
    """Scatter one drive-table row ``(B, k)`` into ``like``-shaped planes
    (zero where nothing is driven)."""

    flat = like.new_zeros((like.shape[0], like[0].numel()))
    flat = flat.index_copy(1, spec.drive_slots, drive_row[:, spec.drive_cols])
    return flat.view(like.shape)


def load_planes(load_row: torch.Tensor, spec: TrajectorySpec, like: torch.Tensor):
    """Scatter one load-table row ``(B, k_load)`` into ``like``-shaped planes:
    pairs that name the same slot add, in pair order (:func:`slot_loads`)."""

    flat = like.new_zeros((like.shape[0], like[0].numel()))
    loads = spec.load_map
    return flat.index_copy(1, loads.slots, slot_loads(load_row, loads)).view(like.shape)


def force(U_free, drive_row, fixed, spec: TrajectorySpec, create_graph=False, load_row=None):
    """``-mask * dE/dU_eff`` at ``U_eff = U_free * mask + drive``, plus the
    loads of ``load_row`` (B, k_load) where given.

    The gradient is taken with ``torch.autograd.grad``; ``create_graph``
    keeps its graph for the adjoint's double backward. It runs on the
    calling thread: autograd numbers graph nodes with a thread-local
    counter and a backward runs ready nodes in the order of those numbers,
    so a gradient graph built on the engine's CUDA worker thread beside a
    forward built on the caller's would interleave by the two counters'
    positions, which depend on the process's history, and the double
    backward would add its gradient contributions in an order, and with
    last bits, that change from call to call.
    """

    mask = fixed[-1]
    with torch.enable_grad(), torch.autograd.set_multithreading_enabled(False):
        Uf = U_free if U_free.requires_grad else U_free.detach().requires_grad_()
        U_eff = Uf * mask + drive_planes(drive_row, spec, Uf)
        (grad,) = torch.autograd.grad(
            spec.energy_of(U_eff, fixed), Uf, create_graph=create_graph
        )
    if load_row is None:
        return -grad
    return -grad + load_planes(load_row, spec, grad)


def stepped_force(U_free, drive_row, fixed, spec: TrajectorySpec, create_graph=False,
                 load_row=None):
    """:func:`force` with ``dE/dU_eff`` from ``spec.force_of`` (the
    lattice's force kernel on CUDA tensors), composed in the same order:
    ``-(dE/dU_eff * mask)`` plus the loads. The kernel keeps no autograd
    graph, so this force serves forward runs only; the adjoint
    differentiates :func:`force`."""

    if create_graph:
        raise ValueError("stepped_force keeps no autograd graph: the adjoint replays force()")
    mask = fixed[-1]
    U_eff = U_free * mask + drive_planes(drive_row, spec, U_free)
    grad = spec.force_of(U_eff, fixed) * mask
    if load_row is None:
        return -grad
    return -grad + load_planes(load_row, spec, grad)


def one_step(U, V, A, ddt, drive_row, fixed, spec, create_graph=False, load_row=None,
             force_fn=force):
    """One velocity-Verlet step with exact implicit diagonal damping
    (``make_interval_body``'s ``one_step``, same operations and order);
    ``force_fn`` is :func:`force` or :func:`stepped_force`."""

    inertia, damping, mask = fixed[-3:]
    inv_m = mask / inertia
    U1 = U + ddt * V + (0.5 * ddt * ddt) * A
    F1 = force_fn(U1, drive_row, fixed, spec, create_graph, load_row)
    V_hat = V + 0.5 * ddt * (A + F1 * inv_m)
    V1 = V_hat / (1.0 + 0.5 * ddt * damping / inertia) * mask
    A1 = (F1 - damping * V1) * inv_m
    return U1, V1, A1


def interval_body(U, V, A, dt, drive_rows, fixed, spec, create_graph=False, load_rows=None,
                  force_fn=force):
    """All ``n_substeps`` steps of one output interval; ``drive_rows`` is
    the ``(B, n_substeps, k)`` slice of the drive table, ``load_rows`` that
    of the load table (or None)."""

    for i in range(spec.n_substeps):
        U, V, A = one_step(U, V, A, dt, drive_rows[:, i], fixed, spec, create_graph,
                           None if load_rows is None else load_rows[:, i], force_fn)
    return U, V, A


def _guarded_step(carry, dt, idx, depth, rows, fixed, spec, risk, create_graph, risky,
                  decisions, replay, lrows=None, force_fn=force, trace=None):
    """One (micro-)step at guard depth ``depth`` (0: a substep), as
    ``make_guarded_stepper``'s ``stepper``: where ``risky`` (B,) bool, on
    any device, the step re-runs as ``refine`` micro-steps of ``dt /
    refine``, each a guarded step of the next depth, down to ``levels``.
    ``rows[d]`` is the interval's slice of drive table ``d`` (``lrows[d]``
    of load table ``d``, or ``lrows`` None); this step's row is ``idx`` and
    its micro-steps' rows ``idx * refine + j``. ``decisions[d]`` is the
    interval's decision table of depth ``d`` (:func:`guarded_interval_body`):
    a micro-step that decides reads its decision there where ``replay``,
    else evaluates the predicate and writes it there. Designs of a batch
    decide on their own: where they disagree both branches run and each
    design takes its own, as ``vmap(lax.cond)`` does. A design that takes
    the coarse branch runs none of the micro-steps, so its decisions there
    are written False (and its discarded fine branch refines no further),
    as the kernels leave them. ``trace``: as for
    :func:`guarded_interval_body`."""

    guard = spec.guard
    load_row = None if lrows is None else lrows[depth][:, idx]
    if depth == guard["levels"]:
        return one_step(*carry, dt, rows[depth][:, idx], fixed, spec, create_graph, load_row,
                        force_fn)

    def coarse():
        return one_step(*carry, dt, rows[depth][:, idx], fixed, spec, create_graph, load_row,
                        force_fn)

    def fine():
        refine = guard["refine"]
        ddt = dt / refine
        c = carry
        for j in range(refine):
            sub, r = idx * refine + j, None
            if depth + 1 < guard["levels"]:
                if replay:
                    r = decisions[depth + 1][:, sub]
                else:
                    with torch.no_grad():
                        r = risk(c, ddt) & risky.to(c[0].device)
                        if trace is not None:
                            trace.append(_traced(depth + 1, c, ddt, fixed, spec, risky))
                    decisions[depth + 1][:, sub] = r
            c = _guarded_step(c, ddt, sub, depth + 1, rows, fixed, spec, risk, create_graph, r,
                              decisions, replay, lrows, force_fn, trace)
        return c

    if not bool(risky.any()):
        return coarse()
    if bool(risky.all()):
        return fine()
    pick = risky.to(carry[0].device).view(-1, *([1] * (carry[0].dim() - 1)))
    return tuple(torch.where(pick, f, c) for f, c in zip(fine(), coarse()))


def guarded_interval_body(U, V, A, dt, rows, fixed, spec, create_graph=False, decisions=None,
                          trace=None, lrows=None, force_fn=force):
    """All substeps of one interval under ``spec.guard``: the plain guarded
    body (``make_interval_body(guard, emit_risk=True)`` of the JAX package).

    ``rows``: the interval's slices of the drive table and of each
    micro-step table; ``lrows`` the same of the load tables, or None.
    ``decisions``: recorded decision tables to replay instead of evaluating
    the predicate, one per depth below ``levels``: ``decisions[d]`` (B,
    n_substeps * refine**d) bool, the substeps' at d = 0, then those of the
    micro-steps of depth d, indexed as micro-step table d's rows (the
    adjoint's replay: the gradient is the taken branches', and the replay
    cannot take another branch than the forward did at any depth).
    ``trace``: a list that receives ``(depth, travel, gap, ran)`` of every
    predicate, in the order they run: its depth, the travel and gap (B,)
    of every design and the (B,) designs that ran that (micro-)step (every
    design at depth 0). Returns ``((U, V, A), decisions)``, the tables
    taken (False where a micro-step did not run).
    """

    risk = spec_risk(spec, fixed)
    replay = decisions is not None
    if not replay:
        n, refine = spec.n_substeps, spec.guard["refine"]
        decisions = [torch.zeros((U.shape[0], n * refine ** d), dtype=torch.bool,
                                 device=U.device) for d in range(spec.guard["levels"])]
    carry = (U, V, A)
    for i in range(spec.n_substeps):
        if replay:
            risky = decisions[0][:, i]
        else:
            with torch.no_grad():
                risky = risk(carry, dt)
                if trace is not None:
                    trace.append(_traced(0, carry, dt, fixed, spec, torch.ones_like(risky)))
            decisions[0][:, i] = risky
        carry = _guarded_step(carry, dt, i, 0, rows, fixed, spec, risk, create_graph, risky,
                              decisions, replay, lrows, force_fn, trace)
    return carry, decisions


def _traced(depth, carry, dt, fixed, spec, ran):
    """A predicate's entry of :func:`guarded_interval_body`'s ``trace``."""

    return (depth, guard_travel(carry[1], carry[2], dt, spec.guard), spec.gap_of(carry[0], fixed),
            ran)


def interval_rows(k, drive, micro, spec):
    """Slices of the drive table and of each micro-step table (or of the
    load tables: ``load, load_micro``) that belong to interval k."""

    n = spec.n_substeps
    rows = [drive[:, k * n:(k + 1) * n]]
    for table in micro:
        n *= spec.guard["refine"]
        rows.append(table[:, k * n:(k + 1) * n])
    return rows


def plain_trajectory(U0, V0, A0, dts, drive, fixed, spec: TrajectorySpec, micro=(), loads=(),
                     trace=None):
    """The plain PyTorch version of the trajectory kernel: every interval
    through :func:`interval_body` (or :func:`guarded_interval_body`, which
    appends to ``trace`` when given), boundary states stacked to ``(B,
    T-1, C, n2, n1)``; guarded, also the per-interval flags ``(B, T-1)``
    and per-substep decisions ``(B, (T-1) * n_substeps)``. ``loads``: the
    load tables (``spec.n_loads``). Counts its calls in
    ``plain_trajectory.calls`` so that a run can show the kernel path never
    reached it."""

    plain_trajectory.calls += 1
    return _trajectory(U0, V0, A0, dts, drive, fixed, spec, micro, loads, trace, force)


plain_trajectory.calls = 0


def stepped_trajectory(U0, V0, A0, dts, drive, fixed, spec: TrajectorySpec, micro=(), loads=()):
    """The stepped forward of ``method="verlet_ckpt"`` on CUDA tensors:
    :func:`plain_trajectory`'s loop, guarded to any depth, with the force of
    every (micro-)step from the lattice's force kernel
    (:func:`stepped_force`, one launch of ``spec.force_of`` a step) instead
    of autograd. Same outputs as :func:`plain_trajectory`; at float64 the
    two differ by the kernel's rounding only."""

    return _trajectory(U0, V0, A0, dts, drive, fixed, spec, micro, loads, None, stepped_force)


def _trajectory(U0, V0, A0, dts, drive, fixed, spec, micro, loads, trace, force_fn):
    """The loop of :func:`plain_trajectory` and :func:`stepped_trajectory`,
    with the force ``force_fn``."""

    fixed = tuple(f.detach() for f in fixed)
    drive = drive.detach()
    micro = tuple(m.detach() for m in micro)
    loads = tuple(t.detach() for t in loads)
    carry = (U0.detach(), V0.detach(), A0.detach())
    outs, decisions = [], []
    with torch.no_grad():
        for k in range(dts.shape[0]):
            rows = interval_rows(k, drive, micro, spec)
            lrows = interval_rows(k, loads[0], loads[1:], spec) if loads else None
            if spec.guard is None:
                carry = interval_body(*carry, dts[k].detach(), rows[0], fixed, spec,
                                      load_rows=None if lrows is None else lrows[0],
                                      force_fn=force_fn)
            else:
                carry, taken = guarded_interval_body(*carry, dts[k].detach(), rows, fixed, spec,
                                                     trace=trace, lrows=lrows, force_fn=force_fn)
                decisions.append(taken)
            outs.append(carry)
    stacked = tuple(torch.stack(x, dim=1) for x in zip(*outs))
    if spec.guard is None:
        return stacked
    substeps, *deep = (torch.cat(tables, dim=1) for tables in zip(*decisions))
    flags = substeps.view(substeps.shape[0], dts.shape[0], spec.n_substeps).any(-1)
    return stacked + (flags, substeps, *deep)


class GraphedIntervalVJP:
    """The vector-Jacobian product of one unguarded interval
    (:func:`interval_body`, double backward through the force) captured
    once as a CUDA graph, then replayed for interval after interval: the
    same kernels on the same shapes, without the host launching each of
    the thousands of small operations again (the eager replay is bound by
    those launches, not by the card).

    ``carry``, ``rows``, ``dt`` (and ``load_rows``, the interval's slice of
    the load table, or None) are one interval's inputs: their values only
    seed the capture. ``fixed_in`` are the fixed leaves, some requiring
    grad, which every interval shares. A call copies an interval's inputs
    and cotangents into the captured buffers, replays the graph, and
    returns copies of the gradients with respect to the carry, then to the
    load rows where ``load_grad``, then to each leaf of ``fixed_in`` that
    requires grad (None where the interval does not depend on it). The
    drive rows and dt take no gradient here.
    """

    def __init__(self, spec, carry, rows, dt, fixed_in, load_rows=None, load_grad=False):
        self.spec, self.fixed = spec, fixed_in
        self.carry = [x.detach().clone().requires_grad_() for x in carry]
        self.rows, self.dt = rows.detach().clone(), dt.detach().clone()
        self.loads = None
        if load_rows is not None:
            self.loads = load_rows.detach().clone().requires_grad_(load_grad)
        self.cot = [torch.zeros_like(x) for x in carry]
        self.inputs = self.carry + ([self.loads] if load_grad else [])
        self.inputs += [f for f in fixed_in if f.requires_grad]
        # Capture after one eager run on a side stream, as CUDA graphs ask.
        side = torch.cuda.Stream(device=self.dt.device)
        side.wait_stream(torch.cuda.current_stream(self.dt.device))
        with torch.cuda.stream(side):
            self._vjp()
        torch.cuda.current_stream(self.dt.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.grads = self._vjp()

    def _vjp(self):
        with torch.enable_grad():
            out = interval_body(*self.carry, self.dt, self.rows, self.fixed, self.spec,
                                create_graph=True, load_rows=self.loads)
            return torch.autograd.grad(out, self.inputs, self.cot, allow_unused=True)

    def __call__(self, carry, rows, dt, cot, load_rows=None):
        buffers, values = [*self.carry, self.rows, self.dt, *self.cot], [*carry, rows, dt, *cot]
        if self.loads is not None:
            buffers.append(self.loads)
            values.append(load_rows)
        with torch.no_grad():
            for buffer, value in zip(buffers, values):
                buffer.copy_(value)
        self.graph.replay()
        return [None if g is None else g.clone() for g in self.grads]


class VerletTrajectory(torch.autograd.Function):
    """Whole trajectory with a stored-boundary-state adjoint.

    ``apply(spec, U0, V0, A0, dts, drive, *micro, *loads, *fixed) -> (outU,
    outV, outA)``, plus ``(flags, decisions)`` and the ``spec.n_deep``
    micro-step decision tables when ``spec.guard`` is set (``len(micro) ==
    spec.n_micro``, ``len(loads) == spec.n_loads``). The
    forward is ``spec.forward`` (the kernel for CUDA tensors, the plain
    body for CPU tensors). The interval-boundary states it returns are
    exact checkpoints, so the backward replays one interval at a time, in
    reverse, through the plain body and differentiates it with autograd
    (double backward through the force), as ``trajectory_bwd`` of
    ``difflexmm_tpu/ops/pallas/core.py``; the drive, micro-step and load
    tables get their cotangents row by row.

    Guarded, an interval where no design fired replays the unguarded body:
    up to the first firing substep the two coincide, so this is exact. An
    interval that fired replays the guarded body with the forward's
    recorded decisions at every depth: a replay that evaluated a
    micro-step's predicate again, on states that differ from the forward's
    in the last bits (another forward than the plain body), could take
    another branch. The flags and decisions are read back to the host once
    per backward. On CUDA tensors, where neither the
    drive nor the substep sizes take a gradient, the unguarded replay is
    captured once per backward as a CUDA graph (:class:`GraphedIntervalVJP`,
    with the load rows as one more input) and replayed for each interval
    that takes it.
    """

    @staticmethod
    def forward(ctx, spec, U0, V0, A0, dts, drive, *rest):
        n_micro, n_loads = spec.n_micro, spec.n_loads
        micro, loads = rest[:n_micro], rest[n_micro:n_micro + n_loads]
        fixed = rest[n_micro + n_loads:]
        outs = spec.forward(U0, V0, A0, dts, drive, fixed, spec, micro, loads)
        ctx.spec = spec
        ctx.save_for_backward(U0, V0, A0, dts, drive, *micro, *loads, *fixed, *outs)
        if spec.guard is not None:
            ctx.mark_non_differentiable(*outs[3:])
        return outs

    @staticmethod
    def backward(ctx, gU, gV, gA, *_):
        spec = ctx.spec
        n_micro, n_loads = spec.n_micro, spec.n_loads
        n_tables = 1 + n_micro + n_loads
        U0, V0, A0, dts, *rest = ctx.saved_tensors
        tables, rest = rest[:n_tables], rest[n_tables:]
        n_out = 3 if spec.guard is None else 5 + spec.n_deep
        fixed, outs = rest[:-n_out], rest[-n_out:]
        outU, outV, outA = outs[:3]
        fired, decisions = [False] * dts.shape[0], None
        if spec.guard is not None:  # one readback of the decisions of every depth
            decisions = [d.cpu().view(U0.shape[0], dts.shape[0], -1) for d in outs[4:]]
            fired = decisions[0].any(-1).any(0).tolist()
        need = ctx.needs_input_grad
        need_dts, need_tables, need_fixed = need[4], need[5:5 + n_tables], need[5 + n_tables:]
        # Each table's guard level: the drive's and the loads' substep
        # tables are level 0, their micro-step tables levels 1, 2, ...
        levels = tuple(range(1 + n_micro)) + tuple(range(n_loads))
        n_drive = 1 + n_micro  # drive tables before the load tables
        # The graph serves the loads' substep table; their micro-step tables
        # are not used where nothing fired.
        graph_ok = not (any(need_tables[:n_drive]) or need_dts)
        need_load0 = bool(n_loads) and need_tables[n_drive]

        fixed_in = tuple(
            f.detach().requires_grad_(bool(n)) for f, n in zip(fixed, need_fixed)
        )
        d_fixed = [torch.zeros_like(f) if n else None for f, n in zip(fixed, need_fixed)]
        d_tables = [torch.zeros_like(t) if n else None for t, n in zip(tables, need_tables)]
        d_dts = torch.zeros_like(dts) if need_dts else None
        cot = (torch.zeros_like(U0), torch.zeros_like(V0), torch.zeros_like(A0))
        graphed = None

        def rows_of(k):
            """Interval k's slice of every table, in the order of ``tables``."""

            rows = interval_rows(k, tables[0], tables[1:n_drive], spec)
            if n_loads:
                rows += interval_rows(k, tables[n_drive], tables[n_drive + 1:], spec)
            return rows

        for k in reversed(range(dts.shape[0])):
            cot = (cot[0] + gU[:, k], cot[1] + gV[:, k], cot[2] + gA[:, k])
            if k == 0:
                cin = (U0, V0, A0)
            else:
                cin = (outU[:, k - 1], outV[:, k - 1], outA[:, k - 1])
            rows = rows_of(k)
            if U0.is_cuda and not fired[k] and graph_ok:
                load0 = rows[n_drive] if n_loads else None
                if graphed is None:
                    graphed = GraphedIntervalVJP(spec, cin, rows[0], dts[k], fixed_in, load0,
                                                 need_load0)
                out = graphed(cin, rows[0], dts[k], cot, load0)
                # In the eager layout: a gradient (or None) for each table
                # that needs one, then the fixed leaves'.
                it = iter(out[3:])
                grads = list(out[:3]) + [
                    next(it) if i == n_drive and need_load0 else None
                    for i, n in enumerate(need_tables) if n
                ] + list(it)
            else:
                with torch.enable_grad():
                    carry = [x.detach().requires_grad_() for x in cin]
                    rows = [r.detach().requires_grad_(bool(n)) for r, n in zip(rows, need_tables)]
                    drows = rows[:n_drive]
                    lrows = rows[n_drive:] or None
                    dt = dts[k].detach().requires_grad_(need_dts)
                    if fired[k]:
                        out, _ = guarded_interval_body(*carry, dt, drows, fixed_in, spec,
                                                       create_graph=True,
                                                       decisions=[d[:, k] for d in decisions],
                                                       lrows=lrows)
                    else:
                        out = interval_body(*carry, dt, drows[0], fixed_in, spec,
                                            create_graph=True,
                                            load_rows=None if lrows is None else lrows[0])
                    extra = [r for r in rows if r.requires_grad]
                    extra += [dt] if need_dts else []
                    extra += [f for f in fixed_in if f.requires_grad]
                    grads = torch.autograd.grad(out, carry + extra, cot, allow_unused=True)
            cot = tuple(
                torch.zeros_like(c) if g is None else g for g, c in zip(grads[:3], cot)
            )
            it = iter(grads[3:])
            for i, n in enumerate(need_tables):
                if n:
                    g = next(it)
                    if g is not None:
                        n_rows = spec.n_substeps * (spec.guard["refine"] ** levels[i]
                                                    if levels[i] else 1)
                        d_tables[i][:, k * n_rows:(k + 1) * n_rows] += g
            if need_dts:
                g = next(it)
                if g is not None:
                    d_dts[k] += g
            for i, n in enumerate(need_fixed):
                if n:
                    g = next(it)
                    if g is not None:
                        d_fixed[i] += g
        return (None, *cot, d_dts, *d_tables, *d_fixed)
