"""Lattice-agnostic Verlet machinery: the plain interval body and the
stored-boundary-state trajectory ``autograd.Function``.

Counterpart of the unguarded parts of ``difflexmm_tpu/ops/pallas/core.py``
(``make_force_fn``, ``make_interval_body``'s ``one_step``,
``build_verlet_trajectory``'s custom vjp). A lattice family plugs in with a
:class:`TrajectorySpec`: its plane energy, the forward that integrates the
whole trajectory (a hand-written kernel for CUDA tensors), and the drive
slots.

Layouts: states are ``(B, C, n2, n1)`` component planes with the design
batch B leading. The fixed leaves are a tuple of per-design tensors whose
last three entries are, by convention, the ``(inertia, damping, mask)``
planes. The drive is a table ``(B, (T-1) * n_substeps, k)``: row
``k * n_substeps + i`` holds the constrained values at the END time of
substep i of interval k, where the force of that substep is evaluated.
JAX traces ``drive_values_fn(t)`` inside the kernel instead; a table keeps
the kernel free of user code and lets autograd reach the drive parameters.
"""

from typing import Callable, NamedTuple

import torch


class TrajectorySpec(NamedTuple):
    """Static description of one trajectory family.

    Attrs:
        n_substeps: Verlet substeps per output interval.
        energy_of: ``(U_eff (B, C, n2, n1), fixed) -> scalar`` total energy
            of all B designs (designs do not interact, so its gradient is
            per-design).
        forward: ``(U0, V0, A0, dts, drive, fixed, spec) -> (outU, outV,
            outA)``, each ``(B, T-1, C, n2, n1)``; the kernel wrapper.
        drive_slots: (s,) int64 flat ``C * n2 * n1`` plane index of each
            driven slot (one per slot: duplicates already resolved).
        drive_cols: (s,) int64 drive-table column written to that slot.
    """

    n_substeps: int
    energy_of: Callable
    forward: Callable
    drive_slots: torch.Tensor
    drive_cols: torch.Tensor


class TrajectoryArgs(NamedTuple):
    """Inputs of one trajectory: ``VerletTrajectory.apply(*args[:-1],
    *args.fixed)`` or ``args.spec.forward(*args[1:], args.spec)``."""

    spec: TrajectorySpec
    U0: torch.Tensor
    V0: torch.Tensor
    A0: torch.Tensor
    dts: torch.Tensor
    drive: torch.Tensor
    fixed: tuple


def drive_planes(drive_row: torch.Tensor, spec: TrajectorySpec, like: torch.Tensor):
    """Scatter one drive-table row ``(B, k)`` into ``like``-shaped planes
    (zero where nothing is driven)."""

    flat = like.new_zeros((like.shape[0], like[0].numel()))
    flat = flat.index_copy(1, spec.drive_slots, drive_row[:, spec.drive_cols])
    return flat.view(like.shape)


def force(U_free, drive_row, fixed, spec: TrajectorySpec, create_graph=False):
    """``-mask * dE/dU_eff`` at ``U_eff = U_free * mask + drive``.

    The gradient is taken with ``torch.autograd.grad``; ``create_graph``
    keeps its graph for the adjoint's double backward.
    """

    mask = fixed[-1]
    with torch.enable_grad():
        Uf = U_free if U_free.requires_grad else U_free.detach().requires_grad_()
        U_eff = Uf * mask + drive_planes(drive_row, spec, Uf)
        (grad,) = torch.autograd.grad(
            spec.energy_of(U_eff, fixed), Uf, create_graph=create_graph
        )
    return -grad


def one_step(U, V, A, ddt, drive_row, fixed, spec, create_graph=False):
    """One velocity-Verlet step with exact implicit diagonal damping
    (``make_interval_body``'s ``one_step``, same operations and order)."""

    inertia, damping, mask = fixed[-3:]
    inv_m = mask / inertia
    U1 = U + ddt * V + (0.5 * ddt * ddt) * A
    F1 = force(U1, drive_row, fixed, spec, create_graph)
    V_hat = V + 0.5 * ddt * (A + F1 * inv_m)
    V1 = V_hat / (1.0 + 0.5 * ddt * damping / inertia) * mask
    A1 = (F1 - damping * V1) * inv_m
    return U1, V1, A1


def interval_body(U, V, A, dt, drive_rows, fixed, spec, create_graph=False):
    """All ``n_substeps`` steps of one output interval; ``drive_rows`` is
    the ``(B, n_substeps, k)`` slice of the drive table."""

    for i in range(spec.n_substeps):
        U, V, A = one_step(U, V, A, dt, drive_rows[:, i], fixed, spec, create_graph)
    return U, V, A


def plain_trajectory(U0, V0, A0, dts, drive, fixed, spec: TrajectorySpec):
    """The plain PyTorch version of the trajectory kernel: every interval
    through :func:`interval_body`, boundary states stacked to
    ``(B, T-1, C, n2, n1)``. Counts its calls in ``plain_trajectory.calls``
    so that a run can show the kernel path never reached it."""

    plain_trajectory.calls += 1
    n_sub = spec.n_substeps
    fixed = tuple(f.detach() for f in fixed)
    drive = drive.detach()
    carry = (U0.detach(), V0.detach(), A0.detach())
    outs = []
    with torch.no_grad():
        for k in range(dts.shape[0]):
            rows = drive[:, k * n_sub:(k + 1) * n_sub]
            carry = interval_body(*carry, dts[k].detach(), rows, fixed, spec)
            outs.append(carry)
    return tuple(torch.stack(x, dim=1) for x in zip(*outs))


plain_trajectory.calls = 0


class VerletTrajectory(torch.autograd.Function):
    """Whole trajectory with a stored-boundary-state adjoint.

    ``apply(spec, U0, V0, A0, dts, drive, *fixed) -> (outU, outV, outA)``.
    The forward is ``spec.forward`` (the kernel for CUDA tensors, the plain
    body for CPU tensors). The interval-boundary states it returns are
    exact checkpoints, so the backward replays one interval at a time, in
    reverse, through the plain body and differentiates it with autograd
    (double backward through the force). This mirrors ``trajectory_bwd``
    of ``difflexmm_tpu/ops/pallas/core.py`` in its unguarded mode.
    """

    @staticmethod
    def forward(ctx, spec, U0, V0, A0, dts, drive, *fixed):
        outU, outV, outA = spec.forward(U0, V0, A0, dts, drive, fixed, spec)
        ctx.spec = spec
        ctx.save_for_backward(U0, V0, A0, dts, drive, *fixed, outU, outV, outA)
        return outU, outV, outA

    @staticmethod
    def backward(ctx, gU, gV, gA):
        spec = ctx.spec
        n_sub = spec.n_substeps
        U0, V0, A0, dts, drive, *rest = ctx.saved_tensors
        fixed, (outU, outV, outA) = rest[:-3], rest[-3:]
        need = ctx.needs_input_grad
        need_dts, need_drive, need_fixed = need[4], need[5], need[6:]

        fixed_in = tuple(
            f.detach().requires_grad_(bool(n)) for f, n in zip(fixed, need_fixed)
        )
        d_fixed = [torch.zeros_like(f) if n else None for f, n in zip(fixed, need_fixed)]
        d_drive = torch.zeros_like(drive) if need_drive else None
        d_dts = torch.zeros_like(dts) if need_dts else None
        cot = (torch.zeros_like(U0), torch.zeros_like(V0), torch.zeros_like(A0))

        for k in reversed(range(dts.shape[0])):
            cot = (cot[0] + gU[:, k], cot[1] + gV[:, k], cot[2] + gA[:, k])
            if k == 0:
                cin = (U0, V0, A0)
            else:
                cin = (outU[:, k - 1], outV[:, k - 1], outA[:, k - 1])
            with torch.enable_grad():
                carry = [x.detach().requires_grad_() for x in cin]
                rows = drive[:, k * n_sub:(k + 1) * n_sub].detach()
                rows.requires_grad_(need_drive)
                dt = dts[k].detach().requires_grad_(need_dts)
                out = interval_body(*carry, dt, rows, fixed_in, spec, create_graph=True)
                extra = [rows] if need_drive else []
                extra += [dt] if need_dts else []
                extra += [f for f in fixed_in if f.requires_grad]
                grads = torch.autograd.grad(
                    out, carry + extra, cot, allow_unused=True
                )
            cot = tuple(
                torch.zeros_like(c) if g is None else g for g, c in zip(grads[:3], cot)
            )
            it = iter(grads[3:])
            if need_drive:
                g = next(it)
                if g is not None:
                    d_drive[:, k * n_sub:(k + 1) * n_sub] += g
            if need_dts:
                g = next(it)
                if g is not None:
                    d_dts[k] += g
            for i, n in enumerate(need_fixed):
                if n:
                    g = next(it)
                    if g is not None:
                        d_fixed[i] += g
        return (None, *cot, d_dts, d_drive, *d_fixed)
