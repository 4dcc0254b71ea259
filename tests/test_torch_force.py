"""Kernel 2's counterpart in the PyTorch port, on the CPU at float64: the
plain quad force (``verlet_grid.quad_grid_force_planes``, which the force
wrapper ``quad_force`` runs for CPU tensors) against the JAX package's
energy gradient, the closed-form bond partials of the quad kernels
(``kernel_checks.closed_form_force``, their CPU mirror) against the plain
force, and the stepped forward of ``method="verlet_ckpt"``
(``core.stepped_trajectory``) against the plain body.

Inputs are made with numpy from a seed (``kernel_checks.lanes_microbench_
inputs``: the structure of ``make_args`` in
``tools/microbench_lanes_batch.py`` with its per-design jitter) and handed
to both packages. The JAX reference of kernel 2 is its own body,
``jax.vmap(grad_split)`` of the tool; its Pallas wrapper runs on a TPU
only.

Tolerances: the force of the two packages within 1e-12 of the field's
largest entry, with the contact barrier engaged too (the same operations
in the same order; only the last bits of sin, cos, atan2, sqrt and of the
summation differ). The closed form against autograd of the plain energy
within 1e-12 too: the same gradient by another sequence of operations
(the void angles' rotation partials exactly +-1, the barrier's slope in
one quotient). The stepped forward driven by the plain force runs the
plain body's very operations: bit-identical.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difflexmm_tpu.ops.pallas.verlet_grid import (
    quad_grid_energy_planes as jax_quad_grid_energy_planes,
)
from difflexmm_tpu_torch import kernel_checks as kc
from difflexmm_tpu_torch.models.flagship import paper_config
from difflexmm_tpu_torch.models.quads_focusing import ForwardProblem
from difflexmm_tpu_torch.ops.kernels import core
from difflexmm_tpu_torch.ops.kernels.verlet_grid import (
    quad_force,
    quad_grid_force_planes,
    quad_void_angles_planes,
)

torch.set_num_threads(1)

TIGHT = 1e-12
# The guard of ``guard="auto"`` refined twice; refine 4 keeps the violent
# 8 x 6 problem's micro-steps of depth 2 few enough for the CPU.
TWO_LEVELS = {"proximity_windows": 2.0, "hard_fraction": 0.1, "levels": 2, "refine": 4}


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _microbench_tool():
    path = Path(__file__).resolve().parents[1] / "tools" / "microbench_lanes_batch.py"
    spec = importlib.util.spec_from_file_location("microbench_lanes_batch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _numpy(tensors):
    return [t.numpy() for t in tensors]


def test_plain_force_matches_kernel_two_body():
    """At the tool's shape, (3, 16, 24) with B = 4: the wrapper on CPU
    tensors against ``jax.vmap(grad_split)`` (strain and contact gradients
    summed; the tool's stiffnesses and barrier)."""

    U, fixed = kc.lanes_microbench_inputs(B=4, device="cpu", dtype=torch.float64)
    grad_split = _microbench_tool().grad_split
    ref = jax.vmap(grad_split)(*(jnp.asarray(x) for x in _numpy((U,) + fixed[:4])))
    launches = quad_force.launches
    got = quad_force(U, fixed, linearized=False, use_contact=True)
    assert quad_force.launches == launches
    assert got.shape == (4, 3, 16, 24)
    assert rel(got, ref) <= TIGHT


@pytest.mark.parametrize("use_contact", [False, True])
@pytest.mark.parametrize("linearized", [False, True])
def test_plain_force_matches_jax_on_a_small_lattice(linearized, use_contact):
    U, fixed = kc.lanes_microbench_inputs(B=2, n1=6, n2=4, seed=3, device="cpu",
                                          dtype=torch.float64)

    def energy(u, *leaves):
        return jax_quad_grid_energy_planes(u, *leaves, linearized=linearized,
                                           use_contact=use_contact)

    ref = jax.vmap(jax.grad(energy))(*(jnp.asarray(x) for x in _numpy((U,) + fixed)))
    got = quad_grid_force_planes(U, *fixed, linearized=linearized, use_contact=use_contact)
    assert rel(got, ref) <= TIGHT


@pytest.mark.parametrize("linearized", [False, True])
def test_plain_force_matches_jax_with_contact_engaged(linearized):
    """The contact probe's state, voids closed into the barrier window."""

    args, _ = kc.contact_probe(device="cpu")
    U = args.U0 * args.fixed[-1] + core.drive_planes(args.drive[:, 0], args.spec, args.U0)
    assert kc.engaged_bonds(U, args.fixed) > 0
    fixed = args.fixed[:13]

    def energy(u, *leaves):
        return jax_quad_grid_energy_planes(u, *leaves, linearized=linearized)

    ref = jax.vmap(jax.grad(energy))(*(jnp.asarray(x) for x in _numpy((U,) + fixed)))
    got = quad_force(U, fixed, linearized=linearized, use_contact=True)
    assert rel(got, ref) <= TIGHT


def _closed_form_case(case, seed=5):
    """``(U_eff, fixed, use_contact)`` of a closed-form check on an 8 x 6
    lattice of two designs (``lanes_microbench_inputs``' structure, made
    from ``seed``): the contact barrier off; its window [cmin, ccut) set
    around the smallest void angle of each design (one void engaged), or
    up to the smaller of the bond's two voids at the bond where that is
    smallest (both voids of a bond engaged); cmin exactly at the smallest
    void angle (the clamp of x = -1 binds there); rotations near +-pi/2 of
    alternating sign; rotations near 3.3 rad, where the nonlinear shear's
    atan2 wraps."""

    U, fixed = kc.lanes_microbench_inputs(B=2, n1=8, n2=6, seed=seed, device="cpu",
                                          dtype=torch.float64)
    rng = np.random.default_rng(seed)
    theta = U[:, 2]
    if case == "near pi/2":
        sign = torch.tensor([[(-1.0) ** (i + j) for i in range(8)] for j in range(6)],
                            dtype=torch.float64)
        theta.copy_(sign * (np.pi / 2) + 0.01 * torch.as_tensor(rng.standard_normal((2, 6, 8))))
    elif case == "past the wrap":
        theta.copy_(3.3 + 0.02 * torch.as_tensor(rng.standard_normal((2, 6, 8))))
    if case == "contact off":
        return U, fixed, False
    if case in ("one void", "both voids", "clamp binds"):
        voids = quad_void_angles_planes(U, fixed[0], fixed[1])
        pairs = torch.cat([torch.stack(voids[:2], 1).flatten(2), torch.stack(voids[2:], 1)
                           .flatten(2)], 2)  # (B, 2, nbond)
        ordered = pairs.flatten(1).sort(1).values
        if case == "one void":
            cmin, ccut = ordered[:, 0] - 0.1, (ordered[:, 0] + ordered[:, 1]) / 2
        elif case == "both voids":
            upper = pairs.max(1).values.min(1).values
            above = torch.where(ordered > upper[:, None], ordered, float("inf")).min(1).values
            cmin, ccut = ordered[:, 0] - 0.1, (upper + above) / 2
        else:
            cmin, ccut = ordered[:, 0], ordered[:, 0] + 0.3
        fixed = fixed[:10] + (cmin.reshape(2, 1, 1), ccut.reshape(2, 1, 1)) + fixed[12:]
    return U, fixed, True


@pytest.mark.parametrize("case", ["contact off", "one void", "both voids", "clamp binds",
                                  "near pi/2", "past the wrap"])
@pytest.mark.parametrize("linearized", [False, True])
def test_closed_form_partials_match_autograd(linearized, case):
    """The kernels' closed-form bond partials (their CPU mirror, gathered
    in ``Quad::gather``'s order) against ``quad_grid_force_planes``
    (autograd of the plain energy) at float64 on an 8 x 6 lattice."""

    U, fixed, use_contact = _closed_form_case(case)
    bonds, voids = kc.engaged_voids(U, fixed)
    if case == "one void":
        assert (bonds, voids) == (2, 2)
    elif case == "both voids":
        assert voids > bonds >= 2
    elif case == "clamp binds":
        assert voids >= 2  # the smallest void of each design sits at cmin
    partials = kc.closed_form_partials(U, fixed, linearized, use_contact)
    assert partials.shape == (2, 6, 6 * 7 + 5 * 8)
    got = kc.closed_form_force(U, fixed, linearized, use_contact)
    ref = quad_grid_force_planes(U, *fixed, linearized=linearized, use_contact=use_contact)
    assert torch.isfinite(got).all() and rel(got, ref) <= TIGHT


def _small(guard=None, loads=False, seed=0):
    problem = kc.small_problem(device="cpu", n_timepoints=3, guard=guard)
    rng = np.random.default_rng(seed)
    args = kc.batched_args(problem, [kc.random_design(problem, rng) for _ in range(2)])
    return kc.with_loads(args, kc.QUAD_LOAD_PAIRS) if loads else args


@pytest.mark.parametrize("guard, loads", [(None, False), (TWO_LEVELS, False), (None, True),
                                          (TWO_LEVELS, True)],
                         ids=["unguarded", "levels2", "loads", "levels2_loads"])
def test_stepped_forward_equals_the_plain_body(guard, loads):
    """``stepped_trajectory`` with the plain force (its force wrapper on CPU
    tensors) runs the plain body's operations in the same order."""

    args = _small(guard, loads)
    calls = core.plain_trajectory.calls
    stepped = core.stepped_trajectory(*args[1:7], args.spec, args.micro, args.loads)
    assert core.plain_trajectory.calls == calls
    plain = core.plain_trajectory(*args[1:7], args.spec, args.micro, args.loads)
    assert len(stepped) == len(plain) == (3 if guard is None else 6)
    for s, p in zip(stepped, plain):
        assert torch.equal(s, p)
    if guard is not None:
        assert bool(plain[4].any()) and bool(plain[5].any())  # the guard fired at both depths


def test_adjoint_replays_the_decisions_of_every_depth():
    """The backward replays a fired interval with the forward's decisions
    at depth 0 and at depth 1, never the predicate evaluated again: a
    forward that took the coarse step at one micro-step of depth 1 where
    the predicate refines gets the gradient of the trajectory it ran."""

    args = _small(TWO_LEVELS)
    spec, B, n_int = args.spec, args.U0.shape[0], args.dts.shape[0]
    outs = core.plain_trajectory(*args[1:7], spec, args.micro)
    substeps, deep = outs[4], outs[5].clone()
    refine, n = spec.guard["refine"], spec.n_substeps
    # A micro-step of depth 1 that refined, in a substep its design refined.
    b, j = next((b, j) for b, j in deep.nonzero().tolist()
                if substeps[b, j // (n * refine) * n + j % (n * refine) // refine])
    deep[b, j] = False
    tables = [substeps.view(B, n_int, -1), deep.view(B, n_int, -1)]

    def edited(U0, V0, A0, dts, drive, fixed, spec, micro=(), loads=()):
        """The plain guarded body on the edited decisions."""

        carry, out = (U0, V0, A0), []
        with torch.no_grad():
            for k in range(n_int):
                carry, _ = core.guarded_interval_body(
                    *carry, dts[k], core.interval_rows(k, drive, micro, spec), fixed, spec,
                    decisions=[t[:, k] for t in tables])
                out.append(carry)
        return tuple(torch.stack(x, dim=1) for x in zip(*out)) + (outs[3], substeps, deep)

    rng = np.random.default_rng(1)
    cots = [torch.tensor(rng.standard_normal(outs[0].shape)) for _ in range(3)]

    def gradient(forward=None):
        """d(cots . outputs)/d(U0, V0, fixed leaf 12) through the adjoint, or
        with ``forward`` None through autograd of the plain guarded body
        replaying the edited decisions."""

        x = [args.U0.clone().requires_grad_(), args.V0.clone().requires_grad_(),
             args.fixed[12].clone().requires_grad_()]
        fixed = args.fixed[:12] + (x[2],) + args.fixed[13:]
        if forward is None:
            carry, out = (x[0], x[1], args.A0), []
            for k in range(n_int):
                carry, _ = core.guarded_interval_body(
                    *carry, args.dts[k], core.interval_rows(k, args.drive, args.micro, spec),
                    fixed, spec, create_graph=True, decisions=[t[:, k] for t in tables])
                out.append(carry)
            fields = [torch.stack(f, dim=1) for f in zip(*out)]
        else:
            fields = core.VerletTrajectory.apply(spec._replace(forward=forward), x[0], x[1],
                                                 args.A0, args.dts, args.drive, *args.micro,
                                                 *fixed)[:3]
        loss = sum(torch.sum(f * c) for f, c in zip(fields, cots))
        return torch.cat([g.flatten() for g in torch.autograd.grad(loss, x)])

    replayed, reference = gradient(edited), gradient()
    assert rel(replayed, reference) <= TIGHT
    # The edit changed the trajectory: the unedited run's gradient differs.
    assert rel(gradient(core.plain_trajectory), reference) > 1e-6


def test_stepped_force_equals_force_and_keeps_no_graph():
    args = _small(loads=True)
    row, load_row = args.drive[:, 0], args.loads[0][:, 0]
    plain = core.force(args.U0, row, args.fixed, args.spec, load_row=load_row)
    stepped = core.stepped_force(args.U0, row, args.fixed, args.spec, load_row=load_row)
    assert torch.equal(stepped, plain)
    with pytest.raises(ValueError, match="no autograd graph"):
        core.stepped_force(args.U0, row, args.fixed, args.spec, create_graph=True)


def test_verlet_ckpt_on_cpu_tensors_runs_the_plain_body():
    cfg = paper_config("verlet_ckpt", 2, device="cpu")
    cfg.update(n1_blocks=8, n2_blocks=6, n_timepoints=3,
               damping=np.broadcast_to(cfg["damping"][0], (48, 3)))
    problem = ForwardProblem(**cfg)
    problem.setup()
    design = problem.geometry.get_design_from_rotated_square(0.4)
    calls, launches = core.plain_trajectory.calls, quad_force.launches
    fields = problem.solve(design).fields
    assert core.plain_trajectory.calls == calls + 1
    assert quad_force.launches == launches
    assert fields.shape == (3, 2, 48, 3) and bool(torch.isfinite(fields).all())


def test_solver_spec_takes_another_forward():
    """A solver's spec set in ``solve_dynamics.specs`` runs its forward:
    the CPU's ``verlet_ckpt`` made to step (``core.stepped_trajectory``)
    runs no plain-body forward and gives the plain body's fields."""

    cfg = paper_config("verlet_ckpt", 2, device="cpu")
    cfg.update(n1_blocks=8, n2_blocks=6, n_timepoints=3,
               damping=np.broadcast_to(cfg["damping"][0], (48, 3)))
    problem = ForwardProblem(**cfg)
    problem.setup()
    design = problem.geometry.get_design_from_rotated_square(0.4)
    plain = problem.solve(design).fields
    solve, cpu = problem.solve_dynamics, torch.device("cpu")
    solve.specs[cpu] = solve.spec_for(cpu)._replace(forward=core.stepped_trajectory)
    calls = core.plain_trajectory.calls
    assert torch.equal(problem.solve(design).fields, plain)
    assert core.plain_trajectory.calls == calls


def test_force_wrapper_refuses_other_devices():
    U, fixed = kc.lanes_microbench_inputs(B=1, n1=4, n2=3, device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError, match="unsupported device"):
        quad_force(U.to("meta"), tuple(f.to("meta") for f in fixed), linearized=False,
                   use_contact=True)


def test_force_bound_counts_inputs_output_and_bonds():
    """Kernel 2's bound at the tool's inputs: each input read once, the
    force written once; 728 bonds a design, none engaged."""

    U, fixed = kc.lanes_microbench_inputs(B=128, device="cpu", dtype=torch.float32)
    bound = kc.force_bound(U, fixed)
    per_design = (2 * 3 + 8 + 2) * 16 * 24 + 5 * 16 * 23 + 5 * 15 * 24 + 3
    assert bound["bytes"] == 128 * per_design * 4
    assert kc.engaged_bonds(U, fixed) == 0
    assert bound["ops"] == 128 * (728 * kc.OPS_BOND_QUAD + 3 * 16 * 24 * kc.OPS_GATHER)
    assert bound["bound_by"] == "bytes"
