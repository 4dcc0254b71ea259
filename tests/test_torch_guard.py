"""The port's substep guard against the JAX package, on the CPU at float64.

The spec, the risk predicate, the travel and gap terms, and the guarded
trajectory with its adjoint are held against ``difflexmm_tpu``. The
trajectory scenario is the rotating-squares harness of
``tests/test_guard.py`` (5 x 4 blocks, voids bouncing off a barrier at
40-45 degrees, coarse substeps that tunnel without the guard). JAX's
guarded trajectories and gradients on it, whose trace and compile take
30-50 s each, are recorded in ``tests/data/guard_harness.npz`` by the
slow ``test_guard_harness_references_match_jax``, which makes them again.
"""

import contextlib
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difflexmm_tpu.geometry import QuadGeometry as JaxQuadGeometry
from difflexmm_tpu.models import base as jax_base
from difflexmm_tpu.ops.bonds import ligament_energy
from difflexmm_tpu.ops.grid import build_quad_grid_energy
from difflexmm_tpu.ops.pallas import core as jax_core
from difflexmm_tpu.ops.pallas import verlet_grid as jax_verlet_grid
from difflexmm_tpu.solver import setup_dynamic_solver as jax_setup_dynamic_solver
from difflexmm_tpu.utils import (
    ContactParams as JaxContactParams,
    ControlParams as JaxControlParams,
    GeometricalParams as JaxGeometricalParams,
    LigamentParams as JaxLigamentParams,
    MechanicalParams as JaxMechanicalParams,
)
from jax_references import record_or_check, stored

from difflexmm_tpu_torch import kernel_checks as kc
from difflexmm_tpu_torch.geometry.quad import QuadGeometry
from difflexmm_tpu_torch.models import base
from difflexmm_tpu_torch.ops.kernels import core, launch, verlet_grid
from difflexmm_tpu_torch.solver import setup_dynamic_solver
from difflexmm_tpu_torch.utils.types import (
    ContactParams,
    ControlParams,
    GeometricalParams,
    LigamentParams,
    MechanicalParams,
)

# One intra-op thread: the suite runs in several worker processes at once,
# and the port's many small tensor operations slow down several times over
# when each worker also runs a thread per core.
torch.set_num_threads(1)

N1, N2 = 5, 4
MIN_A, CUT_A = math.radians(40.0), math.radians(45.0)
# test_guard.py's spec: refine 8, two levels (the recursion is exercised).
GUARD = dict(window=CUT_A - MIN_A, length_scale=1.0, refine=8, levels=2)
# The same with the proximity gate: the travel term fires only within two
# barrier windows of the cutoff, so the gap function decides too.
GUARD_PROX = dict(GUARD, proximity_windows=2.0, hard_fraction=20.0)
# Same operations in the same order at float64 (the flagship parity tests' tolerances): the
# trajectory within 1e-10 and the gradient within 1e-9 of their scales.
TRAJ_TOL, GRAD_TOL = 1e-10, 1e-9


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


# ---------------------------------------------------------------------------
# Spec, predicate, travel, gap
# ---------------------------------------------------------------------------

SPECS = [
    dict(window=0.1),
    dict(threshold=1e-3, length_scale=2.0, translation="absolute"),
    dict(window=0.1, proximity_windows=2.0),
    dict(window=0.1, proximity=0.3, hard=0.05, refine=4, levels=2),
    dict(window=0.1, fraction=0.05, hard_fraction=0.5),
]
BAD_SPECS = [
    (dict(window=0.1, translation="sideways"), "translation"),
    (dict(fraction=0.1), "threshold"),
    (dict(window=0.1, typo=1), "unknown guard spec"),
    (dict(window=0.1, refine=1), "refine >= 2"),
    (dict(threshold=1e-3, proximity_windows=2.0), "needs 'window'"),
    (dict(window=0.1, proximity=0.1, proximity_windows=1.0), "not both"),
    (dict(window=0.1, proximity_windows=1.0, hard_fraction=0.01), "hard threshold must exceed"),
    (dict(window=0.1, proximity=-1.0), "proximity must be positive"),
]


@pytest.mark.parametrize("spec", SPECS)
def test_guard_spec_resolves_like_jax(spec):
    assert core.resolve_guard(spec, (2,)) == jax_core.resolve_guard(spec, (2,))
    assert core.resolve_guard(None, (2,)) is None


@pytest.mark.parametrize("spec, match", BAD_SPECS)
def test_guard_spec_errors_like_jax(spec, match):
    with pytest.raises(ValueError, match=match):
        jax_core.resolve_guard(spec, (2,))
    with pytest.raises(ValueError, match=match):
        core.resolve_guard(spec, (2,))


def test_model_guard_resolves_like_jax():
    args = (math.radians(-15), math.radians(-10), 15.0)
    for guard in (None, "auto", dict(fraction=0.05), dict(threshold=1e-3)):
        assert base.resolve_model_guard(guard, *args) == jax_base.resolve_model_guard(guard, *args)
    with pytest.raises(ValueError, match="guard must be"):
        base.resolve_model_guard(1.5, *args)


def test_risk_predicate_truth_table_with_nan():
    g = core.resolve_guard(dict(threshold=1.0, proximity=0.5, hard=10.0), (0,))
    cases = [(0.5, 0.0), (2.0, 1.0), (2.0, 0.4), (20.0, 1e9), (math.nan, 1e9),
             (math.nan, math.nan), (2.0, math.nan), (1.0, 0.0), (10.0, 0.0)]
    gap = {}

    def jax_risky(travel, g_):
        gap["g"] = g_
        pred = jax_core.make_risk_predicate(g, lambda V, A, dt: V, lambda U: jnp.asarray(gap["g"]))
        return bool(pred((None, jnp.asarray(travel), None), 0.1))

    pred = core.make_risk_predicate(g, lambda V, A, dt: V, lambda U: torch.tensor([gap["g"]]))
    for travel, g_ in cases:
        expected = jax_risky(travel, g_)
        assert bool(pred((None, torch.tensor([travel]), None), 0.1)) == expected, (travel, g_)
    assert [jax_risky(t, g_) for t, g_ in cases] == [
        False, False, True, True, True, True, False, False, True]
    with pytest.raises(ValueError, match="gap function"):
        core.make_risk_predicate(g, lambda V, A, dt: V, None)


def _travel_cases():
    """(V, A) plane pairs: bulk drift, a shear along n1, random fields."""

    rng = np.random.default_rng(0)
    drift = np.zeros((3, 4, 5))
    drift[0] = 1.0
    shear = np.zeros((3, 4, 5))
    shear[1] = np.tile([1.0, -1.0, 1.0, -1.0, 1.0], (4, 1))
    zero = np.zeros((3, 4, 5))
    return [(drift, zero), (shear, zero),
            (rng.standard_normal((3, 4, 5)), rng.standard_normal((3, 4, 5)))]


@pytest.mark.parametrize("translation", ["relative", "absolute"])
def test_travel_under_bulk_motion_matches_jax(translation):
    g = core.resolve_guard(dict(threshold=1e-3, length_scale=1.0, translation=translation), (2,))
    dt = 0.1
    cases = _travel_cases()
    for V, A in cases:
        expected = float(jax_core.guard_travel(jnp.asarray(V), jnp.asarray(A), dt, g))
        got = core.guard_travel(torch.tensor(V)[None], torch.tensor(A)[None], dt, g)
        assert got.shape == (1,)
        assert abs(float(got[0]) - expected) <= 1e-15 * max(1.0, abs(expected))
    drift, shear = cases[0][0], cases[1][0]
    zero = torch.zeros(1, 3, 4, 5, dtype=torch.float64)
    travel = [float(core.guard_travel(torch.tensor(v)[None], zero, dt, g)[0])
              for v in (drift, shear)]
    # Bulk motion closes no void; a shear counts twice its speed relatively.
    assert travel == ([0.0, pytest.approx(2 * dt)] if translation == "relative"
                      else [pytest.approx(dt), pytest.approx(dt)])
    # NaN anywhere in a counted channel propagates.
    nan = cases[2][0].copy()
    nan[0, 1, 2] = math.nan
    assert math.isnan(float(core.guard_travel(torch.tensor(nan)[None], zero, dt, g)[0]))


def test_travel_sees_within_cell_motion_like_jax():
    # Six channels (two blocks per cell): cell-mates moving against each
    # other fire the relative term although every plane is uniform.
    V = np.zeros((6, 4, 5))
    V[0], V[3] = 1.0, -1.0
    A = np.zeros_like(V)
    g = core.resolve_guard(dict(threshold=1e-3, length_scale=1.0), (2, 5))
    expected = float(jax_core.guard_travel(jnp.asarray(V), jnp.asarray(A), 0.1, g))
    got = float(core.guard_travel(torch.tensor(V)[None], torch.tensor(A)[None], 0.1, g)[0])
    assert got == pytest.approx(0.2) and got == pytest.approx(expected, rel=1e-15)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gap_matches_jax_at_random_states(seed):
    rng = np.random.default_rng(seed)
    problem = kc.small_problem(device="cpu")
    args = kc.batched_args(problem, [kc.random_design(problem, rng) for _ in range(2)])
    U = rng.normal(0, [[[0.3]], [[0.3]], [[0.1]]], size=(2, 3, 6, 8))
    got = verlet_grid.quad_min_void_gap_planes(torch.tensor(U), *args.fixed[:2], args.fixed[11])
    for b in range(2):
        leaves = [jnp.asarray(x[b].numpy()) for x in args.fixed]
        expected = float(jax_verlet_grid.quad_min_void_gap_planes(
            jnp.asarray(U[b]), leaves[0], leaves[1], leaves[11]))
        assert abs(float(got[b]) - expected) <= 1e-12 * abs(expected)
    # The barrier's gap is +inf where k_contact <= 0 or contact is off.
    fixed = list(args.fixed)
    fixed[12] = torch.zeros_like(fixed[12])
    assert torch.isinf(verlet_grid._gap_of(torch.tensor(U), fixed, True)).all()
    assert torch.isinf(verlet_grid._gap_of(torch.tensor(U), args.fixed, False)).all()
    # NaN propagates through the minimum.
    U[1, 2, 3, 3] = math.nan
    got = verlet_grid.quad_min_void_gap_planes(torch.tensor(U), *args.fixed[:2], args.fixed[11])
    assert not math.isnan(float(got[0])) and math.isnan(float(got[1]))


class _Library:
    """A stand-in for a trajectory kernel's library: it records what
    ``launch.run`` passes to ``verlet_quad_launch`` and launches nothing."""

    def __init__(self):
        self.calls = []

    def verlet_quad_max_smem(self):
        return 1 << 20

    def verlet_quad_scratch_bytes(self, n1, n2, itemsize):
        return 1024

    def verlet_quad_launch(self, ptrs, dims, itemsize, linearized, use_contact, guard, stream):
        self.calls.append((list(ptrs), list(dims), list(guard)))
        return 0


@pytest.mark.parametrize("levels", [2, 3])
def test_kernel_takes_guards_of_any_depth(levels, monkeypatch):
    """``launch.guard_params`` packs a guard of any depth (ten doubles,
    ``levels`` last; past :data:`launch.MAX_LEVELS` it raises), and
    ``launch.run`` takes ``1 + n_micro`` drive tables and as many load
    tables, passes every table of every depth to the kernel after the
    pointers of depth 1 and returns ``spec.n_deep`` zero-filled deep
    decision tables, one a depth below ``levels``, of the micro-step
    tables' rows."""

    guard = core.resolve_guard(dict(GUARD, levels=levels), (2,))
    packed = launch.guard_params(guard, (2,), "verlet_quad")
    assert len(packed) == 10 and packed[7] == 8 and packed[9] == levels
    with pytest.raises(ValueError, match="levels"):
        launch.guard_params(dict(guard, levels=launch.MAX_LEVELS + 1), (2,), "verlet_quad")
    problem = kc.small_problem(n_timepoints=3, n_substeps=2, device="cpu",
                               guard=dict(window=0.1, levels=levels, refine=3))
    args = kc.batched_args(problem, [problem.geometry.get_design_from_rotated_square(0.4)] * 2)
    args = kc.with_loads(args, kc.QUAD_LOAD_PAIRS)
    assert args.spec.n_micro == levels and args.spec.n_deep == levels - 1
    assert len(args.loads) == 1 + levels
    # Off the card: the wrapper's checks and packing run, the launch does not.
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    lib = _Library()
    fixed_shapes = verlet_grid.fixed_shapes(2, 8, 6)
    keywords = dict(linearized=False, use_contact=True, fixed_shapes=fixed_shapes,
                    drive_map=args.spec.forward.keywords["drive_map"], theta_channels=(2,))
    with pytest.raises(ValueError, match="malformed"):
        launch.run(lib, "verlet_quad", verlet_grid.verlet_quad_trajectory, *args[1:7], args.spec,
                   args.micro[:-1], args.loads, **keywords)
    outs = launch.run(lib, "verlet_quad", verlet_grid.verlet_quad_trajectory, *args[1:7],
                      args.spec, args.micro, args.loads, **keywords)
    ptrs, dims, packed = lib.calls[-1]
    n = len(args.fixed)
    assert dims == [2, 8, 6, 2, 2, args.drive.shape[-1], args.spec.load_map.slots.shape[0]]
    assert packed[9] == levels and len(outs) == 5 + args.spec.n_deep
    # Depth 1's pointers at fixed places, then the micro-step tables of
    # depths 2 ... levels, the load tables of the same depths, the deep
    # decision tables.
    assert ptrs[n + 10] == args.micro[0].data_ptr()
    assert ptrs[n + 11:n + 13] == [outs[4].data_ptr(), outs[3].data_ptr()]
    deep = ptrs[n + 16:]
    assert len(deep) == 3 * (levels - 1)
    assert deep[:levels - 1] == [t.data_ptr() for t in args.micro[1:]]
    assert deep[2 * (levels - 1):] == [t.data_ptr() for t in outs[5:]]
    for d, table in enumerate(outs[5:], start=1):
        assert table.dtype == torch.bool and tuple(table.shape) == (2, 2 * 2 * 3 ** d)
        assert not table.any()


# ---------------------------------------------------------------------------
# The guarded trajectory: test_guard.py's harness in both packages
# ---------------------------------------------------------------------------


def _parity():
    I, J = np.meshgrid(np.arange(N1), np.arange(N2))
    return ((I + J) % 2 * 2 - 1).reshape(-1)


def _state0(scale=1.0):
    state0 = np.zeros((2, N1 * N2, 3))
    state0[1, :, 2] = 0.5 * scale * _parity()
    return state0


TIMEPOINTS = np.linspace(0.0, 1.6, 9)


def _jax_solve(guard, n_substeps, monkeypatch):
    """JAX ``verlet_ckpt`` on the harness: (objective, grad wrt (state0,
    k_contact), fields, per-interval flags). The flags come from the
    package's own guarded interval body (``emit_risk=True``), run on the
    arrays its solver hands the trajectory. The gradient is one compiled
    program; the arrays are caught in an eager call that stops at the
    trajectory (its outputs there are zeros, and unused)."""

    geo = JaxQuadGeometry(N1, N2, 1.0, 0.1)
    bc, cnv, bonds, rbv = geo.get_parametrization()
    design = geo.get_design_from_rotated_square(0.35)
    captured = {}
    real = jax_verlet_grid.build_pallas_verlet_trajectory

    def spy(*a, **kw):
        trajectory = real(*a, **kw)
        captured["drive_fn"] = a[4]

        def wrapped(carry, timepoints, arrays):
            captured["call"] = (carry, timepoints, arrays)
            if captured.get("stop"):
                return tuple(jnp.zeros((len(timepoints) - 1,) + c.shape, c.dtype)
                             for c in carry)
            return trajectory(carry, timepoints, arrays)

        wrapped.force_fn = trajectory.force_fn
        return wrapped

    monkeypatch.setattr(jax_verlet_grid, "build_pallas_verlet_trajectory", spy)
    solve = jax_setup_dynamic_solver(
        geometry=geo, energy_fn=build_quad_grid_energy(N1, N2, ligament_energy),
        damped_blocks=np.arange(geo.n_blocks), method="verlet_ckpt", n_substeps=n_substeps,
        quad_grid=dict(n1=N1, n2=N2, linearized=False), guard=guard,
    )

    def cp(k_contact):
        return JaxControlParams(
            geometrical_params=JaxGeometricalParams(bc(*design), cnv(*design)),
            mechanical_params=JaxMechanicalParams(
                bond_params=JaxLigamentParams(1.0, 0.02, 1e-3, rbv()), density=1.0,
                damping=0.0, contact_params=JaxContactParams(MIN_A, CUT_A, k_contact)),
            constraint_params={},
        )

    def objective(state0, k_contact):
        sol = solve(state0, jnp.asarray(TIMEPOINTS), cp(k_contact))
        return jnp.sum(sol[-1, 1, :, 2] ** 2), sol

    state0 = jnp.asarray(_state0())
    (value, fields), grads = jax.jit(jax.value_and_grad(objective, argnums=(0, 1),
                                                        has_aux=True))(state0, 1.0)
    captured["stop"] = True
    objective(state0, 1.0)  # eager: the spy captures concrete arrays
    carry, ts, arrays = captured["call"]
    force = jax_core.make_force_fn(jax_verlet_grid.N_FIXED_ARRAYS,
                                   jax_verlet_grid._quad_energy_of(False, True),
                                   captured["drive_fn"])
    body = jax.jit(jax_core.make_interval_body(
        jax_verlet_grid.N_FIXED_ARRAYS, n_substeps, force,
        guard=jax_core.resolve_guard(guard, (2,)),
        gap_of=jax_verlet_grid._quad_gap_of(True), emit_risk=True))
    flags = []
    for k in range(len(TIMEPOINTS) - 1):
        carry, risky = body(*carry, ts[k], (ts[k + 1] - ts[k]) / n_substeps, arrays)
        flags.append(bool(risky))
    return dict(value=float(value), fields=np.asarray(fields), flags=flags,
                grads=[np.asarray(g) for g in grads])


def _port_solver(guard, n_substeps):
    geo = QuadGeometry(N1, N2, 1.0, 0.1)
    bc, cnv, _, rbv = geo.get_parametrization()
    design = geo.get_design_from_rotated_square(0.35)
    solve = setup_dynamic_solver(
        geometry=geo, damped_blocks=np.arange(geo.n_blocks), method="verlet_ckpt",
        n_substeps=n_substeps, quad_grid=dict(n1=N1, n2=N2, linearized=False), guard=guard,
    )

    def cp(k_contact):
        return ControlParams(
            geometrical_params=GeometricalParams(bc(*design), cnv(*design)),
            mechanical_params=MechanicalParams(
                bond_params=LigamentParams(1.0, 0.02, 1e-3, rbv()), density=1.0,
                damping=0.0, contact_params=ContactParams(MIN_A, CUT_A, k_contact)),
            constraint_params={},
        )

    return solve, cp


def _port_solve(guard, n_substeps, scale=1.0):
    """The port's objective, grads wrt (state0, k_contact), fields and, when
    guarded, the forward's flags."""

    solve, cp = _port_solver(guard, n_substeps)
    state0 = torch.tensor(_state0(scale), requires_grad=True)
    k_contact = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    fields = solve(state0, torch.tensor(TIMEPOINTS), cp(k_contact))
    value = torch.sum(fields[-1, 1, :, 2] ** 2)
    grads = torch.autograd.grad(value, (state0, k_contact))
    flags = None
    if guard is not None:
        with torch.no_grad():
            args = solve.trajectory_args(state0, torch.tensor(TIMEPOINTS), cp(k_contact))
            flags = core.trajectory_forward(args)[3][0].tolist()
    return dict(value=value.detach(), fields=fields.detach(), flags=flags, grads=grads)


HARNESS_GUARDS = {"travel": GUARD, "proximity": GUARD_PROX}


def _recorded(name):
    """JAX's results for one guard of the harness (see ``_jax_solve``),
    from ``tests/data/guard_harness.npz``."""

    data = stored("guard_harness")
    return dict(value=float(data[f"{name}_value"]), fields=data[f"{name}_fields"],
                flags=data[f"{name}_flags"].tolist(),
                grads=[data[f"{name}_grad{i}"] for i in range(2)])


@pytest.mark.slow
def test_guard_harness_references_match_jax(monkeypatch):
    """Make ``tests/data/guard_harness.npz`` again with the JAX package."""

    out = {}
    for name, guard in HARNESS_GUARDS.items():
        ref = _jax_solve(guard, 2, monkeypatch)
        monkeypatch.undo()
        out.update({f"{name}_value": ref["value"], f"{name}_fields": ref["fields"],
                    f"{name}_flags": np.asarray(ref["flags"])})
        out.update({f"{name}_grad{i}": g for i, g in enumerate(ref["grads"])})
    record_or_check("guard_harness", out)


@pytest.mark.parametrize("name", sorted(HARNESS_GUARDS, reverse=True),
                         ids=lambda name: name)
def test_guarded_trajectory_and_gradient_match_jax(name):
    guard = HARNESS_GUARDS[name]
    ref = _recorded(name)
    got = _port_solve(guard, 2)
    assert ref["flags"] == got["flags"]
    assert any(ref["flags"])
    if guard is GUARD_PROX:  # the gate leaves intervals unrefined: both replays run
        assert not all(ref["flags"])
    assert rel(got["fields"], ref["fields"]) <= TRAJ_TOL
    assert abs(float(got["value"]) - ref["value"]) <= TRAJ_TOL * abs(ref["value"])
    for g, r in zip(got["grads"], ref["grads"]):
        assert np.all(np.isfinite(g.numpy())) and rel(g, r) <= GRAD_TOL


def test_guard_is_bit_exact_noop_on_tame_trajectory():
    plain = _port_solve(None, 4, scale=0.02)
    guarded = _port_solve(GUARD, 4, scale=0.02)
    assert not any(guarded["flags"])
    assert torch.equal(plain["fields"], guarded["fields"])
    for a, b in zip(plain["grads"], guarded["grads"]):
        assert torch.equal(a, b)


def test_guarded_adjoint_matches_autograd_through_the_guarded_loop():
    # The adjoint's per-interval dispatch (unguarded replay where nothing
    # fired, recorded decisions elsewhere) against autograd straight
    # through the plain guarded body, on a batch of two designs that
    # decide differently (both branches run and each design takes its own).
    solve, cp = _port_solver(GUARD_PROX, 2)
    state0 = np.stack([_state0(), _state0(0.02)])
    args = [solve.trajectory_args(torch.tensor(s), torch.tensor(TIMEPOINTS), cp(1.0))
            for s in state0]
    cat = lambda xs: torch.cat(xs).contiguous()  # noqa: E731
    a = core.TrajectoryArgs(
        args[0].spec, *(cat([getattr(x, f) for x in args]) for f in ("U0", "V0", "A0")),
        args[0].dts, cat([x.drive for x in args]),
        tuple(cat(list(f)) for f in zip(*(x.fixed for x in args))),
        tuple(cat(list(m)) for m in zip(*(x.micro for x in args))),
    )
    rng = np.random.default_rng(0)
    cots = [torch.tensor(rng.standard_normal(a.U0.shape[:1] + (8,) + a.U0.shape[1:]))
            for _ in range(3)]
    leaves = [a.U0, a.V0, a.A0, a.fixed[12]]

    def inputs():
        return [x.detach().clone().requires_grad_() for x in leaves]

    def fixed_of(x):
        return a.fixed[:12] + (x[3],) + a.fixed[13:]

    x = inputs()
    outs = core.VerletTrajectory.apply(a.spec, x[0], x[1], x[2], a.dts, a.drive, *a.micro,
                                       *fixed_of(x))
    flags = outs[3]
    assert flags[0].any() and not flags[1].any() and not flags[0].all()
    loss = sum(torch.sum(o * c) for o, c in zip(outs[:3], cots))
    grads_adjoint = torch.autograd.grad(loss, x)

    y = inputs()
    carry, boundary = (y[0], y[1], y[2]), []
    for k in range(a.dts.shape[0]):
        rows = core.interval_rows(k, a.drive, a.micro, a.spec)
        carry, _ = core.guarded_interval_body(*carry, a.dts[k], rows, fixed_of(y), a.spec,
                                              create_graph=True)
        boundary.append(carry)
    plain = [torch.stack(s, dim=1) for s in zip(*boundary)]
    for o, p in zip(outs[:3], plain):
        assert torch.equal(o, p.detach())
    loss = sum(torch.sum(o * c) for o, c in zip(plain, cots))
    grads_plain = torch.autograd.grad(loss, y)
    for g, p in zip(grads_adjoint, grads_plain):
        assert rel(g, p) <= 1e-12


def test_guard_trace_matches_the_plain_body_and_counts_its_terms():
    # The smoke test's instrumented run of the plain guarded body: the same
    # outputs as the plain body, and a summary of which guard term fired.
    args, _ = kc.contact_probe(device="cpu", guard="auto")
    outs, summary = kc.guard_terms(args)
    for a, b in zip(outs, core.trajectory_forward(args)):
        assert torch.equal(a, b)
    assert summary["fired"] == int(outs[4].sum()) > 0
    assert summary["fired_hard"] > 0 and summary["fired_proximity"] > 0
    assert summary["fired_hard"] + summary["fired_proximity"] == summary["fired"]
    assert summary["gaps"] >= summary["fired_proximity"]
    bound = kc.trajectory_bound(args, outs[0], summary)
    plain_bound = kc.trajectory_bound(args, outs[0])
    assert bound["ops"] > plain_bound["ops"] > 0 and bound["bytes"] > plain_bound["bytes"]
    assert bound["bound_by"] == "operations"
