"""The port's kagome family against the JAX package, on the CPU at float64.

Geometry, the kagome plane energy, force and barrier gap, the guard's
travel on kagome planes, the trajectory and its design gradient (the
4 x 3-cell harness of ``tests/test_pallas_kagome.py``), the guarded
trajectory, the kagome-focusing model with its guarded MMA, and the
converter. Inputs are made with numpy from a seed and handed to both
packages; on the CPU the kernel wrapper runs the plain body.

The JAX results whose trace and compile take tens of seconds (the
harness's gradients, unguarded and guarded, and the guarded MMA) are
recorded in ``tests/data/kagome_small.npz`` by the slow
``test_kagome_small_references_match_jax``, which makes them again with
the JAX package; the other tests run JAX as they go.
"""

import json
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difflexmm_tpu.geometry import KagomeGeometry as JaxKagomeGeometry
from difflexmm_tpu.models import base as jax_base
from difflexmm_tpu.models import kagome_focusing as jax_kagome
from difflexmm_tpu.ops.bonds import ligament_energy
from difflexmm_tpu.ops.kagome_grid import build_kagome_grid_energy
from difflexmm_tpu.ops.pallas import core as jax_core
from difflexmm_tpu.ops.pallas import verlet_kagome as jax_verlet_kagome
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
from difflexmm_tpu_torch.geometry.kagome import KagomeGeometry
from difflexmm_tpu_torch.models import base, kagome_config
from difflexmm_tpu_torch.models import kagome_focusing as port_kagome
from difflexmm_tpu_torch.models.flagship import design_stats, flat_numpy, vector_stats
from difflexmm_tpu_torch.ops.kernels import core, verlet_kagome
from difflexmm_tpu_torch.solver import setup_dynamic_solver
from difflexmm_tpu_torch.utils.convert import (
    design_from_numpy,
    forward_problem_from_jax_dict,
    optimization_problem_from_jax_dict,
)
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

# Same operations in the same order at float64: only the last bits of
# library functions (sin, cos, atan2, sqrt) and of summation order differ.
TIGHT = 1e-12
# Force with the contact barrier engaged: stretched ligaments and the
# barrier act at once (the quad tests' tolerance, tests/test_torch_kernels.py).
CONTACT_FORCE = 1e-11
# Trajectories and design gradients, as for the quads
# (tests/test_torch_flagship_parity.py): 1e-10 and 1e-9 of their scales.
TRAJ_TOL, GRAD_TOL = 1e-10, 1e-9
# Guarded MMA iterates: a guarded trajectory and its adjoint per
# iteration, as tests/test_torch_mma.py's HISTORY_TOL.
HISTORY_TOL = 1e-8
N1, N2 = 4, 3
CONFIG_JSON = pathlib.Path(__file__).resolve().parents[1] / "examples/configs/kagome_focusing.json"


def rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _numpy(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n1, n2, angle, seed", [(4, 3, math.pi / 3, 0), (5, 4, 1.2, 1),
                                                 (3, 5, math.pi / 3, 2)])
def test_kagome_geometry_matches_jax(n1, n2, angle, seed):
    basis = 1.3 * np.array([[1.0, 0.0], [math.cos(angle), math.sin(angle)]])
    jgeo = JaxKagomeGeometry(n1, n2, direct_basis=jnp.asarray(basis), bond_length=0.05)
    tgeo = KagomeGeometry(n1, n2, direct_basis=basis, bond_length=0.05)
    jbc, jcnv, jbonds, jref = jgeo.get_parametrization()
    tbc, tcnv, tbonds, tref = tgeo.get_parametrization()
    np.testing.assert_array_equal(tbonds(), np.asarray(jbonds()))
    assert rel(tref(), jref()) <= TIGHT
    rng = np.random.default_rng(seed)
    zero = tgeo.zero_design()
    assert [tuple(x.shape) for x in zero] == [x.shape for x in jgeo.zero_design()]
    design = [0.05 * rng.standard_normal(tuple(x.shape)) for x in zero]
    jd = tuple(jnp.asarray(x) for x in design)
    td = tuple(torch.tensor(x, requires_grad=True) for x in design)
    assert rel(_numpy(tbc(*td)), jbc(*jd)) <= TIGHT
    assert rel(_numpy(tcnv(*td)), jcnv(*jd)) <= TIGHT
    # The design gradient of a scalar of both maps.
    weights = rng.standard_normal((2, tgeo.n_blocks, 3, 2))

    def jax_scalar(*d):
        return jnp.sum(weights[0, :, 0] * jbc(*d)) + jnp.sum(weights[1] * jcnv(*d))

    jg = jax.grad(jax_scalar, argnums=(0, 1, 2))(*jd)
    tv = torch.sum(torch.tensor(weights[0, :, 0]) * tbc(*td)) + torch.sum(
        torch.tensor(weights[1]) * tcnv(*td))
    for g, r in zip(torch.autograd.grad(tv, td), jg):
        assert rel(g, r) <= TIGHT


# ---------------------------------------------------------------------------
# Plane energy, force, gap and the guard's travel
# ---------------------------------------------------------------------------


def _plane_inputs(contact: bool, seed: int = 0):
    """Fixed leaves (unbatched numpy) and an effective state U of the
    4 x 3-cell lattice: a random state on a random design, or the contact
    probe's engaged state with a small random perturbation."""

    rng = np.random.default_rng(seed)
    if contact:
        args, _ = kc.kagome_contact_probe(device="cpu")
        U = args.U0 * args.fixed[-1] + core.drive_planes(args.drive[:, 0], args.spec, args.U0)
        scale = np.array([0.002, 0.002, 0.001] * 2)[:, None, None]
        U = U[0].numpy() + rng.normal(0, scale, size=(6, N2, N1))
    else:
        problem = kc.small_kagome(device="cpu")
        args = kc.batched_args(problem, [kc.random_kagome_design(problem, rng)])
        U = rng.normal(0, np.array([0.05, 0.05, 0.1] * 2)[:, None, None], size=(6, N2, N1))
    fixed = [x[0].numpy() for x in args.fixed[:14]]
    fixed += [float(x.reshape(())) for x in args.fixed[14:17]]
    return U, fixed


@pytest.mark.parametrize("contact", [False, True], ids=["strain", "contact_engaged"])
@pytest.mark.parametrize("linearized", [False, True])
def test_kagome_plane_energy_and_force_match_jax(contact, linearized):
    U, fixed = _plane_inputs(contact)
    jfixed = [jnp.asarray(x) for x in fixed]

    def jax_energy(u, use_contact=True):
        return jax_verlet_kagome.kagome_grid_energy_planes(
            u, *jfixed, linearized=linearized, use_contact=use_contact)

    jv, jg = jax.value_and_grad(jax_energy)(jnp.asarray(U))
    tU = torch.tensor(U, requires_grad=True)
    tfixed = [torch.as_tensor(x, dtype=torch.float64) for x in fixed]
    tv = verlet_kagome.kagome_grid_energy_planes(tU, *tfixed, linearized=linearized)
    (tg,) = torch.autograd.grad(tv, tU)
    if contact:  # the barrier is engaged
        assert float(jv - jax_energy(jnp.asarray(U), use_contact=False)) > 0
    assert abs(float(tv.detach()) - float(jv)) <= TIGHT * abs(float(jv))
    assert rel(tg, jg) <= (CONTACT_FORCE if contact else TIGHT)


@pytest.mark.parametrize("contact", [False, True], ids=["open", "contact_engaged"])
def test_kagome_gap_matches_jax(contact):
    U, fixed = _plane_inputs(contact, seed=1)
    cnv, centroids, ccut = fixed[0], fixed[1], fixed[15]
    ref = jax_verlet_kagome.kagome_min_void_gap_planes(
        jnp.asarray(U), jnp.asarray(cnv), jnp.asarray(centroids), jnp.asarray(ccut))
    got = verlet_kagome.kagome_min_void_gap_planes(
        torch.tensor(U)[None], torch.tensor(cnv)[None], torch.tensor(centroids)[None],
        torch.tensor(ccut, dtype=torch.float64).reshape(1, 1, 1))
    assert got.shape == (1,)
    assert abs(float(got[0]) - float(ref)) <= TIGHT * max(abs(float(ref)), 1.0)
    if contact:
        assert float(ref) < 0  # a void inside the barrier window


@pytest.mark.parametrize("translation", ["relative", "absolute"])
def test_kagome_guard_travel_matches_jax(translation):
    guard = core.resolve_guard(dict(window=0.1, length_scale=1.5, translation=translation), (2, 5))
    assert guard == jax_core.resolve_guard(dict(window=0.1, length_scale=1.5,
                                                translation=translation), (2, 5))
    rng = np.random.default_rng(4)
    V, A = rng.standard_normal((2, 3, 6, N2, N1))
    dt = 0.03
    got = core.guard_travel(torch.tensor(V), torch.tensor(A), dt, guard)
    for b in range(3):
        ref = jax_core.guard_travel(jnp.asarray(V[b]), jnp.asarray(A[b]), dt, guard)
        assert abs(float(got[b]) - float(ref)) <= TIGHT * float(ref)
    # Only the within-cell pairs (0, 3) and (1, 4) see a down triangle
    # moving against its up cell-mate when every triangle of a kind moves
    # alike: no neighbour difference does.
    V, A = np.zeros((1, 6, N2, N1)), np.zeros((1, 6, N2, N1))
    V[:, 0] = 0.7
    got = float(core.guard_travel(torch.tensor(V), torch.tensor(A), dt, guard)[0])
    ref = float(jax_core.guard_travel(jnp.asarray(V[0]), jnp.asarray(A[0]), dt, guard))
    assert got == pytest.approx(0.7 * dt / 1.5, rel=TIGHT) and got == pytest.approx(ref, rel=TIGHT)


# ---------------------------------------------------------------------------
# The trajectory: tests/test_pallas_kagome.py's harness in both packages
# ---------------------------------------------------------------------------

TIMEPOINTS = np.linspace(0.0, 1.0, 7)


def _harness_params():
    """The harness's per-bond stiffnesses (numpy, from its PRNG keys)."""

    n_bonds = N1 * N2 + N1 * (N2 - 1) + (N1 - 1) * N2
    ks = 1.0 + 0.3 * np.asarray(jax.random.uniform(jax.random.PRNGKey(3), (n_bonds,)))
    ksh = 0.02 * (1 + 0.5 * np.asarray(jax.random.uniform(jax.random.PRNGKey(4), (n_bonds,))))
    kr = 1e-3 * (1 + np.asarray(jax.random.uniform(jax.random.PRNGKey(5), (n_bonds,))))
    return ks, ksh, kr


def _harness(pkg, method, n_substeps=8, guard=None):
    """The harness of tests/test_pallas_kagome.py (:26-77) in one package
    ("jax" or "torch"), with its per-bond stiffnesses: ``(solve,
    objective(design) -> (sum of V^2, fields), zero design,
    control_params(design), state0)``."""

    jax_pkg = pkg == "jax"
    stiffness = _harness_params()
    geo = (JaxKagomeGeometry if jax_pkg else KagomeGeometry)(N1, N2, bond_length=0.05)
    bc, cnv, _, rbv = geo.get_parametrization()
    rows = np.array([N2 // 2 - 1, N2 // 2])
    driven_pairs = jax_base.all_dofs_pairs(rows * 2 * N1)
    k = len(rows)
    drive_np = np.concatenate([np.ones(k), np.zeros(2 * k)])
    if jax_pkg:
        def drive(t, amplitude, rate):
            return jax_base.pulse(t, amplitude, rate) * jnp.asarray(drive_np)

        solve = jax_setup_dynamic_solver(
            geometry=geo, energy_fn=build_kagome_grid_energy(N1, N2, ligament_energy),
            constrained_block_DOF_pairs=driven_pairs, constrained_DOFs_fn=drive,
            damped_blocks=np.arange(geo.n_blocks), method=method, n_substeps=n_substeps,
            kagome_grid=dict(n1=N1, n2=N2, linearized=False), guard=guard,
            **(dict(pallas_interpret=True) if method == "verlet_pallas" else {}))
        types = (JaxControlParams, JaxGeometricalParams, JaxMechanicalParams,
                 JaxLigamentParams, JaxContactParams)
        arr = jnp.asarray
    else:
        def drive(t, amplitude, rate):
            return base.pulse(t, amplitude, rate)[..., None] * torch.tensor(drive_np)

        solve = setup_dynamic_solver(
            geometry=geo, constrained_block_DOF_pairs=driven_pairs, constrained_DOFs_fn=drive,
            damped_blocks=np.arange(geo.n_blocks), method=method, n_substeps=n_substeps,
            kagome_grid=dict(n1=N1, n2=N2, linearized=False), guard=guard)
        types = (ControlParams, GeometricalParams, MechanicalParams, LigamentParams,
                 ContactParams)
        arr = torch.tensor
    CP, GP, MP, LP, CoP = types
    ref, zero = rbv(), geo.zero_design()

    def control_params(design):
        return CP(
            geometrical_params=GP(bc(*design), cnv(*design)),
            mechanical_params=MP(
                bond_params=LP(*(arr(x) for x in stiffness), ref),
                density=1.0, damping=0.05,
                contact_params=CoP(0.0, math.radians(30.0), 1.0)),
            constraint_params=dict(amplitude=0.02, rate=4.0),
        )

    state0 = arr(np.zeros((2, geo.n_blocks, 3)))

    def objective(design):
        fields = solve(state0, arr(TIMEPOINTS), control_params(design))
        return (fields[:, 1] ** 2).sum(), fields

    return solve, objective, zero, control_params, state0


def _design(seed=7):
    rng = np.random.default_rng(seed)
    return [0.02 * rng.standard_normal(s) for s in ((N1 + 1, N2, 2), (N1, N2 + 1, 2), (N1, N2, 2))]


@pytest.fixture(scope="module")
def ref():
    """The recorded JAX results (``jax_small_references``)."""

    return stored("kagome_small")


def test_kagome_trajectory_matches_jax(ref):
    _, objective, *_ = _harness("torch", "auto")
    calls = core.plain_trajectory.calls
    with torch.no_grad():
        value, fields = objective(tuple(torch.tensor(x) for x in _design()))
    assert core.plain_trajectory.calls == calls + 1  # CPU tensors: the plain body
    ref_fields, ref_value = ref["harness_fields"], float(ref["harness_value"])
    assert fields.shape == ref_fields.shape
    assert np.abs(ref_fields[:, 1]).max() > 1e-3  # the pulse went in
    assert rel(fields, ref_fields) <= TRAJ_TOL
    assert abs(float(value) - ref_value) <= TRAJ_TOL * ref_value


def test_kagome_design_gradient_matches_jax(ref):
    _, objective, *_ = _harness("torch", "verlet_ckpt")
    design = tuple(torch.tensor(x, requires_grad=True) for x in _design())
    value, _ = objective(design)
    grads = torch.autograd.grad(value, design)
    for i, g in enumerate(grads):
        assert np.all(np.isfinite(g.numpy())) and rel(g, ref[f"harness_grad{i}"]) <= GRAD_TOL


# The shortened window of the interpret-mode comparison: 2 intervals of 2
# substeps.
INTERPRET_TIMEPOINTS = 3


def test_kagome_plain_body_matches_jax_pallas_interpret(model_ref):
    # The JAX package's kagome kernel itself, in interpret mode, on a
    # shortened window (its result recorded, ``jax_model_references``).
    tsolve, _, _, tcp, tstate0 = _harness("torch", "auto", n_substeps=2)
    with torch.no_grad():
        got = tsolve(tstate0, torch.tensor(TIMEPOINTS[:INTERPRET_TIMEPOINTS]),
                     tcp(tuple(torch.tensor(x) for x in _design())))
    ref = model_ref["interpret_fields"]
    # The Pallas kernel takes the polynomial atan2 (about 2e-8 from the
    # true one, tests/test_pallas_kagome.py): its tolerance, not ours.
    assert np.abs(ref).max() > 1e-4
    assert np.allclose(got.numpy(), ref, atol=1e-6)


# A travel-only guard with a low threshold: it fires on some substeps of
# the harness and not on others (the harness has no void near its barrier).
GUARD = dict(threshold=1.5e-3, length_scale=1.0, refine=4)


def jax_interval_flags(solve, n_substeps, guard, monkeypatch):
    """Per-interval guard flags of JAX's own guarded interval body
    (``emit_risk=True``) on the arrays that the JAX solver built inside
    ``solve()`` hands its kagome trajectory. The trajectory itself is not
    run there: ``solve()`` only prepares its inputs."""

    captured = {}
    real = jax_verlet_kagome.build_pallas_kagome_trajectory

    def spy(*a, **kw):
        trajectory = real(*a, **kw)
        captured["drive_fn"] = a[4]

        def wrapped(carry, timepoints, arrays):
            captured["call"] = (carry, timepoints, arrays)
            return tuple(jnp.zeros((len(timepoints) - 1,) + c.shape, c.dtype) for c in carry)

        wrapped.force_fn = trajectory.force_fn
        return wrapped

    monkeypatch.setattr(jax_verlet_kagome, "build_pallas_kagome_trajectory", spy)
    solve()
    monkeypatch.undo()
    carry, ts, arrays = captured["call"]
    force = jax_core.make_force_fn(jax_verlet_kagome.N_FIXED_ARRAYS,
                                   jax_verlet_kagome._kagome_energy_of(False, True),
                                   captured["drive_fn"])
    body = jax.jit(jax_core.make_interval_body(
        jax_verlet_kagome.N_FIXED_ARRAYS, n_substeps, force,
        guard=jax_core.resolve_guard(guard, (2, 5)),
        gap_of=jax_verlet_kagome._kagome_gap_of(True), emit_risk=True))
    flags = []
    for k in range(len(ts) - 1):
        carry, risky = body(*carry, ts[k], (ts[k + 1] - ts[k]) / n_substeps, arrays)
        flags.append(bool(risky))
    return flags


def test_kagome_guarded_trajectory_and_gradient_match_jax(ref):
    flags = ref["guarded_flags"].tolist()
    assert any(flags) and not all(flags)  # both replays of the adjoint run
    solve, objective, _, cp, state0 = _harness("torch", "verlet_ckpt", n_substeps=2, guard=GUARD)
    design = tuple(torch.tensor(x, requires_grad=True) for x in _design())
    value, fields = objective(design)
    grads = torch.autograd.grad(value, design)
    with torch.no_grad():
        args = solve.trajectory_args(state0, torch.tensor(TIMEPOINTS), cp(design))
        assert args.spec.guard["theta_channels"] == (2, 5)
        got_flags = core.trajectory_forward(args)[3][0].tolist()
    assert got_flags == flags
    assert rel(fields.detach(), ref["guarded_fields"]) <= TRAJ_TOL
    ref_value = float(ref["guarded_value"])
    assert abs(float(value.detach()) - ref_value) <= TRAJ_TOL * ref_value
    for i, g in enumerate(grads):
        assert np.all(np.isfinite(g.numpy())) and rel(g, ref[f"guarded_grad{i}"]) <= GRAD_TOL


def test_kagome_guard_is_bit_exact_noop_on_tame_trajectory():
    results = []
    for guard in (None, dict(GUARD, threshold=1.0)):
        solve, objective, _, cp, state0 = _harness("torch", "auto", n_substeps=2, guard=guard)
        design = tuple(torch.tensor(x, requires_grad=True) for x in _design())
        value, fields = objective(design)
        results.append((fields.detach(), torch.autograd.grad(value, design)))
        if guard is not None:
            with torch.no_grad():
                args = solve.trajectory_args(state0, torch.tensor(TIMEPOINTS), cp(design))
                assert not core.trajectory_forward(args)[3].any()
    (f0, g0), (f1, g1) = results
    assert torch.equal(f0, f1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_kagome_contact_probe_fires_both_guard_terms():
    # The smoke test's kagome probe: barrier engaged, and under "auto" both
    # the hard and the proximity term fire in the plain guarded body.
    args, mag = kc.kagome_contact_probe(device="cpu", guard="auto")
    U = args.U0 * args.fixed[-1] + core.drive_planes(args.drive[:, 0], args.spec, args.U0)
    assert kc.contact_energy_of(U, args.fixed) > 0
    outs, summary = kc.guard_terms(args)
    assert summary["fired_hard"] > 0 and summary["fired_proximity"] > 0
    assert all(bool(torch.isfinite(x).all()) for x in outs[:3])
    bound = kc.trajectory_bound(args, outs[0], summary)
    assert bound["ops"] > kc.trajectory_bound(args, outs[0])["ops"] > 0
    assert bound["bound_by"] == "operations"


# ---------------------------------------------------------------------------
# The model and its guarded MMA
# ---------------------------------------------------------------------------


def _small_jax_problem(guard=None, amplitude_scale=1.0):
    """The kagome configuration's physics at 4 x 3 cells, as
    ``kernel_checks.small_kagome`` makes it for the port."""

    cfg = dict(kagome_config.KAGOME_CONFIG["forward"], method="verlet_ckpt", guard=guard)
    cfg.update(n1_cells=N1, n2_cells=N2, n_timepoints=12, n_substeps=4, simulation_time=3.0,
               n_excited_blocks=1, n_blocks_clamped_corner=1,
               amplitude=amplitude_scale * cfg["amplitude"])
    return jax_kagome.ForwardProblem(**cfg)


# The small MMA's pulse: a quarter of the configuration's, so that the
# guard fires on a share of the substeps (11 of 44 at the start).
MMA_AMPLITUDE_SCALE = 0.25


def _jax_dict(problem):
    return {k: (np.asarray(v) if hasattr(v, "shape") else v)
            for k, v in problem.to_dict().items()}


@pytest.fixture(scope="module")
def model_ref():
    """The recorded JAX results of ``jax_model_references``."""

    return stored("kagome_model_small")


def jax_model_references() -> dict:
    """The JAX package's float64 results that ``kagome_model_small.npz``
    records: the small model's objective and design gradient at
    ``_design(seed=11)`` (``verlet_ckpt``), its target blocks, and the
    harness's first ``INTERPRET_TIMEPOINTS`` timepoints through the Pallas
    kernel in interpret mode at ``_design()``."""

    jo = jax_kagome.OptimizationProblem(_small_jax_problem(), target_size=(2, 2))
    jo.setup_objective()
    value, grads = jax.jit(jax.value_and_grad(jo.objective_fn))(
        tuple(jnp.asarray(x) for x in _design(seed=11)))
    out = {"model_value": float(value), "target_blocks": np.asarray(jo.target_blocks)}
    out.update({f"model_grad{i}": np.asarray(g) for i, g in enumerate(grads)})
    jsolve, _, _, jcp, jstate0 = _harness("jax", "verlet_pallas", n_substeps=2)
    out["interpret_fields"] = np.asarray(jsolve(
        jstate0, jnp.asarray(TIMEPOINTS[:INTERPRET_TIMEPOINTS]),
        jcp(tuple(jnp.asarray(x) for x in _design()))))
    return out


@pytest.mark.slow
def test_kagome_model_references_match_jax():
    """Make ``tests/data/kagome_model_small.npz`` again with the JAX package."""

    record_or_check("kagome_model_small", jax_model_references())


def test_kagome_model_objective_and_gradient_match_jax(model_ref):
    # JAX's value and gradient (about half a minute to trace and compile)
    # are recorded (``jax_model_references``).
    jp = _small_jax_problem()
    design = [np.asarray(x) for x in _design(seed=11)]
    jvalue = float(model_ref["model_value"])
    jgrads = [model_ref[f"model_grad{i}"] for i in range(3)]

    problem = kc.small_kagome(device="cpu")
    assert _jax_dict(jp)["n1_cells"] == problem.n1_cells
    to = port_kagome.OptimizationProblem(problem, target_size=(2, 2))
    to.setup_objective()
    np.testing.assert_array_equal(to.target_blocks, model_ref["target_blocks"])
    d = tuple(torch.tensor(x, requires_grad=True) for x in design)
    value = to.objective_fn(d)
    grads = torch.autograd.grad(value, d)
    assert abs(float(value.detach()) - float(jvalue)) <= TRAJ_TOL * float(jvalue)
    for g, r in zip(grads, jgrads):
        assert rel(g, r) <= GRAD_TOL


def _mma_design():
    return [np.asarray(x) for x in _design(seed=11)]


def test_kagome_guarded_mma_matches_jax(ref):
    # The configuration's MMA settings (bounds, edge lengths, move limit,
    # guard "auto") for 2 iterations at 4 x 3 cells.
    to = port_kagome.OptimizationProblem(
        forward_problem_from_jax_dict(_jax_dict(_small_jax_problem(
            amplitude_scale=MMA_AMPLITUDE_SCALE)), device="cpu"),
        target_size=(2, 2))
    final = to.run_optimization_mma(design_from_numpy(_mma_design(), device="cpu"),
                                    n_iterations=2, verbose=False,
                                    **kagome_config.KAGOME_MMA_SETTINGS)
    assert to.forward_problem.guard == "auto"  # re-armed, as in JAX
    assert len(to.objective_values) == 2
    assert rel(to.objective_values, ref["mma_values"]) <= HISTORY_TOL
    for k, d in enumerate(to.design_values):
        assert rel(flat_numpy(d), ref[f"mma_design{k}"]) <= HISTORY_TOL
    assert rel(to.constraints_violation["edge_lengths"], ref["mma_edge_lengths"]) <= HISTORY_TOL
    assert rel(flat_numpy(final), ref["mma_design1"]) <= HISTORY_TOL
    with pytest.raises(NotImplementedError, match="quad-lattice"):
        to.run_optimization_mma(final, 1, min_void_angle=0.0, min_block_angle=0.0,
                                boundary_angle_constraint=True)


def jax_small_references(monkeypatch) -> dict:
    """The JAX package's float64 results that ``kagome_small.npz`` records:
    ``verlet_ckpt`` on the harness at ``_design()`` (objective, fields and
    design gradient; unguarded, and under GUARD with the per-interval flags
    of JAX's guarded interval body), and the small model's guarded
    2-iteration MMA from ``_mma_design()`` (objectives, flat designs,
    edge-length violations)."""

    out = {}
    design = tuple(jnp.asarray(x) for x in _design())
    for name, guard, n_sub in (("harness", None, 8), ("guarded", GUARD, 2)):
        _, objective, *_ = _harness("jax", "verlet_ckpt", n_substeps=n_sub, guard=guard)
        (value, fields), grads = jax.jit(jax.value_and_grad(objective, has_aux=True))(design)
        out.update({f"{name}_value": float(value), f"{name}_fields": np.asarray(fields)})
        out.update({f"{name}_grad{i}": np.asarray(g) for i, g in enumerate(grads)})

    def solve():
        jsolve, _, _, jcp, jstate0 = _harness("jax", "verlet_ckpt", n_substeps=2, guard=GUARD)
        jsolve(jstate0, jnp.asarray(TIMEPOINTS), jcp(design))

    out["guarded_flags"] = np.asarray(jax_interval_flags(solve, 2, GUARD, monkeypatch))
    jo = jax_kagome.OptimizationProblem(
        _small_jax_problem(amplitude_scale=MMA_AMPLITUDE_SCALE), target_size=(2, 2))
    jo.setup_objective()
    jo.run_optimization_mma(tuple(jnp.asarray(x) for x in _mma_design()), n_iterations=2,
                            verbose=False, **kagome_config.KAGOME_MMA_SETTINGS)
    out["mma_values"] = np.asarray(jo.objective_values, dtype=np.float64)
    out.update({f"mma_design{k}": flat_numpy(d) for k, d in enumerate(jo.design_values)})
    out["mma_edge_lengths"] = np.asarray(jo.constraints_violation["edge_lengths"])
    return out


@pytest.mark.slow
def test_kagome_small_references_match_jax(monkeypatch):
    """Make ``tests/data/kagome_small.npz`` again with the JAX package."""

    record_or_check("kagome_small", jax_small_references(monkeypatch))


# ---------------------------------------------------------------------------
# Converter, configuration, solver errors
# ---------------------------------------------------------------------------


def test_kagome_problems_cross_over_from_jax_dicts():
    jp = _small_jax_problem(guard="auto")
    jo = jax_kagome.OptimizationProblem(jp, target_size=(2, 2), target_shift=(1, 0))
    problem = forward_problem_from_jax_dict(_jax_dict(jp), device="cpu")
    assert isinstance(problem, port_kagome.ForwardProblem)
    assert problem.guard == "auto" and problem.method == "verlet_ckpt" and not problem.is_setup
    again = port_kagome.ForwardProblem.from_dict(problem.to_dict())
    assert again.to_dict() == problem.to_dict()
    history = [tuple(np.full(s, 0.01 * k) for s in ((N1 + 1, N2, 2), (N1, N2 + 1, 2),
                                                    (N1, N2, 2))) for k in range(2)]
    data = {**jo.to_dict(), "forward_problem": _jax_dict(jp), "objective_values": [1.0, 2.0],
            "design_values": history}
    opt = optimization_problem_from_jax_dict(data, device="cpu")
    assert isinstance(opt, port_kagome.OptimizationProblem)
    assert opt.target_shift == (1, 0) and opt.objective_values == [1.0, 2.0]
    assert [len(d) for d in opt.design_values] == [3, 3]
    assert rel(flat_numpy(opt.design_values[1]), flat_numpy(history[1])) == 0.0
    with pytest.raises(NotImplementedError, match="family.*not ported"):
        forward_problem_from_jax_dict({**_jax_dict(jp), "name": "no_such_family"},
                                      device="cpu")


def test_kagome_config_is_the_example_json():
    assert kagome_config.KAGOME_CONFIG == json.loads(CONFIG_JSON.read_text())
    settings = dict(kagome_config.KAGOME_CONFIG["optimize"])
    assert settings.pop("method") == "mma" and settings.pop("n_iterations") == 10
    assert kagome_config.KAGOME_MMA_SETTINGS == dict(settings, guard="auto")
    problem = port_kagome.ForwardProblem(**kagome_config.kagome_config(device="cpu",
                                                                      guard="auto"))
    problem.setup()
    assert problem.geometry.n_blocks == 512 and len(problem.geometry.bond_connectivity()) == 736
    args = problem.solve_dynamics.trajectory_args(
        problem.state0, problem.timepoints,
        problem.control_params(problem.geometry.zero_design()))
    guard = args.spec.guard
    window = math.radians(5.0)
    assert guard["theta_channels"] == (2, 5) and guard["length_scale"] == 1.0
    assert guard["threshold"] == pytest.approx(0.02 * window, rel=1e-12)
    assert guard["proximity"] == pytest.approx(2 * window, rel=1e-12)
    assert guard["hard"] == pytest.approx(0.1 * window, rel=1e-12)
    n_drive = args.drive.shape[-1]
    assert args.U0.shape == (1, 6, 16, 16) and args.drive.shape[:2] == (1, 1990)
    assert args.micro[0].shape == (1, 1990 * 16, n_drive)


def test_kagome_solver_checks_its_grid():
    geo = KagomeGeometry(N1, N2)
    with pytest.raises(ValueError, match="does not match"):
        setup_dynamic_solver(geometry=geo, method="auto", kagome_grid=dict(n1=N1, n2=N2 + 1))
    with pytest.raises(ValueError, match="unknown kagome_grid keys"):
        setup_dynamic_solver(geometry=geo, method="auto",
                             kagome_grid=dict(n1=N1, n2=N2, tiled=True))
    # Loads map each (block, DOF) pair to a plane slot: triangle b % 2 at
    # channel offset 3 * (b % 2), cell b // 2; a pair named twice keeps both
    # columns (they add).
    loaded = setup_dynamic_solver(geometry=geo, method="auto", kagome_grid=dict(n1=N1, n2=N2),
                                  loaded_block_DOF_pairs=[[0, 0], [3, 2], [3, 2]],
                                  loading_fn=lambda s, t: 1.0)
    # A CUDA tensor launches the kernel or raises; a tensor on any other
    # device than the CPU is refused, never run on the plain body.
    problem = kc.small_kagome(n_timepoints=3, n_substeps=2, device="cpu")
    loaded_args = loaded.trajectory_args(problem.state0, problem.timepoints,
                                         problem.control_params(problem.geometry.zero_design()))
    assert loaded_args.spec.load_map.pairs.tolist() == [0, 5 * N2 * N1 + 1, 5 * N2 * N1 + 1]
    assert loaded_args.loads[0].shape == (1, 2 * 64, 3)  # 2 intervals of 64 substeps
    args = kc.batched_args(problem, [problem.geometry.zero_design()])
    calls = core.plain_trajectory.calls
    meta = [x.to("meta") for x in (args.U0, args.V0, args.A0, args.dts, args.drive)]
    with pytest.raises(ValueError, match="unsupported device"):
        verlet_kagome.verlet_kagome_trajectory(
            *meta, tuple(x.to("meta") for x in args.fixed), args.spec, linearized=False,
            use_contact=True, drive_map=torch.zeros((6, N2, N1), dtype=torch.int32))
    assert core.plain_trajectory.calls == calls


# ---------------------------------------------------------------------------
# The configuration's JAX references (slow)
# ---------------------------------------------------------------------------


def jax_kagome_references():
    """The JAX package's float64 values of ``models/kagome_config.py``
    (method "verlet_ckpt", on the CPU)."""

    def build(guard):
        cfg = dict(kagome_config.KAGOME_CONFIG["forward"], method="verlet_ckpt", guard=guard)
        problem = jax_kagome.ForwardProblem(**cfg)
        opt = jax_kagome.OptimizationProblem(problem, target_size=(3, 3))
        opt.setup_objective()
        return problem, opt, jax.jit(jax.value_and_grad(opt.objective_fn))

    problem, _, value_and_grad = build(None)
    design = problem.geometry.zero_design()
    value, grad = value_and_grad(design)
    out = dict(objective=float(value), grad_stats=vector_stats(flat_numpy(grad)))
    _, opt, value_and_grad = build("auto")
    out["guarded_objective"] = float(value_and_grad(design)[0])
    opt.run_optimization_mma(design, n_iterations=2, verbose=False,
                             **kagome_config.KAGOME_MMA_SETTINGS)
    out["mma_values"] = tuple(float(v) for v in opt.objective_values)
    out["mma_design_stats"] = tuple(design_stats([np.asarray(x) for x in d],
                                                 [np.asarray(x) for x in design])
                                    for d in opt.design_values)
    out["mma_grad_stats"] = tuple(vector_stats(flat_numpy(value_and_grad(d)[1]))
                                  for d in opt.design_values)

    def fired(d):
        """Intervals (of 199) on which JAX's guard fires at design d."""

        def solve():
            build("auto")[0].solve(d)

        spec = jax_base.resolve_model_guard("auto", 0.0, 5 * jnp.pi / 180, 1.0)
        with pytest.MonkeyPatch.context() as monkeypatch:
            return sum(jax_interval_flags(solve, 10, spec, monkeypatch))

    out["mma_fired_intervals"] = tuple(fired(d) for d in opt.design_values)
    return out


@pytest.mark.slow
def test_kagome_references_match_jax():
    """Make the recorded JAX references of ``models/kagome_config.py`` again."""

    ref = jax_kagome_references()
    c = kagome_config
    assert abs(ref["objective"] - c.JAX_F64_OBJECTIVE) <= 1e-12 * c.JAX_F64_OBJECTIVE
    assert abs(ref["guarded_objective"] - c.JAX_F64_GUARDED_OBJECTIVE) <= (
        1e-12 * c.JAX_F64_GUARDED_OBJECTIVE)
    assert rel(ref["mma_values"], c.JAX_F64_MMA_VALUES) <= 1e-12
    assert ref["mma_fired_intervals"] == c.JAX_F64_MMA_FIRED
    for got, want in ((ref["grad_stats"], c.JAX_F64_GRAD_STATS),
                      *zip(ref["mma_grad_stats"], c.JAX_F64_MMA_GRAD_STATS),
                      *zip(ref["mma_design_stats"], c.JAX_F64_MMA_DESIGN_STATS)):
        assert max(abs(a - b) for a, b in zip(got, want)) <= 1e-10 * max(abs(x) for x in want)


@pytest.mark.slow
def test_kagome_config_objective_matches_jax_reference():
    optimization, design = kagome_config.build_kagome(device="cpu")
    with torch.no_grad():
        value = float(optimization.objective_fn(design))
    assert abs(value - kagome_config.JAX_F64_OBJECTIVE) <= 1e-8 * kagome_config.JAX_F64_OBJECTIVE
