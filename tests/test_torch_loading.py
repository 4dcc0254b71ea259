"""The port's force-controlled dynamics against the JAX package, on the CPU
at float64: ``build_loading`` (pairs named twice add) and
``build_viscous_damping``; the dense ``method="verlet"`` with a drive,
loads and damping on a 3 x 1-cell rotated-square tensile chain; and fused
loading on the 5 x 4 quad setup of ``tests/test_pallas_verlet.py`` and the
4 x 3-cell kagome setup of ``tests/test_pallas_kagome.py``, unguarded and
guarded (trajectory within 1e-10, gradients with respect to the design and
the loading parameters within 1e-9, guard flags identical). JAX's fused
runs, whose trace and compile take 10-40 s each, are recorded in
``tests/data/loading_harness.npz`` by the slow
``test_loading_harness_references_match_jax``, which makes them again.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difflexmm_tpu.geometry import KagomeGeometry as JaxKagomeGeometry
from difflexmm_tpu.geometry import QuadGeometry as JaxQuadGeometry
from difflexmm_tpu.geometry import RotatedSquareGeometry as JaxRotatedSquareGeometry
from difflexmm_tpu.ops import loading as jax_loading
from difflexmm_tpu.ops.assembly import build_strain_energy as jax_build_strain_energy
from difflexmm_tpu.ops.bonds import ligament_energy as jax_ligament_energy
from difflexmm_tpu.ops.grid import build_quad_grid_energy as jax_build_quad_grid_energy
from difflexmm_tpu.ops.kagome_grid import build_kagome_grid_energy as jax_build_kagome_energy
from difflexmm_tpu.ops.pallas import core as jax_core
from difflexmm_tpu.ops.pallas import verlet_grid as jax_verlet_grid
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

from difflexmm_tpu_torch.geometry.kagome import KagomeGeometry
from difflexmm_tpu_torch.geometry.quad import QuadGeometry, RotatedSquareGeometry
from difflexmm_tpu_torch.ops import loading
from difflexmm_tpu_torch.ops.assembly import build_strain_energy
from difflexmm_tpu_torch.ops.bonds import ligament_energy
from difflexmm_tpu_torch.ops.grid import build_quad_grid_energy
from difflexmm_tpu_torch.ops.kernels import core
from difflexmm_tpu_torch.solver import setup_dynamic_solver
from difflexmm_tpu_torch.utils.types import (
    ContactParams,
    ControlParams,
    GeometricalParams,
    LigamentParams,
    MechanicalParams,
)

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

# Same operations in the same order at float64: the elementwise pieces within
# 1e-12, trajectories within 1e-10 and gradients within 1e-9 of their scales.
OP_TOL, TRAJ_TOL, GRAD_TOL = 1e-12, 1e-10, 1e-9


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


# ---------------------------------------------------------------------------
# build_loading and build_viscous_damping
# ---------------------------------------------------------------------------

# Pairs with a repeat (block 3, DOF 0 twice): the two add.
PAIRS = np.array([[3, 0], [1, 2], [3, 0], [0, 1]])


@pytest.mark.parametrize("vector", [False, True], ids=["scalar", "per-pair"])
def test_build_loading_matches_jax(vector):
    rng = np.random.default_rng(0)
    u, v = rng.standard_normal((2, 5, 3))
    weights = rng.standard_normal(len(PAIRS)) if vector else 1.0

    def jax_fn(state, t, amplitude):
        return amplitude * jnp.sin(t) * jnp.asarray(weights) + state[0][2, 1]

    def port_fn(state, t, amplitude):
        return amplitude * torch.sin(t) * torch.as_tensor(weights) + state[0][2, 1]

    ref = jax_loading.build_loading(5, PAIRS, jax_fn)((jnp.asarray(u), jnp.asarray(v)), 0.7,
                                                      dict(amplitude=1.3))
    got = loading.build_loading(5, PAIRS, port_fn)(
        (torch.tensor(u), torch.tensor(v)), torch.tensor(0.7, dtype=torch.float64),
        dict(amplitude=torch.tensor(1.3, dtype=torch.float64)))
    assert got.dtype == torch.float64
    assert rel(got, ref) <= OP_TOL
    # The repeated pair carries the sum of its two values.
    values = torch.broadcast_to(port_fn((torch.tensor(u), None),
                                        torch.tensor(0.7, dtype=torch.float64),
                                        torch.tensor(1.3, dtype=torch.float64)), (len(PAIRS),))
    assert float(got[3, 0]) == float(values[0] + values[2])
    assert np.count_nonzero(np.asarray(ref)) == 3


def test_build_viscous_damping_matches_jax():
    rng = np.random.default_rng(1)
    u, v = rng.standard_normal((2, 6, 3))
    damped = np.array([0, 2, 2, 5])  # block 2 twice: its coefficients add
    coeffs = rng.random((4, 3))
    ref = jax_loading.build_viscous_damping(6, damped)((jnp.asarray(u), jnp.asarray(v)), 0.0,
                                                       jnp.asarray(coeffs))
    got = loading.build_viscous_damping(6, damped)((torch.tensor(u), torch.tensor(v)), 0.0,
                                                   torch.tensor(coeffs))
    assert rel(got, ref) <= OP_TOL


# ---------------------------------------------------------------------------
# Dense "verlet" on a tensile chain: drive, loads and damping
# ---------------------------------------------------------------------------


def _tensile_chain(pkg):
    """A 3 x 1-cell rotated-square chain (6 x 2 blocks): the left column's x
    driven by a ramp, its y pinned, the right column pulled by a force ramp
    (one pair named twice), all blocks damped, 24 intervals of 8 substeps."""

    if pkg == "jax":
        Geo, Cp, Gp, Mp, Lp, lib = (JaxRotatedSquareGeometry, JaxControlParams,
                                    JaxGeometricalParams, JaxMechanicalParams,
                                    JaxLigamentParams, jnp)
        strain, setup = jax_build_strain_energy, jax_setup_dynamic_solver
        bond_energy = jax_ligament_energy
    else:
        Geo, Cp, Gp, Mp, Lp, lib = (RotatedSquareGeometry, ControlParams, GeometricalParams,
                                    MechanicalParams, LigamentParams, torch)
        strain, setup = build_strain_energy, setup_dynamic_solver
        bond_energy = ligament_energy
    geo = Geo(3, 1, spacing=1.0)
    bc, cnv, bonds, rbv = geo.get_parametrization()
    n1, nb = geo.n1_blocks, geo.n_blocks
    left = np.array([0, n1])
    right = np.array([n1 - 1, nb - 1])
    constrained = np.concatenate([np.stack([left, 0 * left], 1), np.stack([left, 1 + 0 * left], 1)])
    loaded = np.array([[right[0], 0], [right[1], 0], [right[1], 0], [right[0], 2]])

    def drive(t, speed):
        return -speed * lib.minimum(t, 2.0 + 0 * t)[..., None] * lib.asarray([1.0, 1.0, 0.0, 0.0])

    def loads(state, t, force):
        return force * lib.minimum(t / 3.0, 1.0 + 0 * t)

    solve = setup(geometry=geo, energy_fn=strain(bonds(), bond_energy),
                  loaded_block_DOF_pairs=loaded, loading_fn=loads,
                  constrained_block_DOF_pairs=constrained, constrained_DOFs_fn=drive,
                  damped_blocks=np.arange(nb), method="verlet", n_substeps=8)
    angle = 0.15
    cp = Cp(geometrical_params=Gp(bc(angle), cnv(angle)),
            mechanical_params=Mp(bond_params=Lp(1.0, 0.02, 1e-3, rbv()), density=1.0,
                                 damping=0.05),
            constraint_params=dict(speed=0.02), loading_params=dict(force=0.05))
    timepoints = np.linspace(0.0, 6.0, 25)
    return solve, cp, timepoints, nb


def test_dense_verlet_matches_jax_on_a_tensile_chain():
    solve, cp, ts, nb = _tensile_chain("jax")
    ref = np.asarray(jax.jit(solve)(jnp.zeros((2, nb, 3)), jnp.asarray(ts), cp))
    solve, cp, ts, nb = _tensile_chain("port")
    cp = cp._replace(
        mechanical_params=cp.mechanical_params._replace(damping=torch.tensor(0.05,
                                                                             dtype=torch.float64)),
        constraint_params=dict(speed=torch.tensor(0.02, dtype=torch.float64)),
        loading_params=dict(force=torch.tensor(0.05, dtype=torch.float64)))
    with torch.no_grad():
        got = solve(torch.zeros((2, nb, 3), dtype=torch.float64), torch.tensor(ts), cp)
    assert float(np.abs(ref).max()) > 1e-2  # the chain moved
    assert rel(got, ref) <= TRAJ_TOL


# ---------------------------------------------------------------------------
# Fused loading: the quad and kagome harnesses of the JAX package's tests
# ---------------------------------------------------------------------------

# The ramp of the JAX harnesses, plus a pair named twice and one on a
# clamped DOF (block 0, DOF 0) among the loaded pairs.
QUAD_N1, QUAD_N2 = 5, 4
KAGOME_N1, KAGOME_N2 = 4, 3
# Guards that fire on a few substeps of the last intervals of each run (the
# earlier intervals replay unguarded): travel thresholds in rad per substep.
GUARDS = {"quad": dict(threshold=0.002, refine=4), "kagome": dict(threshold=3e-4, refine=4)}
LOAD_PARAMS = {"quad": (0.02, 2.0), "kagome": (0.01, 2.0)}


def _harness(lattice):
    """(pairs clamped, loaded pairs, timepoints, n_substeps) of a harness."""

    if lattice == "quad":
        n1, n2 = QUAD_N1, QUAD_N2
        clamped_blocks = np.arange(n2) * n1
        right = np.arange(n2) * n1 + (n1 - 1)
        timepoints = np.linspace(0.0, 2.0, 9)
    else:
        n1, n2 = KAGOME_N1, KAGOME_N2
        clamped_blocks = np.arange(n2) * 2 * n1
        right = np.array([2 * n1 - 1, 4 * n1 - 1])
        timepoints = np.linspace(0.0, 1.0, 6)
    clamped = np.stack([np.repeat(clamped_blocks, 3), np.tile([0, 1, 2], len(clamped_blocks))],
                       axis=1)
    loaded = np.stack([right, np.zeros_like(right)], axis=1)
    loaded = np.concatenate([loaded, [[right[1], 0], [0, 0], [right[0], 1]]])
    return clamped, loaded, timepoints, 8


def _jax_loaded(lattice, guard, monkeypatch):
    """JAX ``verlet_ckpt`` on a harness: (value, fields, grads wrt (first
    design array, force_amplitude, rate), per-interval flags). The flags
    come from the package's own guarded interval body (``emit_risk=True``)
    on the arrays its solver hands the trajectory, caught in an eager call
    that stops there."""

    clamped, loaded, timepoints, n_substeps = _harness(lattice)
    module = jax_verlet_grid if lattice == "quad" else jax_verlet_kagome
    build_name = ("build_pallas_verlet_trajectory" if lattice == "quad"
               else "build_pallas_kagome_trajectory")
    if lattice == "quad":
        geo = JaxQuadGeometry(QUAD_N1, QUAD_N2, 1.0, 0.1)
        energy = jax_build_quad_grid_energy(QUAD_N1, QUAD_N2, jax_ligament_energy)
        grid = dict(quad_grid=dict(n1=QUAD_N1, n2=QUAD_N2, linearized=False))
        design = geo.get_design_from_rotated_square(0.2)
        contact = JaxContactParams(0.0, jnp.deg2rad(5.0), 1.0)
    else:
        geo = JaxKagomeGeometry(n1_cells=KAGOME_N1, n2_cells=KAGOME_N2, bond_length=0.05)
        energy = jax_build_kagome_energy(KAGOME_N1, KAGOME_N2, jax_ligament_energy)
        grid = dict(kagome_grid=dict(n1=KAGOME_N1, n2=KAGOME_N2, linearized=False))
        design = geo.zero_design()
        contact = JaxContactParams(0.0, jnp.deg2rad(30.0), 1.0)
    bc, cnv, _, rbv = geo.get_parametrization()
    captured = {}
    real = getattr(module, build_name)

    def spy(*a, **kw):
        trajectory = real(*a, **kw)
        captured["drive_fn"], captured["load_fn"] = a[4], kw["load_values_fn"]

        def wrapped(carry, ts, arrays):
            captured["call"] = (carry, ts, arrays)
            if captured.get("stop"):
                return tuple(jnp.zeros((len(ts) - 1,) + c.shape, c.dtype) for c in carry)
            return trajectory(carry, ts, arrays)

        wrapped.force_fn = trajectory.force_fn
        return wrapped

    monkeypatch.setattr(module, build_name, spy)

    def loading_fn(state, t, force_amplitude, rate):
        return force_amplitude * jnp.minimum(t * rate, 1.0)

    solve = jax_setup_dynamic_solver(
        geometry=geo, energy_fn=energy, loaded_block_DOF_pairs=loaded, loading_fn=loading_fn,
        constrained_block_DOF_pairs=clamped, damped_blocks=np.arange(geo.n_blocks),
        method="verlet_ckpt", n_substeps=n_substeps, guard=guard, **grid)

    def objective(d0, amp, rate):
        cp = JaxControlParams(
            geometrical_params=JaxGeometricalParams(bc(d0, *design[1:]), cnv(d0, *design[1:])),
            mechanical_params=JaxMechanicalParams(
                bond_params=JaxLigamentParams(1.0, 0.02, 1e-3, rbv()), density=1.0,
                damping=0.05, contact_params=contact),
            constraint_params={}, loading_params=dict(force_amplitude=amp, rate=rate))
        sol = solve(jnp.zeros((2, geo.n_blocks, 3)), jnp.asarray(timepoints), cp)
        return jnp.sum(sol[:, 1] ** 2), sol

    amp, rate = LOAD_PARAMS[lattice]
    (value, fields), grads = jax.jit(jax.value_and_grad(objective, argnums=(0, 1, 2),
                                                        has_aux=True))(design[0], amp, rate)
    flags = []
    if guard is not None:
        captured["stop"] = True
        objective(design[0], amp, rate)  # eager: the spy catches concrete arrays
        carry, ts, arrays = captured["call"]
        if lattice == "quad":
            n_fixed, energy_of = module.N_FIXED_ARRAYS + 3, module._quad_energy_of(False, True)
            gap_of, theta = module._quad_gap_of(True), (2,)
        else:
            n_fixed, energy_of = module.N_FIXED_ARRAYS + 3, module._kagome_energy_of(False, True)
            gap_of, theta = module._kagome_gap_of(True), (2, 5)
        force = jax_core.make_force_fn(n_fixed, energy_of, captured["drive_fn"],
                                       captured["load_fn"])
        body = jax.jit(jax_core.make_interval_body(
            n_fixed, n_substeps, force, True, guard=jax_core.resolve_guard(guard, theta),
            gap_of=gap_of, emit_risk=True))
        for k in range(len(timepoints) - 1):
            carry, risky = body(*carry, ts[k], (ts[k + 1] - ts[k]) / n_substeps, arrays)
            flags.append(bool(risky))
    return dict(value=float(value), fields=np.asarray(fields), flags=flags,
                grads=[np.asarray(g) for g in grads])


def _port_loaded(lattice, guard, pairs=None, loading_fn=None):
    """The port's fused path (``method="auto"``: the kernel wrapper, which
    runs the plain body on CPU tensors) on a harness: value, fields, grads
    and the forward's flags; ``pairs``/``loading_fn`` replace the
    harness's."""

    clamped, loaded, timepoints, n_substeps = _harness(lattice)
    loaded = loaded if pairs is None else pairs
    if lattice == "quad":
        geo = QuadGeometry(QUAD_N1, QUAD_N2, 1.0, 0.1)
        grid = dict(quad_grid=dict(n1=QUAD_N1, n2=QUAD_N2, linearized=False))
        design = geo.get_design_from_rotated_square(0.2)
        contact = ContactParams(0.0, math.radians(5.0), 1.0)
    else:
        geo = KagomeGeometry(KAGOME_N1, KAGOME_N2, bond_length=0.05)
        grid = dict(kagome_grid=dict(n1=KAGOME_N1, n2=KAGOME_N2, linearized=False))
        design = geo.zero_design()
        contact = ContactParams(0.0, math.radians(30.0), 1.0)
    bc, cnv, _, rbv = geo.get_parametrization()

    def ramp(state, t, force_amplitude, rate):
        return force_amplitude * torch.minimum(t * rate, torch.ones_like(t))

    solve = setup_dynamic_solver(
        geometry=geo, loaded_block_DOF_pairs=loaded, loading_fn=loading_fn or ramp,
        constrained_block_DOF_pairs=clamped, damped_blocks=np.arange(geo.n_blocks),
        method="auto", n_substeps=n_substeps, guard=guard, **grid)
    d0 = design[0].clone().requires_grad_()
    amp, rate = (torch.tensor(x, dtype=torch.float64, requires_grad=True)
                 for x in LOAD_PARAMS[lattice])
    cp = ControlParams(
        geometrical_params=GeometricalParams(bc(d0, *design[1:]), cnv(d0, *design[1:])),
        mechanical_params=MechanicalParams(
            bond_params=LigamentParams(1.0, 0.02, 1e-3, rbv()), density=1.0,
            damping=torch.tensor(0.05, dtype=torch.float64), contact_params=contact),
        constraint_params={}, loading_params=dict(force_amplitude=amp, rate=rate))
    state0 = torch.zeros((2, geo.n_blocks, 3), dtype=torch.float64)
    ts = torch.tensor(timepoints)
    fields = solve(state0, ts, cp)
    value = torch.sum(fields[:, 1] ** 2)
    grads = torch.autograd.grad(value, (d0, amp, rate))
    flags = []
    if guard is not None:
        with torch.no_grad():
            flags = core.trajectory_forward(solve.trajectory_args(state0, ts, cp))[3][0].tolist()
    return dict(value=float(value), fields=fields.detach().numpy(), flags=flags,
                grads=[g.numpy() for g in grads])


CASES = [(lattice, guarded) for lattice in ("quad", "kagome") for guarded in (False, True)]


def _case_name(lattice, guarded):
    return f"{lattice}_{'guarded' if guarded else 'unguarded'}"


def _recorded(lattice, guarded):
    data, name = stored("loading_harness"), _case_name(lattice, guarded)
    return dict(value=float(data[f"{name}_value"]), fields=data[f"{name}_fields"],
                flags=data[f"{name}_flags"].tolist(),
                grads=[data[f"{name}_grad{i}"] for i in range(3)])


@pytest.mark.slow
def test_loading_harness_references_match_jax(monkeypatch):
    """Make ``tests/data/loading_harness.npz`` again with the JAX package."""

    out = {}
    for lattice, guarded in CASES:
        ref = _jax_loaded(lattice, GUARDS[lattice] if guarded else None, monkeypatch)
        monkeypatch.undo()
        name = _case_name(lattice, guarded)
        out.update({f"{name}_value": ref["value"], f"{name}_fields": ref["fields"],
                    f"{name}_flags": np.asarray(ref["flags"], dtype=bool)})
        out.update({f"{name}_grad{i}": g for i, g in enumerate(ref["grads"])})
    record_or_check("loading_harness", out)


@pytest.mark.parametrize("lattice, guarded", CASES, ids=[_case_name(*c) for c in CASES])
def test_fused_loading_matches_jax(lattice, guarded):
    ref = _recorded(lattice, guarded)
    got = _port_loaded(lattice, GUARDS[lattice] if guarded else None)
    assert got["flags"] == ref["flags"]
    if guarded:  # some intervals fired and some did not: both replays run
        assert any(ref["flags"]) and not all(ref["flags"])
    assert float(np.abs(ref["fields"]).max()) > 1e-4  # the ramp pulled
    assert rel(got["fields"], ref["fields"]) <= TRAJ_TOL
    assert abs(got["value"] - ref["value"]) <= TRAJ_TOL * abs(ref["value"])
    for g, r in zip(got["grads"], ref["grads"]):
        assert np.all(np.isfinite(g)) and rel(g, r) <= GRAD_TOL


@pytest.mark.parametrize("lattice", ["quad", "kagome"])
def test_load_on_a_constrained_dof_is_a_no_op(lattice):
    # The harness's pairs include (0, 0), a clamped DOF: the same run
    # without it gives the same bits, fields and design gradient alike. The
    # loading parameters' gradients sum over one column fewer of the load
    # table, so they agree to the rounding of that sum.
    _, loaded, _, _ = _harness(lattice)
    with_it = _port_loaded(lattice, None)
    without = _port_loaded(lattice, None, pairs=loaded[[i for i, p in enumerate(loaded.tolist())
                                                         if p != [0, 0]]])
    assert np.array_equal(with_it["fields"], without["fields"])
    assert np.array_equal(with_it["grads"][0], without["grads"][0])
    for a, b in zip(with_it["grads"][1:], without["grads"][1:]):
        assert rel(a, b) <= 1e-14


def test_state_dependent_loading_raises_on_the_fused_path():
    def follower(state, t, force_amplitude, rate):
        return force_amplitude * state[0][3, 0]

    with pytest.raises(TypeError, match="time only"):
        _port_loaded("quad", None, loading_fn=follower)


def test_slot_loads_add_each_slots_pairs_in_pair_order():
    # Pairs that name one slot sum into one column, from zero and in pair
    # order (the plain body and the kernel wrapper share this sum); the
    # kernel's map gives each plane element its slot's column, -1 where
    # nothing is loaded, and each pair takes its slot's cotangent.
    loads = core.load_map([7, 2, 7, 0, 7, 2], (2, 2, 2), "cpu")
    assert loads.slots.tolist() == [0, 2, 7]
    assert loads.columns.flatten().tolist() == [0, -1, 1, -1, -1, -1, -1, 2]
    table = torch.tensor([[1e16, 3.0, 1.0, 5.0, -1e16, 4.0]], dtype=torch.float64,
                         requires_grad=True)
    summed = core.slot_loads(table, loads)
    # Slot 7 in pair order: (1e16 + 1) - 1e16 = 0 at float64 (1 in another).
    assert summed.tolist() == [[5.0, 7.0, 0.0]]
    summed.backward(torch.tensor([[1.0, 2.0, 3.0]], dtype=torch.float64))
    assert table.grad.tolist() == [[3.0, 2.0, 3.0, 1.0, 3.0, 2.0]]


def test_scalar_loading_with_as_many_substeps_as_pairs_matches_jax():
    # Two loaded pairs and two substeps in all: a table of loads built from
    # a vector of times would broadcast a scalar-valued function along the
    # pairs instead of time. Evaluated at scalar times, as JAX does, each
    # substep's row carries both pairs' value at its own time.
    n1, n2 = 3, 3
    pairs = np.array([[2, 0], [8, 1]])
    timepoints = np.array([0.0, 0.5])
    rbv_kw = dict(k=(1.0, 0.02, 1e-3))

    def jax_run():
        geo = JaxQuadGeometry(n1, n2, 1.0, 0.1)
        bc, cnv, _, rbv = geo.get_parametrization()
        design = geo.get_design_from_rotated_square(0.2)
        solve = jax_setup_dynamic_solver(
            geometry=geo, energy_fn=jax_build_quad_grid_energy(n1, n2, jax_ligament_energy),
            loaded_block_DOF_pairs=pairs, loading_fn=lambda s, t, a: a * (t + 0.25),
            method="verlet_ckpt", n_substeps=2, quad_grid=dict(n1=n1, n2=n2))
        cp = JaxControlParams(
            geometrical_params=JaxGeometricalParams(bc(*design), cnv(*design)),
            mechanical_params=JaxMechanicalParams(
                bond_params=JaxLigamentParams(*rbv_kw["k"], rbv()), density=1.0),
            loading_params=dict(a=3.0))
        return np.asarray(solve(jnp.zeros((2, geo.n_blocks, 3)), jnp.asarray(timepoints), cp))

    geo = QuadGeometry(n1, n2, 1.0, 0.1)
    bc, cnv, _, rbv = geo.get_parametrization()
    design = geo.get_design_from_rotated_square(0.2)
    solve = setup_dynamic_solver(geometry=geo, loaded_block_DOF_pairs=pairs,
                                 loading_fn=lambda s, t, a: a * (t + 0.25), method="auto",
                                 n_substeps=2, quad_grid=dict(n1=n1, n2=n2))
    cp = ControlParams(geometrical_params=GeometricalParams(bc(*design), cnv(*design)),
                       mechanical_params=MechanicalParams(
                           bond_params=LigamentParams(*rbv_kw["k"], rbv()), density=1.0),
                       loading_params=dict(a=torch.tensor(3.0, dtype=torch.float64)))
    state0 = torch.zeros((2, geo.n_blocks, 3), dtype=torch.float64)
    with torch.no_grad():
        got = solve(state0, torch.tensor(timepoints), cp)
        table = solve.trajectory_args(state0, torch.tensor(timepoints), cp).loads[0][0]
    assert torch.equal(table, 3.0 * (torch.tensor([[0.25], [0.5]]) + 0.25).expand(2, 2))
    assert rel(got, jax_run()) <= TRAJ_TOL
