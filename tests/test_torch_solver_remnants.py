"""The port's solver and ops remnants against the JAX package, on the CPU
at float64: the spring energies and the bond and magnetic parameter
types, distance-based contact, node loading, the periodic kagome geometry
(and its forward through the kagome grid solver), the dense ``"rk4"``,
``"semi_implicit"`` and guarded ``"verlet"`` trajectories, and the
solver's default method.

The functions run in both packages as the test goes. The trajectories and
the small periodic kagome, whose JAX trace and compile take minutes, are
recorded in ``tests/data/optimizer_small.npz`` by
``tests/jax_optimizer_references.py``.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difflexmm_tpu.geometry import QuadGeometry as JaxQuadGeometry
from difflexmm_tpu.geometry.kagome import KagomePeriodicGeometry as JaxPeriodic
from difflexmm_tpu.ops import bonds as jax_bonds
from difflexmm_tpu.ops import contact as jax_contact
from difflexmm_tpu.ops.grid import build_quad_grid_energy as jax_grid_energy
from difflexmm_tpu.ops.loading import build_node_loading as jax_node_loading
from difflexmm_tpu.solver import setup_dynamic_solver as jax_setup_dynamic_solver
from difflexmm_tpu.utils import types as jax_types
from jax_optimizer_references import PERIODIC_SMALL
from jax_references import stored

from difflexmm_tpu_torch.geometry.kagome import KagomePeriodicGeometry
from difflexmm_tpu_torch.geometry.quad import QuadGeometry
from difflexmm_tpu_torch.models import kagome_config as kg
from difflexmm_tpu_torch.models import small_configs as sc
from difflexmm_tpu_torch.ops import bonds, contact
from difflexmm_tpu_torch.ops.grid import build_quad_grid_energy
from difflexmm_tpu_torch.ops.loading import build_node_loading
from difflexmm_tpu_torch.solver import integrate
from difflexmm_tpu_torch.solver.dynamics import setup_dynamic_solver
from difflexmm_tpu_torch.utils import types
from difflexmm_tpu_torch.utils.convert import params_from_numpy

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

# Closed-form functions, the same operations in the same order: only the
# last bits of library functions (sqrt, atan2, sin, cos) differ.
TIGHT = 1e-12
# Trajectories: the same steps in the same order, rounding carried through
# 16 damped (micro-)steps of a stiff lattice; gradients of their kinetic
# energy through the same adjoint steps (tests/test_torch_kagome.py's).
TRAJ_TOL, GRAD_TOL = 1e-10, 1e-9


def rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _numpy(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _both(fn_jax, fn_torch, args, weights):
    """Value and gradient of ``sum(weights * fn(*args))`` in both packages
    with respect to every argument: ``((jax value, grads), (torch value,
    grads))``."""

    def jax_scalar(*a):
        return jnp.sum(jnp.asarray(weights) * fn_jax(*a))

    jv, jg = jax.jit(jax.value_and_grad(jax_scalar, argnums=tuple(range(len(args)))))(
        *(jnp.asarray(a) for a in args))
    ta = [torch.tensor(a, requires_grad=True) for a in args]
    tv = torch.sum(torch.tensor(weights) * fn_torch(*ta))
    tg = torch.autograd.grad(tv, ta)
    return (jv, jg), (tv, tg)


def _assert_close(j, t, tol=TIGHT):
    (jv, jg), (tv, tg) = j, t
    assert rel(_numpy(tv), jv) <= tol
    for a, b in zip(tg, jg):
        assert rel(_numpy(a), b) <= tol


# ---------------------------------------------------------------------------
# Bond energies and parameter types
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["simple_spring_energy", "stretching_torsional_spring_energy"])
def test_spring_energies_match_jax(name):
    rng = np.random.default_rng(0)
    d1, d2 = 0.1 * rng.standard_normal((2, 7, 3))
    ref = rng.standard_normal((7, 2))
    ks, kr = 1.0 + rng.uniform(size=7), 0.1 * rng.uniform(size=7)
    weights = rng.uniform(size=7)
    if name == "simple_spring_energy":
        j = _both(lambda a, b, r, k: jax_bonds.simple_spring_energy((a, b), r, k),
                  lambda a, b, r, k: bonds.simple_spring_energy((a, b), r, k),
                  (d1, d2, ref, ks), weights)
    else:
        j = _both(lambda a, b, k1, k2: jax_bonds.stretching_torsional_spring_energy((a, b), k1, k2),
                  lambda a, b, k1, k2: bonds.stretching_torsional_spring_energy((a, b), k1, k2),
                  (d1, d2, ks, kr), weights)
    _assert_close(*j)


def test_parameter_types_cross_over_from_jax():
    rng = np.random.default_rng(1)
    springs = jax_types.StretchingTorsionalSpringParams(k_stretch=rng.uniform(size=4), k_rot=0.5)
    magnetic = jax_types.MagneticParams(dipole_angles=rng.uniform(size=6),
                                        dipole_strengths=rng.uniform(size=6))
    mechanical = jax_types.MechanicalParams(
        bond_params=springs, density=1.0, damping=rng.uniform(size=(6, 3)),
        contact_params=jax_types.ContactParams(0.0, 0.1, 1.0))
    for jp, cls in ((springs, types.StretchingTorsionalSpringParams),
                    (magnetic, types.MagneticParams), (mechanical, types.MechanicalParams)):
        tp = params_from_numpy(jp, device="cpu")
        assert type(tp) is cls and tp._fields == jp._fields
        for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(tuple(tp))):
            assert torch.is_tensor(b) and b.dtype == torch.float64
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    tm = params_from_numpy(mechanical, device="cpu")
    assert type(tm.bond_params) is types.StretchingTorsionalSpringParams and tm.inertia is None
    assert type(tm.contact_params) is types.ContactParams
    assert types.BondParams.__args__ == (types.LigamentParams,
                                         types.StretchingTorsionalSpringParams)


# ---------------------------------------------------------------------------
# Distance-based contact
# ---------------------------------------------------------------------------


def test_point_to_edge_distance_matches_jax():
    # Points beyond either end (t < 0, t > 1) and on the segment's span.
    rng = np.random.default_rng(2)
    points = rng.uniform(-1.5, 2.5, (64, 2))
    edges = rng.uniform(-0.5, 1.5, (64, 2, 2))
    x0, x1 = edges[:, 0], edges[:, 1]
    t = np.sum((points - x0) * (x1 - x0), -1) / np.sum((x1 - x0) ** 2, -1)
    assert (t < 0).any() and (t > 1).any() and ((t >= 0) & (t <= 1)).any()
    _assert_close(*_both(jax_contact.point_to_edge_distance, contact.point_to_edge_distance,
                         (points, edges), rng.uniform(size=64)))


def test_edges_and_void_edge_distances_match_jax():
    rng = np.random.default_rng(3)
    e1, e2 = rng.uniform(-1.0, 1.0, (2, 32, 2, 2))
    _assert_close(*_both(jax_contact.edges_distance, contact.edges_distance, (e1, e2),
                         rng.uniform(size=32)))
    geometry = QuadGeometry(4, 3)
    bc, cnv, bond_fn, _ = geometry.get_parametrization()
    design = [torch.tensor(x) for x in sc.remnant_design()]
    nodes = (bc(*design)[:, None] + cnv(*design)).numpy()
    bond_list = bond_fn()
    n_bonds = len(bond_list)
    _assert_close(*_both(jax_contact.build_void_edge_distance(jnp.asarray(bond_list)),
                         contact.build_void_edge_distance(bond_list), (nodes,),
                         rng.uniform(size=2 * n_bonds)))


def _displaced(seed=4):
    """The remnant lattice's design and a displacement (numpy)."""

    rng = np.random.default_rng(seed)
    return sc.remnant_design(), 0.02 * rng.standard_normal((12, 3))


def _contact_params(lib):
    return (jax_types if lib is jnp else types).ContactParams(*sc.REMNANT_CONTACT)


@pytest.mark.parametrize("angle_based", [False, True])
def test_contact_energy_matches_jax(angle_based):
    design, u = _displaced()
    jgeo, tgeo = JaxQuadGeometry(4, 3), QuadGeometry(4, 3)
    jbc, jcnv, jbonds, _ = jgeo.get_parametrization()
    tbc, tcnv, tbonds, _ = tgeo.get_parametrization()
    jd = tuple(jnp.asarray(x) for x in design)
    td = tuple(torch.tensor(x) for x in design)
    jenergy = jax_contact.build_contact_energy(jbonds(), angle_based=angle_based)
    tenergy = contact.build_contact_energy(tbonds(), angle_based=angle_based)

    def jax_energy(uu, c):
        cp = jax_types.ControlParams(
            geometrical_params=jax_types.GeometricalParams(jbc(*jd), c),
            mechanical_params=jax_types.MechanicalParams(None, 1.0, contact_params=(
                _contact_params(jnp) if not angle_based
                else jax_types.ContactParams(0.0, 0.9, 1e-3))))
        return jenergy(uu, cp)

    def torch_energy(uu, c):
        cp = types.ControlParams(
            geometrical_params=types.GeometricalParams(tbc(*td), c),
            mechanical_params=types.MechanicalParams(None, 1.0, contact_params=(
                _contact_params(torch) if not angle_based
                else types.ContactParams(0.0, 0.9, 1e-3))))
        return tenergy(uu, cp)

    j, t = _both(jax_energy, torch_energy, (u, jcnv(*jd)), 1.0)
    assert float(j[0]) > 0  # the barrier acts
    _assert_close(j, t)


def test_quad_grid_distance_energy_matches_jax():
    # The gridded energy with the barrier on edge distances, and the same
    # physics assembled over the bond list.
    design, u = _displaced(5)
    jgeo, tgeo = JaxQuadGeometry(4, 3), QuadGeometry(4, 3)
    jbc, jcnv, _, jrbv = jgeo.get_parametrization()
    tbc, tcnv, tbonds, trbv = tgeo.get_parametrization()
    jd = tuple(jnp.asarray(x) for x in design)
    td = tuple(torch.tensor(x) for x in design)
    jenergy = jax_grid_energy(4, 3, angle_based=False)
    tenergy = build_quad_grid_energy(4, 3, angle_based=False)

    def jax_energy(uu):
        cp = jax_types.ControlParams(
            geometrical_params=jax_types.GeometricalParams(jbc(*jd), jcnv(*jd)),
            mechanical_params=jax_types.MechanicalParams(
                jax_types.LigamentParams(1.0, 0.02, 1e-3, jrbv()), 1.0,
                contact_params=_contact_params(jnp)))
        return jenergy(uu, cp)

    def control_params():
        return types.ControlParams(
            geometrical_params=types.GeometricalParams(tbc(*td), tcnv(*td)),
            mechanical_params=types.MechanicalParams(
                types.LigamentParams(1.0, 0.02, 1e-3, trbv()), 1.0,
                contact_params=_contact_params(torch)))

    j, t = _both(jax_energy, lambda uu: tenergy(uu, control_params()), (u,), 1.0)
    _assert_close(j, t)
    from difflexmm_tpu_torch.ops.assembly import build_strain_energy, combine_block_energies

    general = combine_block_energies(build_strain_energy(tbonds(), bonds.ligament_energy),
                                     contact.build_contact_energy(tbonds(), angle_based=False))
    assert rel(_numpy(general(torch.tensor(u), control_params())), _numpy(t[0])) <= TIGHT


def test_node_loading_matches_jax():
    design, u = _displaced(6)
    triples = np.array([[3, 0, 0], [3, 1, 1], [7, 2, 0], [7, 2, 0], [11, 3, 1]])
    jload = jax_node_loading(12, triples, lambda state, t, f: f * jnp.arange(1.0, 6.0) * t)
    tload = build_node_loading(12, triples, lambda state, t, f: f * torch.arange(
        1.0, 6.0, dtype=torch.float64) * t)
    cnv = QuadGeometry(4, 3).get_parametrization()[1](*(torch.tensor(x) for x in design))
    weights = np.random.default_rng(7).uniform(size=(12, 3))
    j = _both(lambda uu, c, f: jload((uu, uu), 0.7, dict(f=f), c),
              lambda uu, c, f: tload((uu, uu), torch.tensor(0.7, dtype=torch.float64), dict(f=f),
                                     c),
              (u, cnv.numpy(), np.float64(0.3)), weights)
    _assert_close(*j)
    # Virtual work: the loads' power equals the block forces' at any rate.
    forces = tload((torch.tensor(u), None), torch.tensor(0.7, dtype=torch.float64),
                   dict(f=torch.tensor(0.3, dtype=torch.float64)), cnv)
    assert forces[[0, 1, 2, 4, 5, 6, 8, 9, 10]].abs().max() == 0.0
    assert forces[7, 0] == pytest.approx(2 * 0.3 * 0.7 * 3.5, rel=1e-12)  # the pair adds


# ---------------------------------------------------------------------------
# Periodic kagome
# ---------------------------------------------------------------------------


def test_periodic_kagome_geometry_matches_jax():
    basis = 1.2 * np.array([[1.0, 0.0], [np.cos(1.0), np.sin(1.0)]])
    jgeo = JaxPeriodic(4, 3, direct_basis=jnp.asarray(basis), bond_length=0.06)
    tgeo = KagomePeriodicGeometry(4, 3, direct_basis=basis, bond_length=0.06)
    jbc, jcnv, jbonds, jref = jgeo.get_parametrization()
    tbc, tcnv, tbonds, tref = tgeo.get_parametrization()
    np.testing.assert_array_equal(tbonds(), np.asarray(jbonds()))
    assert rel(tref(), jref()) <= TIGHT
    rng = np.random.default_rng(8)
    shifts = 0.03 * rng.standard_normal((3, 2))
    for jfn, tfn, shape in ((jbc, tbc, (24, 2)), (jcnv, tcnv, (24, 3, 2))):
        _assert_close(*_both(jfn, tfn, (shifts,), rng.standard_normal(shape)))
    # Zero shifts by default, and a population keeps its leading dimension.
    assert rel(_numpy(tcnv()), jcnv()) <= TIGHT
    population = torch.tensor(np.stack([shifts, -shifts]))
    assert rel(_numpy(tbc(population)[1]), jbc(jnp.asarray(-shifts))) <= TIGHT


def test_periodic_kagome_through_the_grid_solver_matches_jax():
    ref = stored("optimizer_small")
    objective = kg.build_periodic_kagome(device="cpu", **PERIODIC_SMALL)
    shifts = kg.periodic_shifts(device="cpu").requires_grad_()
    value = objective(shifts)
    (grad,) = torch.autograd.grad(value, shifts)
    assert rel(_numpy(value), ref["periodic_value"]) <= TRAJ_TOL
    assert rel(grad.numpy(), ref["periodic_grad"]) <= GRAD_TOL


# ---------------------------------------------------------------------------
# Dense integrators and the dense guard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(sc.REMNANT_RUNS))
def test_dense_trajectories_match_jax(name):
    ref = stored("optimizer_small")
    solve, fields, value, grads = sc.remnant_run(name, device="cpu")
    assert fields.shape == ref[f"remnant_{name}_fields"].shape
    assert rel(_numpy(fields), ref[f"remnant_{name}_fields"]) <= TRAJ_TOL
    assert rel(_numpy(value), ref[f"remnant_{name}_value"]) <= TRAJ_TOL
    for i, g in enumerate(grads):
        assert rel(g.numpy(), ref[f"remnant_{name}_grad{i}"]) <= GRAD_TOL
    fired = [f for _, f in solve.decisions]
    if sc.REMNANT_RUNS[name][1] is None:
        assert fired == []
    else:
        # The guard fired on some (micro-)steps and not on others: a
        # decision unlike JAX's would change a step's size and move the
        # trajectory far beyond TRAJ_TOL (the unguarded run differs by
        # more than 1e-6 of its scale).
        assert 0 < sum(fired) < len(fired)
        assert rel(_numpy(fields), ref["remnant_verlet_fields"]) > 1e-6
    if name == "verlet_travel_levels2":
        assert any(f for depth, f in solve.decisions if depth == 1)


def test_default_method_is_rk4_as_in_jax():
    default = inspect.signature(setup_dynamic_solver).parameters["method"].default
    assert default == inspect.signature(jax_setup_dynamic_solver).parameters["method"].default
    assert default == "rk4"
    ref = stored("optimizer_small")
    _, fields, value, _ = sc.remnant_run("rk4", device="cpu", default_method=True)
    assert rel(_numpy(fields), ref["remnant_default_fields"]) <= TRAJ_TOL
    np.testing.assert_array_equal(ref["remnant_default_fields"], ref["remnant_rk4_fields"])


def test_dense_solver_refuses_what_jax_refuses():
    geometry = QuadGeometry(3, 3)
    energy = contact.build_contact_energy(geometry.get_parametrization()[2]())
    with pytest.raises(ValueError, match="fixed-step Verlet"):
        setup_dynamic_solver(geometry, energy, method="rk4", guard=dict(threshold=0.1))
    with pytest.raises(ValueError, match="relative"):
        setup_dynamic_solver(geometry, energy, method="verlet",
                             guard=dict(threshold=0.1, translation="relative"))
    with pytest.raises(ValueError, match="bond connectivity"):
        setup_dynamic_solver(9, energy, method="verlet",
                             guard=dict(window=0.1, proximity_windows=2.0))
    with pytest.raises(NotImplementedError, match="torchdiffeq"):
        setup_dynamic_solver(geometry, energy, method="odeint")
    with pytest.raises(NotImplementedError, match="oracle"):
        integrate.integrate(lambda y, t: y, torch.zeros(2), torch.zeros(2), method="odeint")


@pytest.mark.slow
def test_periodic_kagome_references_match_jax():
    """The periodic kagome's constants of ``models/kagome_config.py`` made
    again with the JAX package (about 5 minutes)."""

    import jax_optimizer_references as refs

    got = refs.periodic_kagome()
    assert rel(got["JAX_F64_PERIODIC_OBJECTIVE"], kg.JAX_F64_PERIODIC_OBJECTIVE) <= 1e-12
    assert rel(got["JAX_F64_PERIODIC_GRAD"], kg.JAX_F64_PERIODIC_GRAD) <= 1e-12
