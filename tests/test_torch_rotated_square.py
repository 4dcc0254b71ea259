"""The port's rotated-square lattice, general-connectivity energies and the
``reference_design`` model against the JAX package, on the CPU at
float64: ``RotatedSquareGeometry`` (parametrization and its angle
gradient within 1e-12), ``ligament_energy`` (nonlinear and linearized),
``build_strain_energy``, ``build_contact_energy`` and
``build_quad_grid_energy`` (energy and force within 1e-12), and
``reference_design.ForwardProblem`` at a cut ``pulse_forward.json``
(trajectory within 1e-10, the dense default and the fast path). The slow
tests make the JAX references of ``models/loaded_configs.py`` again.
"""

import json
import math
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difflexmm_tpu.geometry import RotatedSquareGeometry as JaxRotatedSquareGeometry
from difflexmm_tpu.models import reference_design as jax_reference_design
from difflexmm_tpu.ops import bonds as jax_bonds
from difflexmm_tpu.ops.assembly import build_strain_energy as jax_build_strain_energy
from difflexmm_tpu.ops.contact import build_contact_energy as jax_build_contact_energy
from difflexmm_tpu.ops.grid import build_quad_grid_energy as jax_build_quad_grid_energy
from difflexmm_tpu.ops.observables import kinetic_energy as jax_kinetic_energy
from difflexmm_tpu.geometry.polygon import compute_inertia as jax_compute_inertia
from difflexmm_tpu.solver import setup_dynamic_solver as jax_setup_dynamic_solver
from difflexmm_tpu.utils import (
    ContactParams as JaxContactParams,
    ControlParams as JaxControlParams,
    GeometricalParams as JaxGeometricalParams,
    LigamentParams as JaxLigamentParams,
    MechanicalParams as JaxMechanicalParams,
)

from difflexmm_tpu_torch.geometry.quad import RotatedSquareGeometry
from difflexmm_tpu_torch.models import loaded_configs as lc
from difflexmm_tpu_torch.models.flagship import vector_stats
from difflexmm_tpu_torch.ops import bonds
from difflexmm_tpu_torch.ops.assembly import build_strain_energy, combine_block_energies
from difflexmm_tpu_torch.ops.contact import build_contact_energy
from difflexmm_tpu_torch.ops.grid import build_quad_grid_energy
from difflexmm_tpu_torch.utils.convert import (
    design_from_numpy,
    forward_problem_from_jax_dict,
    loading_params_from_numpy,
    reference_design_from_config,
)
from difflexmm_tpu_torch.utils.types import (
    ContactParams,
    ControlParams,
    GeometricalParams,
    LigamentParams,
    MechanicalParams,
)

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

OP_TOL, TRAJ_TOL, REF_TOL = 1e-12, 1e-10, 1e-12
REPO = pathlib.Path(__file__).resolve().parents[1]


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("angle", [0.25, -0.1])
def test_rotated_square_parametrization_matches_jax(angle):
    jgeo, geo = JaxRotatedSquareGeometry(3, 2, spacing=1.2, bond_length=0.15), \
        RotatedSquareGeometry(3, 2, spacing=1.2, bond_length=0.15)
    jbc, jcnv, jbonds, jrbv = jgeo.get_parametrization()
    bc, cnv, bonds_fn, rbv = geo.get_parametrization()
    assert (geo.n1_blocks, geo.n2_blocks, geo.n_blocks) == (6, 4, 24)
    a = torch.tensor(angle, dtype=torch.float64, requires_grad=True)
    assert rel(bc(a).detach(), jbc(angle)) <= OP_TOL
    assert rel(cnv(a).detach(), jcnv(angle)) <= OP_TOL
    assert np.array_equal(bonds_fn(), np.asarray(jbonds()))
    assert rel(rbv(), jrbv()) == 0.0
    # The angle gradient of a probe of the corner vectors.
    r = np.random.default_rng(0).standard_normal((24, 4, 2))
    (g,) = torch.autograd.grad(torch.sum(cnv(a) * torch.tensor(r)), a)
    jg = jax.grad(lambda x: jnp.sum(jcnv(x) * r))(angle)
    assert abs(float(g) - float(jg)) <= OP_TOL * abs(float(jg))
    # A Python number works too, at float64 on the CPU.
    assert cnv(angle).dtype == torch.float64 and bc(angle).device.type == "cpu"


# ---------------------------------------------------------------------------
# Energies on the general bond list and on the grid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["ligament_energy", "ligament_energy_linearized"])
def test_ligament_energy_matches_jax(name):
    rng = np.random.default_rng(1)
    d1, d2 = 0.3 * rng.standard_normal((2, 7, 3))
    ref = rng.standard_normal((7, 2))
    ks, ksh, kr = rng.random((3, 7))
    jax_e = getattr(jax_bonds, name)((jnp.asarray(d1), jnp.asarray(d2)), jnp.asarray(ref),
                                     ks, ksh, kr)
    e = getattr(bonds, name)((torch.tensor(d1), torch.tensor(d2)), torch.tensor(ref),
                             torch.tensor(ks), torch.tensor(ksh), torch.tensor(kr))
    assert rel(e, jax_e) <= OP_TOL
    strains = name.replace("energy", "strains")
    for a, b in zip(getattr(bonds, strains)(torch.tensor(d1), torch.tensor(d2), torch.tensor(ref)),
                    getattr(jax_bonds, strains)(jnp.asarray(d1), jnp.asarray(d2),
                                                jnp.asarray(ref))):
        assert rel(a, b) <= OP_TOL


def _energy_pair(kind):
    """(port energy, JAX energy, port params, JAX params, n_blocks) of a
    4 x 2-cell rotated-square lattice at 0.6 rad (voids of 0.37 rad) with contact between 0
    and 30 degrees (so that it is engaged at the probe states)."""

    geo, jgeo = RotatedSquareGeometry(4, 2), JaxRotatedSquareGeometry(4, 2)
    bc, cnv, bonds_fn, rbv = geo.get_parametrization()
    jbc, jcnv, jbonds, jrbv = jgeo.get_parametrization()
    n1, n2 = geo.n1_blocks, geo.n2_blocks
    if kind == "strain":
        port = build_strain_energy(bonds_fn(), bonds.ligament_energy)
        ref = jax_build_strain_energy(jbonds(), jax_bonds.ligament_energy)
    elif kind == "strain+contact":
        port = combine_block_energies(build_strain_energy(bonds_fn(), bonds.ligament_energy),
                                      build_contact_energy(bonds_fn()))
        jax_strain = jax_build_strain_energy(jbonds(), jax_bonds.ligament_energy)
        jax_contact = jax_build_contact_energy(jbonds())

        def ref(u, cp):
            return jax_strain(u, cp) + jax_contact(u, cp)
    else:
        port = build_quad_grid_energy(n1, n2, bonds.ligament_energy,
                                      use_contact=kind == "grid+contact")
        ref = jax_build_quad_grid_energy(n1, n2, jax_bonds.ligament_energy,
                                         use_contact=kind == "grid+contact")
    cut = math.radians(30.0)
    cp = ControlParams(GeometricalParams(bc(0.6), cnv(0.6)),
                       MechanicalParams(LigamentParams(1.0, 0.02, 1e-3, rbv()), 1.0,
                                        contact_params=ContactParams(0.0, cut, 1.0)))
    jcp = JaxControlParams(JaxGeometricalParams(jbc(0.6), jcnv(0.6)),
                           JaxMechanicalParams(JaxLigamentParams(1.0, 0.02, 1e-3, jrbv()), 1.0,
                                               contact_params=JaxContactParams(0.0, cut, 1.0)))
    return port, ref, cp, jcp, geo.n_blocks


@pytest.mark.parametrize("kind", ["strain", "strain+contact", "grid", "grid+contact"])
def test_energy_and_force_match_jax(kind):
    port, ref, cp, jcp, nb = _energy_pair(kind)
    u = 0.1 * np.random.default_rng(2).standard_normal((nb, 3))
    ut = torch.tensor(u, requires_grad=True)
    e = port(ut, cp)
    (f,) = torch.autograd.grad(e, ut)
    je, jf = jax.value_and_grad(lambda x: ref(x, jcp))(jnp.asarray(u))
    assert abs(float(e) - float(je)) <= OP_TOL * abs(float(je))
    assert rel(f, jf) <= OP_TOL
    if "contact" in kind:  # the barrier is engaged at this state
        no_contact = _energy_pair(kind.split("+")[0])[0]
        assert float(e) > float(no_contact(ut, cp)) + 1e-6


def test_grid_energy_equals_the_bond_list_energy():
    grid, _, cp, _, nb = _energy_pair("grid+contact")
    general = _energy_pair("strain+contact")[0]
    u = torch.tensor(0.1 * np.random.default_rng(3).standard_normal((nb, 3)))
    assert abs(float(grid(u, cp)) - float(general(u, cp))) <= OP_TOL * float(general(u, cp))


# ---------------------------------------------------------------------------
# reference_design
# ---------------------------------------------------------------------------

#: pulse_forward.json cut in time: 9 timepoints over 1.2 s (the pulse's
#: first half), 10 substeps each as in the file.
CUT = dict(n_timepoints=9, simulation_time=1.2)


def _jax_reference_design(method, **overrides):
    forward = dict(lc.PULSE_FORWARD_CONFIG["forward"], method=method, **overrides)
    problem = jax_reference_design.ForwardProblem(**forward)
    problem.setup()
    return np.asarray(jax.jit(lambda: problem.solve().fields)())


def test_pulse_forward_config_is_the_file():
    with open(REPO / "examples" / "configs" / "pulse_forward.json") as f:
        assert json.load(f) == lc.PULSE_FORWARD_CONFIG


def test_pulse_example_constants_are_the_example():
    source = (REPO / "examples" / "pulse_rotated_squares.py").read_text()
    assert "RotatedSquareGeometry(n1_cells=10, n2_cells=5, spacing=1.0)" in source
    assert "angle = 0.25" in source and "n_substeps=16" in source
    assert "LigamentParams(1.0, 0.02, 1e-3, rbv())" in source
    assert "density=1.0" in source and "damping=0.02" in source
    assert "loading_params=dict(amplitude=0.5, rate=0.5)" in source
    assert "jnp.linspace(0.0, 20.0, 100)" in source
    assert re.search(r"jnp\.sin\(jnp\.pi \* rate \* t\) \*\* 2", source)


@pytest.mark.parametrize("method", ["verlet", "verlet_ckpt"])
def test_reference_design_matches_jax(method):
    ref = _jax_reference_design(method, **CUT)
    problem = lc.reference_design_problem("cpu", method=method, **CUT)
    with torch.no_grad():
        got = problem.solve().fields
    assert got.shape == (9, 2, 200, 3) and float(np.abs(ref).max()) > 1e-2
    assert rel(got, ref) <= TRAJ_TOL


def test_reference_design_round_trips_through_the_converter():
    forward = dict(lc.PULSE_FORWARD_CONFIG["forward"], **CUT)
    jax_problem = jax_reference_design.ForwardProblem(**forward)
    port = forward_problem_from_jax_dict(jax_problem.to_dict(), device="cpu")
    assert port.method == "verlet" and port.grid_energy and port.name == "reference_design"
    assert port == reference_design_from_config(forward, device="cpu")
    angle = design_from_numpy(np.float64(forward["initial_angle"]), device="cpu")
    assert angle.ndim == 0 and angle.dtype == torch.float64
    params = loading_params_from_numpy(dict(amplitude=0.5, rate=np.array(0.25)), device="cpu")
    assert {k: float(v) for k, v in params.items()} == dict(amplitude=0.5, rate=0.25)
    assert all(v.dtype == torch.float64 for v in params.values())
    # The dense "verlet" takes the model's guard (ported in the solver
    # remnants slice): it sets up, and each solve records its decisions.
    guarded = reference_design_from_config(forward, device="cpu", guard="auto")
    guarded.setup()
    assert guarded.solve_dynamics.decisions == []


def test_reference_design_angle_gradient_through_the_fast_path():
    problem = lc.reference_design_problem("cpu", method="verlet_ckpt", n_timepoints=3,
                                          simulation_time=0.6)
    angle = torch.tensor(problem.initial_angle, dtype=torch.float64, requires_grad=True)
    fields = problem.solve(angle).fields
    (g,) = torch.autograd.grad(torch.sum(fields[:, 1] ** 2), angle)
    dense = lc.reference_design_problem("cpu", method="verlet", n_timepoints=3,
                                        simulation_time=0.6)
    angle2 = angle.detach().clone().requires_grad_()
    (g2,) = torch.autograd.grad(torch.sum(dense.solve(angle2).fields[:, 1] ** 2), angle2)
    assert torch.isfinite(g) and abs(float(g - g2)) <= 1e-9 * abs(float(g2))


# ---------------------------------------------------------------------------
# The JAX references of models/loaded_configs.py
# ---------------------------------------------------------------------------


def _jax_pulse():
    """The pulse example's kinetic energy at the last timepoint and its
    gradient wrt (angle, amplitude, rate), JAX ``verlet_ckpt`` at float64."""

    p = lc.PULSE
    geo = JaxRotatedSquareGeometry(p["n1_cells"], p["n2_cells"], spacing=p["spacing"])
    bc, cnv, bonds_fn, rbv = geo.get_parametrization()
    rows = np.array([geo.n2_blocks // 2 - 1, geo.n2_blocks // 2])
    pairs = np.stack([rows * geo.n1_blocks, np.zeros_like(rows)], axis=1)

    def loading(state, t, amplitude, rate):
        return amplitude * jnp.where((t > 0) & (t < 1 / rate), jnp.sin(jnp.pi * rate * t) ** 2,
                                     0.0)

    solve = jax_setup_dynamic_solver(
        geometry=geo, energy_fn=jax_build_strain_energy(bonds_fn(), jax_bonds.ligament_energy),
        loaded_block_DOF_pairs=pairs, loading_fn=loading, damped_blocks=np.arange(geo.n_blocks),
        method="verlet_ckpt", n_substeps=p["n_substeps"],
        quad_grid=dict(n1=geo.n1_blocks, n2=geo.n2_blocks, use_contact=False))

    def ke(angle, amplitude, rate):
        cp = JaxControlParams(
            geometrical_params=JaxGeometricalParams(bc(angle), cnv(angle)),
            mechanical_params=JaxMechanicalParams(
                bond_params=JaxLigamentParams(*p["bond_params"], rbv()), density=p["density"],
                damping=p["damping"]),
            loading_params=dict(amplitude=amplitude, rate=rate))
        # numpy's timepoints, the port's (jnp.linspace rounds a few of them
        # differently, by up to 4e-15).
        fields = solve(jnp.zeros((2, geo.n_blocks, 3)),
                       jnp.asarray(np.linspace(0.0, p["simulation_time"], p["n_timepoints"])), cp)
        return jax_kinetic_energy(fields[-1, 1], jax_compute_inertia(cnv(angle), p["density"]))

    value, grad = jax.jit(jax.value_and_grad(ke, argnums=(0, 1, 2)))(
        p["angle"], p["amplitude"], p["rate"])
    return float(value), tuple(float(g) for g in grad)


@pytest.mark.slow
def test_pulse_references_match_jax():
    value, grad = _jax_pulse()
    assert abs(value - lc.JAX_F64_PULSE_KE) <= REF_TOL * abs(value)
    assert max(abs(a - b) for a, b in zip(grad, lc.JAX_F64_PULSE_GRAD)) \
        <= REF_TOL * max(abs(g) for g in grad)


@pytest.mark.slow
def test_reference_design_references_match_jax():
    stats = vector_stats(_jax_reference_design("verlet_ckpt").ravel())
    ref = lc.JAX_F64_REFERENCE_DESIGN_STATS
    assert max(abs(a - b) for a, b in zip(stats, ref)) <= REF_TOL * max(abs(x) for x in ref)


def test_pulse_fused_and_dense_paths_agree():
    # The pulse's first two output intervals (32 substeps; the whole run's
    # 1,584 are the chip's, against the recorded JAX values) through the
    # fused path and through the dense one.
    problem = lc.pulse_problem("cpu", method="auto")
    dense = lc.pulse_problem("cpu", method="verlet")
    cut = tuple(x[:3] if i == 3 else x for i, x in enumerate(problem))
    cut_dense = tuple(x[:3] if i == 3 else x for i, x in enumerate(dense))
    with torch.no_grad():
        inputs = lc.pulse_inputs("cpu")
        a, fa = lc.pulse_kinetic_energy(cut, *inputs)
        b, fb = lc.pulse_kinetic_energy(cut_dense, *inputs)
    assert float(a) > 0 and rel(fa, fb) <= TRAJ_TOL
