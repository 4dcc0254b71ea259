"""The JAX package's float64 results for the port's statics and
linear-analysis tests (``tests/test_torch_statics.py``,
``test_torch_hinge.py``, ``test_torch_continuation.py``,
``test_torch_modal_frequency.py``, ``test_torch_bloch_homogenize.py``) and
for ``chip_smoke.py`` main path 14.

``analysis_small`` (``tests/data/analysis_small.npz``): small cases of each
module (the static compression curve of ``examples/static_compression_curve.py``
on its 4 x 3 cells, hinge samples of 1 x 2 cells through ``"verlet_ckpt"``
and ``"static"``, a 4 x 3 quad sample, the continuation example, a 3 x 2
strip's modes and transmission, the Bloch and homogenization examples at
few k-points), with the Newton iterations of every static solve (a copy of
the JAX solver's loop that counts, the same operations). ``constants``:
``JAX_F64_*`` of ``difflexmm_tpu_torch/models/analysis_configs.py`` at the
examples' and the flagship's sizes, printed as Python source.

From the repository's root (the first takes about 5 minutes, the second
about 15)::

    python tests/jax_analysis_references.py [analysis_small] [constants | hinge
        flagship_static modes analysis trajectories magnetic]

or the slow tests ``test_analysis_small_references_match_jax``
(``tests/test_torch_statics.py``) and ``test_analysis_constants_match_jax``
(``tests/test_torch_hinge.py``).
"""

import math
import sys
from pathlib import Path
from typing import NamedTuple

import numpy as np

REPO = Path(__file__).resolve().parents[1]
for path in (REPO, REPO / "examples"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from difflexmm_tpu.geometry import QuadGeometry, RotatedSquareGeometry  # noqa: E402
from difflexmm_tpu.models import base as jbase  # noqa: E402
from difflexmm_tpu.models import hinge_characterization as jh  # noqa: E402
from difflexmm_tpu.ops.assembly import (  # noqa: E402
    build_strain_energy,
    combine_block_energies,
)
from difflexmm_tpu.ops.bonds import (  # noqa: E402
    ligament_energy,
    ligament_energy_linearized,
    simple_spring_energy,
)
from difflexmm_tpu.ops.contact import build_contact_energy  # noqa: E402
from difflexmm_tpu.ops.grid import build_quad_grid_energy  # noqa: E402
from difflexmm_tpu.ops.magnetic import magnetic_dipole_energy  # noqa: E402
from difflexmm_tpu.solver import bloch  # noqa: E402
from difflexmm_tpu.solver.continuation import (  # noqa: E402
    fold_points,
    setup_arclength_solver,
)
from difflexmm_tpu.solver.frequency import harmonic_response, transmission  # noqa: E402
from difflexmm_tpu.solver.homogenize import (  # noqa: E402
    effective_moduli,
    effective_stress,
    engineering_constants,
)
from difflexmm_tpu.solver.modal import linear_mode_analysis  # noqa: E402
from difflexmm_tpu.solver.statics import setup_static_solver  # noqa: E402
from difflexmm_tpu.utils import (  # noqa: E402
    ContactParams,
    ControlParams,
    GeometricalParams,
    LigamentParams,
    MechanicalParams,
)

from difflexmm_tpu_torch.models import analysis_configs as ac  # noqa: E402
from difflexmm_tpu_torch.models import flagship as fl  # noqa: E402

# ---------------------------------------------------------------------------
# The small cases (CPU tests)
# ---------------------------------------------------------------------------

#: The static compression curve (``examples/static_compression_curve.py``,
#: its 4 x 3 cells and contact), at 11 squeezes in place of 31.
COMPRESSION = dict(n1_cells=4, n2_cells=3, angle=0.25, squeezes=(0.0, 0.30, 11),
                   ligament=(1.0, 0.3, 0.05), contact=(0.08, 0.6, 1.0))
#: Hinge samples of 1 x 2 cells (2 x 4 blocks): the example's physics, 7
#: timepoints.
HINGE_SMALL = dict(n1_cells=1, n2_cells=2, n_timepoints=7)
#: A 4 x 3 quad sample with seeded shifts, static tension at 8% strain.
QUADS_SMALL = dict(n1_blocks=4, n2_blocks=3, seed=7, scale=0.03, n_timepoints=6,
                   amplitude=0.08 * 2)
#: A 3 x 2-cell strip of the transmission example, 12 frequencies; its
#: modes with constrained pairs.
STRIP_SMALL = dict(cells=(3, 2), omegas=(0.3, 10.0, 12))
STRIP_PAIRS = np.array([[0, 0], [0, 1], [0, 2], [5, 1]])
#: A 4 x 3 quad lattice with the contact grid energy, for the Hessian of
#: the energy the flagship's modes use.
MODES_SMALL = dict(n1_blocks=4, n2_blocks=3, seed=3, scale=0.04)
#: A few wave vectors of the kagome path and Bloch settings.
KAGOME_KS_SMALL = slice(0, None, 9)
WAVEGUIDE_SMALL = dict(kx=3, bz=6)
RELAX_STRAIN = 0.05
TOL, N_NEWTON, N_BACKTRACK = 1e-10, 40, 30


def newton_iterations(residual, n_blocks, free_mask, u0, t, cp):
    """``(u, iterations)``: the JAX static solver's damped Newton loop
    (``solver/statics.py:127-178``) with its iteration count returned."""

    flat_mask = jnp.asarray(free_mask).reshape(-1)

    def matrix(u):
        J = jax.jacfwd(lambda f: residual(f.reshape(n_blocks, 3), t, cp))(u).reshape(
            3 * n_blocks, 3 * n_blocks)
        return J - jnp.diag(1.0 - flat_mask)

    def norm(r):
        return jnp.max(jnp.abs(r))

    def cond(carry):
        _, rnorm, it, stalled = carry
        return (rnorm > TOL) & (it < N_NEWTON) & (~stalled)

    def body(carry):
        u, rnorm, it, _ = carry
        r = residual(u.reshape(n_blocks, 3), t, cp).reshape(-1)
        step = jnp.linalg.solve(matrix(u), -r)

        def bt_cond(c):
            return (~c[1]) & (c[2] < N_BACKTRACK)

        def bt_body(c):
            alpha, _, k = c
            ok = norm(residual((u + alpha * step).reshape(n_blocks, 3), t, cp).reshape(-1)) < rnorm
            return jnp.where(ok, alpha, alpha * 0.5), ok, k + 1

        alpha, accepted, _ = jax.lax.while_loop(
            bt_cond, bt_body, (jnp.asarray(1.0, u.dtype), jnp.asarray(False), jnp.asarray(0)))
        u_new = jnp.where(accepted, u + alpha * step, u)
        return (u_new, norm(residual(u_new.reshape(n_blocks, 3), t, cp).reshape(-1)), it + 1,
                ~accepted)

    u0 = (jnp.asarray(u0).reshape(n_blocks, 3) * free_mask).reshape(-1)
    r0 = norm(residual(u0.reshape(n_blocks, 3), t, cp).reshape(-1))
    u, _, n_it, _ = jax.lax.while_loop(cond, body, (u0, r0, jnp.asarray(0), jnp.asarray(False)))
    return u.reshape(n_blocks, 3), n_it


def ramp_iterations(solve, n_blocks, cp, ts):
    """Newton iterations of a warm-started ramp over ``ts``."""

    counter = jax.jit(lambda u, t, cp: newton_iterations(
        solve.residual, n_blocks, solve.dof_set.free_mask, u, t, cp))
    u, counts = jnp.zeros((n_blocks, 3)), []
    for t in ts:
        _, n_it = counter(u, t, cp)
        counts.append(int(n_it))
        u = solve(u, t, cp)
    return np.array(counts)


def compression_setup(ligament=None, angle=None):
    """The example's ``build`` at COMPRESSION: (geometry, energy, control
    params, pairs, drive, right column)."""

    c = COMPRESSION
    geo = RotatedSquareGeometry(c["n1_cells"], c["n2_cells"], spacing=1.0, bond_length=0.1)
    bc, cnv, bonds, rbv = geo.get_parametrization()
    angle = c["angle"] if angle is None else angle
    ligament = c["ligament"] if ligament is None else ligament
    cmin, ccut, kc = c["contact"]
    cp = ControlParams(
        geometrical_params=GeometricalParams(bc(angle), cnv(angle)),
        mechanical_params=MechanicalParams(
            bond_params=LigamentParams(*ligament, rbv()), density=1.0, damping=0.0,
            contact_params=ContactParams(k_contact=kc, min_angle=cmin, cutoff_angle=ccut)),
        constraint_params=dict(squeeze=1.0))
    energy = combine_block_energies(build_strain_energy(bonds(), ligament_energy),
                                    build_contact_energy(bonds()))
    left = np.arange(0, geo.n_blocks, geo.n1_blocks)
    right = np.arange(geo.n1_blocks - 1, geo.n_blocks, geo.n1_blocks)
    pairs = np.concatenate([np.array([[b, d] for b in left for d in range(3)]),
                            np.stack([right, np.zeros_like(right)], 1)])
    n_driven = len(right)

    def drive(t, squeeze):
        return jnp.zeros(len(pairs)).at[-n_driven:].set(-squeeze * t)

    return geo, energy, cp, pairs, drive, right


def compression_small() -> dict:
    geo, energy, cp, pairs, drive, right = compression_setup()
    solve = setup_static_solver(geo, energy, constrained_block_DOF_pairs=pairs,
                                constrained_DOFs_fn=drive)
    squeezes = jnp.linspace(*COMPRESSION["squeezes"][:2], COMPRESSION["squeezes"][2])

    def ramp(params):
        angle, k_rot = params
        _, energy_, cp_, _, _, _ = compression_setup(
            ligament=(COMPRESSION["ligament"][0], COMPRESSION["ligament"][1], k_rot), angle=angle)

        def step(u_prev, s):
            u = solve(u_prev, s, cp_)
            return u, (-solve.reactions(u, s, cp_)[-len(right):].sum(),
                       jnp.max(jnp.abs(solve.residual(u, s, cp_))), u)

        _, out = jax.lax.scan(step, jnp.zeros((geo.n_blocks, 3)), squeezes)
        return out

    params = (jnp.asarray(COMPRESSION["angle"]), jnp.asarray(COMPRESSION["ligament"][2]))
    forces, residuals, us = jax.jit(ramp)(params)
    grad = jax.jit(jax.grad(lambda p: jnp.sum(ramp(p)[0])))(params)
    return dict(compression_forces=forces, compression_residuals=residuals,
                compression_u=us, compression_grad=jnp.stack(grad),
                compression_iterations=ramp_iterations(solve, geo.n_blocks, cp, squeezes))


def hinge_jax(loading_type, method, small=True, **overrides):
    """The JAX sample of the hinge example (at HINGE_SMALL where ``small``)."""

    kwargs = dict(n1_cells=3, n2_cells=3, spacing=1.0, bond_length=0.1, initial_angle=0.22,
                  k_stretch=1.0, k_shear=0.02, k_rot=1e-3, density=1.0, damping=1.0,
                  loading_type=loading_type, amplitude=0.05, loading_rate=0.01,
                  n_timepoints=25, n_substeps=48, method=method)
    if small:
        kwargs.update(HINGE_SMALL)
    kwargs.update(overrides)
    return jh.ForwardProblem(**kwargs)


def hinge_targets(small: bool) -> dict:
    """The example's synthetic targets: the curves at the true stiffnesses
    (``"verlet_ckpt"``) with 1% multiplicative noise from
    ``default_rng(0)``, drawn problem after problem."""

    rng = np.random.default_rng(ac.HINGE_SEED)
    targets = {}
    for lt in ac.HINGE_LOADINGS:
        p = hinge_jax(lt, "verlet_ckpt", small)
        p.setup()
        u, f = p.force_displacement(*p.solve(ac.HINGE_TRUE_K))
        f_noisy = np.asarray(f) * (1 + ac.HINGE_NOISE * rng.standard_normal(np.shape(f)))
        targets[lt] = np.stack([np.asarray(u), f_noisy, ac.HINGE_NOISE * np.abs(f_noisy)])
    return targets


def static_iterations_of(problem, k):
    """Newton iterations of a JAX hinge sample's warm-started ramp, its
    static solver rebuilt with the sample's energy and drive."""

    nb = problem.geometry.n_blocks
    n1 = problem.geometry.n1_blocks
    pairs = jbase.all_dofs_pairs(np.concatenate([np.arange(nb - n1, nb), np.arange(n1)]))
    n_c = len(pairs) // 3
    vector = np.zeros(3 * n_c)
    if problem.loading_type == "tension":
        vector[n_c:n_c + n1] = 1.0
    elif problem.loading_type == "compression":
        vector[n_c:n_c + n1] = -1.0
    else:
        vector[:n1] = 1.0

    def drive(t, amplitude, loading_rate):
        return jnp.asarray(vector) * problem.applied_displacement(t, amplitude, loading_rate)

    solve = setup_static_solver(problem.geometry, problem.potential_energy,
                                constrained_block_DOF_pairs=pairs, constrained_DOFs_fn=drive)
    _, cp = problem.solve(k)
    ts = jnp.linspace(0.0, 1.0 / problem.loading_rate, problem.n_timepoints)
    return ramp_iterations(solve, nb, cp, ts)


def hinge_run(method, small=True, gd=True, targets=None) -> dict:
    """The JAX counterpart of ``analysis_configs.run_hinge``."""

    targets = hinge_targets(small) if targets is None else targets
    problems = [hinge_jax(lt, method, small) for lt in ac.HINGE_LOADINGS]
    for p in problems:
        p.setup()
    fit = jh.OptimizationProblem(problems, {lt: jnp.asarray(targets[lt])
                                            for lt in ac.HINGE_LOADINGS})
    fit.setup_objective()
    guess = tuple(jnp.asarray(x) for x in ac.HINGE_GUESS)
    value, grad = jax.jit(jax.value_and_grad(fit.objective_fn))(guess)
    out = dict(targets=targets, value=float(value), grad=np.array([float(g) for g in grad]))
    if method == "static":
        out["iterations"] = {p.loading_type: static_iterations_of(p, guess) for p in problems}
    if gd:
        design = fit.run_optimization_GD(ac.HINGE_GUESS, ac.HINGE_GD_ITERATIONS,
                                         ac.HINGE_GD_STEP)
        out["gd_values"] = np.array([float(v) for v in fit.objective_values])
        out["gd_designs"] = np.array([[float(x) for x in d] for d in fit.design_values])
        out["gd_final"] = np.array([float(x) for x in design])
    return out


def quads_small_problem():
    q = QUADS_SMALL
    rng = np.random.default_rng(q["seed"])
    geo = QuadGeometry(q["n1_blocks"], q["n2_blocks"], spacing=1.0, bond_length=0.1)
    h, v = geo.get_design_from_rotated_square(0.2)
    h = np.asarray(h) + q["scale"] * rng.standard_normal(np.shape(h))
    v = np.asarray(v) + q["scale"] * rng.standard_normal(np.shape(v))
    return dict(n1_blocks=q["n1_blocks"], n2_blocks=q["n2_blocks"], spacing=1.0,
                bond_length=0.1, horizontal_shifts=h, vertical_shifts=v, k_stretch=1.0,
                k_shear=0.05, k_rot=0.01, density=1.0, damping=1.0, loading_type="tension",
                amplitude=q["amplitude"], loading_rate=0.01, n_timepoints=q["n_timepoints"],
                method="static")


def quads_small() -> dict:
    kwargs = quads_small_problem()
    p = jh.ForwardProblemQuads(**kwargs)
    p.setup()
    k = (jnp.asarray(1.0), jnp.asarray(0.05), jnp.asarray(0.01))
    curve = p.force_displacement(*p.solve(k))
    grad = jax.grad(lambda kk: jnp.sum(p.force_displacement(*p.solve(kk))[1]))(k)
    return dict(quads_shifts_h=kwargs["horizontal_shifts"],
                quads_shifts_v=kwargs["vertical_shifts"], quads_curve=curve,
                quads_grad=jnp.stack(grad), quads_iterations=static_iterations_of(p, k))


class SpringParams(NamedTuple):
    reference_vector: jnp.ndarray
    k_stretch: jnp.ndarray


def snap_control_params(h, k=1.0) -> ControlParams:
    up = jnp.array([0.0, 1.0])
    centroids = jnp.stack([jnp.array([-1.0, 0.0]), jnp.array([1.0, 0.0]),
                           jnp.array([0.0, 0.0]) + h * up])
    refs = jnp.stack([jnp.array([1.0, 0.0]) + h * up, jnp.array([-1.0, 0.0]) + h * up])
    return ControlParams(
        geometrical_params=GeometricalParams(centroids, jnp.zeros((3, 1, 2))),
        mechanical_params=MechanicalParams(bond_params=SpringParams(refs, jnp.asarray(k)),
                                           density=1.0, damping=0.0),
        constraint_params=dict())


def snap_run() -> dict:
    trace = setup_arclength_solver(
        3, build_strain_energy(jnp.array([[0, 2], [1, 2]]), simple_spring_energy),
        loaded_block_DOF_pairs=ac.SNAP_LOADED, loading_fn=lambda state, lam, **kw: -lam,
        constrained_block_DOF_pairs=ac.SNAP_CONSTRAINED)
    zeros = jnp.zeros((3, 3))
    path = jax.jit(lambda cp: trace(zeros, 0.0, control_params=cp, compute_stability=True,
                                    **ac.SNAP_TRACE))(snap_control_params(ac.SNAP_H0))
    limit, grad = jax.jit(jax.value_and_grad(lambda h: jnp.max(trace(
        zeros, 0.0, control_params=snap_control_params(h), **ac.SNAP_LIMIT).load_factor)))(
        ac.SNAP_H0)
    return dict(snap_load_factor=path.load_factor, snap_drop=path.displacement[:, 2, 1],
                snap_stability=path.stability_eig, snap_converged=bool(jnp.all(path.converged)),
                snap_folds=fold_points(path), snap_limit=float(limit),
                snap_limit_grad=float(grad))


def strip_setup(cells):
    geo = RotatedSquareGeometry(*cells, spacing=1.0, bond_length=0.1)
    bc, cnv, bonds, rbv = geo.get_parametrization()
    s = ac.STRIP_STIFF
    return geo, bc, cnv, bonds, rbv, lambda angle, damping=0.05: ControlParams(
        geometrical_params=GeometricalParams(bc(angle), cnv(angle)),
        mechanical_params=MechanicalParams(
            bond_params=LigamentParams(s["k_stretch"], s["k_shear"], s["k_rot"], rbv()),
            density=1.0, damping=damping))


def strip_transmission(cells, omegas) -> np.ndarray:
    geo, bc, cnv, bonds, rbv, cp_of = strip_setup(cells)
    cp = cp_of(ac.STRIP_ANGLE)
    xs = np.asarray(bc(ac.STRIP_ANGLE))[:, 0]
    left = np.where(xs < xs.min() + 0.6)[0]
    right = np.where(xs > xs.max() - 0.6)[0]
    forcing = jnp.zeros((geo.n_blocks, 3)).at[jnp.asarray(left), 0].set(1.0)
    u = harmonic_response(jnp.zeros((geo.n_blocks, 3)), geo,
                          build_strain_energy(bonds(), ligament_energy_linearized), cp, forcing,
                          jnp.linspace(*omegas[:2], omegas[2]),
                          damped_blocks=np.arange(geo.n_blocks))
    return np.asarray(transmission(u, input_blocks=left, output_blocks=right))


def strip_small() -> dict:
    geo, bc, cnv, bonds, rbv, cp_of = strip_setup(STRIP_SMALL["cells"])
    energy = build_strain_energy(bonds(), ligament_energy_linearized)
    w, modes = linear_mode_analysis(jnp.zeros((geo.n_blocks, 3)), geo, energy,
                                    cp_of(ac.STRIP_ANGLE), constrained_block_DOF_pairs=STRIP_PAIRS)
    return dict(strip_transmission=strip_transmission(**STRIP_SMALL),
                strip_eigenvalues=w, strip_mode_weights=jnp.sum(modes**2, axis=-1))


def modes_small() -> dict:
    m = MODES_SMALL
    rng = np.random.default_rng(m["seed"])
    geo = QuadGeometry(m["n1_blocks"], m["n2_blocks"], spacing=1.0, bond_length=0.1)
    bc, cnv, bonds, rbv = geo.get_parametrization()
    h, v = geo.get_design_from_rotated_square(0.25)
    h = np.asarray(h) + m["scale"] * rng.standard_normal(np.shape(h))
    v = np.asarray(v) + m["scale"] * rng.standard_normal(np.shape(v))
    cp = ControlParams(
        geometrical_params=GeometricalParams(bc(h, v), cnv(h, v)),
        mechanical_params=MechanicalParams(
            bond_params=LigamentParams(1.0, 0.05, 0.01, rbv()), density=1.0, damping=0.0,
            contact_params=ContactParams(min_angle=0.0, cutoff_angle=0.6, k_contact=0.01)))
    pairs = jbase.clamped_corner_pairs(m["n1_blocks"], m["n2_blocks"], 1)
    u0 = 0.01 * rng.standard_normal((geo.n_blocks, 3))
    w, modes = linear_mode_analysis(u0, geo, build_quad_grid_energy(m["n1_blocks"],
                                                                   m["n2_blocks"]),
                                    cp, constrained_block_DOF_pairs=pairs)
    return dict(modes_shifts_h=h, modes_shifts_v=v, modes_u0=u0, modes_eigenvalues=w,
                modes_weights=jnp.sum(modes**2, axis=-1))


def kagome_ks():
    cell = bloch.kagome_periodic_cell()
    b = np.asarray(bloch.reciprocal_basis(cell.direct_basis))
    return bloch.high_symmetry_path([np.zeros(2), b[0] / 2, (b[0] + b[1]) / 3, np.zeros(2)],
                                    ac.KAGOME_PATH_N)[0]


def kagome_gap(shifts, ks):
    omega_sq = bloch.band_structure(bloch.kagome_periodic_cell(shifts=shifts), ks)
    lo, hi = ac.KAGOME_BANDS
    return (-jax.scipy.special.logsumexp(-omega_sq[:, hi])
            - jax.scipy.special.logsumexp(omega_sq[:, lo]))


def poisson_run(h0, v0) -> dict:
    def nu_of(h, v):
        c = bloch.quad_periodic_cell(h, v, spacing=1.0, bond_length=0.1, k_stretch=1.0,
                                     k_shear=1.0, k_rot=5e-3)
        return engineering_constants(effective_moduli(c))["nu_xy"]

    nu = nu_of(jnp.asarray(h0), jnp.asarray(v0))
    loss, grads = jax.value_and_grad(lambda hv: (nu_of(*hv) - ac.POISSON_TARGET) ** 2)(
        (jnp.asarray(h0), jnp.asarray(v0)))
    return dict(nu=float(nu), loss=float(loss),
                grad=np.concatenate([np.asarray(g).ravel() for g in grads]))


def waveguide_run(n_kx=ac.WAVEGUIDE_KX, n_bz=ac.WAVEGUIDE_BZ) -> dict:
    base_cell = bloch.rotated_square_cell(angle=0.25, k_stretch=1.0, k_shear=0.3, k_rot=0.05)
    P = ac.WAVEGUIDE_PERIOD
    om_bulk = bloch.frequencies(bloch.band_structure(base_cell, bloch.bz_grid(base_cell, n_bz,
                                                                              n_bz)))
    gap_lo = float(np.asarray(om_bulk.max(axis=0))[:4].max())
    gap_hi = float(np.asarray(om_bulk.min(axis=0))[4:].min())
    target = 0.5 * (gap_lo + gap_hi)
    b = bloch.reciprocal_basis(base_cell.direct_basis)
    kx = jnp.linspace(0.0, 0.5, n_kx)
    ks = jnp.stack([kx * b[0, 0], jnp.zeros_like(kx)], axis=1)
    guide = bloch.line_defect_cell(base_cell, P, k_rot=ac.WAVEGUIDE_K_ROT)
    om_sq, modes = bloch.band_structure(guide, ks, with_modes=True)
    om = np.asarray(bloch.frequencies(om_sq))
    band = np.argmin(np.abs(om - target), axis=1)
    loc = np.asarray(bloch.mode_localization(guide, modes, P))
    rows = np.arange(n_kx)
    mid = P // 2
    weight = sum(loc[rows, r, band] for r in (mid - 1, mid, (mid + 1) % P))
    k_op = jnp.array([0.3 * float(b[0, 0]), 0.0])

    def guided(x):
        om_op = bloch.frequencies(bloch.band_structure(
            bloch.line_defect_cell(base_cell, P, k_rot=jnp.exp(x)), k_op[None]))[0]
        return om_op[jnp.argmin(jnp.abs(om_op - target))]

    value, grad = jax.value_and_grad(guided)(jnp.log(ac.WAVEGUIDE_K_ROT))
    return dict(gap=np.array([gap_lo, gap_hi]), guided=om[rows, band], weight=weight,
                guided_op=float(value), guided_op_grad=float(grad))


def bloch_small() -> dict:
    out = {}
    ks = kagome_ks()[KAGOME_KS_SMALL]
    shifts = jnp.array([[0.02, 0.01], [-0.01, 0.03], [0.0, -0.02]])
    value, grad = jax.value_and_grad(kagome_gap)(shifts, ks)
    out.update(kagome_ks=ks, kagome_shifts=shifts, kagome_gap=value, kagome_gap_grad=grad)
    rs = bloch.rotated_square_cell(0.25, k_stretch=1.0, k_shear=0.3, k_rot=0.05)
    F = (1.0 - RELAX_STRAIN) * jnp.eye(2)
    u = bloch.relax_cell(rs, affine=F)
    rs_ks = bloch.high_symmetry_path([[0.0, 0.0], [np.pi, 0.0], [np.pi, np.pi], [0.0, 0.0]],
                                     4)[0]
    out.update(relax_u=u, relax_bands=bloch.band_structure(rs, rs_ks, displacement=u, affine=F),
               rs_ks=rs_ks)
    # The relaxed rotation's derivative in the strain (relax_cell's adjoint).
    out["relax_grad"] = jax.grad(lambda e: bloch.relax_cell(
        rs, affine=(1.0 - e) * jnp.eye(2))[0, 2])(RELAX_STRAIN)
    om, vg = bloch.group_velocity(rs, rs_ks[1:4])
    out.update(group_omega=om, group_velocity=vg)
    chain = bloch.spring_chain_cell(k_stretch=2.0)
    chain_ks = jnp.stack([jnp.linspace(0.1, 3.0, 5), jnp.zeros(5)], axis=1)
    out["chain_bands"] = bloch.band_structure(chain, chain_ks, bond_energy_fn=simple_spring_energy)
    grid = bloch.bz_grid(rs, 4, 4)
    out.update(bz_grid=grid, dos=bloch.density_of_states(
        bloch.frequencies(bloch.band_structure(rs, grid)), jnp.linspace(0.0, 3.0, 9), 0.2))
    sc = bloch.supercell(bloch.quad_periodic_cell(
        0.01 * jnp.ones((2, 1, 2)), -0.01 * jnp.ones((2, 1, 2))), 1, 2)
    out["supercell_bands"] = bloch.band_structure(sc, rs_ks[:3])
    wg = waveguide_run(WAVEGUIDE_SMALL["kx"], WAVEGUIDE_SMALL["bz"])
    out.update({f"waveguide_{k}": v for k, v in wg.items()})
    rs_h = bloch.rotated_square_cell(angle=0.25, k_stretch=1.0, k_shear=1.0, k_rot=1e-2)
    C = effective_moduli(rs_h)
    ec = engineering_constants(C)
    out.update(moduli=C, moduli_affine=effective_moduli(rs_h, condense=False),
               engineering=np.array([float(ec[k]) for k in ("E_x", "E_y", "nu_xy", "nu_yx",
                                                            "G_xy")]),
               stress=effective_stress(rs_h, 0.98 * jnp.eye(2)))
    h0 = 0.02 * np.random.default_rng(0).standard_normal((2, 2, 2))
    v0 = 0.02 * np.random.default_rng(1).standard_normal((2, 2, 2))
    pr = poisson_run(h0, v0)
    out.update(poisson_h0=h0, poisson_v0=v0, poisson_nu=pr["nu"], poisson_grad=pr["grad"])
    return out


def analysis_small() -> dict:
    out = {}
    out.update(compression_small())
    for method in ("verlet_ckpt", "static"):
        run = hinge_run(method, small=True, targets=None if method == "verlet_ckpt"
                        else out_targets)
        if method == "verlet_ckpt":
            out_targets = run["targets"]
            for lt in ac.HINGE_LOADINGS:
                out[f"hinge_targets_{lt}"] = run["targets"][lt]
        for key in ("value", "grad", "gd_values", "gd_designs", "gd_final"):
            out[f"hinge_{method}_{key}"] = run[key]
        for lt, counts in run.get("iterations", {}).items():
            out[f"hinge_static_iterations_{lt}"] = counts
    for part in (quads_small, snap_run, strip_small, modes_small, bloch_small):
        jax.clear_caches()  # see constants()
        out.update(part())
    return {k: np.asarray(v) for k, v in out.items()}


# ---------------------------------------------------------------------------
# The constants of models/analysis_configs.py (chip_smoke.py main path 14)
# ---------------------------------------------------------------------------


def flagship_jax(n_substeps=10, guard=None):
    """The JAX flagship problem (``bench.py``'s configuration through the
    port's copy of it), method ``"verlet_ckpt"``, at the 25-degree design."""

    from difflexmm_tpu.models import quads_focusing as jq

    config = fl.paper_config(method="verlet_ckpt", n_substeps=n_substeps, guard=guard)
    for key in ("device", "dtype"):
        config.pop(key)
    problem = jq.ForwardProblem(**config)
    problem.setup()
    design = problem.geometry.get_design_from_rotated_square(25 * math.pi / 180)
    return problem, design


def constants_hinge() -> dict:
    out = {}
    targets = hinge_targets(small=False)
    out["HINGE_TARGETS"] = {lt: targets[lt][:2] for lt in ac.HINGE_LOADINGS}
    for method in ("verlet_ckpt", "static"):
        run = hinge_run(method, small=False, gd=method == "verlet_ckpt", targets=targets)
        run.pop("targets")
        out[f"HINGE_{method.upper()}"] = run
    return out


def constants_flagship_static() -> dict:
    """(b) The flagship lattice in static tension, one load step at a time
    (a compiled ramp of 1,152-DOF Jacobians takes tens of GB to compile)."""

    config = fl.paper_config()
    spacing = config["spacing"]
    geo = QuadGeometry(config["n1_blocks"], config["n2_blocks"], spacing=spacing,
                       bond_length=config["bond_length"])
    h, v = geo.get_design_from_rotated_square(25 * math.pi / 180)
    p = jh.ForwardProblemQuads(
        n1_blocks=config["n1_blocks"], n2_blocks=config["n2_blocks"], spacing=spacing,
        bond_length=config["bond_length"], horizontal_shifts=h, vertical_shifts=v,
        k_stretch=config["k_stretch"], k_shear=config["k_shear"], k_rot=config["k_rot"],
        density=config["density"], damping=1.0, loading_type="tension",
        amplitude=0.05 * config["n2_blocks"] / 6 * spacing, loading_rate=0.01,
        n_timepoints=ac.FLAGSHIP_STATIC_STEPS + 1, use_contact=True,
        k_contact=config["k_contact"], min_angle=config["min_angle"],
        cutoff_angle=config["cutoff_angle"], method="static")
    p.setup()
    k = tuple(jnp.asarray(float(x)) for x in (config["k_stretch"], config["k_shear"],
                                              config["k_rot"]))
    curve = p.force_displacement(*p.solve(k))
    grad = jax.grad(lambda kk: jnp.sum(p.force_displacement(*p.solve(kk))[1]))(k)
    return {"FLAGSHIP_STATIC": dict(curve=np.asarray(curve),
                                    grad=np.array([float(g) for g in grad]),
                                    iterations=static_iterations_of(p, k))}


def constants_modes() -> dict:
    """(c) The flagship's lowest modes."""

    problem, design = flagship_jax()
    driven, _ = jbase.driven_side_pairs(problem.n1_blocks, problem.n2_blocks,
                                        problem.n_excited_blocks, problem.loaded_side,
                                        problem.input_shift)
    pairs = np.concatenate([driven, jbase.clamped_corner_pairs(
        problem.n1_blocks, problem.n2_blocks, problem.n_blocks_clamped_corner)])
    bc, cnv, _, rbv = problem.geometry.get_parametrization()
    cp = ControlParams(
        geometrical_params=GeometricalParams(bc(*design), cnv(*design)),
        mechanical_params=MechanicalParams(
            bond_params=LigamentParams(problem.k_stretch, problem.k_shear, problem.k_rot, rbv()),
            density=problem.density, damping=problem.damping,
            contact_params=ContactParams(min_angle=problem.min_angle,
                                         cutoff_angle=problem.cutoff_angle,
                                         k_contact=problem.k_contact)))
    w, _ = linear_mode_analysis(jnp.zeros((problem.geometry.n_blocks, 3)), problem.geometry,
                                build_quad_grid_energy(problem.n1_blocks, problem.n2_blocks), cp,
                                constrained_block_DOF_pairs=pairs)
    return {"FLAGSHIP_MODES": np.asarray(w[:ac.N_MODES])}


def constants_analysis() -> dict:
    """(d) - (f)."""

    out = {}
    snap = snap_run()
    out["SNAP"] = {k[len("snap_"):]: v for k, v in snap.items()}
    out["TRANSMISSION"] = strip_transmission(ac.STRIP_CELLS, ac.STRIP_OMEGAS)
    cell = bloch.rotated_square_cell(ac.STRIP_ANGLE, **ac.STRIP_STIFF)
    b = bloch.reciprocal_basis(cell.direct_basis)
    frac = jnp.linspace(-0.5, 0.5, ac.BLOCH_GRID)
    ks = jnp.stack(jnp.meshgrid(frac, frac), -1).reshape(-1, 2) @ b
    omega = np.asarray(bloch.frequencies(bloch.band_structure(cell, ks)))
    gaps = [(float(omega[:, j].max()), float(omega[:, j + 1].min()))
            for j in range(omega.shape[1] - 1) if omega[:, j + 1].min() > omega[:, j].max()]
    out["BLOCH_GAP"] = max(gaps, key=lambda g: g[1] - g[0])
    value, grad = jax.value_and_grad(kagome_gap)(jnp.asarray(ac.KAGOME_SHIFTED), kagome_ks())
    out["KAGOME_GAP"] = dict(value=float(value), grad=np.asarray(grad).ravel())
    ec = engineering_constants(effective_moduli(bloch.rotated_square_cell(
        angle=0.25, k_stretch=1.0, k_shear=1.0, k_rot=ac.EFFECTIVE_K_ROT)))
    out["EFFECTIVE_ROW"] = np.array([float(ec[k]) for k in ("E_x", "nu_xy", "G_xy")])
    key = jax.random.PRNGKey(0)
    h0 = np.asarray(0.02 * jax.random.normal(key, (2, 2, 2)))
    v0 = np.asarray(0.02 * jax.random.normal(jax.random.fold_in(key, 1), (2, 2, 2)))
    out["POISSON_H0"], out["POISSON_V0"] = h0, v0
    out["POISSON"] = poisson_run(h0, v0)
    out["WAVEGUIDE"] = waveguide_run()
    return out


def constants_trajectories() -> dict:
    """(g) The n = 5 rescue's trajectories (unguarded, and the travel-only
    guard at one level), their tunneling reports, and the xcorr of the
    flagship's field against the rescued one."""

    from difflexmm_tpu.objectives import compute_space_time_xcorr
    from difflexmm_tpu.solver.diagnose import contact_tunneling_report

    out = {}
    fields = {}
    for name, n, guard in (("flagship", 10, None), ("n5_plain", fl.RESCUE_N5_SUBSTEPS, None),
                           ("n5_guarded", fl.RESCUE_N5_SUBSTEPS,
                            fl.RESCUE_N5_GUARDS["levels1"])):
        problem, design = flagship_jax(n, guard)
        sol = problem.solve(design)
        fields[name] = (np.asarray(sol.fields), np.asarray(sol.timepoints), problem)
    out["TUNNELING"] = {}
    for name in ("n5_plain", "n5_guarded"):
        f, ts, problem = fields[name]
        report = contact_tunneling_report(f, ts, fl.RESCUE_N5_SUBSTEPS, problem.min_angle,
                                          problem.cutoff_angle)
        out["TUNNELING"][name] = dict(first_nonfinite=report.first_nonfinite,
                                      risky=np.nonzero(np.asarray(report.risky_intervals))[0])

    def space_time(f):
        return jnp.linalg.norm(jnp.asarray(f)[:, 0, :, :2], axis=-1).T

    value, delay = compute_space_time_xcorr(space_time(fields["flagship"][0]),
                                            space_time(fields["n5_guarded"][0]))
    out["XCORR"] = (float(value), int(delay))
    return out


def constants_magnetic() -> dict:
    positions, rotations, angles, strengths = (np.asarray(x.cpu()) for x in
                                               ac.magnetic_state(device="cpu"))
    energy, grads = jax.value_and_grad(
        lambda p, r: magnetic_dipole_energy(p, r, jnp.asarray(angles), jnp.asarray(strengths),
                                            prefactor=ac.MAGNETIC_PREFACTOR,
                                            min_distance=ac.MAGNETIC_MIN_DISTANCE),
        argnums=(0, 1))(jnp.asarray(positions), jnp.asarray(rotations))
    return {"MAGNETIC": dict(energy=float(energy), grad_stats=fl.vector_stats(
        np.concatenate([np.asarray(g).ravel() for g in grads])))}


#: The constants' parts, each computed on its own (``constants(parts)``).
CONSTANT_PARTS = {"hinge": constants_hinge, "flagship_static": constants_flagship_static,
                  "modes": constants_modes, "analysis": constants_analysis,
                  "trajectories": constants_trajectories, "magnetic": constants_magnetic}


def constants(parts=None) -> dict:
    out = {}
    for name in parts or CONSTANT_PARTS:
        out.update(CONSTANT_PARTS[name]())
        # Every XLA executable keeps memory maps: dropping them between
        # parts keeps one process under the kernel's map count limit.
        jax.clear_caches()
    return out


def main(argv):
    import pprint

    names = argv or ["analysis_small", "constants"]
    if "analysis_small" in names:
        from jax_references import record_or_check

        record_or_check("analysis_small", analysis_small())
        print("tests/data/analysis_small.npz written or checked")
    parts = [n for n in names if n in CONSTANT_PARTS] or (
        list(CONSTANT_PARTS) if "constants" in names else [])
    for part in parts:
        pprint.pprint(constants([part]), width=100)


if __name__ == "__main__":
    main(sys.argv[1:])
