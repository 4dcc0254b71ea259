"""Configurations of the statics and linear-analysis slice, at the sizes of
the example scripts and of the flagship, shared by ``chip_smoke.py`` main
path 14 and the CPU tests, with the JAX package's float64 results.

- ``hinge_*``: ``examples/hinge_characterization_fit.py``: rotated-square
  samples of 3 x 3 cells in tension and shear, 25 timepoints, 48 substeps,
  fitted from the guess ``HINGE_GUESS`` against curves made from
  ``HINGE_TRUE_K`` with 1% multiplicative noise (``default_rng(0)``); the
  squared error, its gradient and two ``run_optimization_GD`` iterations.
- ``flagship_static_*``: ``ForwardProblemQuads`` on the flagship lattice
  (24 x 16 quads, 1,152 DOFs, its 25-degree design and physics) in
  tension at the example's nominal strain (0.05 of the sample's height of
  6 spacings: an amplitude of 0.05 x 16/6 spacings), ``method="static"``,
  8 load steps after the unloaded state.
- ``flagship_modes``: the lowest 20 eigenvalues of the flagship at its
  design with its constrained pairs (clamped corners, driven strip).
- ``snap_*``: the von Mises truss of ``examples/snap_through_continuation.py``.
- ``strip_*`` / ``bloch_gap``: ``examples/transmission_spectrum.py``.
- ``kagome_gap``, ``effective_row``, ``poisson``, ``waveguide``:
  ``examples/dispersion_design.py``, ``effective_properties_design.py`` and
  ``defect_waveguide.py``.
- ``magnetic_state``: seeded dipoles and displacements on the flagship's
  blocks.

The constants ``JAX_F64_*`` were made by the JAX package at float64 on the
CPU by ``python tests/jax_analysis_references.py constants``; the slow
test ``tests/test_torch_hinge.py::test_analysis_constants_match_jax``
makes them again and checks them.
"""

import math
import time
from typing import NamedTuple

import numpy as np
import torch

from difflexmm_tpu_torch.geometry.quad import QuadGeometry, RotatedSquareGeometry
from difflexmm_tpu_torch.models import base, flagship
from difflexmm_tpu_torch.models.hinge_characterization import (
    ForwardProblem,
    ForwardProblemQuads,
    OptimizationProblem,
)
from difflexmm_tpu_torch.ops.assembly import build_strain_energy
from difflexmm_tpu_torch.ops.bonds import ligament_energy_linearized, simple_spring_energy
from difflexmm_tpu_torch.ops.grid import build_quad_grid_energy
from difflexmm_tpu_torch.ops.magnetic import magnetic_dipole_energy
from difflexmm_tpu_torch.solver import bloch
from difflexmm_tpu_torch.solver.continuation import fold_points, setup_arclength_solver
from difflexmm_tpu_torch.solver.frequency import harmonic_response, transmission
from difflexmm_tpu_torch.solver.homogenize import effective_moduli, engineering_constants
from difflexmm_tpu_torch.solver.modal import linear_mode_analysis
from difflexmm_tpu_torch.utils.types import (
    ControlParams,
    GeometricalParams,
    LigamentParams,
    MechanicalParams,
)

# ---------------------------------------------------------------------------
# (a) Hinge characterization
# ---------------------------------------------------------------------------

HINGE_TRUE_K = (1.0, 0.018, 1.2e-3)
HINGE_GUESS = (1.4, 0.03, 2e-3)
HINGE_LOADINGS = ("tension", "shear")
HINGE_NOISE, HINGE_SEED = 0.01, 0
#: ``run_optimization_GD``: two iterations of this step.
HINGE_GD_ITERATIONS = 2
HINGE_GD_STEP = 0.05


def hinge_problem(loading_type, method="verlet_pallas", device="cuda", dtype=torch.float64,
                  **overrides) -> ForwardProblem:
    """The example's sample (its ``make_problem``), with ``method``."""

    kwargs = dict(n1_cells=3, n2_cells=3, spacing=1.0, bond_length=0.1, initial_angle=0.22,
                  k_stretch=1.0, k_shear=0.02, k_rot=1e-3, density=1.0, damping=1.0,
                  loading_type=loading_type, amplitude=0.05, loading_rate=0.01,
                  n_timepoints=25, n_substeps=48, method=method, device=device, dtype=dtype)
    kwargs.update(overrides)
    return ForwardProblem(**kwargs)


def hinge_fit(method="verlet_pallas", device="cuda", dtype=torch.float64, targets=None,
              **overrides) -> OptimizationProblem:
    """The example's fit of both samples against ``targets`` (default the
    JAX package's recorded noisy curves), its objective set up."""

    targets = JAX_F64_HINGE_TARGETS if targets is None else targets
    problems = [hinge_problem(lt, method, device, dtype, **overrides) for lt in HINGE_LOADINGS]
    fit = OptimizationProblem(problems, {lt: np.asarray(targets[lt]) for lt in HINGE_LOADINGS})
    fit.setup_objective()
    return fit


def run_hinge(method="verlet_pallas", device="cuda", dtype=torch.float64, gd=True,
              targets=None, **overrides) -> dict:
    """The squared error at the guess, its gradient, (``gd``) two GD
    iterations, and with ``method="static"`` the Newton iterations of
    every load step of each sample's value solve."""

    fit = hinge_fit(method, device, dtype, targets, **overrides)
    k = tuple(torch.tensor(x, dtype=dtype, device=device, requires_grad=True)
              for x in HINGE_GUESS)
    value = fit.objective_fn(k)
    out = dict(value=float(value.detach()),
               grad=np.array([float(g) for g in torch.autograd.grad(value, k)]))
    if method == "static":
        out["iterations"] = {p.loading_type: list(p.solve_equilibrium.iterations)
                             for p in fit.forward_problems}
    if gd:
        design = fit.run_optimization_GD(HINGE_GUESS, HINGE_GD_ITERATIONS, HINGE_GD_STEP)
        out["gd_values"] = np.array(fit.objective_values)
        out["gd_designs"] = np.array([[float(x) for x in d] for d in fit.design_values])
        out["gd_final"] = np.array([float(x) for x in design])
    return out


# ---------------------------------------------------------------------------
# (b) Statics on the flagship lattice
# ---------------------------------------------------------------------------

FLAGSHIP_STATIC_STEPS = 8


def flagship_static_problem(device="cuda", dtype=torch.float64) -> ForwardProblemQuads:
    """``ForwardProblemQuads`` on the flagship lattice at its 25-degree
    design, in tension, ``method="static"``."""

    config = flagship.paper_config(device=device, dtype=dtype)
    spacing = config["spacing"]
    geometry = QuadGeometry(config["n1_blocks"], config["n2_blocks"], spacing=spacing,
                            bond_length=config["bond_length"])
    h, v = geometry.get_design_from_rotated_square(25 * math.pi / 180, device=device,
                                                   dtype=dtype)
    return ForwardProblemQuads(
        n1_blocks=config["n1_blocks"], n2_blocks=config["n2_blocks"], spacing=spacing,
        bond_length=config["bond_length"], horizontal_shifts=h, vertical_shifts=v,
        k_stretch=config["k_stretch"], k_shear=config["k_shear"], k_rot=config["k_rot"],
        density=config["density"], damping=1.0, loading_type="tension",
        amplitude=0.05 * config["n2_blocks"] / 6 * spacing, loading_rate=0.01,
        n_timepoints=FLAGSHIP_STATIC_STEPS + 1, use_contact=True, k_contact=config["k_contact"],
        min_angle=config["min_angle"], cutoff_angle=config["cutoff_angle"], method="static",
        device=device, dtype=dtype)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_flagship_static(device="cuda", dtype=torch.float64) -> dict:
    """The force-displacement curve, the gradient of the sum of its forces
    with respect to the three stiffnesses, the Newton iterations of every
    load step, and seconds (host clock): the whole value and gradient, and
    one Newton Jacobian and one solve at the last equilibrium."""

    problem = flagship_static_problem(device, dtype)
    problem.setup()
    k = tuple(torch.tensor(float(x), dtype=dtype, device=device, requires_grad=True)
              for x in (problem.k_stretch, problem.k_shear, problem.k_rot))
    t0 = time.perf_counter()
    solution, cp = problem.solve(k)
    curve = problem.force_displacement(solution, cp)
    grad = torch.autograd.grad(curve[1].sum(), k)
    _sync(device)
    seconds = time.perf_counter() - t0
    solve = problem.solve_equilibrium
    u = solution.fields[-1, 0].detach()
    t_last = problem.timepoints[-1]
    with torch.no_grad():
        t0 = time.perf_counter()
        J = solve.newton_matrix(u.reshape(-1), t_last, cp)
        _sync(device)
        t_jac = time.perf_counter() - t0
        r = solve.residual(u, t_last, cp).reshape(-1)
        _sync(device)
        t0 = time.perf_counter()
        torch.linalg.solve(J, r)
        _sync(device)
        t_solve = time.perf_counter() - t0
    return dict(curve=curve.detach().cpu().numpy(), grad=np.array([float(g) for g in grad]),
                iterations=list(solve.iterations), seconds=seconds, jacobian_s=t_jac,
                solve_s=t_solve)


# ---------------------------------------------------------------------------
# (c) Modes of the flagship
# ---------------------------------------------------------------------------

N_MODES = 20


def flagship_modes(device="cuda", dtype=torch.float64) -> np.ndarray:
    """The lowest ``N_MODES`` squared angular frequencies of the flagship
    lattice at its design (the grid energy with contact), its clamped
    corners and driven strip constrained."""

    opt, design = flagship.build_flagship(device=device, dtype=dtype)
    fp = opt.forward_problem
    driven, _ = base.driven_side_pairs(fp.n1_blocks, fp.n2_blocks, fp.n_excited_blocks,
                                       fp.loaded_side, fp.input_shift)
    pairs = np.concatenate([driven, base.clamped_corner_pairs(fp.n1_blocks, fp.n2_blocks,
                                                              fp.n_blocks_clamped_corner)])
    energy = build_quad_grid_energy(fp.n1_blocks, fp.n2_blocks)
    cp = fp.control_params(design)
    w, _ = linear_mode_analysis(torch.zeros((fp.geometry.n_blocks, 3), dtype=dtype,
                                            device=device),
                                fp.geometry, energy, cp, constrained_block_DOF_pairs=pairs)
    return w[:N_MODES].cpu().numpy()


# ---------------------------------------------------------------------------
# (d) Snap-through continuation
# ---------------------------------------------------------------------------

SNAP_H0 = 0.35
SNAP_TRACE = dict(ds=0.04, n_steps=60)
SNAP_LIMIT = dict(ds=0.03, n_steps=12)
SNAP_CONSTRAINED = np.array([[b, d] for b in (0, 1) for d in range(3)] + [[2, 0], [2, 2]])
SNAP_LOADED = np.array([[2, 1]])  # a downward force lambda on the apex


class SpringParams(NamedTuple):
    reference_vector: torch.Tensor
    k_stretch: torch.Tensor


def snap_control_params(h, k=1.0, device="cuda", dtype=torch.float64) -> ControlParams:
    """Anchors at (-1, 0) and (1, 0), the apex at (0, h); one node a block."""

    like = dict(device=device, dtype=dtype)
    h = torch.as_tensor(h, **like)
    up = torch.tensor([0.0, 1.0], **like)
    centroids = torch.stack([torch.tensor([-1.0, 0.0], **like), torch.tensor([1.0, 0.0], **like),
                             torch.tensor([0.0, 0.0], **like) + h * up])
    refs = torch.stack([torch.tensor([1.0, 0.0], **like) + h * up,
                        torch.tensor([-1.0, 0.0], **like) + h * up])
    return ControlParams(
        geometrical_params=GeometricalParams(centroids, torch.zeros((3, 1, 2), **like)),
        mechanical_params=MechanicalParams(bond_params=SpringParams(refs,
                                                                    torch.as_tensor(k, **like)),
                                           density=1.0, damping=0.0),
        constraint_params=dict())


def snap_tracer():
    return setup_arclength_solver(
        3, build_strain_energy(np.array([[0, 2], [1, 2]]), simple_spring_energy),
        loaded_block_DOF_pairs=SNAP_LOADED, loading_fn=lambda state, lam, **kw: -lam,
        constrained_block_DOF_pairs=SNAP_CONSTRAINED)


def run_snap(device="cuda", dtype=torch.float64) -> dict:
    """The 60-step path's load factors, apex drops, stability eigenvalues
    and folds; the limit load over 12 steps and its gradient in h."""

    trace = snap_tracer()
    zeros = torch.zeros((3, 3), device=device, dtype=dtype)
    path = trace(zeros, 0.0, control_params=snap_control_params(SNAP_H0, device=device,
                                                                dtype=dtype),
                 compute_stability=True, **SNAP_TRACE)
    h = torch.tensor(SNAP_H0, device=device, dtype=dtype, requires_grad=True)
    limit = torch.max(trace(zeros, 0.0, control_params=snap_control_params(h, device=device,
                                                                           dtype=dtype),
                            **SNAP_LIMIT).load_factor)
    (grad,) = torch.autograd.grad(limit, h)
    return dict(load_factor=path.load_factor.detach().cpu().numpy(),
                drop=path.displacement[:, 2, 1].detach().cpu().numpy(),
                stability=path.stability_eig.cpu().numpy(),
                converged=bool(path.converged.all()), folds=fold_points(path),
                limit=float(limit.detach()), limit_grad=float(grad))


# ---------------------------------------------------------------------------
# (e) Transmission and the Bloch gap
# ---------------------------------------------------------------------------

STRIP_ANGLE = 0.35
STRIP_STIFF = dict(k_stretch=1.0, k_shear=1.0, k_rot=1.0)
STRIP_CELLS = (8, 3)
STRIP_OMEGAS = (0.3, 10.0, 80)
BLOCH_GRID = 25


def strip_transmission(device="cuda", dtype=torch.float64, cells=STRIP_CELLS,
                       omegas=STRIP_OMEGAS, damping=0.05) -> np.ndarray:
    """Transmission of the force-driven rotated-square strip over the
    drive frequencies (the example's ``finite_strip_transmission``)."""

    like = dict(device=device, dtype=dtype)
    geo = RotatedSquareGeometry(*cells, spacing=1.0, bond_length=0.1)
    bc, cnv, bonds, rbv = geo.get_parametrization()
    angle = torch.tensor(STRIP_ANGLE, **like)
    cp = ControlParams(
        geometrical_params=GeometricalParams(bc(angle), cnv(angle)),
        mechanical_params=MechanicalParams(
            bond_params=LigamentParams(STRIP_STIFF["k_stretch"], STRIP_STIFF["k_shear"],
                                       STRIP_STIFF["k_rot"], rbv().to(**like)),
            density=1.0, damping=damping))
    xs = bc(angle)[:, 0].cpu().numpy()
    left = np.where(xs < xs.min() + 0.6)[0]
    right = np.where(xs > xs.max() - 0.6)[0]
    forcing = torch.zeros((geo.n_blocks, 3), **like)
    forcing[left, 0] = 1.0
    u = harmonic_response(torch.zeros((geo.n_blocks, 3), **like), geo,
                          build_strain_energy(bonds(), ligament_energy_linearized), cp, forcing,
                          torch.linspace(*omegas[:2], omegas[2], **like),
                          damped_blocks=np.arange(geo.n_blocks))
    return transmission(u, input_blocks=left, output_blocks=right).cpu().numpy()


def bloch_gap(device="cuda", dtype=torch.float64, n=BLOCH_GRID):
    """The widest full-zone gap ``(lo, hi)`` of the strip's cell over an
    ``n x n`` grid of fractional wave vectors in [-1/2, 1/2]."""

    cell = bloch.rotated_square_cell(STRIP_ANGLE, device=device, dtype=dtype, **STRIP_STIFF)
    b = bloch.reciprocal_basis(cell.direct_basis)
    frac = torch.linspace(-0.5, 0.5, n, device=device, dtype=dtype)
    ks = torch.stack(torch.meshgrid(frac, frac, indexing="xy"), -1).reshape(-1, 2) @ b
    omega = bloch.frequencies(bloch.band_structure(cell, ks)).cpu().numpy()
    gaps = [(float(omega[:, j].max()), float(omega[:, j + 1].min()))
            for j in range(omega.shape[1] - 1) if omega[:, j + 1].min() > omega[:, j].max()]
    return max(gaps, key=lambda g: g[1] - g[0])


# ---------------------------------------------------------------------------
# (f) Bloch design and homogenization
# ---------------------------------------------------------------------------

KAGOME_PATH_N = 24
KAGOME_BANDS = (2, 3)
#: The example's "shifted" design, where the gap is taken: at zero shifts
#: bands meet at the path's symmetry points and the eigenvalues'
#: derivatives there are not defined (the two packages' differ).
KAGOME_SHIFTED = ((0.08, 0.0), (-0.04, 0.07), (-0.04, -0.07))


def kagome_ks(device="cuda", dtype=torch.float64) -> torch.Tensor:
    """Gamma - M - K - Gamma of the default kagome basis, 24 points a
    segment (the example's ``kagome_path``)."""

    cell = bloch.kagome_periodic_cell(device=device, dtype=dtype)
    b = bloch.reciprocal_basis(cell.direct_basis).cpu().numpy()
    corners = [np.zeros(2), b[0] / 2, (b[0] + b[1]) / 3, np.zeros(2)]
    return bloch.high_symmetry_path(corners, KAGOME_PATH_N, device=device, dtype=dtype)[0]


def kagome_gap(shifts, ks):
    """The example's smooth gap between bands 2 and 3 (log-sum-exp, tau 1)."""

    omega_sq = bloch.band_structure(bloch.kagome_periodic_cell(shifts=shifts), ks)
    lo, hi = KAGOME_BANDS
    return (-torch.logsumexp(-omega_sq[:, hi], dim=0)) - torch.logsumexp(omega_sq[:, lo], dim=0)


def run_kagome_gap(device="cuda", dtype=torch.float64) -> dict:
    """The smooth gap at ``KAGOME_SHIFTED`` and its shift gradient."""

    shifts = torch.tensor(KAGOME_SHIFTED, device=device, dtype=dtype, requires_grad=True)
    value = kagome_gap(shifts, kagome_ks(device, dtype))
    (grad,) = torch.autograd.grad(value, shifts)
    return dict(value=float(value.detach()), grad=grad.cpu().numpy().ravel())


EFFECTIVE_K_ROT = 1e-2
POISSON_TARGET = -0.5


def effective_row(device="cuda", dtype=torch.float64) -> np.ndarray:
    """Stage 1's row at ``k_rot = 1e-2``: ``(E_x, nu_xy, G_xy)``."""

    cell = bloch.rotated_square_cell(angle=0.25, k_stretch=1.0, k_shear=1.0,
                                     k_rot=EFFECTIVE_K_ROT, device=device, dtype=dtype)
    ec = engineering_constants(effective_moduli(cell))
    return np.array([float(ec[k]) for k in ("E_x", "nu_xy", "G_xy")])


def poisson_ratio(h, v):
    cell = bloch.quad_periodic_cell(h, v, spacing=1.0, bond_length=0.1, k_stretch=1.0,
                                    k_shear=1.0, k_rot=5e-3)
    return engineering_constants(effective_moduli(cell))["nu_xy"]


def run_poisson(device="cuda", dtype=torch.float64) -> dict:
    """Stage 3's Poisson ratio at its start (the shifts the example draws
    from ``jax.random``, recorded as ``JAX_F64_POISSON_H0`` / ``_V0``), its
    loss and the loss's gradient."""

    h = torch.tensor(JAX_F64_POISSON_H0, device=device, dtype=dtype, requires_grad=True)
    v = torch.tensor(JAX_F64_POISSON_V0, device=device, dtype=dtype, requires_grad=True)
    nu = poisson_ratio(h, v)
    loss = (nu - POISSON_TARGET) ** 2
    grads = torch.autograd.grad(loss, (h, v))
    return dict(nu=float(nu.detach()), loss=float(loss.detach()),
                grad=torch.cat([g.reshape(-1) for g in grads]).cpu().numpy())


WAVEGUIDE_PERIOD = 7
WAVEGUIDE_KX = 11
WAVEGUIDE_K_ROT = 0.005
WAVEGUIDE_BZ = 14


def run_waveguide(device="cuda", dtype=torch.float64) -> dict:
    """The bulk gap (bands 4 | 5 over a 14 x 14 zone grid); the guided
    branch at 11 kx (the eigenvalue nearest the gap centre) with its
    weight on the defect row and its two neighbours; the guided
    frequency's derivative in log k_rot at kx = 0.3 b1."""

    base_cell = bloch.rotated_square_cell(angle=0.25, k_stretch=1.0, k_shear=0.3, k_rot=0.05,
                                          device=device, dtype=dtype)
    P = WAVEGUIDE_PERIOD
    om_bulk = bloch.frequencies(bloch.band_structure(
        base_cell, bloch.bz_grid(base_cell, WAVEGUIDE_BZ, WAVEGUIDE_BZ)))
    gap_lo = float(om_bulk.max(dim=0).values[:4].max())
    gap_hi = float(om_bulk.min(dim=0).values[4:].min())
    target = 0.5 * (gap_lo + gap_hi)
    b = bloch.reciprocal_basis(base_cell.direct_basis)
    kx = torch.linspace(0.0, 0.5, WAVEGUIDE_KX, device=device, dtype=dtype)
    ks = torch.stack([kx * b[0, 0], torch.zeros_like(kx)], dim=1)
    guide = bloch.line_defect_cell(base_cell, P, k_rot=WAVEGUIDE_K_ROT)
    om_sq, modes = bloch.band_structure(guide, ks, with_modes=True)
    om = bloch.frequencies(om_sq)
    band = torch.argmin(torch.abs(om - target), dim=1)
    loc = bloch.mode_localization(guide, modes, P)  # (n_k, P, n_modes)
    rows = torch.arange(WAVEGUIDE_KX, device=device)
    mid = P // 2
    weight = sum(loc[rows, r, band] for r in (mid - 1, mid, (mid + 1) % P))

    x = torch.tensor(math.log(WAVEGUIDE_K_ROT), device=device, dtype=dtype, requires_grad=True)
    k_op = torch.stack([0.3 * b[0, 0], torch.zeros_like(b[0, 0])])[None]
    om_op = bloch.frequencies(bloch.band_structure(
        bloch.line_defect_cell(base_cell, P, k_rot=torch.exp(x)), k_op))[0]
    guided = om_op[torch.argmin(torch.abs(om_op - target))]
    (grad,) = torch.autograd.grad(guided, x)
    return dict(gap=np.array([gap_lo, gap_hi]),
                guided=om[rows, band].cpu().numpy(), weight=weight.cpu().numpy(),
                guided_op=float(guided.detach()), guided_op_grad=float(grad))


# ---------------------------------------------------------------------------
# (g) The magnetic energy on the flagship's blocks
# ---------------------------------------------------------------------------

MAGNETIC_SEED = 3
MAGNETIC_PREFACTOR = 1e-3
MAGNETIC_MIN_DISTANCE = 1.5  # mm: a tenth of the flagship's spacing


def magnetic_state(device="cuda", dtype=torch.float64):
    """``(positions, rotations, dipole_angles, strengths)``: the flagship
    design's centroids displaced by seeded small motions (2% of the
    spacing, 0.05 rad), seeded dipoles."""

    opt, design = flagship.build_flagship(device=device, dtype=dtype)
    fp = opt.forward_problem
    centroids = fp.control_params(design).geometrical_params.block_centroids.detach()
    n = centroids.shape[0]
    rng = np.random.default_rng(MAGNETIC_SEED)
    u = rng.standard_normal((n, 3)) * np.array([0.02 * fp.spacing, 0.02 * fp.spacing, 0.05])
    angles = np.stack([rng.uniform(-np.pi, np.pi, n), rng.uniform(-0.3, 0.3, n)], axis=1)
    strengths = rng.uniform(0.5, 1.5, n)
    like = dict(device=device, dtype=dtype)
    return (centroids + torch.as_tensor(u[:, :2], **like), torch.as_tensor(u[:, 2], **like),
            torch.as_tensor(angles, **like), torch.as_tensor(strengths, **like))


def run_magnetic(device="cuda", dtype=torch.float64) -> dict:
    """The energy and its gradient (positions, rotations) as
    ``flagship.vector_stats``."""

    positions, rotations, angles, strengths = magnetic_state(device, dtype)
    positions.requires_grad_()
    rotations.requires_grad_()
    energy = magnetic_dipole_energy(positions, rotations, angles, strengths,
                                    prefactor=MAGNETIC_PREFACTOR,
                                    min_distance=MAGNETIC_MIN_DISTANCE)
    grads = torch.autograd.grad(energy, (positions, rotations))
    g = torch.cat([x.reshape(-1) for x in grads]).cpu().numpy()
    return dict(energy=float(energy.detach()), grad_stats=flagship.vector_stats(g))


# ---------------------------------------------------------------------------
# JAX float64 results (tests/jax_analysis_references.py constants)
# ---------------------------------------------------------------------------
#: The example's targets: each sample's (displacement, noisy force) at the
#: true stiffnesses (JAX "verlet_ckpt", 1% noise from default_rng(0)).
JAX_F64_HINGE_TARGETS = {
    'tension': (
        (0.0, 0.0020833333333333333, 0.004166666666666667, 0.0062499999999999995,
         0.008333333333333333, 0.010416666666666664, 0.012499999999999999,
         0.014583333333333332, 0.016666666666666666, 0.01875, 0.02083333333333333,
         0.02291666666666667, 0.024999999999999998, 0.027083333333333334, 0.029166666666666664,
         0.031249999999999997, 0.03333333333333333, 0.035416666666666666, 0.0375,
         0.03958333333333333, 0.04166666666666666, 0.04375, 0.04583333333333334,
         0.04791666666666666, 0.05),
        (0.0, 0.005481695879206654, 0.007980639822843442, 0.009894439095631013,
         0.011567353064086607, 0.013275506873596493, 0.01490059739491511, 0.016248717718469897,
         0.017286863947975198, 0.018428073379724214, 0.019750542828991885, 0.02105987089268875,
         0.021687738759531696, 0.023289724348075264, 0.02416337802654655, 0.025404490009671765,
         0.026571075794765253, 0.02775790686866178, 0.029103071873489126, 0.030446831058879516,
         0.03125498247046953, 0.03291712770812839, 0.033445058516621766, 0.03500624644670616,
         0.036444822768526584),
    ),
    'shear': (
        (0.0, 0.0020833333333333333, 0.004166666666666667, 0.0062499999999999995,
         0.008333333333333333, 0.010416666666666664, 0.012499999999999999,
         0.014583333333333332, 0.016666666666666666, 0.01875, 0.02083333333333333,
         0.02291666666666667, 0.024999999999999998, 0.027083333333333334, 0.029166666666666664,
         0.031249999999999997, 0.03333333333333333, 0.035416666666666666, 0.0375,
         0.03958333333333333, 0.04166666666666666, 0.04375, 0.04583333333333334,
         0.04791666666666666, 0.05),
        (0.0, 0.00021601077389923385, 0.00041683428111309297, 0.0006088397584424213,
         0.000793681303470168, 0.0009529631152336966, 0.001122338991176838,
         0.0012765993637623974, 0.0014328109456503615, 0.0015679983824682638,
         0.0017037932112666564, 0.0018130251798099436, 0.0019441823489379415,
         0.002079634060686256, 0.002208133074731463, 0.0022549105355198365,
         0.0024240529232879902, 0.0025222040679565008, 0.002606618108829224,
         0.0026883943959431595, 0.002764954622656003, 0.00290548653207542,
         0.0030096024244307676, 0.0030926196822199195, 0.003163418952299094),
    ),
}

#: (g) The magnetic energy of magnetic_state() and its gradient's summary.
JAX_F64_MAGNETIC = {
    'energy': 6.439156085929392e-06,
    'grad_stats': (1.4270105780441835e-05, -1.9132621142813456e-05, 3.0858561550454525e-06),
}

#: (d) The snap-through path (run_snap's keys).
JAX_F64_SNAP = {
    'load_factor': (
        0.0, 0.007320977781175857, 0.012252378488524942, 0.014920406137903887,
        0.015535531618655705, 0.014377606339826071, 0.01177685179105851, 0.008095701296918181,
        0.00371461290365564, -0.0009773407634876782, -0.0055880758516057855,
        -0.009726259165445396, -0.013005557077961825, -0.015051610796153275,
        -0.01551337644557873, -0.01407916128415745, -0.010495625368026137,
        -0.0045857392529794795, 0.003739563887446094, 0.014480251648840096,
        0.027557463631199774, 0.042832234166112426, 0.06012752526373607, 0.07924872889188163,
        0.09999971566763828, 0.12219361662349157, 0.14565893926306084, 0.17024220234826037,
        0.19580828984743429, 0.2222394839601166, 0.24943384580958916, 0.2773033646721772,
        0.3057721173325358, 0.33477456171236547, 0.3642540175372528, 0.39416134632061745,
        0.42445382179276137, 0.455094172206015, 0.48604977268745914, 0.5172919659467692,
        0.5487954914071734, 0.5805380052222482, 0.612499676144177, 0.644662844561242,
        0.6770117341137765, 0.7095322070984015, 0.742211556389927, 0.7750383278766779,
        0.808002168452083, 0.8410936954669731, 0.874304384254221, 0.9076264709171408,
        0.9410528680484179, 0.9745770914364127, 1.0081931961361987, 1.0418957205465735,
        1.0756796373519801, 1.1095403103683112, 1.143473456480847, 1.1774751119866667,
        1.2115416027573085,
    ),
    'drop': (
        0.0, -0.0393437911851861, -0.07905652013191172, -0.1189827655880352,
        -0.1589901641090498, -0.19898212234909693, -0.23890301235871791, -0.2787361568559159,
        -0.31849654712627756, -0.3582205175445751, -0.3979540363888601, -0.4377405576776582,
        -0.4776089826406657, -0.5175623843320154, -0.5575687095436681, -0.5975553940343229,
        -0.6374101309256545, -0.6769892307779364, -0.7161328734855891, -0.7546839001546429,
        -0.7925052622681006, -0.8294919605708804, -0.865575774487343, -0.9007236788044011,
        -0.9349322751056285, -0.9682206532752607, -1.0006234164345724, -1.0321847796885992,
        -1.062954027755518, -1.0929822581175175, -1.122320184564194, -1.1510167463947452,
        -1.1791182962031468, -1.206668185524434, -1.233706613784367, -1.260270644685858,
        -1.2863943238925684, -1.3121088535596164, -1.3374427945600373, -1.3624222777905899,
        -1.387071213060878, -1.4114114888046567, -1.435463158950091, -1.459244615275305,
        -1.4827727448230836, -1.5060630727044035, -1.5291298910541737, -1.551986375128034,
        -1.574644687622285, -1.5971160723104245, -1.6194109380524107, -1.6415389341682154,
        -1.663509018089351, -1.685329516119473, -1.7070081780532986, -1.7285522263249684,
        -1.7499684002843239, -1.7712629961331487, -1.7924419029933476, -1.8135106355252286,
        -1.834474363466103,
    ),
    'stability': (
        0.2182628062360802, 0.1545346673082387, 0.09465119896946755, 0.04001659677157017,
        -0.00806973626867083, -0.04848607265178936, -0.08032860022258632, -0.10292204227765547,
        -0.11581141741134894, -0.11874723883034043, -0.11167384925458626, -0.09472643512260139,
        -0.06823795845911865, -0.03275299146286744, 0.010958866345700341, 0.06190105154896345,
        0.11887186753505376, 0.18051840377292303, 0.24542078085561475, 0.31219231201563624,
        0.37957324601738296, 0.44649796651231727, 0.5121262740647938, 0.5758416128066189,
        0.6372266195007393, 0.6960277266750184, 0.752117944526688, 0.8054632202156418,
        0.856094664366861, 0.9040869615080365, 0.9495422912918605, 0.9925787384619016, 1.0, 1.0,
        1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0,
        1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0,
    ),
    'converged': True,
    'folds': (4, 14),
    'limit': 0.01555979822661966,
    'limit_grad': 0.126865091936134,
}

#: (e) The strip's transmission at STRIP_OMEGAS.
JAX_F64_TRANSMISSION = (
    0.8547061392009137, 1.5494478845432886, 0.8999208155152137, 1.0850783736641327,
    1.1066569821840297, 0.8512770540652188, 1.3499860635126792, 0.7645332279370464,
    1.2942782773032924, 0.7285870151073073, 1.090689430383363, 0.6813240573446462,
    0.9441229073725083, 0.5945073722752984, 0.8057543579346556, 0.4993044586569353,
    0.5482670214405836, 0.46744697434989385, 0.31915909360750305, 0.23550039222149546,
    0.14261609496709554, 0.04373473365782936, 0.010137795464153616, 0.00787105492619787,
    0.007324042901842145, 0.0074633492185507905, 0.007839990356681169, 0.008034828549827034,
    0.007231549872756116, 0.005201381689242025, 0.0023679616203810807, 0.00010996540629514756,
    9.013534308000205e-07, 3.2923091340670877e-08, 3.1485521708982695e-09,
    1.4685218796717629e-09, 1.505328118088097e-09, 1.678946834190265e-09, 1.928603985501974e-09,
    2.267270609865458e-09, 2.7242969232311512e-09, 3.3457927462857352e-09,
    4.202874343873133e-09, 5.407567265330899e-09, 7.1425120320546795e-09, 9.718601972457283e-09,
    1.3691765650618832e-08, 2.010747785059172e-08, 3.1018960007882107e-08,
    5.056847987213934e-08, 8.713871847800686e-08, 1.5726951564133623e-07, 2.917297422316515e-07,
    5.423347931185145e-07, 9.847246215589593e-07, 1.7117101977877344e-06,
    2.8183979825353287e-06, 4.384170931444075e-06, 6.449950570559558e-06, 8.992653658011717e-06,
    1.1914618937277505e-05, 1.506180691451051e-05, 1.8259561712740865e-05,
    2.1344342177779906e-05, 2.4185126615812432e-05, 2.66917716331657e-05,
    2.8806097122126447e-05, 3.04946964788281e-05, 3.17526817369294e-05, 3.259378567373173e-05,
    3.303170111210411e-05, 3.308483051446657e-05, 3.278757775350827e-05, 3.217607452480231e-05,
    3.127430613001832e-05, 3.0106585376490193e-05, 2.8703819253138086e-05,
    2.708582940919544e-05, 2.5257435546210506e-05, 2.3231648992505612e-05,
)

#: (e) The widest full-zone gap (lo, hi) of the strip's cell.
JAX_F64_BLOCH_GAP = (4.174989834877239, 7.547645273377092)

#: (f) The kagome smooth gap at zero shifts and its shift gradient.
JAX_F64_KAGOME_GAP = {
    'value': -28.29585485403326,
    'grad': (
        19.5662743127549, -0.5437398559520901, -10.255214775857187, 16.545440643669547,
        -9.31105953689772, -16.00170078771746,
    ),
}

#: (f) (E_x, nu_xy, G_xy) at k_rot = EFFECTIVE_K_ROT.
JAX_F64_EFFECTIVE_ROW = (0.6023570577107565, -0.3976429422892432, 0.4999999999999999)

#: (f) Stage 3's start: the shifts the example draws with
#: jax.random.PRNGKey(0) (horizontal, then vertical after fold_in(key, 1)).
JAX_F64_POISSON_H0 = (
    (
        (-0.0041168427895928675, -0.01569531552893482),
        (0.03632173345335967, 0.003756880257875774),
    ),
    (
        (0.0016173576207486552, -0.0074422158666924065),
        (0.0238032744997726, 0.00677284582061921),
    ),
)
JAX_F64_POISSON_V0 = (
    (
        (-0.02801768205655336, 0.02864289995555375),
        (0.012496213922689205, 0.00400974543815956),
    ),
    (
        (0.004942952220755033, 0.010489542024064484),
        (0.017237372886477816, 0.024474290951043937),
    ),
)

#: (f) The Poisson ratio at the start, the loss and its gradient (h, then v).
JAX_F64_POISSON = {
    'nu': 0.0008985305083257207,
    'loss': 0.2508993378654001,
    'grad': (
        0.0006201209250873339, -0.1700325784020712, 0.0004975687588184961, 0.16909703633848505,
        -0.0011787365587998056, 0.170952901929603, -0.0010000039040462326, -0.168261885546866,
        -0.030920590019728706, 0.0005441057048101304, 0.03147137307091842,
        -0.0014587518462221868, 0.03238171211197747, 0.00043309298098383154,
        -0.03187144438422699, -0.001273921158722637,
    ),
}

#: (f) The waveguide (run_waveguide's keys).
JAX_F64_WAVEGUIDE = {
    'gap': (3.4558564741446256, 4.050635279528298),
    'guided': (
        3.987437794533505, 3.986686090342511, 3.986801013989307, 3.524124354219894,
        3.5369839710582505, 3.5506361855473187, 3.5655071996826884, 3.5799342320782137,
        3.5933394521191713, 3.6060398780832883, 3.6183298393479277,
    ),
    'weight': (
        0.9147075019541495, 0.8929561571346909, 0.8767474452947706, 0.9462886968356313,
        0.9670325379081244, 0.9779152742817524, 0.984717177074638, 0.9898948790875187,
        0.9932150415929596, 0.9951093617169746, 0.9963245175862514,
    ),
    'guided_op': 3.565507199682687,
    'guided_op_grad': 0.0401768223597392,
}

#: (c) The flagship's lowest N_MODES squared angular frequencies.
JAX_F64_FLAGSHIP_MODES = (
    10539.110003564614, 15956.833488439845, 29798.526104621866, 47632.75118276697,
    69308.240006279, 85191.14099573715, 85660.82499567316, 122451.12263805076,
    155706.70596559384, 177632.10101719707, 193382.40533418307, 193759.15709704946,
    229930.9764883136, 261377.2280606116, 309090.2248593195, 318644.7044494841,
    327736.24068948964, 339241.1925472636, 384042.20850732515, 403392.61737300956,
)

#: (a) The fit through JAX's "verlet_ckpt" (run_hinge's keys).
JAX_F64_HINGE_VERLET_CKPT = {
    'value': 1.9192277100347102e-05,
    'grad': (7.026938002544013e-05, 0.00014420312112308907, 0.010179900924042907),
    'gd_values': (1.9192277100347102e-05, 1.420719030624055e-05),
    'gd_designs': (
        (1.3999964865309986, 0.029992789843943844, 0.0014910049537978547),
        (1.3999936406310725, 0.02998608858742988, 0.0010232708299664015),
    ),
    'gd_final': (1.3999936406310725, 0.02998608858742988, 0.0010232708299664015),
}

#: (a) The fit through JAX's static solver, with its Newton iterations.
JAX_F64_HINGE_STATIC = {
    'value': 2.1864501933449732e-05,
    'grad': (-2.750151205996109e-05, -0.0002540696859883768, -0.01749057892664117),
    'iterations': {
        'tension': (
            0, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3,
        ),
        'shear': (
            0, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3,
        ),
    },
}

#: (g) The n = 5 rescue's tunneling reports: first non-finite timepoint and
#: the risky intervals' indices.
JAX_F64_TUNNELING = {
    'n5_plain': {
        'first_nonfinite': 31,
        'risky': (
            23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43,
            44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64,
            65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85,
            86, 87, 88, 89, 90, 91, 92, 93, 94, 95, 96, 97, 98, 99, 100, 101, 102, 103, 104,
            105, 106, 107, 108, 109, 110, 111, 112, 113, 114, 115, 116, 117, 118, 119, 120, 121,
            122, 123, 124, 125, 126, 127, 128, 129, 130, 131, 132, 133, 134, 135, 136, 137, 138,
            139, 140, 141, 142, 143, 144, 145, 146, 147, 148, 149, 150, 151, 152, 153, 154, 155,
            156, 157, 158, 159, 160, 161, 162, 163, 164, 165, 166, 167, 168, 169, 170, 171, 172,
            173, 174, 175, 176, 177, 178, 179, 180, 181, 182, 183, 184, 185, 186, 187, 188, 189,
            190, 191, 192, 193, 194, 195, 196, 197, 198,
        ),
    },
    'n5_guarded': {
        'first_nonfinite': None,
        'risky': (),
    },
}

#: (g) The space-time xcorr of the flagship's field against the rescued one:
#: (peak, delay).
JAX_F64_XCORR = (0.9999906983203274, 0)

#: (b) The flagship's static tension (run_flagship_static's keys).
JAX_F64_FLAGSHIP_STATIC = {
    'curve': (
        (0.0, 0.25, 0.5, 0.75, 1.0, 1.25, 1.5, 1.75, 2.0),
        (
            0.0, 0.7075286542329741, 1.4299933355631336, 2.1681418893624578, 2.922767147218706,
            3.6947117551385746, 4.484873941144632, 5.294214381282546, 6.123764339385519,
        ),
    ),
    'grad': (0.008338316327786505, 15.690705389656914, 4.768972046778445),
    'iterations': (0, 4, 5, 5, 5, 5, 5, 5, 5),
}
