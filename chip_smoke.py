#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written trajectory kernels from ``difflexmm_tpu_torch/csrc``
into ``build/kernels`` (the sources in parallel, the trajectory sources
once per type) and holds each against its plain PyTorch version on the
same inputs: the quad kernels
(kernel 1, unguarded, and kernel 1g, guarded, per-substep decisions
identical at float64), the kagome kernels (1K and 1Kg, the same) and the
fused external loads (1L) in all four of them. The plain version's runs, and
the dense ``method="verlet"`` runs of the loaded problems, go to worker
processes on the host's CPU cores while the kernels build. Then it drives
fourteen main paths.
On the paper flagship (24 x 16 quads, 200 timepoints, 10 substeps): the
value and design gradient of ``OptimizationProblem.objective_fn`` (kernel
1), and the guarded constrained optimizer
``OptimizationProblem.run_optimization_mma`` (kernel 1g, two iterations at
float64 held against the JAX package's recorded history and gradients,
one at float32 timed). On the kagome configuration
(``examples/configs/kagome_focusing.json``: 16 x 16 cells, 200
timepoints, 10 substeps): the value and design gradient (kernel 1K), and
``run_optimization_mma`` with the configuration's settings (kernel 1Kg, two
iterations at float64 held against the JAX history and gradients; in a
process of its own on the card, beside the flagship's MMA). The
force pulse of ``examples/pulse_rotated_squares.py`` (10 x 5 rotated-square
cells, 100 timepoints, 16 substeps, kernel 1L): the value and gradient of
the last kinetic energy with respect to (angle, amplitude, rate), held
against JAX's float64 values and its trajectory against the dense path
(at float32 on its first 12 intervals: float32 leaves float64 after). The
tensile oracle of ``tools/tpu_parity_check.py`` at float32 (kernel 1L): the
chain's final strain equals the applied one. ``reference_design`` on
``examples/configs/pulse_forward.json`` (kernel 1 on the rotated-square
lattice), held against JAX's float64 trajectory summary. Populations of
designs (main path 8): the flagship's and the 12 x 10-cell kagome
population's values and design gradients at B = 128
(``parallel.population_value_and_grad``), each population one launch of
kernel 1 or 1K with one block per design, four designs held against B = 1
runs (forward outputs bit for bit), the kernel at the population's shapes
against the plain body on the card; and the multistart MMA
(``OptimizationProblem.run_multistart_mma``: eight flagship candidates
screened through kernel 1, the four finalists re-ranked through one
launch of kernel 1g). Kernel 2, the quad force (main path 9): held against
its plain version at the shape of ``tools/microbench_lanes_batch.py`` (B =
128) and timed; the flagship's value and gradient through
``method="verlet_ckpt"`` (one launch of kernel 2 a substep), guard levels =
2 on the card through it (held against the plain guarded body; the same
guard runs through kernel 1g in main path 12), and the 96 x 64 lattice of
``bench.py`` through kernel 2 and through kernel 1. The
flagship's robustness map (main path 10, ``bench.py:380-400``): 64 loading
scenarios (the pulse's amplitude and rate swept) in one
``compute_robustness_map`` call, one launch of kernel 1, each cell held
against its scenario alone at B = 1 and two against the plain body on the
card. The five other quad families at their example scripts' sizes (main
path 11): the value and design gradient of multi-input focusing, energy
splitting, the restricted design space, spin and static tuning through
kernel 1, static tuning's value held against the plain body on the card
(the plain-body runs of main paths 10-11 go to a process of their own,
on the card beside main path 2). Guards deeper than one level (main path
12) through kernels 1g and 1Kg, which refine to any depth: the flagship's
n = 5 rescue (unguarded NaN; the travel-only guard at one level and at two
within 1e-3 of the f64 odeint oracle at both types and within 1e-8 of the
JAX package's f64 value), the flagship at its MMA iterate 1 and the kagome
configuration at levels 2, and the violent 8 x 6 problem's value and
design gradient at levels 2 (against the plain body's on the host) and its
value at levels 3; before it, those kernels and guarded 1L at levels 2 and
3 against the plain guarded body, decisions of every depth identical at
float64 (guarded 1L at levels 2 timed on the 8 x 6 case). The rest of the
optimizer and the solver remnants (main path 13): the runner's
``run_optimization_optax`` on the flagship under ``guard="auto"`` (kernel
1g, two float64 iterations held against the JAX package's recorded
history); ``run_multistart_optax`` on 128 flagship designs (kernel 1 with
the batch on the grid, three iterations; two candidates held against B = 1
runs of ``optim.loops.run_optimization_optax``; designs/s); the MMA with a
``MetricsLogger`` and an ``OptimizationCheckpoint`` on the 6 x 6 problem of
``models/small_configs.py`` (kernel 1g), resumed by a fresh problem, held
against JAX's history; the periodic kagome (``KagomePeriodicGeometry``,
16 x 16 cells) value and shift gradient through kernel 1K against JAX's;
the dense ``"rk4"``, ``"semi_implicit"`` and guarded ``"verlet"`` with
distance-based contact and node loads on CUDA tensors against the same on
the host; and one flagship value and gradient inside
``utils.observability.trace``, whose Chrome trace must list kernel 1's
launch. All of it but (b)'s population runs in a process of its own on
the card beside main paths 2 and 4, whose work is host-bound too. Statics
and linear analysis (main path 14, ``models/analysis_configs.py``, all at
float64 against the JAX package's recorded results): the hinge fit of
``examples/hinge_characterization_fit.py`` (3 x 3-cell samples in tension
and shear) through kernel 1 (value, stiffness gradient, two GD iterations)
and through Newton (``method="static"``, the same Newton iterations as
JAX's); the flagship lattice's static tension (1,152 DOFs, 8 load steps:
the curve, its gradient, the seconds of a Jacobian and a solve) and its
lowest 20 modes; the snap-through continuation (60 steps, both folds, the
limit load's gradient); the 8 x 3-cell strip's transmission at 80
frequencies and its cell's Bloch gap; the kagome gap and its shift
gradient, the effective constants, the Poisson ratio's gradient and the
waveguide's guided branch; all of that in a process of its own beside
main paths 2, 4 and 13. In the main process after main path 13: the
tunneling report of the n = 5 rescue's trajectories (kernel 1, NaN; kernel
1g), the space-time cross-correlation of the flagship's field against the
rescued one, and the magnetic energy and gradient on a flagship state.
Objectives and float64 design gradients are checked against the JAX
package's float64 values, and the kernels are timed against their plain
versions. Fails
(non-zero exit, no result line) without a CUDA device or outside a
checkout of the repository. Imports no JAX.

The last line of standard output is ``{"ok": true, "device": {...}}``;
the line before it lists the kernels with their launches on the main
paths, errors, times and bounds; the card's name and power limit come
before that.
"""

import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# Tolerances, each with its reason:
# - float64 kernel vs plain body on the same inputs: the two differ only in
#   rounding (fused multiply-adds, the order in which each DOF sums its
#   bonds' partials), which over the flagship's 1,990 damped substeps stays
#   within 1e-9 of each field's scale. The guarded kernel's per-substep
#   decisions must equal the plain body's exactly at float64.
# - float32: rounding at float32 resolution is amplified by cancellation
#   (the acceleration is a small difference of stiff ligament forces), so
#   the kernel and the plain body are each held against the float64 plain
#   body on the same inputs, and the kernel's error may be at most three
#   times the plain body's (or 1e-5 of the field scale, where both are tiny).
F64_TRAJ_TOL = 1e-9
F32_TRAJ_FACTOR, F32_TRAJ_FLOOR = 3.0, 1e-5
# The loaded kernel checks (kernel 1L in its four instantiations, on the
# contact probes and tame kagome cells) run 20 substeps each, few enough
# that the two codes' rounding stays within 1e-12 of each field's scale at
# float64. A batch of tame 8 x 6 quads with loads is held at F64_TRAJ_TOL,
# as its unloaded twin is: its stiff ligaments amplify rounding to about
# 1e-12 of the acceleration's scale in 20 substeps (9.8e-13 against the
# plain body on the host, 1.2e-12 against the plain body on an H100).
LOAD_F64_TOL = 1e-12
LOAD_CHECKS = {"loaded contact probe": LOAD_F64_TOL, "loaded contact probe auto": LOAD_F64_TOL,
               "loaded kagome 4x3 tame B=2": LOAD_F64_TOL,
               "loaded kagome contact probe auto": LOAD_F64_TOL,
               "loaded 8x6 tame B=2": F64_TRAJ_TOL}
# The force pulse of main path 5 at float32 leaves the float64 pulse at its
# 14th interval (from 4e-6 to 0.6 of the acceleration's scale in one
# interval, the plain body as the kernel): the float32 rule holds on the
# first 12 intervals, where the plain body stays within 2.1e-6 of float64
# on the host.
PULSE_F32_INTERVALS = 12
# Where the guard fired nowhere, the guarded kernel runs the unguarded
# kernel's steps, so the two agree to rounding at float64.
GUARD_NOOP_TOL = 1e-12
# Force at one state (no integration): rounding of one energy gradient at
# float64; at float32 the same rule as for trajectories.
F64_FORCE_TOL = 1e-12
# Flagship objectives against the JAX float64 values.
OBJECTIVE_TOL = {"float64": 1e-8, "float32": 1e-4}
# The guarded kagome objective at float32: the guard fires on about 140 of
# the configuration's 1,990 substeps, and each refined substep amplifies
# rounding, so the float32 fields differ from float64 by about 3e-3 of
# their scale (in the plain body as in the kernel, on an H100), ten times
# the unguarded configuration's difference; the float32 objective is held
# at ten times the unguarded limit.
GUARDED_KAGOME_F32_TOL = 1e-3
# Float64 design gradients against JAX's, compared as (|g|, sum g, g . r)
# (models/flagship.py) relative to the largest of the three: the adjoint
# replays the same plain body as JAX in the same order, so the kernel
# forward's rounding (1e-9 of the field scale) is all that separates them
# (the gradient with the kernel forward and with the plain one differ by
# ~1e-12). At float32 the trajectory rule holds against the float64
# gradient of this run, with the plain body's float32 error on the velocity
# plane of the flagship as its measure: the objective is a kinetic energy.
GRAD_TOL = 1e-7
# Float64 guarded MMA against the JAX history: the kernel forward differs
# from JAX's by rounding (1e-9 of the field scale), which reaches the
# objective at ~1e-12 and the gradient at ~1e-9 relative; the first MMA step
# moves every hinge by the move limit, so it depends on the gradient's
# signs only, and the iterate's objective differs by the rounding of one
# more trajectory. 1e-7 relative leaves room above that and is far below
# any change of step (a move of 0.84 mm changes the objective by O(1)).
MMA_TOL = 1e-7
MMA_ITERATIONS = 2
# The float32 flagship MMA is timed, not checked against JAX: one
# iteration leaves room in the time limit for the kagome paths.
MMA_ITERATIONS_F32 = 1
# Worker processes for the plain body's runs (one core each): the card's
# machine has 8 cores, two of which the builds take at first.
PLAIN_WORKERS = 5
# Main path 8: the flagship and the kagome population at POPULATION_B
# designs, and four of its designs held against B = 1 runs. A design's
# forward outputs in a population equal its B = 1 outputs bit for bit (one
# thread block per design, nothing shared between blocks). The value
# reduces the design's kinetic energies in an order that follows the
# batch's shape, so it may differ by a few rounding steps (1e-13
# relative); the float64 gradient replays the same per-design operations
# at another batch width (1e-12 relative).
POPULATION_B = 128
POPULATION_CHECKED = (0, 42, 85, 127)
POP_VALUE_TOL, POP_GRAD_TOL = 1e-13, 1e-12
# Design b of a population is the configuration's design scaled by 1 +
# POPULATION_STEP b (bench.py's populations; the kagome design, zero, is
# shifted by POPULATION_STEP b instead). The float32 gradients are also
# taken at the second population, step -POPULATION_STEP.
POPULATION_STEP = 1e-3
# The population's float32 gradients against its float64 gradients, each
# design relative to its own float64 gradient's scale, through the kernel
# and with the plain body as the forward on the same inputs (the same
# adjoint). A design's float32 forward in the population equals its B = 1
# float32 forward bit for bit (checked), so the population adds no float32
# error of its own. The rule for kernel 1 (three times the plain body's
# error) is held by the population as a whole: the largest error of any
# design through the kernel within three times the largest with the plain
# forward, and the median of the per-design ratios (kernel over plain)
# within three. A single design's two float32 errors are two draws of
# rounding that scatter either way (6.8e-4 through the kernel against
# 1.9e-4 with the plain forward at one design on an H100, and the other way
# round at others; PERF.md has the ratios' distribution), so the rule is
# not held design by design.
# Multistart MMA of main path 8: candidates, iterations, finalists.
MULTISTART_B, MULTISTART_ITERATIONS, MULTISTART_FINALISTS = 8, 2, 4
# Batch sizes of the designs/s curve: 1, about one design on each of the
# H100's 132 SMs, and four per SM (B = 8, 32, 132 and 264 ran until the
# time limit needed their time).
CURVE_BATCHES = (1, 128, 528)
# Main path 9: kernel 2 at the microbenchmark's B, each time the median of
# KERNEL2_REPS runs after a warm-up; its device time a call from a CUDA
# graph of KERNEL2_CALLS calls (one replay of a graph of one call also
# times the host's submission of the graph, about 15 us on an H100's host).
KERNEL2_B, KERNEL2_REPS, KERNEL2_CALLS = 128, 30, 20
# The flagship's guard ("auto": proximity 2 windows, hard 0.1 window)
# refined to depth 2.
TWO_LEVELS = {"proximity_windows": 2.0, "hard_fraction": 0.1, "levels": 2}
# Main path 12 (d): the violent 8 x 6 problem (kernel_checks.small_problem,
# DEEP_SMALL_TIMEPOINTS timepoints) under that guard at refine 4, at levels
# 2 and 3. Its value and design gradient at levels 2 through kernel 1g
# (the adjoint replays the fired intervals with the kernel's decisions)
# against the plain body's on the host within DEEP_GRAD_TOL of their scale:
# the two forwards differ by rounding (1e-10 of the fields at float64), the
# adjoints replay the same plain body.
DEEP_SMALL_GUARD = dict(TWO_LEVELS, refine=4)
DEEP_SMALL_TIMEPOINTS = 3
DEEP_GRAD_TOL = 1e-9
# Main path 12 (a): the n = 5 rescue (models/flagship.py), held within
# RESCUE_ORACLE_TOL of the f64 odeint oracle at both types (the JAX
# package's own gate for it) and at float64 within OBJECTIVE_TOL of the JAX
# package's f64 value for the same guard.
RESCUE_ORACLE_TOL = 1e-3
# The 96 x 64 lattice (bench.py:405-440) through kernel 2 and through kernel
# 1: the two forwards differ by rounding (the force's summation is the same
# code; the Verlet update is fused on the card in kernel 1, not in the
# stepped forward), which over 1,990 damped substeps stays far below 1e-10
# of the objective at float64.
LARGE_OBJECTIVE_TOL = 1e-10
# Main path 10: the flagship's robustness map, the pulse's amplitude and
# rate each swept by linspace(0.5, 1.5, MAP_POINTS) (bench.py:388-389), all
# scenarios in one launch of kernel 1. A scenario's row takes the same
# operations as the same scenario alone at B = 1 (a thread block a row, the
# same block while the rows do not outnumber the SMs), so its fields are the
# same; its kinetic energy is reduced in an order that follows the batch's
# shape, a few rounding steps (MAP_TOL). The cells of MAP_PLAIN_CELLS are
# held against the plain body on the card at F64_TRAJ_TOL.
MAP_POINTS = 8
MAP_TOL = 1e-12
MAP_PLAIN_CELLS = ((1, 6), (6, 1))
# Their plain-body yardsticks (about 10 ms a plain step on the card, a
# minute in all) run in a process of their own, SIDE_WORKERS, while the
# main process drives main path 2 (host-bound, the card mostly idle); so
# does main path 4 after them, the kagome MMA (as host-bound).
SIDE_WORKERS = 1
# Main path 11: launches of kernel 1 in one value of each family (two
# forward problems for multi-input, two phases of two scenarios for static
# tuning, one solve for the others).
FAMILY_LAUNCHES = {"multi_input": 2, "energy_splitting": 1, "restricted_space": 1, "spin": 1,
                   "static_tuning": 4}

# Main path 13 (the rest of the optimizer and the solver remnants):
# (a) the runner's optax path on the flagship, OPTAX_ITERATIONS float64
# iterations under guard="auto" (kernel 1g), held against the JAX package's
# recorded history (models/flagship.py) at MMA_TOL: the kernel forward's
# rounding (1e-9 of the field scale) reaches the objective at ~1e-12 and the
# gradient at ~1e-9, and Adam's first steps move by lr * sign(g).
OPTAX_ITERATIONS = 2
# (b) run_multistart_optax on OPTAX_B flagship designs (stepped_designs),
# OPTAX_MULTISTART_ITERATIONS iterations through kernel 1 with the batch on
# the grid; candidates OPTAX_CHECKED against B = 1 runs of
# optim.loops.run_optimization_optax from the same designs within
# OPTAX_POPULATION_TOL: a design's forward in the population equals its B = 1
# forward bit for bit, its float64 gradient replays the same operations at
# another batch width (1e-12), and Adam's update is elementwise.
OPTAX_B = 128
OPTAX_MULTISTART_ITERATIONS = 3
OPTAX_CHECKED = (0, 127)
OPTAX_POPULATION_TOL = 1e-12
# (c) the 6 x 6 checkpointed MMA (models/small_configs.py) through kernel 1g
# against the JAX history, as (a): MMA_TOL.
# (d) the periodic kagome (models/kagome_config.py) through kernel 1K:
# value within PERIODIC_VALUE_TOL, the shift triple's gradient within
# PERIODIC_GRAD_TOL of the JAX float64 values (the kernel forward's rounding,
# 1e-9 of the fields, as for the kagome configuration's objective).
PERIODIC_VALUE_TOL, PERIODIC_GRAD_TOL = 1e-8, 1e-7
# (e) the dense rk4, semi-implicit and guarded Verlet runs of the remnant
# lattice on CUDA tensors against the same runs on the host: the same
# operations, so only the two devices' rounding of library functions
# separates them, carried through 16 damped (micro-)steps; the guard's
# decisions must be the same.
REMNANT_TRAJ_TOL, REMNANT_GRAD_TOL = 1e-10, 1e-9
# Main path 14 (statics and linear analysis, models/analysis_configs.py),
# against the JAX package's float64 results recorded there:
# - (a) the hinge fit through kernel 1 ("verlet_pallas") against JAX's
#   "verlet_ckpt": the squared error within HINGE_VALUE_TOL and its
#   stiffness gradient and two GD iterations within HINGE_GRAD_TOL (the
#   kernel forward's rounding, as the flagship's value and gradient);
# - equilibria, reactions and curves (statics, the hinge fit through Newton,
#   continuation paths) within EQ_TOL: the two packages' LU factorizations
#   order their sums differently, a few ulps amplified by the Newton
#   matrix's conditioning; Newton iterations equal;
# - gradients through implicit adjoints (statics, relax_cell, continuation)
#   within IFT_TOL: one more solve and the residual's second derivatives;
# - eigenvalues, bands and moduli within EIG_TOL (cuSOLVER against LAPACK);
#   transmission within TRANSMISSION_TOL (ratios of complex solves near
#   resonances); derivatives of non-degenerate eigenvalues within IFT_TOL;
# - the cross-correlation and the magnetic energy and gradient within
#   CLOSED_FORM_TOL (FFTs and closed forms; the magnetic state is made from
#   a seed, the xcorr's fields are the kernels' at float64, 1e-9 of their
#   scale, whose correlation peak moves by far less);
# - the tunneling report: identical first non-finite timepoint and risky
#   intervals.
HINGE_VALUE_TOL, HINGE_GRAD_TOL = 1e-10, 1e-9
EQ_TOL, IFT_TOL, EIG_TOL, TRANSMISSION_TOL = 1e-9, 1e-7, 1e-9, 1e-8
CLOSED_FORM_TOL = 1e-12
XCORR_TOL = 1e-9


def log(*parts):
    print(*parts, flush=True)


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def stepped_designs(design, B, step, scaled=True):
    """``B`` copies of ``design`` (a tuple of tensors) on a leading
    dimension, copy b scaled by ``1 + step b`` (or, not ``scaled``, shifted
    by ``step b``)."""

    import torch

    def each(x):
        b = torch.arange(B, dtype=x.dtype, device=x.device).view((B,) + (1,) * x.dim())
        return x[None] * (1 + step * b) if scaled else x[None] + step * b

    return tuple(each(x) for x in design)


#: Checks that failed; the script goes on to its end and then exits 1.
FAILED = []


def check(name, err, tol, what="max rel err"):
    ok = err <= tol
    log(f"  {name}: {what} {err:.3e} (tol {tol:.1e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILED.append(f"{name}: {what} {err:.3e} above tolerance {tol:.1e}")


def stats_err(got, ref):
    """Largest difference of two ``(|g|, sum g, g . r)`` summaries, relative
    to the largest entry of ``ref``."""

    return max(abs(a - b) for a, b in zip(got, ref)) / max(abs(x) for x in ref)


def map_scenarios(forward_problem, device):
    """Main path 10's scenarios: the pulse's amplitudes and rates, each the
    problem's swept by linspace(0.5, 1.5, MAP_POINTS), float64."""

    import numpy as np
    import torch

    factors = np.linspace(0.5, 1.5, MAP_POINTS)
    like = dict(device=device, dtype=torch.float64)
    return (torch.as_tensor(forward_problem.amplitude * factors, **like),
            torch.as_tensor(forward_problem.loading_rate * factors, **like))


def map_cells(optimization, design, amplitudes, rates):
    """The target kinetic energy of ``design`` under each (amplitude, rate)
    scenario, one ``solve_scenario`` call."""

    import torch

    from difflexmm_tpu_torch.geometry.polygon import compute_inertia
    from difflexmm_tpu_torch.ops.observables import trajectory_kinetic_energy

    fp = optimization.forward_problem
    target = torch.as_tensor(optimization.target_blocks, device=design[0].device)
    inertia = compute_inertia(fp.geometry.centroid_node_vectors(*design), fp.density)[target]
    solution = fp.solve_scenario(design, amplitudes, rates)
    return trajectory_kinetic_energy(solution.fields[..., 1, target, :], inertia)


def plain_yardsticks():
    """Main paths 10 and 11's plain-body yardsticks on the card (run in a
    process of their own): the target kinetic energies of MAP_PLAIN_CELLS
    of the flagship's robustness map and static tuning's value at its
    example, each with the plain body as the forward (the "verlet_ckpt"
    solvers with ``core.plain_trajectory`` as their spec's forward on the
    card, as for main path 8's yardstick). Returns (cells, value, host
    seconds)."""

    import torch

    from difflexmm_tpu_torch.models import family_configs as fc
    from difflexmm_tpu_torch.models import flagship as fl
    from difflexmm_tpu_torch.ops.kernels import core
    from difflexmm_tpu_torch.ops.kernels.verlet_grid import quad_force

    t0 = time.perf_counter()
    device = torch.device("cuda", torch.cuda.current_device())

    def plain_on_card(solve_dynamics):
        solve_dynamics.specs[device] = solve_dynamics.spec_for(device)._replace(
            forward=core.plain_trajectory)

    flagship, design = fl.build_flagship(method="verlet_ckpt", device=device,
                                         dtype=torch.float64)
    plain_on_card(flagship.forward_problem.solve_dynamics)
    amplitudes, rates = map_scenarios(flagship.forward_problem, device)
    rows, cols = (torch.tensor(ix, device=device) for ix in zip(*MAP_PLAIN_CELLS))
    static, static_design = fc.example_families(method="verlet_ckpt", device=device,
                                                dtype=torch.float64)["static_tuning"]
    plain_on_card(static.forward_problem.solve_dynamics)
    with torch.no_grad():
        cells = map_cells(flagship, design, amplitudes[rows], rates[cols])
        value = float(static.objective_fn(static_design))
    # One plain forward of the two cells, four of static tuning (two phases
    # of two scenarios), and no launch of kernel 2.
    if core.plain_trajectory.calls != 5 or quad_force.launches != 0:
        raise AssertionError("main paths 10-11 yardsticks: the forwards were not the plain body")
    return cells.tolist(), value, time.perf_counter() - t0


def deep_small_objective(device, dtype, levels=2):
    """Main path 12 (d): the focusing objective (target 2 x 2) of the
    violent 8 x 6 problem under DEEP_SMALL_GUARD at ``levels``, and its
    design (the 25-degree rotated square with noise from a seed)."""

    import numpy as np

    from difflexmm_tpu_torch import kernel_checks as kc
    from difflexmm_tpu_torch.models.quads_focusing import OptimizationProblem

    problem = kc.small_problem(n_timepoints=DEEP_SMALL_TIMEPOINTS, device=device, dtype=dtype,
                               guard=dict(DEEP_SMALL_GUARD, levels=levels))
    opt = OptimizationProblem(problem, target_size=(2, 2))
    opt.setup_objective()
    return opt, kc.random_design(problem, np.random.default_rng(13))


def deep_small_value_and_grad(device="cpu", levels=2):
    """The value and flattened design gradient of
    :func:`deep_small_objective` at float64 on ``device`` (on the host: the
    plain body, one thread) and the seconds they took."""

    import torch

    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    opt, design = deep_small_objective(device, torch.float64, levels)
    d = tuple(x.detach().clone().requires_grad_() for x in design)
    t0 = time.perf_counter()
    value = opt.objective_fn(d)
    grads = torch.autograd.grad(value, d)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    grad = torch.cat([g.flatten() for g in grads]).cpu()
    return float(value.detach()), grad, time.perf_counter() - t0


def capturing(opt, grads):
    """Keep the design gradient of every value-and-gradient call of
    ``opt.objective_fn`` (the MMA's), flattened, in ``grads``."""

    objective_fn = opt.objective_fn

    def objective(design):
        value = objective_fn(design)
        if value.requires_grad:
            got = [None] * len(design)
            grads.append(got)
            for i, x in enumerate(design):
                def keep(g, i=i, got=got):
                    got[i] = g.detach().flatten()
                x.register_hook(keep)
        return value

    opt.objective_fn = objective


def kagome_mma():
    """Main path 4 (run in a process of its own on the card, beside main
    path 2): the kagome configuration's guarded MMA through kernel 1Kg, at
    float64, MMA_ITERATIONS iterations with the configuration's settings,
    built guarded as the JAX reference ran (``run_optimization_mma`` re-arms
    "auto"), so that the objective whose gradients are kept is the MMA's.
    Returns the seconds an iteration took (host clock), this process's
    launch counts of the run (its counts set to 0 just before it), and the
    history to hold against JAX's: each iteration's objective, design
    summary, gradient summary and the guard's firing (substeps and
    intervals) at its design."""

    import torch

    from difflexmm_tpu_torch import kernel_checks as kc
    from difflexmm_tpu_torch.models import flagship as fl
    from difflexmm_tpu_torch.models import kagome_config as kg
    from difflexmm_tpu_torch.ops.kernels import core, launch
    from difflexmm_tpu_torch.ops.kernels.verlet_grid import quad_force, verlet_quad_trajectory
    from difflexmm_tpu_torch.ops.kernels.verlet_kagome import verlet_kagome_trajectory

    device = torch.device("cuda", torch.cuda.current_device())
    opt, design = kg.build_kagome(device=device, dtype=torch.float64, guard="auto")
    grads = []
    capturing(opt, grads)
    for wrapper in (verlet_quad_trajectory, verlet_kagome_trajectory):
        launch.reset_counts(wrapper)
    quad_force.launches = 0
    core.plain_trajectory.calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt.run_optimization_mma(design, n_iterations=MMA_ITERATIONS, verbose=False,
                             **kg.KAGOME_MMA_SETTINGS)
    torch.cuda.synchronize()
    out = dict(per_iter=(time.perf_counter() - t0) / MMA_ITERATIONS,
               launches=verlet_kagome_trajectory.guarded_launches,
               plain_calls=core.plain_trajectory.calls, values=list(opt.objective_values),
               design_stats=[fl.design_stats(d, design) for d in opt.design_values],
               grad_stats=[fl.vector_stats(torch.cat(g).cpu().numpy()) for g in grads],
               fired=[], intervals=[])
    for d in opt.design_values:
        with torch.no_grad():
            fired = core.trajectory_forward(kc.batched_args(opt.forward_problem, [d]))[4]
        n_int = fired.shape[1] // opt.forward_problem.n_substeps
        out["fired"].append((int(fired.sum()), fired.numel()))
        out["intervals"].append((int(fired.view(n_int, -1).any(-1).sum()), n_int))
    return out


def remnant_reference(name):
    """Main path 13 (e) on the host (a worker process): the remnant run
    ``name`` at float64, as numpy (fields, value, gradients, decisions)."""

    import torch

    from difflexmm_tpu_torch.models import small_configs as sc

    torch.set_num_threads(1)
    solve, fields, value, grads = sc.remnant_run(name, device="cpu")
    return (fields.detach().numpy(), float(value.detach()), [g.numpy() for g in grads],
            list(solve.decisions))


def counted(fn):
    """Run ``fn`` with this process's counts set to 0 just before it and
    the card synchronised around it: (its result, seconds, {count: value})."""

    import torch

    from difflexmm_tpu_torch.ops.kernels import core, launch
    from difflexmm_tpu_torch.ops.kernels.verlet_grid import quad_force, verlet_quad_trajectory
    from difflexmm_tpu_torch.ops.kernels.verlet_kagome import verlet_kagome_trajectory

    for wrapper in (verlet_quad_trajectory, verlet_kagome_trajectory):
        launch.reset_counts(wrapper)
    quad_force.launches = 0
    core.plain_trajectory.calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(quad=verlet_quad_trajectory.launches,
                  quad_guarded=verlet_quad_trajectory.guarded_launches,
                  kagome=verlet_kagome_trajectory.launches,
                  kagome_guarded=verlet_kagome_trajectory.guarded_launches,
                  force=quad_force.launches, plain=core.plain_trajectory.calls)
    return result, seconds, counts


def only(label, counts, path="13", **expected):
    """The run went through the kernels ``expected`` names, that many
    times, and through nothing else."""

    want = dict(dict.fromkeys(counts, 0), **expected)
    if counts != want:
        raise AssertionError(f"main path {path} {label}: launches {counts}, expected {want}")


def scan_trace(path, kernel, category="kernel"):
    """Stream a Chrome trace of ``torch.profiler`` without loading it (a
    flagship fwd+grad's is gigabytes): (events of ``category``, those of
    them whose name holds ``kernel``, their microseconds in all, and their
    span from the first start to the last end). Kineto writes an event's
    keys on one line or a line each; both are read."""

    import re

    fields = re.compile(r'"(cat|name|ts|dur)": ("[^"]*"|[-0-9.eE+]+)')
    n_events, n_named, busy = 0, 0, 0.0
    first, last = float("inf"), float("-inf")
    inside, ts = False, 0.0
    with open(path) as f:
        for line in f:
            for key, value in fields.findall(line):
                if key == "cat":
                    inside = value == f'"{category}"'
                    n_events += inside
                elif not inside:
                    continue
                elif key == "name":
                    n_named += kernel in value
                elif key == "ts":
                    ts = float(value)
                else:
                    dur = float(value)
                    busy += dur
                    first, last = min(first, ts), max(last, ts + dur)
                    inside = False
    return n_events, n_named, busy, (last - first) if n_events else 0.0


def main_path_13_side():
    """Main path 13's parts beside main path 2 (a process of its own on the
    card, whose work is host-bound, while main path 2's is): (f) one flagship
    value and gradient inside ``utils.observability.trace`` with a
    ``trace_dir`` (its Chrome trace streamed, then removed: it holds every
    kernel of the adjoint's graph replays); (b)'s B = 1 loops of
    ``optim.loops.run_optimization_optax``; (a) the runner's optax path on the
    flagship under ``guard="auto"``; (c) the 6 x 6 checkpointed MMA and its
    resumption; (d) the periodic kagome's value and shift gradient; (e) the
    dense remnant runs on CUDA tensors. Returns each part's numbers, this
    process's launch counts and seconds (host clock); main_path_13 checks
    them."""

    import torch

    from difflexmm_tpu_torch.models import flagship as fl
    from difflexmm_tpu_torch.models import kagome_config as kg
    from difflexmm_tpu_torch.models import small_configs as sc
    from difflexmm_tpu_torch.optim import loops
    from difflexmm_tpu_torch.utils.observability import (
        MetricsLogger,
        OptimizationCheckpoint,
        trace,
    )

    device = torch.device("cuda", torch.cuda.current_device())
    f64 = torch.float64
    out = {}

    # (f)
    opt, design = fl.build_flagship(device=device, dtype=f64)
    traces = os.path.join(REPO, "build", "traces")
    shutil.rmtree(traces, ignore_errors=True)

    def traced():
        with trace("flagship fwd+grad", trace_dir=traces):
            d = tuple(x.detach().clone().requires_grad_() for x in design)
            torch.autograd.grad(opt.objective_fn(d), d)

    _, seconds, counts = counted(traced)
    (path,) = [os.path.join(traces, f) for f in os.listdir(traces)]
    size = os.path.getsize(path)
    out["f"] = dict(seconds=seconds, counts=counts, bytes=size,
                    scan=scan_trace(path, "verlet_quad_kernel"))
    shutil.rmtree(traces)

    # (b)'s B = 1 loops, from the population's candidates OPTAX_CHECKED.
    designs = stepped_designs(design, OPTAX_B, POPULATION_STEP)
    runs, seconds, counts = counted(lambda: [loops.run_optimization_optax(
        opt.objective_fn, tuple(x[b] for x in designs), OPTAX_MULTISTART_ITERATIONS)
        for b in OPTAX_CHECKED])
    out["singles"] = dict(seconds=seconds, counts=counts, runs=[
        (r.objective_values, fl.flat_numpy(r.design_values[-1])) for r in runs])

    # (a) The runner's optax path: it re-arms guard="auto" (kernel 1g).
    final, seconds, counts = counted(
        lambda: opt.run_optimization_optax(design, n_iterations=OPTAX_ITERATIONS, verbose=False))
    out["a"] = dict(seconds=seconds, counts=counts, values=list(opt.objective_values),
                    design_stats=[fl.design_stats(d, design) for d in opt.design_values],
                    final_stats=fl.design_stats(final, design))

    # (c) Two MMA iterations with a logger and a snapshot every iteration,
    # then a fresh problem resumes for one more.
    work = os.path.join(REPO, "build", "main_path_13")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ckpt = OptimizationCheckpoint(os.path.join(work, "opt.ckpt"), every=1)
    logger = MetricsLogger(os.path.join(work, "opt.jsonl"))

    def checkpointed():
        first, start = sc.checkpoint_problem(device=device)
        first.run_optimization_mma(start, n_iterations=sc.CHECKPOINT_ITERATIONS[0],
                                   metrics_logger=logger, checkpoint=ckpt, **sc.CHECKPOINT_MMA)
        second, _ = sc.checkpoint_problem(device=device)
        second.run_optimization_mma(start, n_iterations=sc.CHECKPOINT_ITERATIONS[1],
                                    checkpoint=ckpt, resume=True, **sc.CHECKPOINT_MMA)
        return second, start

    (second, start), seconds, counts = counted(checkpointed)
    out["c"] = dict(seconds=seconds, counts=counts, steps=[r["step"] for r in logger.read()],
                    values=list(second.objective_values),
                    design_stats=[fl.design_stats(d, start) for d in second.design_values],
                    violations={k: list(v) for k, v in second.constraints_violation.items()})

    # (d) The periodic kagome through kernel 1K.
    objective = kg.build_periodic_kagome(device=device, dtype=f64)
    shifts = kg.periodic_shifts(device=device, dtype=f64).requires_grad_()

    def periodic():
        value = objective(shifts)
        return float(value.detach()), torch.autograd.grad(value, shifts)[0].cpu().numpy()

    (value, grad), seconds, counts = counted(periodic)
    out["d"] = dict(seconds=seconds, counts=counts, value=value, grad=grad.ravel())

    # (e) The dense remnant runs on CUDA tensors (plain torch).
    out["e"] = {}
    for name in sc.REMNANT_RUNS:
        (solve, fields, value, grads), seconds, counts = counted(
            lambda name=name: sc.remnant_run(name, device=device))
        out["e"][name] = dict(seconds=seconds, counts=counts,
                              fields=fields.detach().cpu().numpy(),
                              grads=[g.cpu().numpy() for g in grads],
                              decisions=list(solve.decisions))
    return out


def rel_err(got, ref):
    """Largest difference of two arrays (or sequences), relative to the
    largest entry of ``ref`` (absolute where ``ref`` is all zeros)."""

    import numpy as np

    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    scale = float(np.max(np.abs(ref))) if ref.size else 0.0
    return float(np.max(np.abs(got - ref))) / (scale if scale > 0 else 1.0)


def main_path_13(device, results, side_job, remnant_jobs, card_line):
    """Main path 13: the rest of the optimizer and the solver remnants
    through the entry points a user calls. (b)'s population runs here;
    ``side_job`` is :func:`main_path_13_side`'s (the other parts, run
    beside main path 2), ``remnant_jobs`` the host's runs of (e). Checks
    every part, returns the timings and adds the launches to ``results``."""

    import numpy as np
    import torch

    from difflexmm_tpu_torch.models import flagship as fl
    from difflexmm_tpu_torch.models import kagome_config as kg
    from difflexmm_tpu_torch.models import small_configs as sc
    from difflexmm_tpu_torch.parallel import run_multistart_optax

    t13 = time.perf_counter()
    side = side_job.result()
    out = {}

    # (a) The runner's optax path on the flagship, guard="auto" (kernel 1g):
    # each iteration one guarded forward, then compute_best_forward.
    a = side["a"]
    only("(a)", a["counts"], quad_guarded=OPTAX_ITERATIONS + 1)
    log(f"main path 13 (a) (runner optax, flagship, {OPTAX_ITERATIONS} float64 iterations under "
        f"guard='auto', beside main path 2): {a['counts']['quad_guarded']} kernel-1g launches, "
        f"{a['seconds']:.2f} s ({a['seconds'] / OPTAX_ITERATIONS:.2f} s/iter, host clock); "
        f"values {a['values']}")
    check("(a) optax values vs JAX float64", rel_err(a["values"], fl.JAX_F64_OPTAX_VALUES),
          MMA_TOL)
    for k, (got, ref) in enumerate(zip(a["design_stats"], fl.JAX_F64_OPTAX_DESIGN_STATS)):
        check(f"(a) optax design {k} vs JAX float64 (summary)", rel_err(got, ref), MMA_TOL)
    check("(a) optax returned design vs JAX float64 (summary)",
          rel_err(a["final_stats"], fl.JAX_F64_OPTAX_FINAL_STATS), MMA_TOL)
    out.update(optax_flagship_s_per_iter=a["seconds"] / OPTAX_ITERATIONS)

    # (b) run_multistart_optax on a population of the flagship (kernel 1,
    # the batch on the grid), against the B = 1 loops of the side process.
    opt, design = fl.build_flagship(device=device, dtype=torch.float64)
    designs = stepped_designs(design, OPTAX_B, POPULATION_STEP)
    result, seconds, counts = counted(lambda: run_multistart_optax(
        opt.population_objective_fn, designs, OPTAX_MULTISTART_ITERATIONS))
    only("(b)", counts, quad=OPTAX_MULTISTART_ITERATIONS)
    rate = OPTAX_B * OPTAX_MULTISTART_ITERATIONS / seconds
    log(f"main path 13 (b) (run_multistart_optax, {OPTAX_B} flagship designs, "
        f"{OPTAX_MULTISTART_ITERATIONS} float64 iterations): {counts['quad']} kernel-1 launches "
        f"of {OPTAX_B} designs, {seconds:.2f} s, {rate:.2f} designs/s (fwd+grad and the Adam "
        f"step, host clock); best candidate {result.best_index}; {card_line}")
    values = result.objective_values.cpu().numpy()
    if values.shape != (OPTAX_MULTISTART_ITERATIONS, OPTAX_B) or not np.isfinite(values).all():
        raise AssertionError(f"main path 13 (b): values of shape {values.shape}, finite "
                             f"{bool(np.isfinite(values).all())}")
    singles = side["singles"]
    only("(b) B = 1", singles["counts"], quad=OPTAX_MULTISTART_ITERATIONS * len(OPTAX_CHECKED))
    log(f"  (b) B = 1 loops of candidates {OPTAX_CHECKED} (beside main path 2): "
        f"{singles['counts']['quad']} kernel-1 launches, "
        f"{singles['seconds'] / singles['counts']['quad']:.2f} s/iter")
    for b, (single_values, single_design) in zip(OPTAX_CHECKED, singles["runs"]):
        check(f"(b) candidate {b}: population values vs B = 1 loop",
              rel_err(values[:, b], single_values), OPTAX_POPULATION_TOL)
        check(f"(b) candidate {b}: evaluated design vs B = 1 loop",
              rel_err(np.concatenate([x[b].cpu().numpy().ravel() for x in result.designs]),
                      single_design), OPTAX_POPULATION_TOL)
    out.update(optax_multistart_s=seconds, optax_multistart_designs_per_s=rate,
               optax_single_s_per_iter=singles["seconds"] / singles["counts"]["quad"])

    # (c) The checkpointed MMA on the 6 x 6 problem through kernel 1g.
    c = side["c"]
    log(f"main path 13 (c) (6x6 MMA, checkpoint every iteration, resumed): "
        f"{c['counts']['quad_guarded']} kernel-1g launches, {c['seconds']:.2f} s, "
        f"{len(c['steps'])} logged lines, values {c['values']}")
    if c["counts"]["quad_guarded"] < sum(sc.CHECKPOINT_ITERATIONS) or any(
            v for k, v in c["counts"].items() if k != "quad_guarded"):
        raise AssertionError(f"main path 13 (c): launches {c['counts']}")
    if c["steps"] != [1, 2]:
        FAILED.append(f"main path 13 (c): the logger holds steps {c['steps']}, not [1, 2]")
    if len(c["values"]) != len(sc.JAX_F64_CHECKPOINT_VALUES):
        raise AssertionError(f"main path 13 (c): {len(c['values'])} history entries")
    check("(c) resumed history values vs JAX float64",
          rel_err(c["values"], sc.JAX_F64_CHECKPOINT_VALUES), MMA_TOL)
    for k, (got, ref) in enumerate(zip(c["design_stats"], sc.JAX_F64_CHECKPOINT_DESIGN_STATS)):
        check(f"(c) resumed history design {k} vs JAX float64 (summary)", rel_err(got, ref),
              MMA_TOL)
    for name, ref in sc.JAX_F64_CHECKPOINT_VIOLATIONS.items():
        check(f"(c) resumed {name} violations vs JAX float64",
              rel_err(c["violations"][name], ref), MMA_TOL)
    out.update(checkpoint_mma_s=c["seconds"])

    # (d) The periodic kagome's value and shift-triple gradient (kernel 1K).
    d = side["d"]
    only("(d)", d["counts"], kagome=1)
    log(f"main path 13 (d) (periodic kagome 16x16, value and gradient): "
        f"{d['counts']['kagome']} kernel-1K launch, {d['seconds']:.2f} s; value "
        f"{d['value']!r} (JAX f64 {kg.JAX_F64_PERIODIC_OBJECTIVE!r})")
    check("(d) periodic kagome value vs JAX float64",
          rel_err(d["value"], kg.JAX_F64_PERIODIC_OBJECTIVE), PERIODIC_VALUE_TOL)
    check("(d) periodic kagome shift gradient vs JAX float64",
          rel_err(d["grad"], kg.JAX_F64_PERIODIC_GRAD), PERIODIC_GRAD_TOL)
    out.update(periodic_kagome_fwd_grad_s=d["seconds"])

    # (e) The dense runs on CUDA tensors against the same on the host.
    dense = {}
    for name, e in side["e"].items():
        only(f"(e) {name}", e["counts"])  # plain torch: no kernel of this repository
        ref_fields, _, ref_grads, ref_decisions = remnant_jobs[name].result()
        if e["decisions"] != ref_decisions:
            FAILED.append(f"main path 13 (e) {name}: the guard's decisions differ from the host's")
        check(f"(e) {name} fields: CUDA vs host", rel_err(e["fields"], ref_fields),
              REMNANT_TRAJ_TOL)
        check(f"(e) {name} design gradient: CUDA vs host",
              rel_err(np.concatenate([g.ravel() for g in e["grads"]]),
                      np.concatenate([g.ravel() for g in ref_grads])), REMNANT_GRAD_TOL)
        dense[name] = dict(s=e["seconds"], fired=sum(f for _, f in e["decisions"]),
                           decisions=len(e["decisions"]))
    log("main path 13 (e) (dense remnant lattice on CUDA tensors): " + ", ".join(
        f"{k} {v['s']:.2f} s" + (f" (guard fired {v['fired']} of {v['decisions']})"
                                 if v["decisions"] else "") for k, v in dense.items()))
    out["dense_remnants"] = dense

    # (f) One flagship fwd+grad under the profiler: the trace lists kernel 1.
    f = side["f"]
    only("(f)", f["counts"], quad=1)
    n_kernels, n_quad, busy_us, span_us = f["scan"]
    log(f"main path 13 (f) (flagship fwd+grad in observability.trace): 1 kernel-1 launch; the "
        f"trace ({f['bytes']} bytes) lists {n_kernels} kernels, {n_quad} of them "
        f"verlet_quad_kernel; kernels busy {busy_us / 1e6:.3f} s of the {span_us / 1e6:.3f} s "
        f"from the first kernel to the last; {f['seconds']:.2f} s with the profiler on and the "
        f"trace written; {card_line}")
    if n_quad != f["counts"]["quad"]:
        FAILED.append(f"main path 13 (f): the trace lists {n_quad} launches of kernel 1, the "
                      f"wrapper counted {f['counts']['quad']}")
    out.update(traced_fwd_grad_s=f["seconds"], trace_bytes=f["bytes"],
               trace_kernel_events=n_kernels, trace_kernel_busy_us=busy_us,
               trace_kernel_span_us=span_us)

    results["verlet_quad"]["launches_by_path"]["13"] = (
        singles["counts"]["quad"] + f["counts"]["quad"])
    results["verlet_quad_population"].setdefault("launches_by_path", {
        "8": results["verlet_quad_population"]["launches"]})["13"] = counts["quad"]
    results["verlet_quad_guarded"]["launches_by_path"]["13"] = (
        a["counts"]["quad_guarded"] + c["counts"]["quad_guarded"])
    results["verlet_kagome"].setdefault("launches_by_path", {
        "3": results["verlet_kagome"]["launches"]})["13"] = d["counts"]["kagome"]
    out["main_path_13_s"] = time.perf_counter() - t13
    return out


def main_path_14_side():
    """Main path 14's parts (a)-(f) beside main path 2 (a process of its own
    on the card): the hinge fit through kernel 1 and through Newton, the
    flagship's static tension and modes, the snap-through continuation, the
    strip's transmission and Bloch gap, and the Bloch and homogenization
    examples. Returns each part's numbers, launch counts and seconds (host
    clock); main_path_14 checks them."""

    import torch

    from difflexmm_tpu_torch.models import analysis_configs as ac

    device = torch.device("cuda", torch.cuda.current_device())
    f64 = torch.float64
    out = {}
    for method in ("verlet_pallas", "static"):
        result, seconds, counts = counted(lambda method=method: ac.run_hinge(
            method, device, f64, gd=method == "verlet_pallas"))
        out[f"a_{method}"] = dict(result, seconds=seconds, counts=counts)
    parts = {"b": lambda: ac.run_flagship_static(device, f64),
             "c": lambda: ac.flagship_modes(device, f64),
             "d": lambda: ac.run_snap(device, f64),
             "e_transmission": lambda: ac.strip_transmission(device, f64),
             "e_gap": lambda: ac.bloch_gap(device, f64),
             "f_kagome": lambda: ac.run_kagome_gap(device, f64),
             "f_effective": lambda: ac.effective_row(device, f64),
             "f_poisson": lambda: ac.run_poisson(device, f64),
             "f_waveguide": lambda: ac.run_waveguide(device, f64)}
    for name, fn in parts.items():
        result, seconds, counts = counted(fn)
        out[name] = dict(result=result, seconds=seconds, counts=counts)
    out["ended_at"] = time.time()
    return out


def rescue_plain_first_nonfinite():
    """The first non-finite timepoint of the unguarded n = 5 rescue through
    the plain body on a host core (float64): where kernel 1's trajectory
    must turn non-finite too."""

    import torch

    from difflexmm_tpu_torch.models import flagship as fl
    from difflexmm_tpu_torch.solver.diagnose import first_nonfinite_timepoint

    torch.set_num_threads(1)
    opt, design = fl.build_flagship(n_substeps=fl.RESCUE_N5_SUBSTEPS, device="cpu",
                                    dtype=torch.float64)
    with torch.no_grad():
        return first_nonfinite_timepoint(opt.forward_problem.solve(design).fields)


def main_path_14(device, results, side_job, nan_job, card_line):
    """Main path 14: statics and linear analysis through the entry points a
    user calls. (a)-(f) come from ``side_job`` (:func:`main_path_14_side`,
    run beside main path 2); (g) runs here: the tunneling report of the n =
    5 rescue's trajectories (unguarded through kernel 1, NaN; the
    travel-only guard through kernel 1g; ``nan_job`` gives the plain body's
    first non-finite timepoint of the unguarded one), the space-time
    cross-correlation
    of main path 1's flagship field (its forward again through kernel 1)
    against the rescued one, and the magnetic energy and gradient on a
    flagship state.
    Checks every part against models/analysis_configs.py's JAX float64
    results; returns the timings and adds the launches to ``results``."""

    import numpy as np
    import torch

    from difflexmm_tpu_torch.models import analysis_configs as ac
    from difflexmm_tpu_torch.models import flagship as fl
    from difflexmm_tpu_torch.objectives import compute_space_time_xcorr
    from difflexmm_tpu_torch.solver.diagnose import contact_tunneling_report

    t14 = time.perf_counter()
    side = side_job.result()
    out = {}

    # (a) The hinge fit through kernel 1: each forward one launch per sample.
    a = side["a_verlet_pallas"]
    forwards = 1 + ac.HINGE_GD_ITERATIONS + 1  # the value, GD's, the fitted responses
    only("(a)", a["counts"], path="14", quad=forwards * len(ac.HINGE_LOADINGS))
    ref = ac.JAX_F64_HINGE_VERLET_CKPT
    log(f"main path 14 (a) (hinge fit, 3x3-cell samples, tension and shear, 25 timepoints, 48 "
        f"substeps, verlet_pallas, beside main path 2): {a['counts']['quad']} kernel-1 launches, "
        f"{a['seconds']:.2f} s for the value, gradient and {ac.HINGE_GD_ITERATIONS} GD "
        f"iterations; squared error {a['value']!r} (JAX verlet_ckpt {ref['value']!r})")
    check("(a) hinge squared error through kernel 1 vs JAX float64",
          rel_err(a["value"], ref["value"]), HINGE_VALUE_TOL)
    check("(a) hinge stiffness gradient through kernel 1 vs JAX float64",
          rel_err(a["grad"], ref["grad"]), HINGE_GRAD_TOL)
    for key in ("gd_values", "gd_designs", "gd_final"):
        check(f"(a) hinge GD {key} vs JAX float64", rel_err(a[key], ref[key]), HINGE_GRAD_TOL)
    s = side["a_static"]
    only("(a) static", s["counts"], path="14")
    ref = ac.JAX_F64_HINGE_STATIC
    log(f"  (a) the same through Newton (method='static'): {s['seconds']:.2f} s, Newton "
        f"iterations {s['iterations']} (JAX {ref['iterations']}); squared error {s['value']!r} "
        f"(JAX {ref['value']!r})")
    check("(a) hinge squared error through Newton vs JAX float64",
          rel_err(s["value"], ref["value"]), EQ_TOL)
    check("(a) hinge stiffness gradient through Newton vs JAX float64",
          rel_err(s["grad"], ref["grad"]), IFT_TOL)
    for lt in ac.HINGE_LOADINGS:
        if list(s["iterations"][lt]) != list(ref["iterations"][lt]):
            FAILED.append(f"main path 14 (a) {lt}: Newton iterations {s['iterations'][lt]}, "
                          f"JAX {list(ref['iterations'][lt])}")

    # (b) Static tension of the flagship lattice (1,152 DOFs, 8 load steps).
    b = side["b"]
    only("(b)", b["counts"], path="14")
    r, ref = b["result"], ac.JAX_F64_FLAGSHIP_STATIC
    log(f"main path 14 (b) (flagship static tension, {ac.FLAGSHIP_STATIC_STEPS} load steps): "
        f"{b['seconds']:.2f} s (curve and its stiffness gradient {r['seconds']:.2f} s); one "
        f"Newton Jacobian {r['jacobian_s'] * 1e3:.1f} ms, one solve {r['solve_s'] * 1e3:.1f} ms "
        f"at the last equilibrium; Newton iterations {r['iterations']} (JAX "
        f"{list(ref['iterations'])}); {card_line}")
    check("(b) flagship static curve vs JAX float64", rel_err(r["curve"], ref["curve"]), EQ_TOL)
    check("(b) flagship static stiffness gradient vs JAX float64",
          rel_err(r["grad"], ref["grad"]), IFT_TOL)
    if list(r["iterations"]) != list(ref["iterations"]):
        FAILED.append(f"main path 14 (b): Newton iterations {r['iterations']}, JAX "
                      f"{list(ref['iterations'])}")

    # (c) The flagship's lowest 20 modes.
    c = side["c"]
    only("(c)", c["counts"], path="14")
    log(f"main path 14 (c) (flagship modes, 1,152 DOFs): {c['seconds']:.2f} s (Hessian and "
        f"eigh); lowest {ac.N_MODES} omega^2 from {float(c['result'][0])!r} to "
        f"{float(c['result'][-1])!r}")
    check("(c) flagship lowest 20 eigenvalues vs JAX float64",
          rel_err(c["result"], ac.JAX_F64_FLAGSHIP_MODES), EIG_TOL)

    # (d) The snap-through path and the limit load's gradient.
    d = side["d"]
    only("(d)", d["counts"], path="14")
    r, ref = d["result"], ac.JAX_F64_SNAP
    log(f"main path 14 (d) (snap-through, 60 steps at ds 0.04, limit load over 12 at 0.03): "
        f"{d['seconds']:.2f} s; folds {[int(i) for i in r['folds']]} (JAX "
        f"{list(ref['folds'])}); limit load {r['limit']!r} (JAX {ref['limit']!r}), d/dh "
        f"{r['limit_grad']!r}")
    if not r["converged"] or list(r["folds"]) != list(ref["folds"]):
        FAILED.append(f"main path 14 (d): converged {r['converged']}, folds {r['folds']}")
    check("(d) snap-through load factors vs JAX float64",
          rel_err(r["load_factor"], ref["load_factor"]), EQ_TOL)
    check("(d) snap-through apex drops vs JAX float64", rel_err(r["drop"], ref["drop"]), EQ_TOL)
    check("(d) stability eigenvalues vs JAX float64",
          rel_err(r["stability"], ref["stability"]), EIG_TOL)
    check("(d) limit load vs JAX float64", rel_err(r["limit"], ref["limit"]), EQ_TOL)
    check("(d) limit load gradient vs JAX float64",
          rel_err(r["limit_grad"], ref["limit_grad"]), IFT_TOL)

    # (e) Transmission of the 8 x 3-cell strip and its cell's Bloch gap.
    e, g = side["e_transmission"], side["e_gap"]
    log(f"main path 14 (e) (transmission, 8x3 cells, 80 frequencies): {e['seconds']:.2f} s; "
        f"Bloch gap {g['result']} at {ac.BLOCH_GRID}x{ac.BLOCH_GRID} k-points "
        f"{g['seconds']:.2f} s (JAX {ac.JAX_F64_BLOCH_GAP})")
    check("(e) transmission vs JAX float64",
          rel_err(e["result"], ac.JAX_F64_TRANSMISSION), TRANSMISSION_TOL)
    check("(e) Bloch gap vs JAX float64", rel_err(g["result"], ac.JAX_F64_BLOCH_GAP), EIG_TOL)

    # (f) Bloch design and homogenization.
    fk, fe, fp, fw = (side[k] for k in ("f_kagome", "f_effective", "f_poisson", "f_waveguide"))
    log(f"main path 14 (f) (kagome gap and shift gradient {fk['seconds']:.2f} s, effective "
        f"row {fe['seconds']:.2f} s, Poisson ratio and gradient {fp['seconds']:.2f} s, "
        f"waveguide {fw['seconds']:.2f} s): gap {fk['result']['value']!r}, (E_x, nu_xy, G_xy) "
        f"{[float(x) for x in fe['result']]}, nu {fp['result']['nu']!r}, guided frequency at "
        f"kx = 0.3 b1 "
        f"{fw['result']['guided_op']!r}")
    check("(f) kagome gap vs JAX float64",
          rel_err(fk["result"]["value"], ac.JAX_F64_KAGOME_GAP["value"]), EIG_TOL)
    check("(f) kagome gap shift gradient vs JAX float64",
          rel_err(fk["result"]["grad"], ac.JAX_F64_KAGOME_GAP["grad"]), IFT_TOL)
    check("(f) effective constants vs JAX float64",
          rel_err(fe["result"], ac.JAX_F64_EFFECTIVE_ROW), EIG_TOL)
    check("(f) Poisson ratio vs JAX float64",
          rel_err(fp["result"]["nu"], ac.JAX_F64_POISSON["nu"]), EIG_TOL)
    check("(f) Poisson loss gradient vs JAX float64",
          rel_err(fp["result"]["grad"], ac.JAX_F64_POISSON["grad"]), IFT_TOL)
    for key in ("gap", "guided", "weight", "guided_op"):
        check(f"(f) waveguide {key} vs JAX float64",
              rel_err(fw["result"][key], ac.JAX_F64_WAVEGUIDE[key]), EIG_TOL)
    check("(f) guided frequency's derivative in log k_rot vs JAX float64",
          rel_err(fw["result"]["guided_op_grad"], ac.JAX_F64_WAVEGUIDE["guided_op_grad"]),
          IFT_TOL)
    # Plain PyTorch: no kernel of this repository in (e) and (f).
    for name in ("e_transmission", "e_gap", "f_kagome", "f_effective", "f_poisson",
                 "f_waveguide"):
        only(f"({name})", side[name]["counts"], path="14")

    # (g) Here: the tunneling report of the n = 5 rescue's trajectories, and
    # main path 1's flagship field.
    def field(n_substeps, guard):
        opt, design = fl.build_flagship(n_substeps=n_substeps, device=device,
                                        dtype=torch.float64, guard=guard)
        fp_ = opt.forward_problem
        with torch.no_grad():
            sol = fp_.solve(design)
        return sol.fields, sol.timepoints, fp_

    fields, seconds_g, counts_g = counted(lambda: {
        "flagship": field(fl.N_SUBSTEPS, None),
        "n5_plain": field(fl.RESCUE_N5_SUBSTEPS, None),
        "n5_guarded": field(fl.RESCUE_N5_SUBSTEPS, fl.RESCUE_N5_GUARDS["levels1"])})
    only("(g)", counts_g, path="14", quad=2, quad_guarded=1)
    flagship_fields = fields.pop("flagship")[0]
    # After the unguarded trajectory blows up (|u| ~ 1e21 mm at timepoint 30,
    # growing a thousandfold an interval), JAX's XLA forward turns NaN one
    # interval later, the port's only when squares overflow (|u| ~ 1e158):
    # its first non-finite timepoint is held against the plain body's on the
    # host, JAX's is logged beside it; the risky intervals against JAX's.
    plain_first = nan_job.result()
    for name, (f, ts, fp_) in fields.items():
        report = contact_tunneling_report(f, ts, fl.RESCUE_N5_SUBSTEPS, fp_.min_angle,
                                          fp_.cutoff_angle)
        ref = ac.JAX_F64_TUNNELING[name]
        risky = np.nonzero(report.risky_intervals.cpu().numpy())[0]
        want = plain_first if name == "n5_plain" else ref["first_nonfinite"]
        plain_note = f"plain body on the host {plain_first}, " if name == "n5_plain" else ""
        log(f"main path 14 (g) tunneling report of the n = 5 rescue, {name}: first non-finite "
            f"timepoint {report.first_nonfinite} ({plain_note}JAX {ref['first_nonfinite']}), "
            f"{len(risky)} risky intervals (JAX {len(ref['risky'])})")
        if report.first_nonfinite != want or list(risky) != list(ref["risky"]):
            FAILED.append(f"main path 14 (g) {name}: report ({report.first_nonfinite}, "
                          f"{list(risky)}) differs from ({want}, {list(ref['risky'])})")
        if name == "n5_plain" and report.first_nonfinite is None:
            FAILED.append("main path 14 (g): the unguarded n = 5 rescue stayed finite")

    def space_time(f):
        return torch.linalg.norm(f[:, 0, :, :2], dim=-1).T

    t0 = time.perf_counter()
    value, delay = compute_space_time_xcorr(space_time(flagship_fields),
                                            space_time(fields["n5_guarded"][0]))
    value, delay = float(value), int(delay)
    xcorr_s = time.perf_counter() - t0
    log(f"  (g) space-time xcorr of main path 1's flagship field against the rescued n = 5 "
        f"field: {value!r}, delay {delay} (JAX {ac.JAX_F64_XCORR}), {xcorr_s * 1e3:.1f} ms")
    check("(g) space-time xcorr vs JAX float64", rel_err(value, ac.JAX_F64_XCORR[0]), XCORR_TOL)
    if delay != ac.JAX_F64_XCORR[1]:
        FAILED.append(f"main path 14 (g): xcorr delay {delay}, JAX {ac.JAX_F64_XCORR[1]}")
    magnetic, magnetic_s, counts_m = counted(lambda: ac.run_magnetic(device, torch.float64))
    only("(g) magnetic", counts_m, path="14")
    log(f"  (g) magnetic energy on a flagship state (384 dipoles, CUDA): "
        f"{magnetic['energy']!r} (JAX {ac.JAX_F64_MAGNETIC['energy']!r}), {magnetic_s:.3f} s")
    check("(g) magnetic energy vs JAX float64",
          rel_err(magnetic["energy"], ac.JAX_F64_MAGNETIC["energy"]), CLOSED_FORM_TOL)
    check("(g) magnetic gradient vs JAX float64 (summary)",
          stats_err(magnetic["grad_stats"], ac.JAX_F64_MAGNETIC["grad_stats"]), CLOSED_FORM_TOL)

    results["verlet_quad"]["launches_by_path"]["14"] = a["counts"]["quad"] + counts_g["quad"]
    results["verlet_quad_guarded"]["launches_by_path"]["14"] = counts_g["quad_guarded"]
    out.update({f"main_path_14_{k}_s": v["seconds"] for k, v in side.items()
                if isinstance(v, dict)},
               main_path_14_flagship_jacobian_s=side["b"]["result"]["jacobian_s"],
               main_path_14_flagship_solve_s=side["b"]["result"]["solve_s"],
               main_path_14_g_s=seconds_g + xcorr_s + magnetic_s)
    out["main_path_14_s"] = time.perf_counter() - t14
    return out


def main():
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    spawn = multiprocessing.get_context("spawn")
    pool = ProcessPoolExecutor(PLAIN_WORKERS, mp_context=spawn)
    side = ProcessPoolExecutor(SIDE_WORKERS, mp_context=spawn)
    side13 = ProcessPoolExecutor(1, mp_context=spawn)
    side14 = ProcessPoolExecutor(1, mp_context=spawn)
    try:
        smoke(pool, side, side13, side14)
    finally:
        pool.shutdown(cancel_futures=True)
        side.shutdown(cancel_futures=True)
        side13.shutdown(cancel_futures=True)
        side14.shutdown(cancel_futures=True)


def smoke(pool, side, side13, side14):
    """Everything but the set-up: ``pool`` runs the plain body's
    trajectories on host cores (see below), ``side`` main paths 10 and
    11's plain-body yardsticks and main path 4 on the card, ``side13`` main
    path 13's parts beside main path 2 (:func:`main_path_13_side`),
    ``side14`` main path 14's (a)-(f) beside them (:func:`main_path_14_side`)."""

    import torch

    device = torch.device("cuda")
    started = time.perf_counter()

    def phase_done(name):
        log(f"[{name} done at {time.perf_counter() - started:.1f} s]")

    card_line = card()
    log(card_line)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import numpy as np

    from concurrent.futures import ThreadPoolExecutor

    from difflexmm_tpu_torch import kernel_checks as kc
    from difflexmm_tpu_torch.models import flagship as fl
    from difflexmm_tpu_torch.models import kagome_config as kg
    from difflexmm_tpu_torch.models import loaded_configs as lc
    from difflexmm_tpu_torch.models import small_configs as sc
    from difflexmm_tpu_torch.ops.kernels import build, core, launch
    from difflexmm_tpu_torch.ops.kernels.verlet_grid import (
        carry_bytes,
        force_tile,
        quad_force,
        quad_grid_force_planes,
        quad_grid_energy_planes,
        verlet_quad_trajectory,
    )
    from difflexmm_tpu_torch.ops.kernels.verlet_kagome import verlet_kagome_trajectory

    f64, f32 = torch.float64, torch.float32
    dtypes = (f64, f32)
    results = {"verlet_quad": {}, "verlet_quad_guarded": {}, "verlet_kagome": {},
               "verlet_kagome_guarded": {}, "verlet_quad_loaded": {},
               "verlet_quad_population": {}, "verlet_kagome_population": {}, "quad_force": {}}

    def reset_counts():
        """Every launch count and the plain-body count to 0."""

        for wrapper in (verlet_quad_trajectory, verlet_kagome_trajectory):
            launch.reset_counts(wrapper)
        quad_force.launches = 0
        core.plain_trajectory.calls = 0

    def finite(outs, label):
        for name, x in zip("UVA", outs):
            if not bool(torch.isfinite(x).all()):
                raise AssertionError(f"{label}: {name} is not finite")

    # -- build: every source started together (the trajectory sources one nvcc a
    # type), in the background ---------------------------------------------------
    t0 = time.perf_counter()
    sources = ("verlet_quad", "verlet_kagome", "quad_force")
    builders = ThreadPoolExecutor(len(sources))
    builds = [builders.submit(build.load, name) for name in sources]

    # -- the inputs, and the plain body's runs on them --------------------------
    # The plain body (``core.plain_trajectory``) takes seconds to minutes per
    # trajectory where the kernel takes milliseconds: the host launches
    # each of its small operations. Its runs go to worker processes, one CPU
    # core each, on CPU copies of the very inputs the kernels get, and run
    # while the kernels build and the checks go on.
    rng = np.random.default_rng(0)
    small = kc.small_problem(device=device, dtype=f64)
    cases = {f"small 8x6 B={B}": kc.batched_args(small, [kc.random_design(small, rng)
                                                         for _ in range(B)]) for B in (1, 4)}
    # A lattice whose carry does not fit in shared memory: global workspace.
    big = kc.small_problem(n1=56, n2=48, n_timepoints=3, n_substeps=4, device=device,
                           dtype=f64, simulation_time=2.7e-4)
    cases["workspace 56x48 B=2"] = kc.batched_args(big, [kc.random_design(big, rng)] * 2)
    probe, mag = kc.contact_probe(device=device, dtype=f64)
    cases["contact probe"] = probe
    flagship_opt, flagship_design = fl.build_flagship(device=device, dtype=f64)
    cases["flagship 24x16"] = kc.batched_args(flagship_opt.forward_problem, [flagship_design])
    # Guarded: both the proximity and the hard term fire on the probe;
    # nothing fires on the tame case.
    cases["contact probe auto"] = kc.contact_probe(device=device, dtype=f64, guard="auto")[0]
    cases["small 8x6 tame auto"] = kc.batched_args(
        kc.small_problem(device=device, guard="auto", amplitude_scale=0.01),
        [kc.random_design(small, rng)])
    cases["flagship 24x16 auto"] = kc.batched_args(
        fl.build_flagship(device=device, dtype=f64, guard="auto")[0].forward_problem,
        [flagship_design])
    small_k = kc.small_kagome(device=device, dtype=f64)
    cases.update({f"kagome 4x3 B={B}": kc.batched_args(
        small_k, [kc.random_kagome_design(small_k, rng) for _ in range(B)]) for B in (1, 4)})
    kprobe, kmag = kc.kagome_contact_probe(device=device, dtype=f64)
    cases["kagome contact probe"] = kprobe
    kagome_opt, kagome_design = kg.build_kagome(device=device, dtype=f64)
    cases["kagome 16x16"] = kc.batched_args(kagome_opt.forward_problem, [kagome_design])
    cases["kagome contact probe auto"] = kc.kagome_contact_probe(device=device, dtype=f64,
                                                                 guard="auto")[0]
    cases["kagome 4x3 tame auto"] = kc.batched_args(
        kc.small_kagome(device=device, guard="auto", amplitude_scale=0.01),
        [kc.random_kagome_design(small_k, rng)])
    cases["kagome 16x16 auto"] = kc.batched_args(
        kg.build_kagome(device=device, dtype=f64, guard="auto")[0].forward_problem,
        [kagome_design])
    # Kernel 1L: loads in each of the four instantiations, at the force
    # pulse of main path 5 (whole, and its first PULSE_F32_INTERVALS
    # intervals for the float32 rule) and at main path 6's tensile chain.
    cases.update(kc.loaded_cases(device=device, dtype=f64))
    pulse64 = lc.pulse_problem(device, f64)
    with torch.no_grad():
        cases["pulse 20x10"] = pulse64[0].trajectory_args(
            pulse64[2], pulse64[3], pulse64[1](*lc.pulse_inputs(device, f64)))
        tensile64 = lc.tensile_problem(device, f64)
        cases["tensile chain 0.6"] = tensile64[0].trajectory_args(
            tensile64[2], tensile64[3], tensile64[1](0.6))
    cases["pulse 20x10 prefix"] = kc.prefix(cases["pulse 20x10"], PULSE_F32_INTERVALS)
    # Main path 12: guard levels > 1 through kernels 1g, 1Kg and guarded 1L,
    # (c) the kagome configuration and (d) the violent 8 x 6 problem; (b),
    # the flagship's, needs main path 2's iterate and comes after it.
    deep_labels = ["kagome 16x16 levels 2"]
    cases[deep_labels[0]] = kc.batched_args(
        kg.build_kagome(device=device, dtype=f64, guard=TWO_LEVELS)[0].forward_problem,
        [kagome_design])
    for levels in (2, 3):
        deep_opt, deep_design = deep_small_objective(device, f64, levels)
        label = f"8x6 violent levels {levels}"
        cases[label] = kc.batched_args(deep_opt.forward_problem, [deep_design])
        deep_labels.append(label)
    cases["8x6 violent levels 2 loads"] = kc.with_loads(cases["8x6 violent levels 2"],
                                                        kc.QUAD_LOAD_PAIRS)
    deep_labels.append("8x6 violent levels 2 loads")
    # Main path 9 (c): guard levels = 2 through method="verlet_ckpt" on the
    # violent 8 x 6 problem, whose micro-steps fire at depth 2 too.
    deep_small = kc.batched_args(
        kc.small_problem(n_timepoints=4, device=device, guard=TWO_LEVELS, method="verlet_ckpt"),
        [kc.random_design(small, rng)])

    # The dense method="verlet" runs of main paths 5 and 6 (float64, on the
    # CPU), the longest first.
    dense_jobs = {("tensile", strain): pool.submit(lc.dense_reference, "tensile", strain)
                  for strain in lc.TENSILE_STRAINS}
    dense_jobs["pulse"] = pool.submit(lc.dense_reference, "pulse")

    plain_jobs = {}

    def submit(label):
        """The plain body's runs on case ``label``: float64 (its guard traced
        where guarded), float32, and float64 on the float32-rounded inputs
        (the float32 runs' reference)."""

        args64 = cases[label]
        args32 = kc.cast(args64, f32)
        plain_jobs[label] = {
            name: pool.submit(kc.plain_reference, kc.to_bytes(kc.on_cpu(args)), traced)
            for name, args, traced in (("64", args64, args64.spec.guard is not None),
                                       ("32", args32, False), ("ref", kc.cast(args32, f64), False))
        }

    # The configurations' runs (the longest) first; main path 12's last,
    # needed only at its end.
    firsts = [label for label in cases if label not in deep_labels]
    for label in sorted(firsts, key=lambda label: not ("16" in label or "20x10" in label)):
        submit(label)
    deep_jobs = {"8x6 violent": pool.submit(kc.plain_reference,
                                            kc.to_bytes(kc.on_cpu(deep_small)))}
    for label in deep_labels:
        submit(label)
    deep_grad_job = pool.submit(deep_small_value_and_grad)
    # Main path 13 (e)'s host runs, needed at the script's end.
    remnant_jobs = {name: pool.submit(remnant_reference, name) for name in sc.REMNANT_RUNS}
    log(f"plain body: {3 * len(cases) + 2} runs of {len(cases) + 1} cases sent to "
        f"{PLAIN_WORKERS} worker processes at {time.perf_counter() - started:.1f} s")

    def plain(label, name):
        return kc.from_bytes(plain_jobs[label][name].result())

    def against_plain(label, tol64=F64_TRAJ_TOL, f32_rule=True):
        """The kernel (``args.spec.forward``) on case ``label`` against the
        plain body on the same inputs, at float64 (within ``tol64``) and at
        float32 (the rule above; without ``f32_rule`` the float32 errors
        are logged, not checked). Returns the float64 kernel outputs, the
        guard summary of the plain float64 run (None unguarded) and the
        errors."""

        args64 = cases[label]
        k64 = core.trajectory_forward(args64)
        finite(k64[:3], f"{label} float64 kernel")
        p64, _, summary = plain(label, "64")
        k64_cpu = [x.cpu() for x in k64]
        for name, k, p in zip("UVA", k64_cpu, p64):
            check(f"{label} float64 {name}", kc.max_rel_err(k, p), tol64)
        if args64.spec.guard is not None:
            if len(k64_cpu) != len(p64) or not all(torch.equal(k, p) for k, p in
                                                    zip(k64_cpu[3:], p64[3:])):
                raise AssertionError(f"{label}: float64 decisions of kernel and plain body differ")
            deep = "".join(f", {int(t.sum())} of {t.numel()} micro-steps of depth {d}"
                           for d, t in enumerate(k64_cpu[5:], start=1))
            log(f"  {label} float64: decisions of every depth identical, "
                f"{int(k64_cpu[4].sum())} of {k64_cpu[4].numel()} substeps fired{deep}")
        k32 = [x.cpu() for x in core.trajectory_forward(kc.cast(args64, f32))]
        finite(k32[:3], f"{label} float32 kernel")
        p32, plain_ms, _ = plain(label, "32")
        ref = plain(label, "ref")[0]
        plain_errors = {}
        for name, k, p, r in zip("UVA", k32, p32, ref):
            e_plain = plain_errors[name] = kc.max_rel_err(p.double(), r)
            log(f"  {label} float32 {name}: plain body vs float64 {e_plain:.3e}, "
                f"kernel vs plain {kc.max_rel_err(k, p):.3e}, kernel vs float64 "
                f"{kc.max_rel_err(k.double(), r):.3e}")
            if f32_rule:
                check(f"{label} float32 {name} kernel vs float64", kc.max_rel_err(k.double(), r),
                      max(F32_TRAJ_FACTOR * e_plain, F32_TRAJ_FLOOR))
        if args64.spec.guard is not None:
            same = len(k32) == len(p32) and all(torch.equal(k, p) for k, p in zip(k32[4:], p32[4:]))
            log(f"  {label} float32: {[int(t.sum()) for t in k32[4:]]} steps fired by depth in "
                f"the kernel, {[int(t.sum()) for t in p32[4:]]} in the plain body, decisions "
                f"{'identical' if same else 'differ'}")
        errors = {
            "max_abs_err": max(float((k - p).abs().max()) for k, p in zip(k64_cpu[:3], p64[:3])),
            "max_rel_err": {dtype_name(dt): max(kc.max_rel_err(k, p) for k, p in zip(ks, ps))
                            for dt, ks, ps in ((f64, k64_cpu[:3], p64[:3]),
                                               (f32, k32[:3], p32[:3]))},
            "plain_float32_rel_err": plain_errors,
            # The float32 plain body's time on these inputs: one run, on one
            # core of the host, in a worker process.
            "plain_ms": plain_ms,
            "plain_device": "cpu",
        }
        return k64, summary, errors

    def force_vs_plain(args64, label):
        check(f"{label} force float64",
              kc.max_rel_err(kc.kernel_force(args64), kc.plain_force(args64)), F64_FORCE_TOL)
        args32 = kc.cast(args64, f32)
        ref = kc.plain_force(kc.cast(args32, f64))
        e_plain = kc.max_rel_err(kc.plain_force(args32).double(), ref)
        check(f"{label} force float32 kernel vs float64 (plain float32 {e_plain:.3e})",
              kc.max_rel_err(kc.kernel_force(args32).double(), ref),
              max(F32_TRAJ_FACTOR * e_plain, F32_TRAJ_FLOOR))

    def unguarded(args):
        """The same inputs on the unguarded kernel."""

        spec = args.spec._replace(guard=None)
        return core.trajectory_forward(args._replace(spec=spec, micro=()))

    def guarded_vs_plain(label, both_terms=False):
        """A guarded kernel against the plain guarded body (whose guard is
        traced, kc.guard_terms), with its firing counts; where nothing
        fired, against the unguarded kernel too. ``both_terms``: the hard
        and the proximity term must both fire. Returns the float64 kernel
        outputs, the summary and the errors."""

        k64, summary, errors = against_plain(label)
        log(f"  {label}: fired {summary['fired']} of {summary['substeps']} substeps "
            f"({summary['fired_hard']} by the hard term, {summary['fired_proximity']} by "
            f"proximity alone), closest travel/threshold {summary['closest_ratio']:.6f}, "
            f"gap needed on {summary['gaps']} substeps, smallest gap/proximity there "
            f"{summary['closest_gap_ratio']:.4f}")
        if both_terms and not (summary["fired_hard"] and summary["fired_proximity"]):
            raise AssertionError(f"{label}: both guard terms were meant to fire")
        if summary["fired"] == 0:
            free = unguarded(cases[label])
            for name, g, u in zip("UVA", k64, free):
                check(f"{label} guarded vs unguarded kernel {name}", kc.max_rel_err(g, u),
                      GUARD_NOOP_TOL)
        return k64, summary, errors

    def engaged(args, label):
        U_eff = args.U0 * args.fixed[-1] + core.drive_planes(args.drive[:, 0], args.spec,
                                                             args.U0)
        energy = kc.contact_energy_of(U_eff, args.fixed)
        log(f"  {label}: contact energy {energy:.6e}")
        if not energy > 0:
            raise AssertionError(f"{label}: the barrier is not engaged")

    # -- main path 8's float32 yardstick, while the kernels build -------------
    # The population's float32 gradients with the plain body as the forward
    # need no kernel of this repository, so they run on the card while nvcc
    # builds.
    import math

    from difflexmm_tpu_torch.models import kagome_focusing
    from difflexmm_tpu_torch.optim.loops import population_unflatten
    from difflexmm_tpu_torch.parallel import population_value_and_grad

    kernel_path = {dt: fl.build_flagship(device=device, dtype=dt) for dt in dtypes}

    def population_run(opt, designs):
        """Values and flattened per-design gradients of a population, and
        the host seconds they took."""

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        values, grads = population_value_and_grad(opt.population_objective_fn, designs,
                                                  grad_chunk=None)
        torch.cuda.synchronize()
        return values, torch.cat([g.flatten(1) for g in grads], 1), time.perf_counter() - t0

    kagome_zero = {}
    objectives = {("quad", dt): kernel_path[dt][0] for dt in dtypes}
    for dt in dtypes:
        kopt = kagome_focusing.OptimizationProblem(
            kc.kagome_multistart_problem(device=device, dtype=dt), target_size=(2, 2))
        kopt.setup_objective()
        objectives[("kagome", dt)] = kopt
        kagome_zero[dt] = kopt.forward_problem.geometry.zero_design(device=device, dtype=dt)

    def population(lattice, dt, step=POPULATION_STEP):
        """The population of ``step``: the flagship's design scaled, the
        kagome design (zero) shifted."""

        if lattice == "quad":
            return stepped_designs(kernel_path[dt][1], POPULATION_B, step)
        return stepped_designs(kagome_zero[dt], POPULATION_B, step, scaled=False)

    # The same float32 objectives with the plain body as the forward (the
    # "verlet_ckpt" solver, whose adjoint is the same), the measure of the
    # float32 rule on the population's gradients. On the card the quad
    # "verlet_ckpt" steps through kernel 2, so each solver's spec on the
    # card gets core.plain_trajectory as its forward here, and the count of
    # plain-body forwards shows it ran.
    plain_objectives = {"quad": fl.build_flagship(method="verlet_ckpt", device=device,
                                                  dtype=f32)[0]}
    plain_objectives["kagome"] = kagome_focusing.OptimizationProblem(
        dataclasses.replace(objectives[("kagome", f32)].forward_problem,
                            method="verlet_ckpt", is_setup=False), target_size=(2, 2))
    plain_objectives["kagome"].setup_objective()
    card_device = torch.device("cuda", torch.cuda.current_device())
    for plain_opt in plain_objectives.values():
        solve = plain_opt.forward_problem.solve_dynamics
        solve.specs[card_device] = solve.spec_for(card_device)._replace(
            forward=core.plain_trajectory)

    def plain_forward_run(lattice, designs):
        """``population_run`` of the plain objective of ``lattice``, checked
        by the counts: one more plain-body forward, no launch of kernel 2."""

        calls, launches = core.plain_trajectory.calls, quad_force.launches
        out = population_run(plain_objectives[lattice], designs)
        if core.plain_trajectory.calls != calls + 1 or quad_force.launches != launches:
            raise AssertionError(f"{lattice} float32 yardstick: the forward was not the plain "
                                 "body")
        return out

    yardstick = {(lattice, step): plain_forward_run(lattice, population(lattice, f32, step))[1]
                 for lattice in ("quad", "kagome") for step in (POPULATION_STEP, -POPULATION_STEP)}
    phase_done("float32 yardstick of main path 8")


    for job in builds:
        job.result()
    builders.shutdown()
    log(f"build: {', '.join(sources)} in {time.perf_counter() - t0:.1f} s")
    usage = {}
    # Kernel templates by source: the trajectory kernels' (dtype,
    # linearized, contact, guard, threads), the force kernel's (dtype,
    # linearized, contact, tile along n1, along n2, threads).
    templates = {"verlet_quad": "verlet_quad", "verlet_kagome": "verlet_kagome",
                 "quad_force": "quad_force"}
    parameters = {"quad_force": ("linearized", "contact", "tile_n1", "tile_n2", "threads")}
    for name in sources:
        info = build.BUILD_INFO[name]
        log(f"  {name}: nvcc {info['seconds']:.1f} s")
        usage[name] = build.ptxas_usage(info["log"], templates[name])
        for key, u in sorted(usage[name].items()):
            names = parameters.get(name, ("linearized", "contact", "guard", "threads"))
            flags = " ".join(f"{flag}={value}" for flag, value in zip(names, key[1:]))
            log(f"  ptxas {templates[name]} {key[0]} {flags}: {u['registers']} registers, "
                f"{u['stack']} B stack, {u['spill_stores']} B spill stores, "
                f"{u['spill_loads']} B spill loads")

    phase_done("build")

    # -- kernel 1 against its plain body --------------------------------------
    for dtype in dtypes:
        need, have = carry_bytes(56, 48, dtype)
        log(f"  56x48 {dtype_name(dtype)}: carry {need} B per design, shared memory {have} B")
        if need <= have:
            raise AssertionError("56x48 was meant to exercise the workspace path")
    for label in ("small 8x6 B=1", "small 8x6 B=4", "workspace 56x48 B=2"):
        against_plain(label)
    log(f"  contact probe: mag {np.degrees(mag):.3f} deg")
    engaged(probe, "contact probe")
    force_vs_plain(probe, "contact probe")
    against_plain("contact probe")

    flagship = cases["flagship 24x16"]
    k64, _, errors = against_plain("flagship 24x16")
    results["verlet_quad"].update(errors)
    results["verlet_quad"].update(kc.trajectory_bound(kc.cast(flagship, f32), k64[0]))
    # The force at a state mid-pulse (the initial state is at rest).
    mid = flagship._replace(U0=k64[0][:, 20].contiguous(),
                            drive=flagship.drive[:, 200:].contiguous())
    force_vs_plain(mid, "flagship mid-pulse")

    phase_done("kernel")

    # -- kernel 1g against its plain body -----------------------------------
    for label in ("contact probe auto", "small 8x6 tame auto", "flagship 24x16 auto"):
        k64, summary, errors = guarded_vs_plain(label, both_terms=label.startswith("contact"))
    flagship_guarded = cases[label]
    results["verlet_quad_guarded"].update(errors)
    results["verlet_quad_guarded"]["summary"] = summary
    results["verlet_quad_guarded"].update(
        kc.trajectory_bound(kc.cast(flagship_guarded, f32), k64[0], summary))

    phase_done("guarded")

    # -- the guarded flagship objective --------------------------------------
    for dt in dtypes:
        opt, design = fl.build_flagship(device=device, dtype=dt, guard="auto")
        launches = verlet_quad_trajectory.guarded_launches
        calls = core.plain_trajectory.calls
        with torch.no_grad():
            value = float(opt.objective_fn(design))
        if verlet_quad_trajectory.guarded_launches != launches + 1 \
                or core.plain_trajectory.calls != calls:
            raise AssertionError("the guarded objective did not run the guarded kernel")
        rel = abs(value - fl.JAX_F64_GUARDED_OBJECTIVE) / fl.JAX_F64_GUARDED_OBJECTIVE
        log(f"  guarded flagship {dtype_name(dt)}: objective {value!r} "
            f"(JAX f64 {fl.JAX_F64_GUARDED_OBJECTIVE!r})")
        check(f"guarded flagship {dtype_name(dt)} objective vs JAX float64", rel,
              OBJECTIVE_TOL[dtype_name(dt)])

    phase_done("objective")

    # -- kernel 1K against its plain body ------------------------------------
    for label in ("kagome 4x3 B=1", "kagome 4x3 B=4"):
        against_plain(label)
    log(f"  kagome contact probe: mag {np.degrees(kmag):.3f} deg")
    engaged(kprobe, "kagome contact probe")
    force_vs_plain(kprobe, "kagome contact probe")
    against_plain("kagome contact probe")

    kagome = cases["kagome 16x16"]
    k64, _, errors = against_plain("kagome 16x16")
    results["verlet_kagome"].update(errors)
    results["verlet_kagome"].update(kc.trajectory_bound(kc.cast(kagome, f32), k64[0]))

    phase_done("kagome kernel")

    # -- kernel 1Kg against its plain body -----------------------------------
    for label in ("kagome contact probe auto", "kagome 4x3 tame auto", "kagome 16x16 auto"):
        k64, summary, errors = guarded_vs_plain(label, both_terms="probe" in label)
        if "tame" in label and summary["fired"]:
            raise AssertionError(f"{label}: the guard was meant to fire nowhere")
    kagome_guarded = cases[label]
    results["verlet_kagome_guarded"].update(errors)
    results["verlet_kagome_guarded"]["summary"] = summary
    results["verlet_kagome_guarded"].update(
        kc.trajectory_bound(kc.cast(kagome_guarded, f32), k64[0], summary))

    phase_done("kagome guarded checks")

    # -- kernel 1L (loads) against its plain body -----------------------------
    load_checks = {}
    for label, tol64 in LOAD_CHECKS.items():
        k64, summary, errors = against_plain(label, tol64)
        if summary is not None:
            log(f"  {label}: fired {summary['fired']} of {summary['substeps']} substeps")
            if not summary["fired"]:
                raise AssertionError(f"{label}: the guard was meant to fire")
        load_checks[label] = errors["max_rel_err"]
    # The float32 pulse leaves the float64 one at its 14th interval (plain
    # body and kernel alike), so its float32 rule holds on the intervals
    # before; the whole pulse is held at float64, and the tensile chain
    # (not chaotic) at both.
    pulse_prefix_errors = against_plain("pulse 20x10 prefix")[2]
    load_checks["pulse 20x10 prefix"] = pulse_prefix_errors["max_rel_err"]
    load_checks["tensile chain 0.6"] = against_plain("tensile chain 0.6")[2]["max_rel_err"]
    pulse_args = cases["pulse 20x10"]
    log("  pulse 20x10: float32 not checked over the whole pulse (see its prefix)")
    k64, _, errors = against_plain("pulse 20x10", f32_rule=False)
    results["verlet_quad_loaded"].update(errors)
    results["verlet_quad_loaded"]["checks"] = load_checks
    results["verlet_quad_loaded"].update(kc.trajectory_bound(kc.cast(pulse_args, f32), k64[0]))

    phase_done("loaded checks")

    # The guarded kagome objective through 1Kg.
    for dt in dtypes:
        opt, design = kg.build_kagome(device=device, dtype=dt, guard="auto")
        launches = verlet_kagome_trajectory.guarded_launches
        calls = core.plain_trajectory.calls
        with torch.no_grad():
            value = float(opt.objective_fn(design))
        if verlet_kagome_trajectory.guarded_launches != launches + 1 \
                or core.plain_trajectory.calls != calls:
            raise AssertionError("the guarded kagome objective did not run kernel 1Kg")
        ref = kg.JAX_F64_GUARDED_OBJECTIVE
        log(f"  guarded kagome {dtype_name(dt)}: objective {value!r} (JAX f64 {ref!r})")
        check(f"guarded kagome {dtype_name(dt)} objective vs JAX float64",
              abs(value - ref) / ref, OBJECTIVE_TOL["float64"] if dt == f64
              else GUARDED_KAGOME_F32_TOL)

    phase_done("kagome guarded")

    # -- main path 1: flagship value and gradient through kernel 1 -----------
    def value_and_grad(opt, design):
        d = tuple(x.detach().clone().requires_grad_() for x in design)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value = opt.objective_fn(d)
        value.backward()
        torch.cuda.synchronize()
        grad = torch.cat([x.grad.flatten() for x in d])
        return float(value.detach()), grad, time.perf_counter() - t0

    reset_counts()
    main = {dt: value_and_grad(*kernel_path[dt]) for dt in dtypes}
    launches = verlet_quad_trajectory.launches
    plain_calls = core.plain_trajectory.calls
    log(f"main path 1 (flagship value and gradient): {launches} kernel launches, "
        f"{plain_calls} plain-body forwards")
    if launches < len(dtypes) or plain_calls != 0:
        raise AssertionError("main path 1 did not run through kernel 1")
    results["verlet_quad"]["launches"] = launches
    for dt in dtypes:
        name = dtype_name(dt)
        value, grad, seconds = main[dt]
        rel = abs(value - fl.JAX_F64_OBJECTIVE) / fl.JAX_F64_OBJECTIVE
        log(f"  flagship {name}: objective {value!r} (JAX f64 {fl.JAX_F64_OBJECTIVE!r}), "
            f"fwd+grad {seconds:.2f} s")
        check(f"flagship {name} objective vs JAX float64", rel, OBJECTIVE_TOL[name])
        if not (bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0):
            raise AssertionError(f"flagship {name} gradient is not finite and non-zero")
    grad64, grad32 = main[f64][1], main[f32][1]
    stats = fl.vector_stats(grad64.cpu().numpy())
    log(f"  flagship float64 gradient (|g|, sum g, g.r) {stats} (JAX {fl.JAX_F64_GRAD_STATS})")
    check("flagship float64 gradient vs JAX float64", stats_err(stats, fl.JAX_F64_GRAD_STATS),
          GRAD_TOL)
    e_plain = results["verlet_quad"]["plain_float32_rel_err"]["V"]
    check(f"flagship float32 gradient vs float64 (plain body float32 V {e_plain:.3e})",
          kc.max_rel_err(grad32.double(), grad64), max(F32_TRAJ_FACTOR * e_plain, F32_TRAJ_FLOOR))
    timings = {"fwd_grad_kernel_s": main[f32][2], "fwd_grad_kernel_s_float64": main[f64][2]}

    phase_done("main")

    # Main paths 10 and 11's plain-body yardsticks: on the card beside main
    # path 2, whose guarded adjoint keeps the host busy and the card mostly
    # idle (after main path 1, whose time they would share).
    yardstick_job = side.submit(plain_yardsticks)
    # Main path 4, the kagome MMA, in the same process after them: its
    # adjoint keeps a host core busy and the card mostly idle, as main path
    # 2's does, so the two run side by side.
    kagome_job = side.submit(kagome_mma)
    # Main path 13's host-bound parts, in a process of their own beside main
    # paths 2 and 4 (they end before main path 4 does, so the timed paths
    # after it run alone).
    side13_job = side13.submit(main_path_13_side)
    # Main path 14's parts (a)-(f), host-bound too (small dense solves and
    # Newton loops), in a process of their own beside them.
    side14_job = side14.submit(main_path_14_side)
    nan_job = pool.submit(rescue_plain_first_nonfinite)

    # -- main path 2: the guarded constrained MMA through kernel 1g ----------
    mma = {}
    mma_grads = []
    reset_counts()
    for dt in dtypes:
        if dt == f64:
            # Built guarded, as the JAX reference was, so that the objective
            # whose gradients are kept is the one the MMA runs.
            opt, design = fl.build_flagship(device=device, dtype=dt, guard="auto")
            capturing(opt, mma_grads)
        else:
            # Built unguarded: run_optimization_mma re-arms the guard.
            opt, design = fl.build_flagship(device=device, dtype=dt)
        iterations = MMA_ITERATIONS if dt == f64 else MMA_ITERATIONS_F32
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.run_optimization_mma(design, n_iterations=iterations, verbose=False,
                                 **fl.MMA_SETTINGS)
        torch.cuda.synchronize()
        mma[dt] = (opt, design, (time.perf_counter() - t0) / iterations)
    launches = verlet_quad_trajectory.guarded_launches
    plain_calls = core.plain_trajectory.calls
    log(f"main path 2 (guarded flagship MMA, {MMA_ITERATIONS} iterations at float64, "
        f"{MMA_ITERATIONS_F32} at float32): {launches} guarded kernel launches, "
        f"{plain_calls} plain-body forwards")
    if launches < MMA_ITERATIONS + MMA_ITERATIONS_F32 or plain_calls != 0:
        raise AssertionError("main path 2 did not run through the guarded kernel")
    results["verlet_quad_guarded"]["launches"] = launches
    opt, design, _ = mma[f64]
    if len(opt.objective_values) != len(fl.JAX_F64_MMA_VALUES):
        raise AssertionError(f"float64 MMA made {len(opt.objective_values)} history entries")
    if len(mma_grads) != len(fl.JAX_F64_MMA_GRAD_STATS):
        raise AssertionError(f"float64 MMA took {len(mma_grads)} gradients")
    scale = max(abs(x) for s in fl.JAX_F64_MMA_DESIGN_STATS for x in s)
    for k, (value, ref) in enumerate(zip(opt.objective_values, fl.JAX_F64_MMA_VALUES)):
        stats = fl.design_stats(opt.design_values[k], design)
        ref_stats = fl.JAX_F64_MMA_DESIGN_STATS[k]
        log(f"  MMA float64 iteration {k}: objective {value!r} (JAX {ref!r}), "
            f"design (|dx|, sum dx, dx.r) {stats} (JAX {ref_stats})")
        check(f"MMA float64 iteration {k} objective vs JAX", abs(value - ref) / abs(ref),
              MMA_TOL)
        check(f"MMA float64 iteration {k} design vs JAX",
              max(abs(a - b) for a, b in zip(stats, ref_stats)) / scale, MMA_TOL)
        grad_stats = fl.vector_stats(torch.cat(mma_grads[k]).cpu().numpy())
        ref_grad = fl.JAX_F64_MMA_GRAD_STATS[k]
        log(f"  MMA float64 iteration {k}: gradient (|g|, sum g, g.r) {grad_stats} "
            f"(JAX {ref_grad})")
        check(f"MMA float64 iteration {k} gradient vs JAX", stats_err(grad_stats, ref_grad),
              GRAD_TOL)
    # How often the guard fires at each iterate (one kernel run each):
    # fired intervals replay through the guarded body in the adjoint.
    for k, d in enumerate(opt.design_values):
        with torch.no_grad():
            fired = core.trajectory_forward(kc.batched_args(opt.forward_problem, [d]))[4]
        n_int = fired.shape[1] // opt.forward_problem.n_substeps
        intervals = int(fired.view(n_int, -1).any(-1).sum())
        log(f"  MMA float64 iterate {k}: guard fired on {int(fired.sum())} of "
            f"{fired.numel()} substeps, in {intervals} of {n_int} intervals")
    # Main path 9 (c): the second float64 iterate with the guard refined to
    # depth 2 through method="verlet_ckpt"; its plain guarded body runs in a
    # worker process from here on.
    # Main path 12 (b) runs the same inputs through kernel 1g; the plain
    # guarded body's runs on them serve both.
    deep_design = opt.design_values[1]
    deep_flagship = kc.batched_args(
        fl.build_flagship(method="verlet_ckpt", device=device, dtype=f64,
                          guard=TWO_LEVELS)[0].forward_problem, [deep_design])
    flagship_deep = "flagship MMA iterate 1 levels 2"
    cases[flagship_deep] = kc.batched_args(
        fl.build_flagship(device=device, dtype=f64, guard=TWO_LEVELS)[0].forward_problem,
        [deep_design])
    for key in ("U0", "V0", "A0", "dts", "drive", "fixed", "micro"):
        a, b = getattr(cases[flagship_deep], key), getattr(deep_flagship, key)
        if not all(torch.equal(x, y) for x, y in zip(*((a, b) if key in ("fixed", "micro")
                                                       else ((a,), (b,))))):
            raise AssertionError(f"{flagship_deep}: {key} differs between the two methods")
    submit(flagship_deep)
    deep_labels.append(flagship_deep)
    deep_jobs["flagship MMA iterate 1"] = plain_jobs[flagship_deep]["64"]
    opt, design, per_iter = mma[f32]
    violation = max(v[-1] for v in opt.constraints_violation.values())
    values = opt.objective_values
    if not all(np.isfinite(values)):
        raise AssertionError(f"float32 MMA objective values {values}")
    log(f"  MMA float32: objectives {values}, final constraint violation {violation!r}, "
        f"{per_iter:.2f} s/iter over {MMA_ITERATIONS_F32} (host clock)")
    timings.update(mma_float32_s_per_iter=per_iter, mma_float64_s_per_iter=mma[f64][2],
                   mma_float32_final_violation=violation)

    # Where an iteration's time goes besides fwd+grad: the constraints
    # with their Jacobian, and one MMA update, each timed alone.
    from difflexmm_tpu_torch.optim.loops import ravel_pytree
    from difflexmm_tpu_torch.optim.mma import mma_init, mma_update

    flat, unflatten = ravel_pytree(design)
    fns = [fn for _, fn in opt._design_constraints(
        fl.MMA_SETTINGS["min_void_angle"], fl.MMA_SETTINGS["min_block_angle"],
        fl.MMA_SETTINGS["min_edge_length"])]

    def stacked(x):
        return torch.cat([fn(unflatten(x)) for fn in fns])

    def host_seconds(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (fi, dfi), jac_s = host_seconds(lambda: (stacked(flat), torch.func.jacrev(stacked)(flat)))
    lo = torch.full_like(flat, fl.MMA_SETTINGS["lower_bound"])
    hi = torch.full_like(flat, fl.MMA_SETTINGS["upper_bound"])
    _, update_s = host_seconds(lambda: mma_update(
        mma_init(flat, lo, hi), torch.ones_like(flat), fi, dfi, lo, hi,
        move_limit=fl.MMA_SETTINGS["move_limit"]))
    log(f"  MMA float32 pieces (host clock, one call each): constraints and Jacobian "
        f"{tuple(dfi.shape)} {jac_s:.3f} s, MMA update {update_s:.3f} s")
    timings.update(mma_float32_jacobian_s=jac_s, mma_float32_update_s=update_s)

    phase_done("mma")

    # -- main path 3: kagome value and gradient through kernel 1K ------------
    kagome_path = {dt: kg.build_kagome(device=device, dtype=dt) for dt in dtypes}
    reset_counts()
    value64, grad64, seconds64 = value_and_grad(*kagome_path[f64])
    with torch.no_grad():
        value32 = float(kagome_path[f32][0].objective_fn(kagome_path[f32][1]))
    launches = verlet_kagome_trajectory.launches
    plain_calls = core.plain_trajectory.calls
    log(f"main path 3 (kagome value and gradient): {launches} kernel launches, "
        f"{plain_calls} plain-body forwards")
    if launches < len(dtypes) or plain_calls != 0:
        raise AssertionError("main path 3 did not run through kernel 1K")
    results["verlet_kagome"]["launches"] = launches
    for name, value in (("float64", value64), ("float32", value32)):
        log(f"  kagome {name}: objective {value!r} (JAX f64 {kg.JAX_F64_OBJECTIVE!r})")
        check(f"kagome {name} objective vs JAX float64",
              abs(value - kg.JAX_F64_OBJECTIVE) / kg.JAX_F64_OBJECTIVE, OBJECTIVE_TOL[name])
    if not (bool(torch.isfinite(grad64).all()) and float(grad64.abs().max()) > 0):
        raise AssertionError("kagome float64 gradient is not finite and non-zero")
    stats = fl.vector_stats(grad64.cpu().numpy())
    log(f"  kagome float64 gradient (|g|, sum g, g.r) {stats} (JAX {kg.JAX_F64_GRAD_STATS}), "
        f"fwd+grad {seconds64:.2f} s")
    check("kagome float64 gradient vs JAX float64", stats_err(stats, kg.JAX_F64_GRAD_STATS),
          GRAD_TOL)
    timings["kagome_fwd_grad_s_float64"] = seconds64

    phase_done("kagome main")

    # -- main path 4: the kagome MMA through kernel 1Kg (run beside main path 2) --
    km = kagome_job.result()
    kagome_done_at = time.time()
    launches, plain_calls, per_iter = km["launches"], km["plain_calls"], km["per_iter"]
    log(f"main path 4 (kagome MMA, {MMA_ITERATIONS} iterations at float64, in a process of "
        f"its own beside main path 2): {launches} guarded kernel launches, {plain_calls} "
        f"plain-body forwards, {per_iter:.2f} s/iter (host clock)")
    if launches < MMA_ITERATIONS or plain_calls != 0:
        raise AssertionError("main path 4 did not run through kernel 1Kg")
    results["verlet_kagome_guarded"]["launches"] = launches
    timings["kagome_mma_float64_s_per_iter"] = per_iter
    if len(km["values"]) != len(kg.JAX_F64_MMA_VALUES) \
            or len(km["grad_stats"]) != len(kg.JAX_F64_MMA_GRAD_STATS):
        raise AssertionError(f"kagome MMA: {len(km['values'])} history entries, "
                             f"{len(km['grad_stats'])} gradients")
    scale = max(abs(x) for s in kg.JAX_F64_MMA_DESIGN_STATS for x in s)
    for k, (value, ref) in enumerate(zip(km["values"], kg.JAX_F64_MMA_VALUES)):
        stats, ref_stats = km["design_stats"][k], kg.JAX_F64_MMA_DESIGN_STATS[k]
        grad_stats = km["grad_stats"][k]
        (fired, substeps), (intervals, n_int) = km["fired"][k], km["intervals"][k]
        log(f"  kagome MMA iteration {k}: objective {value!r} (JAX {ref!r}), design "
            f"(|dx|, sum dx, dx.r) {stats} (JAX {ref_stats}), gradient {grad_stats} (JAX "
            f"{kg.JAX_F64_MMA_GRAD_STATS[k]}); guard fired on {fired} of {substeps} substeps, "
            f"in {intervals} of {n_int} intervals (JAX: {kg.JAX_F64_MMA_FIRED[k]} intervals)")
        check(f"kagome MMA iteration {k} objective vs JAX", abs(value - ref) / abs(ref), MMA_TOL)
        check(f"kagome MMA iteration {k} design vs JAX",
              max(abs(a - b) for a, b in zip(stats, ref_stats)) / scale, MMA_TOL)
        check(f"kagome MMA iteration {k} gradient vs JAX",
              stats_err(grad_stats, kg.JAX_F64_MMA_GRAD_STATS[k]), GRAD_TOL)
        timings[f"kagome_mma_fired_substeps_{k}"] = fired

    phase_done("kagome mma")

    # -- main path 5: the force pulse's value and gradient through kernel 1L -
    pulse = {f64: pulse64, f32: lc.pulse_problem(device, f32)}
    reset_counts()
    pulse_runs = {}
    for dt in dtypes:
        inputs = [x.requires_grad_() for x in lc.pulse_inputs(device, dt)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value, fields = lc.pulse_kinetic_energy(pulse[dt], *inputs)
        grad = torch.stack(torch.autograd.grad(value, inputs))
        torch.cuda.synchronize()
        pulse_runs[dt] = (float(value.detach()), grad.double().cpu(), fields.detach(),
                          time.perf_counter() - t0)
    launches = verlet_quad_trajectory.loaded_launches
    plain_calls = core.plain_trajectory.calls
    log(f"main path 5 (force pulse, value and gradient): {launches} loaded kernel launches, "
        f"{plain_calls} plain-body forwards")
    if launches < len(dtypes) or plain_calls != 0:
        raise AssertionError("main path 5 did not run through kernel 1L")
    path_launches = launches
    ref_grad = torch.tensor(lc.JAX_F64_PULSE_GRAD, dtype=f64)
    # The float32 run: its fields up to the end of the pulse's prefix
    # against the float64 run's under the float32 rule, with the plain
    # body's float32 error on the prefix as the measure. Past the prefix
    # the float32 pulse leaves the float64 one, so its kinetic energy and
    # gradient at the last timepoint are logged, not checked.
    e_plain = max(pulse_prefix_errors["plain_float32_rel_err"].values())
    f32_tol = max(F32_TRAJ_FACTOR * e_plain, F32_TRAJ_FLOOR)
    head = PULSE_F32_INTERVALS + 1  # timepoints of the prefix
    for dt in dtypes:
        name = dtype_name(dt)
        value, grad, fields, seconds = pulse_runs[dt]
        log(f"  pulse {name}: kinetic energy {value!r} (JAX f64 {lc.JAX_F64_PULSE_KE!r}), "
            f"gradient {grad.tolist()} (JAX {list(lc.JAX_F64_PULSE_GRAD)}), fwd+grad "
            f"{seconds:.2f} s")
        finite([fields], f"pulse {name} fields")
        rel = abs(value - lc.JAX_F64_PULSE_KE) / lc.JAX_F64_PULSE_KE
        grad_err = float((grad - ref_grad).abs().max() / ref_grad.abs().max())
        if dt == f64:
            check("pulse float64 kinetic energy vs JAX float64", rel, OBJECTIVE_TOL["float64"])
            check("pulse float64 gradient vs JAX float64", grad_err, GRAD_TOL)
        else:
            log(f"  pulse float32: kinetic energy {rel:.3e} from JAX float64, gradient "
                f"{kc.max_rel_err(grad, pulse_runs[f64][1]):.3e} from the float64 run's")
            check(f"pulse float32 fields vs float64, first {head} timepoints (plain body "
                  f"float32 {e_plain:.3e})",
                  kc.max_rel_err(fields[:head].double(), pulse_runs[f64][2][:head]), f32_tol)
    dense_fields, dense_s = dense_jobs["pulse"].result()
    check("pulse float64 fused (kernel 1L) vs dense verlet trajectory",
          kc.max_rel_err(pulse_runs[f64][2].cpu(), torch.as_tensor(dense_fields)), F64_TRAJ_TOL)
    timings.update(pulse_fwd_grad_s_float64=pulse_runs[f64][3],
                   pulse_fwd_grad_s_float32=pulse_runs[f32][3], pulse_dense_cpu_s=dense_s)

    phase_done("pulse")

    # -- main path 6: the tensile oracle at float32 through kernel 1L ---------
    solve, control_params, state0, timepoints, tip_strain = lc.tensile_problem(device, f32)
    reset_counts()
    tensile = {}
    for strain in lc.TENSILE_STRAINS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            fields = solve(state0, timepoints, control_params(strain))
        torch.cuda.synchronize()
        tensile[strain] = (fields, time.perf_counter() - t0)
    launches = verlet_quad_trajectory.loaded_launches
    plain_calls = core.plain_trajectory.calls
    log(f"main path 6 (tensile oracle, float32): {launches} loaded kernel launches, "
        f"{plain_calls} plain-body forwards")
    if launches < len(lc.TENSILE_STRAINS) or plain_calls != 0:
        raise AssertionError("main path 6 did not run through kernel 1L")
    path_launches += launches
    for strain, (fields, seconds) in tensile.items():
        finite([fields], f"tensile {strain} fields")
        got = tip_strain(fields)
        dense_fields, dense_s = dense_jobs[("tensile", strain)].result()
        deviation = float((fields.double().cpu() - torch.as_tensor(dense_fields)).abs().max())
        log(f"  tensile strain {strain}: tip strain {got!r}, fused float32 vs dense float64 "
            f"max |difference| {deviation:.3e}, {seconds:.3f} s (dense on a host core "
            f"{dense_s:.1f} s)")
        check(f"tensile {strain} tip strain vs applied", abs(got - strain) / strain,
              lc.TENSILE_STRAIN_TOL)
        check(f"tensile {strain} fused vs dense trajectory (absolute)", deviation,
              lc.TENSILE_TRAJECTORY_TOL)
    results["verlet_quad_loaded"]["launches"] = path_launches
    tensile_args = {dt: lc.tensile_problem(device, dt) for dt in dtypes}

    phase_done("tensile")

    # -- main path 7: reference_design through kernel 1 -----------------------
    problem = lc.reference_design_problem(device, f64)
    reset_counts()
    with torch.no_grad():
        fields = problem.solve().fields
    launches = verlet_quad_trajectory.launches
    plain_calls = core.plain_trajectory.calls
    log(f"main path 7 (reference_design, pulse_forward.json): {launches} kernel launches, "
        f"{plain_calls} plain-body forwards")
    if launches < 1 or plain_calls != 0:
        raise AssertionError("main path 7 did not run through kernel 1")
    finite([fields], "reference_design fields")
    stats = fl.vector_stats(fields.cpu().numpy().ravel())
    log(f"  reference_design float64 fields (|x|, sum x, x.r) {stats} "
        f"(JAX {lc.JAX_F64_REFERENCE_DESIGN_STATS})")
    check("reference_design float64 fields vs JAX float64",
          stats_err(stats, lc.JAX_F64_REFERENCE_DESIGN_STATS), OBJECTIVE_TOL["float64"])

    phase_done("reference_design")

    # -- main path 8: populations through kernels 1 and 1K, the multistart MMA --
    reset_counts()
    pop_runs, peak_bytes = {}, {}
    for key, opt in objectives.items():
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        pop_runs[key] = population_run(opt, population(*key))
        peak_bytes[key] = torch.cuda.max_memory_allocated() - base
    quad_launches = verlet_quad_trajectory.launches
    kagome_launches = verlet_kagome_trajectory.launches
    plain_calls = core.plain_trajectory.calls
    log(f"main path 8 (populations of {POPULATION_B}, value and gradient at float64 and "
        f"float32): {quad_launches} kernel-1 launches, {kagome_launches} kernel-1K launches, "
        f"{plain_calls} plain-body forwards")
    if quad_launches != len(dtypes) or kagome_launches != len(dtypes) or plain_calls != 0:
        raise AssertionError("main path 8 did not run each population as one launch")
    results["verlet_quad_population"]["launches"] = quad_launches
    results["verlet_kagome_population"]["launches"] = kagome_launches

    def per_design(a, b):
        """Each design's largest difference, relative to its largest entry
        of ``b``."""

        return (a - b).flatten(1).abs().amax(1) / b.flatten(1).abs().amax(1)

    def population_checks(lattice):
        """Main path 8's checks of one lattice's population: values finite,
        four designs against B = 1 runs, float32 gradients against float64
        (at this population and the one of step -POPULATION_STEP), forward
        outputs bit-identical to B = 1 at float64 and float32, and the
        kernel at the population's shapes against the plain body on the
        card. Returns the float64 trajectory inputs and the errors."""

        opt, opt32 = objectives[(lattice, f64)], objectives[(lattice, f32)]
        designs, designs32 = population(lattice, f64), population(lattice, f32)
        values, grads, seconds = pop_runs[(lattice, f64)]
        values32, grads32, seconds32 = pop_runs[(lattice, f32)]
        for name, v, g in (("float64", values, grads), ("float32", values32, grads32)):
            if not (bool(torch.isfinite(v).all()) and bool(torch.isfinite(g).all())
                    and tuple(v.shape) == (POPULATION_B,)):
                raise AssertionError(f"{lattice} population {name}: values or gradients")
        for b in POPULATION_CHECKED:
            v1, g1, _ = population_run(opt, tuple(x[b:b + 1] for x in designs))
            check(f"{lattice} population float64 design {b} value vs B = 1",
                  abs(float(values[b]) - float(v1[0])) / abs(float(v1[0])), POP_VALUE_TOL)
            check(f"{lattice} population float64 design {b} gradient vs B = 1",
                  kc.max_rel_err(grads[b], g1[0]), POP_GRAD_TOL)

        # The float32 rule, at this population and at the second one.
        ratios = []
        for step in (POPULATION_STEP, -POPULATION_STEP):
            if step == POPULATION_STEP:
                g64, g32 = grads, grads32
            else:
                g64 = population_run(opt, population(lattice, f64, step))[1]
                g32 = population_run(opt32, population(lattice, f32, step))[1]
            g_plain = yardstick[(lattice, step)]
            e_kernel, e_plain = per_design(g32.double(), g64), per_design(g_plain.double(), g64)
            if step == POPULATION_STEP:
                worst = int(e_kernel.argmax())
            ratios.append(e_kernel / e_plain)
            log(f"  {lattice} population (step {step:+g}) float32 gradients vs float64, per "
                f"design: through the kernel median {float(e_kernel.median()):.3e}, largest "
                f"{float(e_kernel.max()):.3e} (design {int(e_kernel.argmax())}); with the plain "
                f"forward median {float(e_plain.median()):.3e}, largest "
                f"{float(e_plain.max()):.3e} (design {int(e_plain.argmax())})")
            check(f"{lattice} population (step {step:+g}) float32 gradients vs float64, largest "
                  f"of any design (the plain forward's {float(e_plain.max()):.3e})",
                  float(e_kernel.max()), max(F32_TRAJ_FACTOR * float(e_plain.max()),
                                             F32_TRAJ_FLOOR))
        ratio = torch.cat(ratios)
        log(f"  {lattice} population float32 gradient errors, kernel over plain forward, "
            f"{ratio.numel()} designs of both populations: median {float(ratio.median()):.3f}, "
            f"10th and 90th percentiles {float(ratio.quantile(0.1)):.3f} and "
            f"{float(ratio.quantile(0.9)):.3f}, smallest {float(ratio.min()):.3f}, largest "
            f"{float(ratio.max()):.3f}")
        check(f"{lattice} population float32 gradient errors, kernel over plain forward",
              float(ratio.median()), F32_TRAJ_FACTOR, what="median ratio")

        # Each checked design's forward outputs, and those of the design
        # whose float32 gradient is the worst, equal its B = 1 outputs.
        identical = 0
        shown = POPULATION_CHECKED + (worst,)
        for dt, problem, ds in ((f64, opt.forward_problem, designs),
                                (f32, opt32.forward_problem, designs32)):
            with torch.no_grad():
                fields = problem.solve(ds).fields
                for b in shown:
                    if torch.equal(problem.solve(tuple(x[b:b + 1] for x in ds)).fields[0],
                                   fields[b]):
                        identical += 1
                    else:
                        FAILED.append(f"{lattice} population design {b} {dtype_name(dt)}: "
                                      "forward outputs differ from its B = 1 run")
        _, g1, _ = population_run(opt32, tuple(x[worst:worst + 1] for x in designs32))
        log(f"  {lattice} population: forward outputs of designs {list(shown)} bit-identical "
            f"to B = 1 in {identical} of {2 * len(shown)} runs (float64, float32); design "
            f"{worst}'s float32 gradient error at B = 1 "
            f"{kc.max_rel_err(g1[0].double(), grads[worst]):.3e} (in the population "
            f"{kc.max_rel_err(grads32[worst].double(), grads[worst]):.3e}); value and gradient "
            f"{seconds:.2f} s (float64), {seconds32:.2f} s (float32)")

        problem = opt.forward_problem
        with torch.no_grad():
            args = problem.solve_dynamics.trajectory_args(problem.state0, problem.timepoints,
                                                          problem.control_params(designs))
            kout = core.trajectory_forward(args)
            plain = {}
            for dt in dtypes:
                a = kc.cast(args, dt)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = core.plain_trajectory(a.U0, a.V0, a.A0, a.dts, a.drive, a.fixed, a.spec)
                torch.cuda.synchronize()
                plain[dt] = (out, time.perf_counter() - t0)
        pout = plain[f64][0]
        for name, k, p in zip("UVA", kout, pout):
            check(f"{lattice} population B={POPULATION_B} float64 {name}: kernel vs plain body "
                  "(on the card)", kc.max_rel_err(k, p), F64_TRAJ_TOL)
        errors = dict(
            max_abs_err=max(float((k - p).abs().max()) for k, p in zip(kout, pout)),
            # One float32 plain trajectory of the whole population, on the
            # card (on a host core it would take hours).
            plain_ms=plain[f32][1] * 1e3, plain_ms_float64=plain[f64][1] * 1e3,
            plain_device="cuda",
            fwd_grad_s=seconds, fwd_grad_s_float32=seconds32,
            fwd_grad_peak_bytes_float64=peak_bytes[(lattice, f64)],
            float32_grad_ratio_median=float(ratio.median()),
            float32_grad_ratio_max=float(ratio.max()),
        )
        return args, errors

    pop_args = {}
    for lattice, name in (("quad", "verlet_quad"), ("kagome", "verlet_kagome")):
        pop_args[lattice], errors = population_checks(lattice)
        results[f"{name}_population"].update(errors)

    phase_done("populations")

    # The multistart MMA: flagship candidates screened through kernel 1, the
    # finalists re-ranked through one launch of kernel 1g.
    opt, design = fl.build_flagship(device=device, dtype=f64)
    guesses = [tuple(x[b] for x in stepped_designs(design, MULTISTART_B, POPULATION_STEP))
               for b in range(MULTISTART_B)]
    settings = {k: v for k, v in fl.MMA_SETTINGS.items() if k not in ("guard", "feasibility_tol")}
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = opt.run_multistart_mma(guesses, MULTISTART_ITERATIONS,
                                    n_finalists=MULTISTART_FINALISTS,
                                    final_guard=fl.MMA_SETTINGS["guard"], **settings)
    torch.cuda.synchronize()
    multistart_s = time.perf_counter() - t0
    launches = verlet_quad_trajectory.launches
    guarded_launches = verlet_quad_trajectory.guarded_launches
    plain_calls = core.plain_trajectory.calls
    log(f"main path 8 (multistart MMA, {MULTISTART_B} candidates, {MULTISTART_ITERATIONS} "
        f"iterations at float64, {MULTISTART_FINALISTS} finalists): {launches} kernel-1 "
        f"launches, {guarded_launches} kernel-1g launches, {plain_calls} plain-body forwards, "
        f"{multistart_s:.2f} s (host clock)")
    if launches != MULTISTART_ITERATIONS or guarded_launches != 1 or plain_calls != 0:
        raise AssertionError("the multistart MMA did not screen through kernel 1 and re-rank "
                             "through one launch of kernel 1g")
    results["verlet_quad_population"]["launches"] += launches
    finalists = result.finalists
    log(f"  multistart winner: candidate {result.best_index}, guarded value "
        f"{finalists.best_value!r}; finalists {finalists.indices.tolist()}, screening values "
        f"{finalists.screen_values.tolist()}, guarded values {finalists.values.tolist()}")
    if not math.isfinite(finalists.best_value) \
            or opt.objective_values[-1] != finalists.best_value:
        raise AssertionError("the multistart MMA's recorded value is not the winner's own")
    guarded = opt._guarded_sibling(fl.MMA_SETTINGS["guard"])
    gp = guarded.forward_problem
    finalist_designs = population_unflatten(design)(result.designs[finalists.indices])
    with torch.no_grad():
        finalist_args = gp.solve_dynamics.trajectory_args(
            gp.state0, gp.timepoints, gp.control_params(finalist_designs))
        # The plain guarded body on the finalists' batch, float64, in a
        # worker process while the timing below runs.
        finalist_plain = pool.submit(kc.plain_reference, kc.to_bytes(kc.on_cpu(finalist_args)))
        batch = core.trajectory_forward(finalist_args)
        for j in range(len(finalists.indices)):
            one = tuple(x[j:j + 1] for x in finalist_designs)
            single = core.trajectory_forward(gp.solve_dynamics.trajectory_args(
                gp.state0, gp.timepoints, gp.control_params(one)))
            same = torch.equal(single[4][0], batch[4][j])
            if not same:
                FAILED.append(f"multistart finalist {j}: guard decisions differ from B = 1")
            value = float(guarded.population_objective_fn(one)[0])
            log(f"  finalist {j}: guard fired on {int(single[4].sum())} substeps, decisions "
                f"{'equal' if same else 'DIFFER'} at B = 1")
            check(f"multistart finalist {j} guarded value vs its B = 1 guarded forward",
                  abs(value - float(finalists.values[j])) / abs(value), POP_VALUE_TOL)
    timings["multistart_s"] = multistart_s

    phase_done("multistart")

    # -- timing (flagship and kagome) ------------------------------------------
    def event_ms(fn, reps):
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
        return statistics.median(times)

    def trajectory(args):
        return lambda: core.trajectory_forward(args)

    def repeated(args, B):
        """One design's trajectory inputs, B times on the batch dimension."""

        rep = lambda x: x.expand(B, *x.shape[1:]).contiguous()  # noqa: E731
        return args._replace(U0=rep(args.U0), V0=rep(args.V0), A0=rep(args.A0),
                             drive=rep(args.drive), fixed=tuple(rep(f) for f in args.fixed),
                             micro=tuple(rep(m) for m in args.micro))

    def per_step(name, args32, args64):
        """The fired substeps of a guarded kernel's timing inputs and its time
        per step-equivalent: ms / (substeps + fired x (refine - 1))."""

        r = results[name]
        refine = args32.spec.guard["refine"]
        for dt, args, key in ((f32, args32, "ms"), (f64, args64, "ms_float64")):
            decisions = core.trajectory_forward(args)[4]
            fired, substeps = int(decisions.sum()), decisions.numel()
            steps = substeps + fired * (refine - 1)
            r.setdefault("fired", {})[dtype_name(dt)] = fired
            r.setdefault("per_step_us", {})[dtype_name(dt)] = r[key] * 1e3 / steps
            log(f"  {name} {dtype_name(dt)}: {fired} of {substeps} substeps fired, "
                f"{steps} step-equivalents, {r[key] * 1e3 / steps:.3f} us a step")

    args32 = kc.cast(flagship, f32)
    g32 = kc.cast(flagship_guarded, f32)
    core.trajectory_forward(g32)  # warm up
    # Kernels alternate: unguarded, guarded, guarded, unguarded.
    t = {
        "kernel_ms": event_ms(trajectory(args32), 3),
        "guarded_ms": event_ms(trajectory(g32), 3),
        "guarded_ms_2": event_ms(trajectory(g32), 3),
        "kernel_ms_2": event_ms(trajectory(args32), 3),
        "kernel_ms_float64": event_ms(trajectory(flagship), 5),
        "guarded_ms_float64": event_ms(trajectory(flagship_guarded), 5),
    }
    # Designs per launch (one thread block each): 1, one per SM, four per SM.
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    batch_ms = {B: event_ms(trajectory(repeated(args32, B)), 3) for B in (1, n_sm, 4 * n_sm)}

    host = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            kernel_path[f32][0].objective_fn(kernel_path[f32][1])
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    timings["fwd_kernel_s"] = statistics.median(host)
    timings["backward_share"] = 1 - timings["fwd_kernel_s"] / timings["fwd_grad_kernel_s"]
    log(f"timing ({card_line}), flagship float32 unless named, CUDA events, medians of 3 "
        f"(float64: 5): " + ", ".join(f"{k} {v:.3f}" for k, v in t.items()))
    for B, ms in batch_ms.items():
        log(f"  kernel batch B={B}: {ms:.3f} ms, {B / ms * 1e3:.1f} designs/s")
    log("  objective (s, host clock): " + ", ".join(
        f"{k} {v:.4g}" for k, v in timings.items()))
    results["verlet_quad"].update(ms=statistics.median([t["kernel_ms"], t["kernel_ms_2"]]),
                                  ms_float64=t["kernel_ms_float64"],
                                  batch_ms={str(B): ms for B, ms in batch_ms.items()})
    results["verlet_quad_guarded"].update(
        ms=statistics.median([t["guarded_ms"], t["guarded_ms_2"]]),
        ms_float64=t["guarded_ms_float64"])
    per_step("verlet_quad_guarded", g32, flagship_guarded)

    # Kagome: 1K and 1Kg at the configuration, alternating, then 1K on the
    # 12 x 10-cell population workload of tools/bench_kagome_multistart.py.
    kagome32 = kc.cast(kagome, f32)
    kagome_g32 = kc.cast(kagome_guarded, f32)
    core.trajectory_forward(kagome_g32)  # warm up
    tk = {
        "kernel_ms": event_ms(trajectory(kagome32), 3),
        "guarded_ms": event_ms(trajectory(kagome_g32), 3),
        "guarded_ms_2": event_ms(trajectory(kagome_g32), 3),
        "kernel_ms_2": event_ms(trajectory(kagome32), 3),
        "kernel_ms_float64": event_ms(trajectory(kagome), 3),
        "guarded_ms_float64": event_ms(trajectory(kagome_guarded), 3),
    }
    population = kc.kagome_multistart_problem(device=device, dtype=f32)
    kagome_batch_ms = {}
    for B in (1, 32, 128):
        designs = [tuple(x + 1e-3 * b for x in population.geometry.zero_design(device=device,
                                                                                dtype=f32))
                   for b in range(B)]
        args = kc.batched_args(population, designs)
        core.trajectory_forward(args)  # warm up
        kagome_batch_ms[B] = event_ms(trajectory(args), 3)
    log(f"timing ({card_line}), kagome 16x16 float32 unless named, CUDA events, medians of 3: "
        + ", ".join(f"{k} {v:.3f}" for k, v in tk.items()))
    for B, ms in kagome_batch_ms.items():
        log(f"  kagome 12x10 population B={B}: {ms:.3f} ms, {B / ms * 1e3:.1f} designs/s")
    results["verlet_kagome"].update(
        ms=statistics.median([tk["kernel_ms"], tk["kernel_ms_2"]]),
        ms_float64=tk["kernel_ms_float64"],
        batch_ms={str(B): ms for B, ms in kagome_batch_ms.items()})
    results["verlet_kagome_guarded"].update(
        ms=statistics.median([tk["guarded_ms"], tk["guarded_ms_2"]]),
        ms_float64=tk["guarded_ms_float64"])
    per_step("verlet_kagome_guarded", kagome_g32, kagome_guarded)

    # Main path 8's populations: kernels 1 and 1K at B = POPULATION_B (CUDA
    # events, float32 and float64) with their bounds; designs per second of
    # the flagship's population objective (host clock; the forward the
    # median of 3 after a warm-up; value and gradient one run each, no
    # warm-up: the adjoint captures its graph anew in every backward; at
    # B = 1 from main path 1, at B = POPULATION_B from main path 8) with the
    # peak memory of each value and gradient; the host's
    # share of a population's forward; the graph replay's capture at
    # B = POPULATION_B (float64).
    for lattice, name in (("quad", "verlet_quad_population"),
                          ("kagome", "verlet_kagome_population")):
        args32 = kc.cast(pop_args[lattice], f32)
        out32 = core.trajectory_forward(args32)  # warm up
        results[name].update(B=POPULATION_B, ms=event_ms(trajectory(args32), 3),
                             ms_float64=event_ms(trajectory(pop_args[lattice]), 3))
        results[name].update(kc.trajectory_bound(args32, out32[0]))
        log(f"timing ({card_line}), {lattice} population B={POPULATION_B}, CUDA events, medians "
            f"of 3: float32 {results[name]['ms']:.3f} ms, float64 "
            f"{results[name]['ms_float64']:.3f} ms (bound {results[name]['bound_ms']:.4f} ms)")
    curve = {}
    for dt in dtypes:
        opt, design = kernel_path[dt]
        curve[dtype_name(dt)] = c = {}
        for B in CURVE_BATCHES:
            designs = stepped_designs(design, B, POPULATION_STEP)
            with torch.no_grad():
                opt.population_objective_fn(designs)  # warm up
                fwd_s = statistics.median(
                    host_seconds(lambda: opt.population_objective_fn(designs))[1]
                    for _ in range(3))
            if B == 1:
                fwd_grad_s, peak = main[dt][2], None
            elif B == POPULATION_B:
                fwd_grad_s, peak = pop_runs[("quad", dt)][2], peak_bytes[("quad", dt)]
            else:
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                fwd_grad_s = population_run(opt, designs)[2]
                peak = torch.cuda.max_memory_allocated() - base
            c[B] = dict(fwd_s=fwd_s, fwd_designs_per_s=B / fwd_s, fwd_grad_s=fwd_grad_s,
                        fwd_grad_designs_per_s=B / fwd_grad_s, fwd_grad_peak_bytes=peak)
            log(f"  flagship population {dtype_name(dt)} B={B}: forward {fwd_s:.4f} s "
                f"({B / fwd_s:.1f} designs/s), value and gradient {fwd_grad_s:.3f} s "
                f"({B / fwd_grad_s:.2f} designs/s, peak memory {peak} B)")

    opt, design = kernel_path[f64]
    problem = opt.forward_problem
    designs = stepped_designs(design, POPULATION_B, POPULATION_STEP)

    def population_args():
        with torch.no_grad():
            return problem.solve_dynamics.trajectory_args(
                problem.state0, problem.timepoints, problem.control_params(designs))

    def forward():
        with torch.no_grad():
            opt.population_objective_fn(designs)

    args = population_args()
    share = dict(B=POPULATION_B,
                 prepare_s=statistics.median(host_seconds(population_args)[1] for _ in range(3)),
                 kernel_s=event_ms(trajectory(args), 3) / 1e3,
                 forward_s=statistics.median(host_seconds(forward)[1] for _ in range(3)))
    share["host_share"] = 1 - share["kernel_s"] / share["forward_s"]
    # One interval's graphed vector-Jacobian product at the population, as
    # the adjoint captures it: host seconds and the device memory it holds.
    with torch.no_grad():
        outU, outV, outA = core.trajectory_forward(args)[:3]
    fixed_in = tuple(f.detach().requires_grad_(i < 2) for i, f in enumerate(args.fixed))
    k, n = args.dts.shape[0] - 1, args.spec.n_substeps
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    graphed, capture_s = host_seconds(lambda: core.GraphedIntervalVJP(
        args.spec, (outU[:, k - 1], outV[:, k - 1], outA[:, k - 1]),
        args.drive[:, k * n:(k + 1) * n], args.dts[k], fixed_in))
    capture = dict(B=POPULATION_B, capture_s=capture_s,
                   graph_bytes=torch.cuda.memory_allocated() - before)
    del graphed, args, outU, outV, outA, fixed_in
    torch.cuda.empty_cache()
    log(f"  flagship population B={POPULATION_B} float64 forward: inputs built in "
        f"{share['prepare_s']:.4f} s, kernel {share['kernel_s']:.4f} s, objective "
        f"{share['forward_s']:.4f} s, host share {share['host_share']:.3f}; graph capture "
        f"{capture['capture_s']:.3f} s holding {capture['graph_bytes']} B")
    timings.update(population_curve=curve, population_host_share=share,
                   population_graph_capture=capture)

    # Kernel 1L at main paths 5 (the pulse) and 6 (the tensile chain at
    # strain 0.6), float32 and float64.
    pulse32 = kc.cast(pulse_args, f32)
    with torch.no_grad():
        chain = {dt: tensile_args[dt][0].trajectory_args(tensile_args[dt][2],
                                                         tensile_args[dt][3],
                                                         tensile_args[dt][1](0.6))
                 for dt in dtypes}
    core.trajectory_forward(pulse32)  # warm up
    tl = {
        "pulse_ms": event_ms(trajectory(pulse32), 3),
        "pulse_ms_float64": event_ms(trajectory(pulse_args), 3),
        "tensile_ms": event_ms(trajectory(chain[f32]), 3),
        "tensile_ms_float64": event_ms(trajectory(chain[f64]), 3),
    }
    log(f"timing ({card_line}), kernel 1L, CUDA events, medians of 3: "
        + ", ".join(f"{k} {v:.3f}" for k, v in tl.items()))
    results["verlet_quad_loaded"].update(ms=tl["pulse_ms"], ms_float64=tl["pulse_ms_float64"],
                                         tensile_ms=tl["tensile_ms"],
                                         tensile_ms_float64=tl["tensile_ms_float64"])
    results["verlet_quad_loaded"]["tensile_bound"] = kc.trajectory_bound(
        chain[f32], core.trajectory_forward(chain[f32])[0])

    phase_done("timing")

    # Main path 8's finalists: the launch of kernel 1g at B =
    # MULTISTART_FINALISTS against the plain guarded body on the same
    # inputs (run in a worker process during the timing).
    p_out, p_ms, _ = kc.from_bytes(finalist_plain.result())
    batch = [x.cpu() for x in batch]
    if not torch.equal(batch[4], p_out[4]) or not torch.equal(batch[3], p_out[3]):
        FAILED.append("multistart finalists: decisions of kernel 1g and the plain guarded body "
                      "differ")
    log(f"  multistart finalists B={MULTISTART_FINALISTS} float64: decisions of kernel 1g and "
        f"the plain guarded body {'identical' if torch.equal(batch[4], p_out[4]) else 'DIFFER'}"
        f", {int(batch[4].sum())} of {batch[4].numel()} substeps fired (plain body on a host "
        f"core {p_ms / 1e3:.1f} s)")
    for name, k, p in zip("UVA", batch, p_out):
        check(f"multistart finalists B={MULTISTART_FINALISTS} float64 {name}: kernel 1g vs "
              "plain guarded body", kc.max_rel_err(k, p), F64_TRAJ_TOL)
    results["verlet_quad_guarded"]["finalists_max_rel_err"] = max(
        kc.max_rel_err(k, p) for k, p in zip(batch[:3], p_out[:3]))

    # -- main path 9: kernel 2 and the stepped forward of "verlet_ckpt" --------
    t9 = time.perf_counter()
    force = results["quad_force"]

    def timed_ms(fn):
        fn()  # warm up
        return event_ms(fn, KERNEL2_REPS)

    def graphed_ms(fn):
        """The device's time of one call of ``fn``: a replay of a CUDA graph
        of KERNEL2_CALLS calls over KERNEL2_CALLS, without the host's work
        in the wrapper (an eager call of kernel 2 waits on the host;
        ``timed_ms`` of the call measures that)."""

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(KERNEL2_CALLS):
                fn()
        return timed_ms(graph.replay) / KERNEL2_CALLS

    # (a) Kernel 2 against its plain version at the microbenchmark's inputs,
    # (3, 16, 24) x KERNEL2_B (no bond engaged there), and at the contact
    # probe's state (engaged), float64 within F64_FORCE_TOL and float32 by
    # the trajectory rule against the float64 plain force.
    lanes = {dt: kc.lanes_microbench_inputs(B=KERNEL2_B, device=device, dtype=dt)
             for dt in dtypes}
    probe_state = (probe.U0 * probe.fixed[-1]
                   + core.drive_planes(probe.drive[:, 0], probe.spec, probe.U0))
    force_inputs = {f"microbench B={KERNEL2_B}": lanes[f64],
                    "contact probe": (probe_state, probe.fixed[:13])}
    for label, (U64, fixed64) in force_inputs.items():
        log(f"  kernel 2 {label}: {kc.engaged_bonds(U64, fixed64)} bonds engaged")
        for lin in (False, True):
            for contact in (False, True):
                opts = dict(linearized=lin, use_contact=contact)
                name = f"kernel 2 {label} linearized={lin} contact={contact}"
                k64 = quad_force(U64, fixed64, **opts)
                p64 = quad_grid_force_planes(U64, *fixed64, **opts)
                check(f"{name} float64", kc.max_rel_err(k64, p64), F64_FORCE_TOL)
                if label.startswith("microbench") and not lin and contact:
                    force["max_abs_err"] = float((k64 - p64).abs().max())
                U32, fixed32 = U64.float(), tuple(f.float() for f in fixed64)
                ref = quad_grid_force_planes(U32.double(), *(f.double() for f in fixed32), **opts)
                e_plain = kc.max_rel_err(quad_grid_force_planes(U32, *fixed32, **opts).double(),
                                         ref)
                check(f"{name} float32 vs float64 (plain float32 {e_plain:.3e})",
                      kc.max_rel_err(quad_force(U32, fixed32, **opts).double(), ref),
                      max(F32_TRAJ_FACTOR * e_plain, F32_TRAJ_FLOOR))
    # Times at the flagship's variant (nonlinear ligaments, contact): ms is
    # the kernel's one launch a call replayed from a CUDA graph, call_ms one
    # eager call of the wrapper. No single PyTorch call computes this
    # gradient, so there is no library time; vmap_ms is the counterpart of
    # the microbenchmark's form a), torch.func.vmap of the gradient of one
    # design's plain energy.
    vmap_grad = torch.func.vmap(torch.func.grad(
        lambda u, *leaves: quad_grid_energy_planes(u, *leaves)))
    for dt in dtypes:
        U, fixed = lanes[dt]
        suffix = "" if dt == f32 else "_float64"
        def kernel():
            return quad_force(U, fixed, linearized=False, use_contact=True)

        force["ms" + suffix] = graphed_ms(kernel)
        force["call_ms" + suffix] = timed_ms(kernel)
        force["plain_ms" + suffix] = timed_ms(lambda: quad_grid_force_planes(U, *fixed))
        force["vmap_ms" + suffix] = timed_ms(lambda: vmap_grad(U, *fixed))
    force.update(kc.force_bound(*lanes[f32]), B=KERNEL2_B, plain_device="cuda",
                 bound_ms_float64=kc.force_bound(*lanes[f64])["bound_ms"])
    log(f"timing ({card_line}), kernel 2 at (3, 16, 24) x {KERNEL2_B}, CUDA events, medians of "
        f"{KERNEL2_REPS}: " + ", ".join(f"{k} {force[k]:.4f}" for k in (
            "ms", "ms_float64", "call_ms", "call_ms_float64", "plain_ms", "plain_ms_float64",
            "vmap_ms", "vmap_ms_float64", "bound_ms", "bound_ms_float64"))
        + f" ({force['bound_by']})")
    U, fixed = lanes[f64]
    U = U[:4].clone()
    clean = quad_force(U, tuple(f[:4].contiguous() for f in fixed), linearized=False,
                       use_contact=True)
    U[1, 2, 5, 7] = float("nan")
    dirty = quad_force(U, tuple(f[:4].contiguous() for f in fixed), linearized=False,
                       use_contact=True)
    if bool(torch.isfinite(dirty[1]).all()) or not torch.equal(dirty[[0, 2, 3]],
                                                               clean[[0, 2, 3]]):
        FAILED.append("kernel 2: a NaN in design 1 did not stay in design 1")

    # (b) The flagship's value and design gradient through "verlet_ckpt".
    ckpt_path = {dt: fl.build_flagship(method="verlet_ckpt", device=device, dtype=dt)
                 for dt in dtypes}
    reset_counts()
    ckpt = {}
    for dt in dtypes:
        ckpt[dt] = value_and_grad(*ckpt_path[dt])
        if quad_force.launches != 1990 * len(ckpt) or core.plain_trajectory.calls != 0:
            raise AssertionError(f"main path 9 {dtype_name(dt)}: {quad_force.launches} kernel-2 "
                                 f"launches, {core.plain_trajectory.calls} plain-body forwards "
                                 f"(want 1990 a forward, none)")
    force["launches"] = quad_force.launches
    log(f"main path 9 (flagship value and gradient through method='verlet_ckpt'): "
        f"{quad_force.launches} kernel-2 launches, {core.plain_trajectory.calls} plain-body "
        f"forwards, {verlet_quad_trajectory.launches} kernel-1 launches")
    for dt in dtypes:
        name = dtype_name(dt)
        value, grad, seconds = ckpt[dt]
        log(f"  flagship verlet_ckpt {name}: objective {value!r} (JAX f64 "
            f"{fl.JAX_F64_OBJECTIVE!r}, kernel 1 {main[dt][0]!r}), fwd+grad {seconds:.2f} s")
        check(f"flagship verlet_ckpt {name} objective vs JAX float64",
              abs(value - fl.JAX_F64_OBJECTIVE) / fl.JAX_F64_OBJECTIVE, OBJECTIVE_TOL[name])
        check(f"flagship verlet_ckpt {name} objective vs kernel 1",
              abs(value - main[dt][0]) / abs(main[dt][0]), OBJECTIVE_TOL[name])
        if not (bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0):
            raise AssertionError(f"flagship verlet_ckpt {name} gradient is not finite and "
                                 "non-zero")
    stats = fl.vector_stats(ckpt[f64][1].cpu().numpy())
    log(f"  flagship verlet_ckpt float64 gradient (|g|, sum g, g.r) {stats} (JAX "
        f"{fl.JAX_F64_GRAD_STATS})")
    check("flagship verlet_ckpt float64 gradient vs JAX float64",
          stats_err(stats, fl.JAX_F64_GRAD_STATS), GRAD_TOL)
    e_plain = results["verlet_quad"]["plain_float32_rel_err"]["V"]
    check(f"flagship verlet_ckpt float32 gradient vs float64 (plain body float32 V "
          f"{e_plain:.3e})", kc.max_rel_err(ckpt[f32][1].double(), ckpt[f64][1]),
          max(F32_TRAJ_FACTOR * e_plain, F32_TRAJ_FLOOR))
    for dt in dtypes:
        opt, design = ckpt_path[dt]
        with torch.no_grad():
            force[f"flagship_fwd_s_{dtype_name(dt)}"] = statistics.median(
                host_seconds(lambda: opt.objective_fn(design))[1] for _ in range(3))
        force[f"flagship_fwd_grad_s_{dtype_name(dt)}"] = ckpt[dt][2]
    log(f"  flagship forward (host clock, median of 3): verlet_ckpt float32 "
        f"{force['flagship_fwd_s_float32']:.3f} s, float64 {force['flagship_fwd_s_float64']:.3f} "
        f"s; kernel 1 objective float32 {timings['fwd_kernel_s']:.3f} s")

    def force_at_state(label, args, k):
        """Kernel 2 against its plain version at float64 on the state that
        kernel 1 reaches at the end of interval ``k`` of ``args``, with the
        drive of the next substep (the configuration's variant)."""

        U = core.trajectory_forward(args)[0][:, k]
        U_eff = U * args.fixed[-1] + core.drive_planes(
            args.drive[:, (k + 1) * args.spec.n_substeps], args.spec, U)
        plain = quad_grid_force_planes(U_eff, *args.fixed[:13], **args.spec.force_of.keywords)
        check(f"kernel 2 {label} float64", kc.max_rel_err(args.spec.force_of(U_eff, args.fixed),
                                                          plain), F64_FORCE_TOL)

    force_at_state("flagship B=1 at interval 99", cases["flagship 24x16"], 99)

    # (c) Guard levels = 2 on the card through "verlet_ckpt" (float64,
    # forward only) against the plain guarded body on a host core, the
    # decisions of both depths identical. At B = 1 the launches count the
    # steps: every substep, refine - 1 more where a substep fired, and
    # refine - 1 more where a micro-step fired at depth 1 (then refine
    # micro-steps at depth 2).
    refine = deep_flagship.spec.guard["refine"]
    depth2 = {}
    for label, args in (("flagship MMA iterate 1", deep_flagship), ("8x6 violent", deep_small)):
        launches = quad_force.launches
        calls = core.plain_trajectory.calls
        out, seconds = host_seconds(lambda: core.trajectory_forward(args))
        steps = quad_force.launches - launches
        substeps, fired, micro_fired = out[4].numel(), int(out[4].sum()), int(out[5].sum())
        depth2[label] = refine * micro_fired
        if core.plain_trajectory.calls != calls:
            raise AssertionError(f"guard levels=2 {label}: the plain body ran on the card")
        if steps != substeps + (refine - 1) * (fired + micro_fired):
            raise AssertionError(f"guard levels=2 {label}: {steps} kernel-2 launches for "
                                 f"{fired} and {micro_fired} refined steps of {substeps}")
        p_out, p_ms, _ = kc.from_bytes(deep_jobs[label].result())
        cpu = [x.cpu() for x in out]
        same = len(cpu) == len(p_out) and all(torch.equal(c, p)
                                              for c, p in zip(cpu[3:], p_out[3:]))
        log(f"  guard levels=2 {label} float64: {fired} of {substeps} substeps fired, "
            f"{micro_fired} micro-steps fired at depth 1, {depth2[label]} micro-steps at depth "
            f"2, {steps} kernel-2 launches in {seconds:.2f} s (plain guarded body on a host core "
            f"{p_ms / 1e3:.1f} s); decisions {'identical' if same else 'DIFFER'}")
        if not same:
            FAILED.append(f"guard levels=2 {label}: decisions of the stepped forward and the "
                          "plain guarded body differ")
        for name, k, p in zip("UVA", cpu, p_out):
            check(f"guard levels=2 {label} float64 {name}: kernel 2 vs plain guarded body",
                  kc.max_rel_err(k, p), F64_TRAJ_TOL)
        force[f"levels2_{label.split()[0]}"] = dict(fired=fired, substeps=substeps,
                                                    depth1_fired=micro_fired,
                                                    depth2_steps=depth2[label], s=seconds)
    if not sum(depth2.values()):
        FAILED.append("guard levels=2: no micro-step ran at depth 2")

    # (d) The 96 x 64 lattice (bench.py:405-440: its damping, target shift
    # (40, 30), the 25-degree design; 200 timepoints, 10 substeps), forward
    # only at float64: through kernel 2 (many SMs) and through kernel 1 (one
    # SM, its carry on a global workspace).
    from difflexmm_tpu_torch.models.quads_focusing import ForwardProblem, OptimizationProblem

    def large(method):
        cfg = fl.paper_config(method, fl.N_SUBSTEPS, device, f64)
        cfg.update(n1_blocks=96, n2_blocks=64, damping=0.0186 * 2 * (
            0.36125 * cfg["density"] * cfg["spacing"] ** 2 * cfg["k_shear"]) ** 0.5)
        problem = ForwardProblem(**cfg)
        opt = OptimizationProblem(problem, target_size=(2, 2), target_shift=(40, 30))
        opt.setup_objective()
        return opt, problem.geometry.get_design_from_rotated_square(
            25 * math.pi / 180, device=device, dtype=f64)

    large_runs = {}
    for method in ("verlet_ckpt", "auto"):
        opt, design = large(method)
        if method == "auto":
            force_at_state("96x64 at interval 99", kc.batched_args(opt.forward_problem, [design]),
                           99)
        reset_counts()
        with torch.no_grad():
            value, seconds = host_seconds(lambda: float(opt.objective_fn(design)))
        large_runs[method] = (value, seconds, quad_force.launches,
                              verlet_quad_trajectory.launches)
    (v2, s2, l2, _), (v1, s1, _, l1) = large_runs["verlet_ckpt"], large_runs["auto"]
    log(f"  96x64 float64 forward (host clock, one run each): kernel 2 {s2:.3f} s ({l2} "
        f"launches), objective {v2!r}; kernel 1 {s1:.3f} s ({l1} launch), objective {v1!r}")
    if l2 != 1990 or l1 != 1 or not math.isfinite(v2):
        raise AssertionError("96x64: the forwards did not run through kernels 2 and 1")
    check("96x64 float64 objective: kernel 2 vs kernel 1", abs(v2 - v1) / abs(v1),
          LARGE_OBJECTIVE_TOL)
    force.update(large_96x64=dict(kernel2_s=s2, kernel1_s=s1, objective=v2,
                                  objective_kernel1=v1))
    force["main_path_9_s"] = time.perf_counter() - t9
    phase_done(f"main path 9 ({force['main_path_9_s']:.1f} s)")

    # -- main path 10: the flagship's robustness map through kernel 1 ----------
    t10 = time.perf_counter()
    from difflexmm_tpu_torch.models import family_configs as fc

    map_opt, map_design = kernel_path[f64]
    map_amplitudes, map_rates = map_scenarios(map_opt.forward_problem, device)
    map_plain, static_plain, yardstick_s = yardstick_job.result()
    map_plain = torch.tensor(map_plain, device=device, dtype=f64)
    plain_rows, plain_cols = (torch.tensor(ix, device=device) for ix in zip(*MAP_PLAIN_CELLS))
    log(f"main paths 10-11 plain-body yardsticks (a process of their own): {yardstick_s:.1f} s")
    n_map = MAP_POINTS * MAP_POINTS
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        robustness = map_opt.compute_robustness_map(map_design, map_amplitudes, map_rates)
    torch.cuda.synchronize()
    map_s = time.perf_counter() - t0
    launches, plain_calls = verlet_quad_trajectory.launches, core.plain_trajectory.calls
    log(f"main path 10 (flagship robustness map, {n_map} scenarios at float64): {launches} "
        f"kernel-1 launches, {plain_calls} plain-body forwards")
    if launches != 1 or plain_calls != 0:
        raise AssertionError("main path 10: the map was not one launch of kernel 1")
    if tuple(robustness.shape) != (MAP_POINTS, MAP_POINTS) or not bool(
            torch.isfinite(robustness).all()):
        raise AssertionError(f"main path 10: map of shape {tuple(robustness.shape)}, finite "
                             f"{bool(torch.isfinite(robustness).all())}")
    results["verlet_quad"]["launches_by_path"] = {"1": results["verlet_quad"]["launches"],
                                                  "10": launches}
    warm_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            map_opt.compute_robustness_map(map_design, map_amplitudes, map_rates)
        torch.cuda.synchronize()
        warm_s.append(time.perf_counter() - t0)
    with torch.no_grad():
        alone = torch.stack([map_cells(map_opt, map_design, a, r) for a in map_amplitudes
                             for r in map_rates]).reshape(MAP_POINTS, MAP_POINTS)
    check("main path 10: each map cell vs its scenario alone at B = 1 (kernel 1)",
          float(((robustness - alone).abs() / alone.abs()).max()), MAP_TOL)
    cells = robustness[plain_rows, plain_cols]
    check("main path 10: two map cells vs the plain body on the card",
          float(((cells - map_plain).abs() / map_plain.abs()).max()), F64_TRAJ_TOL)
    warm = statistics.median(warm_s)
    log(f"  robustness map: {map_s:.4f} s ({n_map / map_s:.1f} scenarios/s), warm median of "
        f"3 {warm:.4f} s ({n_map / warm:.1f} scenarios/s); {card_line}")
    timings.update(robustness_map_s=map_s, robustness_map_scenarios_per_s=n_map / map_s,
                   robustness_map_warm_s=warm, robustness_map_warm_scenarios_per_s=n_map / warm,
                   yardsticks_10_11_s=yardstick_s)
    phase_done(f"main path 10 ({time.perf_counter() - t10:.1f} s)")

    # -- main path 11: the five other quad families through kernel 1 ----------
    t11 = time.perf_counter()
    families = fc.example_families(device=device, dtype=f64)
    family_values, family_s = {}, {}
    reset_counts()
    for name, (opt, design) in families.items():
        before = verlet_quad_trajectory.launches
        d = tuple(x.detach().clone().requires_grad_() for x in design)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value = opt.objective_fn(d)
        grads = torch.autograd.grad(value, d)
        torch.cuda.synchronize()
        family_s[name] = time.perf_counter() - t0
        family_values[name] = float(value.detach())
        n = verlet_quad_trajectory.launches - before
        finite_grads = all(bool(torch.isfinite(g).all()) for g in grads)
        log(f"  {name}: value {family_values[name]!r}, |grad| "
            f"{float(torch.sqrt(sum((g * g).sum() for g in grads))):.6e}, {n} kernel-1 "
            f"launches, fwd+grad {family_s[name]:.3f} s")
        if n != FAMILY_LAUNCHES[name]:
            raise AssertionError(f"main path 11 {name}: {n} kernel-1 launches, expected "
                                 f"{FAMILY_LAUNCHES[name]}")
        if not (math.isfinite(family_values[name]) and finite_grads):
            raise AssertionError(f"main path 11 {name}: value or gradient not finite")
    launches, plain_calls = verlet_quad_trajectory.launches, core.plain_trajectory.calls
    log(f"main path 11 (five quad families, value and gradient at float64): {launches} "
        f"kernel-1 launches, {plain_calls} plain-body forwards; {card_line}")
    if launches != sum(FAMILY_LAUNCHES.values()) or plain_calls != 0:
        raise AssertionError("main path 11 did not run through kernel 1")
    results["verlet_quad"]["launches_by_path"]["11"] = launches
    check("main path 11: static tuning value (kernel 1) vs the plain body on the card",
          abs(family_values["static_tuning"] - static_plain) / abs(static_plain), F64_TRAJ_TOL)
    timings.update(families_fwd_grad_s=family_s, families_value=family_values)
    phase_done(f"main path 11 ({time.perf_counter() - t11:.1f} s)")

    # -- main path 12: guards deeper than one level through kernels 1g and 1Kg --
    t12 = time.perf_counter()
    # The kernels against the plain guarded body on the same inputs (run in
    # the worker processes): (b) the flagship's MMA iterate 1 and (c) the
    # kagome configuration at TWO_LEVELS, (d) the violent 8 x 6 problem at
    # levels 2 (also with loads: guarded 1L) and 3. Float64: the decisions of
    # every depth identical, U, V, A within F64_TRAJ_TOL; float32 by the rule.
    deep = {}
    for label in deep_labels:
        k64, summary, errors = against_plain(label)
        deep[label] = (k64, summary, errors)
        log(f"  {label}: steps fired by depth {summary['fired_by_depth']} "
            f"(refine {cases[label].spec.guard['refine']}), gap needed by depth "
            f"{summary['gaps_by_depth']}")
    if not bool(deep["8x6 violent levels 3"][0][6].any()):
        FAILED.append("main path 12: no micro-step of depth 2 fired at levels 3 on the 8x6 case")
    for label in ("8x6 violent levels 2", "8x6 violent levels 2 loads"):
        if not bool(deep[label][0][5].any()):
            FAILED.append(f"main path 12: no micro-step of depth 1 fired on {label}")
    # Kernel times at levels 2 (CUDA events, medians of 3 after a warm-up),
    # each with the steps of every depth it ran and its bound.
    deep_timing = {}
    for label, name in ((flagship_deep, "verlet_quad_guarded"),
                        ("kagome 16x16 levels 2", "verlet_kagome_guarded")):
        args64 = cases[label]
        args32 = kc.cast(args64, f32)
        k64, summary, errors = deep[label]
        core.trajectory_forward(args32)  # warm up
        r = dict(ms=event_ms(trajectory(args32), 3), ms_float64=event_ms(trajectory(args64), 3),
                 fired_by_depth=summary["fired_by_depth"], refine=args64.spec.guard["refine"],
                 max_abs_err=errors["max_abs_err"], max_rel_err=errors["max_rel_err"],
                 plain_ms=errors["plain_ms"])
        r.update(kc.trajectory_bound(args32, k64[0], summary))
        r["us_per_step"] = r["ms"] * 1e3 / r["steps"]
        # The kernel of the walk (GUARD = 2) in its block, nonlinear with
        # contact as the configurations run.
        prefix = "verlet_kagome" if "kagome" in name else "verlet_quad"
        lib = launch.type_library(build.load(prefix), prefix)
        used = {dtype_name(dt): usage[prefix].get(
            (dtype_name(dt), 0, 1, 2, launch.block_threads(lib, prefix, 1, dt, True)), {})
            for dt in dtypes}
        r["registers"] = {d: u.get("registers") for d, u in used.items()}
        r["spills"] = {d: {k: v for k, v in u.items() if k != "registers"}
                       for d, u in used.items()}
        deep_timing[name] = r
        log(f"  {label}: kernel float32 {r['ms']:.3f} ms, float64 {r['ms_float64']:.3f} ms "
            f"for {r['steps']} steps ({r['us_per_step']:.3f} us a step at float32), bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}); {card_line}")
    # Guarded 1L at levels 2: the 8 x 6 case with loads, timed as above.
    label = "8x6 violent levels 2 loads"
    args64 = cases[label]
    args32 = kc.cast(args64, f32)
    k64, summary, errors = deep[label]
    core.trajectory_forward(args32)  # warm up
    r = dict(ms=event_ms(trajectory(args32), 3), ms_float64=event_ms(trajectory(args64), 3),
             fired_by_depth=summary["fired_by_depth"], refine=args64.spec.guard["refine"],
             max_abs_err=errors["max_abs_err"], plain_ms=errors["plain_ms"])
    r.update(kc.trajectory_bound(args32, k64[0], summary))
    results["verlet_quad_loaded"]["levels2"] = r
    log(f"  {label} (guarded 1L): kernel float32 {r['ms']:.3f} ms, float64 "
        f"{r['ms_float64']:.3f} ms for {r['steps']} steps, bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}); {card_line}")
    stepped_s = force["levels2_flagship"]["s"]
    log(f"  flagship MMA iterate 1 at levels 2, float64 forward: kernel 1g "
        f"{deep_timing['verlet_quad_guarded']['ms_float64']:.3f} ms, the stepped forward of "
        f"verlet_ckpt (main path 9 (c), host clock) {stepped_s:.2f} s")

    # The main path: the entry points a user calls. (a) The n = 5 rescue's
    # objective, forward only, unguarded (kernel 1, NaN), at one level and at
    # two (kernel 1g); (b) the flagship's objective at TWO_LEVELS at the MMA
    # iterate; (c) the kagome configuration's objective at TWO_LEVELS; (d) the
    # 8 x 6 objective's value and design gradient at levels 2, its value at
    # levels 3.
    rescue_builds = {(name, dt): fl.build_flagship(n_substeps=fl.RESCUE_N5_SUBSTEPS,
                                                   device=device, dtype=dt, guard=guard)
                     for dt in dtypes
                     for name, guard in (("plain", None), *fl.RESCUE_N5_GUARDS.items())}
    deep_objectives = {("flagship", dt): fl.build_flagship(device=device, dtype=dt,
                                                           guard=TWO_LEVELS)[0]
                       for dt in dtypes}
    deep_objectives.update({("kagome", dt): kg.build_kagome(device=device, dtype=dt,
                                                            guard=TWO_LEVELS)[0]
                            for dt in dtypes})
    deep3_opt, deep3_design = deep_small_objective(device, f64, 3)
    reset_counts()
    with torch.no_grad():
        rescue = {key: float(o.objective_fn(d)) for key, (o, d) in rescue_builds.items()}
        deep_values = {}
        for (lattice, dt), o in deep_objectives.items():
            design = deep_design if lattice == "flagship" else kagome_design
            deep_values[(lattice, dt)] = float(o.objective_fn(tuple(x.to(dt) for x in design)))
        deep3_value = float(deep3_opt.objective_fn(deep3_design))
    deep_value, deep_grad, deep_s = deep_small_value_and_grad(device, 2)
    torch.cuda.synchronize()
    quad_guarded = verlet_quad_trajectory.guarded_launches
    kagome_guarded = verlet_kagome_trajectory.guarded_launches
    quad_plain_launches = verlet_quad_trajectory.launches
    plain_calls, force_launches = core.plain_trajectory.calls, quad_force.launches
    log(f"main path 12 (guards of two and three levels: the n = 5 rescue, the flagship and "
        f"kagome at levels 2, the 8x6 value and gradient): {quad_guarded} kernel-1g launches, "
        f"{kagome_guarded} kernel-1Kg launches, {quad_plain_launches} kernel-1 launches, "
        f"{plain_calls} plain-body forwards, {force_launches} kernel-2 launches")
    # 1g: four rescue objectives, two flagship objectives, the 8 x 6 value at
    # levels 3 and its value and gradient at levels 2; 1Kg: two; kernel 1: the
    # two unguarded rescue objectives.
    if (quad_guarded != 4 + 2 + 2 or kagome_guarded != 2 or quad_plain_launches != 2
            or plain_calls != 0 or force_launches != 0):
        raise AssertionError("main path 12 did not run through kernels 1g, 1Kg and 1 alone")
    for dt in dtypes:
        name = dtype_name(dt)
        plain_value = rescue[("plain", dt)]
        log(f"  n = 5 rescue {name}: unguarded {plain_value!r}, " + ", ".join(
            f"{key} {rescue[(key, dt)]!r} (JAX f64 {fl.JAX_F64_RESCUE_N5[key]!r})"
            for key in fl.RESCUE_N5_GUARDS) + f", f64 odeint oracle {fl.ODEINT_F64_ORACLE!r}")
        if not math.isnan(plain_value):
            FAILED.append(f"n = 5 rescue {name}: the unguarded objective is {plain_value!r}, "
                          "not NaN")
        for key in fl.RESCUE_N5_GUARDS:
            value = rescue[(key, dt)]
            check(f"n = 5 rescue {name} {key} vs the f64 odeint oracle",
                  abs(value - fl.ODEINT_F64_ORACLE) / fl.ODEINT_F64_ORACLE, RESCUE_ORACLE_TOL)
            if dt == f64:
                ref = fl.JAX_F64_RESCUE_N5[key]
                check(f"n = 5 rescue float64 {key} vs JAX float64", abs(value - ref) / ref,
                      OBJECTIVE_TOL["float64"])
    for (lattice, dt), value in deep_values.items():
        log(f"  {lattice} at levels 2 {dtype_name(dt)}: objective {value!r}")
        if not math.isfinite(value):
            FAILED.append(f"main path 12: {lattice} objective at levels 2 is {value!r}")
    plain_value, plain_grad, plain_s = deep_grad_job.result()
    log(f"  8x6 violent levels 2 float64: value {deep_value!r} (plain body {plain_value!r}), "
        f"value and gradient {deep_s:.2f} s (plain body on a host core {plain_s:.2f} s); "
        f"levels 3 value {deep3_value!r}")
    check("8x6 violent levels 2 float64 value: kernel 1g vs plain body",
          abs(deep_value - plain_value) / abs(plain_value), DEEP_GRAD_TOL)
    check("8x6 violent levels 2 float64 design gradient: kernel 1g vs plain body",
          kc.max_rel_err(deep_grad, plain_grad), DEEP_GRAD_TOL)
    if not math.isfinite(deep3_value):
        FAILED.append(f"main path 12: the 8x6 value at levels 3 is {deep3_value!r}")
    # How the rescue's guards fired, and their kernels' times (float32 and
    # float64, medians of 3), outside the counted run.
    rescue_runs = {}
    for key in fl.RESCUE_N5_GUARDS:
        r = rescue_runs[key] = {}
        for dt in dtypes:
            o, d = rescue_builds[(key, dt)]
            args = kc.batched_args(o.forward_problem, [d])
            out = core.trajectory_forward(args)
            r[dtype_name(dt)] = dict(fired_by_depth=[int(t.sum()) for t in out[4:]],
                                     substeps=out[4].numel(), ms=event_ms(trajectory(args), 3),
                                     value=rescue[(key, dt)])
        log(f"  n = 5 rescue {key}: " + "; ".join(
            f"{d} fired by depth {v['fired_by_depth']} of {v['substeps']} substeps, "
            f"kernel {v['ms']:.3f} ms" for d, v in r.items()))
    for name, launches in (("verlet_quad_guarded", quad_guarded),
                           ("verlet_kagome_guarded", kagome_guarded)):
        results[name]["levels2"] = dict(deep_timing[name], launches=launches)
        results[name]["launches_by_path"] = {
            "2" if name == "verlet_quad_guarded" else "4": results[name]["launches"],
            "12": launches}
    results["verlet_quad"]["launches_by_path"]["12"] = quad_plain_launches
    timings.update(rescue_n5=rescue_runs, levels2_stepped_s=stepped_s,
                   deep_small_fwd_grad_s=deep_s, deep_small_plain_s=plain_s)
    phase_done(f"main path 12 ({time.perf_counter() - t12:.1f} s)")

    # -- main path 13: the rest of the optimizer and the solver remnants -------
    timings.update(main_path_13(device, results, side13_job, remnant_jobs, card_line))
    phase_done(f"main path 13 ({timings['main_path_13_s']:.1f} s)")

    # -- main path 14: statics and linear analysis -------------------------------
    timings.update(main_path_14(device, results, side14_job, nan_job, card_line))
    side14_lead = kagome_done_at - side14_job.result()["ended_at"]
    log(f"  main path 14's side process ended {side14_lead:.1f} s before main path 4 did")
    timings["main_path_14_side_lead_s"] = side14_lead
    phase_done(f"main path 14 ({timings['main_path_14_s']:.1f} s)")

    replaces = {"verlet_quad": "difflexmm_tpu/ops/pallas/core.py:822",
                "verlet_quad_guarded": "difflexmm_tpu/ops/pallas/core.py:822 (guarded: "
                                       "core.py:330-625, verlet_grid.py:201-262)",
                "verlet_kagome": "difflexmm_tpu/ops/pallas/core.py:822 (kagome: "
                                 "verlet_kagome.py:336-375, energy :127-242)",
                "verlet_kagome_guarded": "difflexmm_tpu/ops/pallas/core.py:822 (kagome, guarded: "
                                         "core.py:330-625, verlet_kagome.py:245-308)",
                "verlet_quad_loaded": "difflexmm_tpu/ops/pallas/core.py:822 (with load_values_fn: "
                                      "core.py:129-181, scatter verlet_grid.py:68-80)",
                "verlet_quad_population": "difflexmm_tpu/ops/pallas/core.py:822 (tiled: "
                                          "verlet_grid.py:265-287 on tiling.py, from "
                                          "solver/dynamics.py:984-1000)",
                "verlet_kagome_population": "difflexmm_tpu/ops/pallas/core.py:822 (kagome, "
                                            "tiled: verlet_kagome.py:311-333)",
                "quad_force": "tools/microbench_lanes_batch.py:143"}
    kernels = []
    for name, r in results.items():
        source = ("quad_force.cu" if name == "quad_force" else "verlet_kagome.cu"
                  if name.startswith("verlet_kagome") else "verlet_quad.cu")
        entry = {"name": name, "route": "cuda", "source": f"difflexmm_tpu_torch/csrc/{source}",
                 "replaces": replaces[name], "launches": r["launches"],
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"],
                 # No single PyTorch call integrates a trajectory of
                 # dependent substeps, nor computes a lattice's energy
                 # gradient (kernel 2).
                 "library_ms": None}
        entry.update({k: v for k, v in r.items() if k not in entry})
        # The kernels redesigned for the card: the block shape of the
        # main path's launch (1g and 1Kg at B = 1; the unguarded quad and
        # kagome kernels at B = 1 and at the population's B) or kernel 2's tile at
        # the microbenchmark's B, its registers and its stack and spill
        # bytes (float32, float64), nonlinear with contact as the
        # configurations run.
        if name in ("verlet_quad_guarded", "verlet_kagome_guarded", "verlet_quad",
                    "verlet_quad_loaded", "verlet_quad_population", "verlet_kagome",
                    "verlet_kagome_population"):
            prefix = "verlet_kagome" if "kagome" in name else "verlet_quad"
            guarded = name.endswith("_guarded")
            B = POPULATION_B if name.endswith("_population") else 1
            lib = launch.type_library(build.load(prefix), prefix)
            threads = {dtype_name(dt): launch.block_threads(lib, prefix, B, dt, guarded)
                       for dt in dtypes}
            used = {d: usage[prefix].get((d, 0, 1, int(guarded), t), {})
                    for d, t in threads.items()}
            entry.update(redesigned="PR 9" if guarded else "PR 11" if "kagome" in name
                         else "PR 10", block_threads=threads)
        elif name == "quad_force":
            tile = force_tile(24, 16, KERNEL2_B)
            used = {dtype_name(dt): usage[name].get((dtype_name(dt), 0, 1) + tile, {})
                    for dt in dtypes}
            entry.update(redesigned="PR 10", tile={"n1": tile[0], "n2": tile[1],
                                                   "threads": tile[2]},
                         tile_flagship_B1=force_tile(24, 16, 1))
        else:
            used = None
        if used is not None:
            entry.update(registers={d: u.get("registers") for d, u in used.items()},
                         spills={d: {k: v for k, v in u.items() if k != "registers"}
                                 for d, u in used.items()})
        kernels.append(entry)
    if FAILED:
        raise SystemExit("chip_smoke: checks failed:\n  " + "\n  ".join(FAILED))
    print(json.dumps({"kernels": kernels, "card": card_line, "ptxas": {
        f"{name} " + " ".join(map(str, k)): v
        for name, used in usage.items() for k, v in sorted(used.items())}, **timings}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
