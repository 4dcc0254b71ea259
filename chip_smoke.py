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
nine main paths.
On the paper flagship (24 x 16 quads, 200 timepoints, 10 substeps): the
value and design gradient of ``OptimizationProblem.objective_fn`` (kernel
1), and the guarded constrained optimizer
``OptimizationProblem.run_optimization_mma`` (kernel 1g, two iterations at
float64 held against the JAX package's recorded history and gradients,
one at float32 timed). On the kagome configuration
(``examples/configs/kagome_focusing.json``: 16 x 16 cells, 200
timepoints, 10 substeps): the value and design gradient (kernel 1K), and
``run_optimization_mma`` with the configuration's settings (kernel 1Kg, two
iterations at float64 held against the JAX history and gradients). The
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
2 on the card through it (held against the plain guarded body), and the 96
x 64 lattice of ``bench.py`` through kernel 2 and through kernel 1.
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
# Batch sizes of the designs/s curve: 1, a few designs, about one design
# on each of the H100's 132 SMs, and four per SM (B = 8, 132 and 264 ran
# until the time limit needed their minute).
CURVE_BATCHES = (1, 32, 128, 528)
# Main path 9: kernel 2 at the microbenchmark's B, each time the median of
# KERNEL2_REPS runs after a warm-up; its device time a call from a CUDA
# graph of KERNEL2_CALLS calls (one replay of a graph of one call also
# times the host's submission of the graph, about 15 us on an H100's host).
KERNEL2_B, KERNEL2_REPS, KERNEL2_CALLS = 128, 30, 20
# The flagship's guard ("auto": proximity 2 windows, hard 0.1 window)
# refined to depth 2.
TWO_LEVELS = {"proximity_windows": 2.0, "hard_fraction": 0.1, "levels": 2}
# The 96 x 64 lattice (bench.py:405-440) through kernel 2 and through kernel
# 1: the two forwards differ by rounding (the force's summation is the same
# code; the Verlet update is fused on the card in kernel 1, not in the
# stepped forward), which over 1,990 damped substeps stays far below 1e-10
# of the objective at float64.
LARGE_OBJECTIVE_TOL = 1e-10


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


def main():
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    pool = ProcessPoolExecutor(PLAIN_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    try:
        smoke(pool)
    finally:
        pool.shutdown(cancel_futures=True)


def smoke(pool):
    """Everything but the set-up: ``pool`` runs the plain body's
    trajectories (see below)."""

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

    # The configurations' runs (the longest) first.
    for label in sorted(cases, key=lambda label: not ("16" in label or "20x10" in label)):
        submit(label)
    deep_jobs = {"8x6 violent": pool.submit(kc.plain_reference,
                                            kc.to_bytes(kc.on_cpu(deep_small)))}
    log(f"plain body: {3 * len(cases) + 1} runs of {len(cases) + 1} cases sent to "
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
            if not torch.equal(k64_cpu[4], p64[4]) or not torch.equal(k64_cpu[3], p64[3]):
                raise AssertionError(f"{label}: float64 decisions of kernel and plain body differ")
            log(f"  {label} float64: decisions identical, {int(k64_cpu[4].sum())} of "
                f"{k64_cpu[4].numel()} substeps fired")
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
            log(f"  {label} float32: {int(k32[4].sum())} substeps fired in the kernel, "
                f"{int(p32[4].sum())} in the plain body, decisions "
                f"{'identical' if torch.equal(k32[4], p32[4]) else 'differ'}")
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

    def refuses_two_levels(args):
        """levels > 1 is the plain body's only: the kernel raises."""

        deep = args.spec._replace(guard=dict(args.spec.guard, levels=2))
        try:
            core.trajectory_forward(args._replace(spec=deep))
        except NotImplementedError as err:
            log(f"  levels=2 on the card: NotImplementedError ({err})")
        else:
            raise AssertionError("the guarded kernel accepted levels=2")

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
    from difflexmm_tpu_torch.models.runner import population_unflatten
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
    refuses_two_levels(flagship_guarded)

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
    refuses_two_levels(kagome_guarded)

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

    # -- main path 2: the guarded constrained MMA through kernel 1g ----------
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
    deep_flagship = kc.batched_args(
        fl.build_flagship(method="verlet_ckpt", device=device, dtype=f64,
                          guard=TWO_LEVELS)[0].forward_problem, [opt.design_values[1]])
    deep_jobs["flagship MMA iterate 1"] = pool.submit(
        kc.plain_reference, kc.to_bytes(kc.on_cpu(deep_flagship)))
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
    from difflexmm_tpu_torch.models.runner import ravel_design
    from difflexmm_tpu_torch.optim.mma import mma_init, mma_update

    flat, unflatten = ravel_design(design)
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

    # -- main path 4: the kagome MMA through kernel 1Kg ----------------------
    # Built guarded, as the JAX reference ran (run_optimization_mma re-arms
    # "auto"), so that the objective whose gradients are kept is the MMA's.
    opt, design = kg.build_kagome(device=device, dtype=f64, guard="auto")
    kagome_grads = []
    capturing(opt, kagome_grads)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt.run_optimization_mma(design, n_iterations=MMA_ITERATIONS, verbose=False,
                             **kg.KAGOME_MMA_SETTINGS)
    torch.cuda.synchronize()
    per_iter = (time.perf_counter() - t0) / MMA_ITERATIONS
    launches = verlet_kagome_trajectory.guarded_launches
    plain_calls = core.plain_trajectory.calls
    log(f"main path 4 (kagome MMA, {MMA_ITERATIONS} iterations at float64): {launches} guarded "
        f"kernel launches, {plain_calls} plain-body forwards, {per_iter:.2f} s/iter (host clock)")
    if launches < MMA_ITERATIONS or plain_calls != 0:
        raise AssertionError("main path 4 did not run through kernel 1Kg")
    results["verlet_kagome_guarded"]["launches"] = launches
    timings["kagome_mma_float64_s_per_iter"] = per_iter
    if len(opt.objective_values) != len(kg.JAX_F64_MMA_VALUES) \
            or len(kagome_grads) != len(kg.JAX_F64_MMA_GRAD_STATS):
        raise AssertionError(f"kagome MMA: {len(opt.objective_values)} history entries, "
                             f"{len(kagome_grads)} gradients")
    scale = max(abs(x) for s in kg.JAX_F64_MMA_DESIGN_STATS for x in s)
    for k, (value, ref) in enumerate(zip(opt.objective_values, kg.JAX_F64_MMA_VALUES)):
        stats = fl.design_stats(opt.design_values[k], design)
        ref_stats = kg.JAX_F64_MMA_DESIGN_STATS[k]
        grad_stats = fl.vector_stats(torch.cat(kagome_grads[k]).cpu().numpy())
        with torch.no_grad():
            fired = core.trajectory_forward(kc.batched_args(opt.forward_problem,
                                                            [opt.design_values[k]]))[4]
        n_int = fired.shape[1] // opt.forward_problem.n_substeps
        intervals = int(fired.view(n_int, -1).any(-1).sum())
        log(f"  kagome MMA iteration {k}: objective {value!r} (JAX {ref!r}), design "
            f"(|dx|, sum dx, dx.r) {stats} (JAX {ref_stats}), gradient {grad_stats} (JAX "
            f"{kg.JAX_F64_MMA_GRAD_STATS[k]}); guard fired on {int(fired.sum())} of "
            f"{fired.numel()} substeps, in {intervals} of {n_int} intervals (JAX: "
            f"{kg.JAX_F64_MMA_FIRED[k]} intervals)")
        check(f"kagome MMA iteration {k} objective vs JAX", abs(value - ref) / abs(ref), MMA_TOL)
        check(f"kagome MMA iteration {k} design vs JAX",
              max(abs(a - b) for a, b in zip(stats, ref_stats)) / scale, MMA_TOL)
        check(f"kagome MMA iteration {k} gradient vs JAX",
              stats_err(grad_stats, kg.JAX_F64_MMA_GRAD_STATS[k]), GRAD_TOL)
        timings[f"kagome_mma_fired_substeps_{k}"] = int(fired.sum())

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
