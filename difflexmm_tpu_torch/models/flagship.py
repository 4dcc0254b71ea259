"""The paper flagship configuration: 24 x 16 quads focusing a raised-cosine
pulse onto a 2 x 2 target patch, in mm / N / s, and its guarded
constrained MMA run.

The constants are copied from ``paper_config`` and ``build_flagship`` of
the JAX package's ``bench.py`` (lines 42-106), which themselves follow the
reference notebook ``quads_focusing_3dp_pla_shims.ipynb`` cell 8, and the
MMA settings from ``tools/mma_flagship.py:89-103`` and
``bench.py:300-367``. They are copied rather than imported because
``bench.py`` imports jax. The reference values below were made with the
JAX package at float64 on the CPU; the slow test
``tests/test_torch_mma.py::test_flagship_references_match_jax`` makes them
again and checks these constants.
"""

import math

import numpy as np
import torch

from difflexmm_tpu_torch.models.quads_focusing import ForwardProblem, OptimizationProblem

#: Verlet substeps per output interval of the flagship benchmark.
N_SUBSTEPS = 10

#: Objective of the JAX package's f64 "verlet" solve of the flagship at
#: N_SUBSTEPS (ACCURACY.json, verlet_substep_sweep["10"]).
JAX_F64_OBJECTIVE = 4.9251240110676795

#: Lattice spacing of the flagship (mm).
SPACING = 15.0

#: The guarded constrained MMA of the flagship (``run_optimization_mma``
#: keywords): hinge shifts within +-0.35 spacing, no negative void or block
#: angle, edges at least 0.05 spacing long, 8% of the bound span per step.
#: With ``guard="auto"`` the flagship's guard has window 5 degrees,
#: threshold 0.02 window, proximity 2 windows, hard 0.1 window and
#: length_scale SPACING.
MMA_SETTINGS = dict(
    lower_bound=-0.35 * SPACING,
    upper_bound=0.35 * SPACING,
    min_void_angle=0.0,
    min_block_angle=0.0,
    min_edge_length=0.05 * SPACING,
    move_limit=0.08,
    feasibility_tol=1e-6,
    guard="auto",
)

#: Objective of the JAX package's f64 guarded flagship (``guard="auto"``,
#: method "verlet_ckpt") at the 25-degree design. The guard fires on no
#: substep of this trajectory, so the value equals the unguarded one to
#: rounding.
JAX_F64_GUARDED_OBJECTIVE = 4.925124011067685

#: The JAX package's f64 guarded flagship MMA: ``run_optimization_mma`` from
#: the 25-degree design with MMA_SETTINGS for 2 iterations (method
#: "verlet_ckpt", the default device loop). The objective of each
#: iteration, and each iteration's design as three numbers of its change dx
#: from the start (the flat design, horizontal then vertical shifts):
#: ``(|dx|, sum(dx), dx . r)`` with r standard normal from numpy's
#: ``default_rng(MMA_DESIGN_PROBE_SEED)``. The first step moves every
#: hinge by the move limit (0.84 mm).
JAX_F64_MMA_VALUES = (4.925124011067685, 42.31786950978283)
JAX_F64_MMA_DESIGN_STATS = (
    (0.0, 0.0, 0.0),
    (33.19860238022076, 13.440000000000005, -35.73928419363712),
)
MMA_DESIGN_PROBE_SEED = 0

#: The JAX package's f64 runner optax path on the flagship
#: (``run_optimization_optax`` from the 25-degree design, ``optax.adam(1e-2)``,
#: the runner's ``guard="auto"``, method "verlet_ckpt", 2 iterations;
#: ``tests/jax_optimizer_references.py``): each iteration's objective, its
#: design (the one evaluated) and the returned design (after the second
#: step, never evaluated) as summaries of their change from the start, as
#: JAX_F64_MMA_DESIGN_STATS's. Adam's first step moves every hinge by about
#: its learning rate, 1e-2 mm.
JAX_F64_OPTAX_VALUES = (4.925124011067685, 5.1163507621945215)
JAX_F64_OPTAX_DESIGN_STATS = (
    (0.0, 0.0, 0.0),
    (0.3952154109102004, 0.15998033155752656, -0.4255200196724887),
)
JAX_F64_OPTAX_FINAL_STATS = (0.7886818373019393, 0.3388790651778074, -0.8360335629015176)

#: Design gradients of the JAX package's f64 flagship objective (method
#: "verlet_ckpt", ``jax.value_and_grad`` of ``objective_fn``), each as
#: ``(|g|, sum(g), g . r)`` with the r of JAX_F64_MMA_DESIGN_STATS: unguarded
#: at the 25-degree design, and guarded (``guard="auto"``) at the two MMA
#: iterates of JAX_F64_MMA_VALUES, the gradients the MMA steps from. The
#: sum is zero to rounding: a uniform shift of every hinge leaves the
#: objective as it is.
JAX_F64_GRAD_STATS = (0.9012255894248804, -5.551115123125783e-17, -0.8084258280305556)
JAX_F64_MMA_GRAD_STATS = (
    (0.9012255894249632, -5.551115123125783e-17, -0.8084258280299957),
    (5.601530841701871, 0.0, 1.2930103916175053),
)

#: The n = 5 rescue (``tools/tunneling_study.py``): the flagship at
#: ``n_substeps=5``, whose plain integrator steps across a force spike and
#: gives NaN, under the travel-only model guard at one level (refine 16)
#: and at two (refine 32). JAX_F64_RESCUE_N5: the JAX package's f64
#: objective of each at the 25-degree design (method "verlet_ckpt", the
#: plane layout of the port; recorded in ``tests/data/guard_depth.npz`` by
#: ``tests/jax_guard_depth_references.py``). ODEINT_F64_ORACLE: the f64
#: adaptive ``odeint`` objective of the same design (``TUNNELING.json``),
#: which a rescue must land within 1e-3 of (``tools/tpu_parity_check.py``'s
#: gate).
RESCUE_N5_SUBSTEPS = 5
RESCUE_N5_GUARDS = {"levels1": {}, "levels2": {"refine": 32, "levels": 2}}
JAX_F64_RESCUE_N5 = {"levels1": 4.926892021240123, "levels2": 4.928659567608952}
ODEINT_F64_ORACLE = 4.925499947691854


def flat_numpy(design) -> np.ndarray:
    """A design (tensors or arrays) as one float64 numpy vector."""

    return np.concatenate([
        (x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x))
        .astype(np.float64).reshape(-1) for x in design
    ])


def vector_stats(v) -> tuple:
    """``(|v|, sum(v), v . r)`` of a flat vector, r standard normal from
    ``default_rng(MMA_DESIGN_PROBE_SEED)``."""

    v = np.asarray(v, dtype=np.float64)
    r = np.random.default_rng(MMA_DESIGN_PROBE_SEED).standard_normal(v.shape)
    return float(np.linalg.norm(v)), float(v.sum()), float(v @ r)


def design_stats(design, start) -> tuple:
    """:func:`vector_stats` of a design's change from ``start`` (see
    JAX_F64_MMA_DESIGN_STATS)."""

    return vector_stats(flat_numpy(design) - flat_numpy(start))


def paper_config(method="auto", n_substeps=N_SUBSTEPS, device="cuda", dtype=torch.float64,
                 guard=None) -> dict:
    """The flagship ForwardProblem kwargs."""

    n1_blocks, n2_blocks = 24, 16
    spacing = SPACING
    k_stretch = 120.0  # N/mm
    k_shear = 1.19  # N/mm
    k_rot = 1.50  # N mm
    density = 6.18e-9  # Mg/mm^2
    frequency = 30.0  # Hz
    # Rayleigh-style per-DOF damping of the zero-angle rotated square
    # (0.36125 / 0.02175026 = unit-square mass / rotational inertia factors).
    damping = 0.0186 * np.array([
        2 * (0.36125 * density * spacing**2 * k_shear) ** 0.5,
        2 * (0.36125 * density * spacing**2 * k_shear) ** 0.5,
        2 * (0.02175026 * density * spacing**4 * k_rot) ** 0.5,
    ]) * np.ones((n1_blocks * n2_blocks, 3))
    return dict(
        n1_blocks=n1_blocks,
        n2_blocks=n2_blocks,
        spacing=spacing,
        bond_length=0.15 * spacing,
        k_stretch=k_stretch,
        k_shear=k_shear,
        k_rot=k_rot,
        density=density,
        damping=damping,
        use_contact=True,
        k_contact=k_rot,
        min_angle=-15 * math.pi / 180,
        cutoff_angle=-10 * math.pi / 180,
        amplitude=0.5 * spacing,
        loading_rate=frequency,
        input_delay=0.1 / frequency,
        n_excited_blocks=2,
        loaded_side="left",
        input_shift=0,
        simulation_time=2 / frequency,
        n_timepoints=200,
        n_substeps=n_substeps,
        method=method,
        guard=guard,
        device=device,
        dtype=dtype,
    )


def build_flagship(method="auto", n_substeps=N_SUBSTEPS, device="cuda", dtype=torch.float64,
                   guard=None):
    """(OptimizationProblem with its objective set up, initial design): the
    rotated-square design at 25 degrees."""

    problem = ForwardProblem(**paper_config(method, n_substeps, device, dtype, guard))
    optimization = OptimizationProblem(problem, target_size=(2, 2), target_shift=(4, 5))
    optimization.setup_objective()
    design = problem.geometry.get_design_from_rotated_square(
        25 * math.pi / 180, device=device, dtype=dtype
    )
    return optimization, design
