"""The paper flagship configuration: 24 x 16 quads focusing a raised-cosine
pulse onto a 2 x 2 target patch, in mm / N / s.

The constants are copied from ``paper_config`` and ``build_flagship`` of
the JAX package's ``bench.py`` (lines 42-106), which themselves follow the
reference notebook ``quads_focusing_3dp_pla_shims.ipynb`` cell 8. They are
copied rather than imported because ``bench.py`` imports jax.
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


def paper_config(method="auto", n_substeps=N_SUBSTEPS, device="cpu", dtype=torch.float64) -> dict:
    """The flagship ForwardProblem kwargs."""

    n1_blocks, n2_blocks = 24, 16
    spacing = 15.0  # mm
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
        device=device,
        dtype=dtype,
    )


def build_flagship(method="auto", n_substeps=N_SUBSTEPS, device="cpu", dtype=torch.float64):
    """(OptimizationProblem with its objective set up, initial design): the
    rotated-square design at 25 degrees."""

    problem = ForwardProblem(**paper_config(method, n_substeps, device, dtype))
    optimization = OptimizationProblem(problem, target_size=(2, 2), target_shift=(4, 5))
    optimization.setup_objective()
    design = problem.geometry.get_design_from_rotated_square(
        25 * math.pi / 180, device=device, dtype=dtype
    )
    return optimization, design
