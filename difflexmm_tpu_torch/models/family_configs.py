"""The example configurations of the five other quad families (the JAX
package's ``examples/quads_focusing_multi_input_optimization.py``,
``quads_energy_splitting_optimization.py``,
``quads_focusing_restricted_space_optimization.py``,
``quads_spin_optimization.py`` and ``quads_static_tuning_optimization.py``),
copied rather than imported so that the port needs nothing of the JAX
package's tree: 16 x 12 quads over 120 timepoints (10 substeps) for the
four that share quads focusing's forward problem, 12 x 10 quads over 12
static and 80 dynamic timepoints (12 substeps) and two scenarios for
static tuning. Each at its example's initial design, the rotated square
at 0.25 rad.
"""

import dataclasses

import torch

from difflexmm_tpu_torch.models import (
    quads_energy_splitting,
    quads_focusing,
    quads_focusing_multi_input,
    quads_focusing_restricted_space,
    quads_spin,
    quads_static_tuning,
)

#: The examples' shared quads-focusing forward problem (16 x 12 quads).
FOCUSING_EXAMPLE = dict(
    n1_blocks=16, n2_blocks=12, spacing=1.0, bond_length=0.1, k_stretch=1.0, k_shear=0.02,
    k_rot=1e-3, density=1.0, damping=0.02, amplitude=0.2, loading_rate=0.5, input_delay=0.0,
    n_excited_blocks=4, loaded_side="left", simulation_time=16.0, n_timepoints=120,
    n_substeps=10,
)

#: The static-tuning example's forward problem (12 x 10 quads).
STATIC_TUNING_EXAMPLE = dict(
    n1_blocks=12, n2_blocks=10, spacing=1.0, bond_length=0.1, k_stretch=1.0, k_shear=0.02,
    k_rot=1e-3, density=1.0, damping=0.1, n_excited_blocks=3, simulation_time_dynamic=12.0,
    n_timepoints=80, n_timepoints_static=12, n_substeps=12,
)

#: The static-tuning example's two scenarios: light pre-compression focuses
#: onto the target (+1), heavier pre-compression protects it (-1).
STATIC_TUNING_SCENARIOS = dict(amplitude=(0.15, 0.15), loading_rate=(0.5, 0.5),
                               compressive_strain=(0.02, 0.08),
                               compressive_strain_rate=(0.05, 0.05))

ROTATION = 0.25


def example_families(method="auto", device="cuda", dtype=torch.float64) -> dict:
    """``{name: (OptimizationProblem with its objective set up, design)}``
    of the five families as their examples configure them (the restricted
    space's design is the reduced one)."""

    focusing = quads_focusing.ForwardProblem(**FOCUSING_EXAMPLE, method=method, device=device,
                                             dtype=dtype)
    focusing.setup()
    design = focusing.geometry.get_design_from_rotated_square(ROTATION, device=device,
                                                              dtype=dtype)
    static = quads_static_tuning.ForwardProblem(**STATIC_TUNING_EXAMPLE, method=method,
                                                device=device, dtype=dtype)
    static.setup()
    static_design = static.geometry.get_design_from_rotated_square(ROTATION, device=device,
                                                                   dtype=dtype)
    restricted = quads_focusing_restricted_space.OptimizationProblem(
        focusing, target_size=(2, 2), target_shift=(3, 0), initial_guess_all=design,
        design_patch_size=6)
    problems = {
        "multi_input": (quads_focusing_multi_input.OptimizationProblem(
            [dataclasses.replace(focusing, loaded_side=side, is_setup=False)
             for side in ("left", "bottom")],
            target_size=(2, 2), target_shift=(3, 0), weights=(0.5, 0.5)), design),
        "energy_splitting": (quads_energy_splitting.OptimizationProblem(
            focusing, target_sizes=((2, 2), (2, 2)), target_shifts=((3, 3), (3, -3)),
            weights=(1.0, -1.0)), design),
        "restricted_space": (restricted, restricted.all_to_reduced_shifts(design)),
        "spin": (quads_spin.OptimizationProblem(
            focusing, quads_spin.ForwardInput(*design), target_size=(2, 2),
            target_shift=(2, 0)), design),
        "static_tuning": (quads_static_tuning.OptimizationProblem(
            static, quads_static_tuning.ForwardInput(*static_design, **STATIC_TUNING_SCENARIOS),
            target_sizes=((2, 2), (2, 2)), target_shifts=((2, 0), (2, 0)),
            weights=(1.0, -1.0)), static_design),
    }
    for optimization, _ in problems.values():
        optimization.setup_objective()
    return problems
