"""The JAX package's float64 results for guards deeper than one level
(``tests/test_torch_guard_depth.py``) and for the flagship's n = 5 rescue.

Two sets, recorded in ``tests/data/guard_depth.npz``:

- ``levels3_fields``: the violent 8 x 6 problem of
  ``kernel_checks.small_problem`` (3 timepoints, 4 substeps, the pulse at
  30 % of the flagship's amplitude) under a guard of three levels
  (:data:`LEVELS3_GUARD`, refine 4), solved at :func:`levels3_design`;
- ``rescue_n5_<case>``: the flagship's objective at ``n_substeps=5``, the
  25-degree design and the 2 x 2 target shifted (4, 5)
  (``tools/tunneling_study.py:67-85``), with each guard of
  :data:`RESCUE_GUARDS`: the travel-only guard at one level (refine 16) and
  at two (refine 32); and ``rescue_n5_plain_is_nan``, whether the unguarded
  objective is NaN.

The JAX side runs ``method="verlet_ckpt"`` on the CPU, the plane layout
the port's kernels and plain body share (``TUNNELING.json``'s values came
from the dense ``"verlet"``, whose rounding differs). Tracing and compiling
them takes minutes. To make the file again after a change to the JAX side,
delete it and run, from the repository's root::

    python tests/jax_guard_depth_references.py

or the ``slow`` test ``test_guard_depth_references_match_jax``, which also
holds a recomputed set against the file.
"""

import math
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402
from difflexmm_tpu.models import quads_focusing as jax_quads  # noqa: E402

#: The three-level guard of the 8 x 6 case: the flagship's "auto" terms
#: (proximity 2 windows, hard 0.1 window), refine 4.
LEVELS3_GUARD = {"proximity_windows": 2.0, "hard_fraction": 0.1, "levels": 3, "refine": 4}
LEVELS3_AMPLITUDE = 0.3
LEVELS3_TIMEPOINTS = 3

#: The n = 5 rescue's guards (model guards: window and length scale from
#: the model).
RESCUE_GUARDS = {"plain": None, "levels1": {}, "levels2": {"refine": 32, "levels": 2}}
RESCUE_SUBSTEPS = 5


def levels3_design(seed=11):
    """The 25-degree rotated square on 8 x 6 quads plus noise of 0.05,
    numpy (from the port's geometry: the same inputs for both packages)."""

    from difflexmm_tpu_torch.geometry.quad import QuadGeometry

    geometry = QuadGeometry(8, 6, spacing=15.0, bond_length=2.25)
    rng = np.random.default_rng(seed)
    return tuple(x.numpy() + 0.05 * rng.standard_normal(tuple(x.shape))
                 for x in geometry.get_design_from_rotated_square(25 * math.pi / 180,
                                                                  device="cpu"))


def levels3_problem():
    """The JAX twin of ``kernel_checks.small_problem(n_timepoints=3,
    guard=LEVELS3_GUARD, amplitude_scale=0.3)``."""

    cfg = bench.paper_config("verlet_ckpt", 4)
    cfg.update(n1_blocks=8, n2_blocks=6, n_timepoints=LEVELS3_TIMEPOINTS,
               damping=np.broadcast_to(np.asarray(cfg["damping"][0]), (48, 3)),
               loading_rate=600.0, input_delay=0.0, simulation_time=1.5e-3,
               guard=LEVELS3_GUARD, amplitude=LEVELS3_AMPLITUDE * cfg["amplitude"])
    problem = jax_quads.ForwardProblem(**cfg)
    problem.setup()
    return problem


def rescue_objective(guard) -> float:
    """The flagship's objective at n_substeps=5 under ``guard``."""

    cfg = bench.paper_config("verlet_ckpt", RESCUE_SUBSTEPS)
    problem = jax_quads.ForwardProblem(guard=guard, **cfg)
    optimization = jax_quads.OptimizationProblem(problem, target_size=(2, 2),
                                                 target_shift=(4, 5))
    optimization.setup_objective()
    design = problem.geometry.get_design_from_rotated_square(25 * jnp.pi / 180)
    return float(jax.jit(optimization.objective_fn)(design))


def guard_depth_references() -> dict:
    """``guard_depth.npz``."""

    problem = levels3_problem()
    design = tuple(jnp.asarray(x) for x in levels3_design())
    out = {"levels3_fields": np.asarray(problem.solve(design).fields)}
    for name, guard in RESCUE_GUARDS.items():
        value = rescue_objective(guard)
        if guard is None:
            out["rescue_n5_plain_is_nan"] = math.isnan(value)
        else:
            out[f"rescue_n5_{name}"] = value
    return out


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from jax_references import record_or_check

    record_or_check("guard_depth", guard_depth_references())
    print("tests/data/guard_depth.npz recorded (or matched)")
