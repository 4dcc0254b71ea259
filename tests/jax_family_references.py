"""The JAX package's float64 results for the port's scenario and family
tests (``tests/test_torch_scenarios.py``, ``tests/test_torch_families.py``),
and the small problems both packages solve.

Every problem here is a JAX ``ForwardProblem`` or ``OptimizationProblem``
at a small size (6 x 4 quads, 13 to 24 timepoints, 4 substeps); the port builds
its own from the same ``to_dict()`` through ``utils.convert``. The JAX side
runs ``method="verlet_ckpt"`` on the CPU. Its results are recorded in
``tests/data/scenarios_small.npz`` and ``tests/data/families_small.npz``,
because tracing and compiling them takes minutes. To make the files again
after a change to the JAX side, delete them and run, from the repository's
root::

    python tests/jax_family_references.py [scenarios_small] [families_small]

or the ``slow`` tests ``test_scenario_references_match_jax`` and
``test_family_references_match_jax``, which also hold a recomputed set
against the file.
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
from difflexmm_tpu.geometry.polygon import compute_inertia  # noqa: E402
from difflexmm_tpu.models import kagome_focusing as jax_kagome  # noqa: E402
from difflexmm_tpu.models import quads_energy_splitting as jax_splitting  # noqa: E402
from difflexmm_tpu.models import quads_focusing as jax_quads  # noqa: E402
from difflexmm_tpu.models import quads_focusing_multi_input as jax_multi  # noqa: E402
from difflexmm_tpu.models import quads_focusing_restricted_space as jax_restricted  # noqa: E402
from difflexmm_tpu.models import quads_spin as jax_spin  # noqa: E402
from difflexmm_tpu.models import quads_static_tuning as jax_static  # noqa: E402
from difflexmm_tpu.ops.observables import kinetic_energy  # noqa: E402

N1, N2 = 6, 4

#: The scenario batch: the pulse's amplitude (a factor of the problem's)
#: and rate in each of three scenarios, and a weight for each.
SCENARIO_FACTORS = (0.8, 1.0, 1.2)
SCENARIO_RATES = (500.0, 600.0, 700.0)
SCENARIO_WEIGHTS = (0.5, -0.25, 1.0)
#: The robustness map's grid.
MAP_FACTORS = (0.9, 1.1)
MAP_RATES = (500.0, 600.0, 700.0)


def numpy_dict(problem) -> dict:
    """A JAX problem's ``to_dict()`` with its arrays as numpy."""

    def convert(v):
        if isinstance(v, dict):
            return {k: convert(x) for k, x in v.items()}
        if isinstance(v, list):
            return [convert(x) for x in v]
        if isinstance(v, tuple) and any(hasattr(x, "shape") for x in v):
            return tuple(np.asarray(x) for x in v)
        return np.asarray(v) if hasattr(v, "shape") else v

    return convert(problem.to_dict())


def flagship_small(**changes):
    """The flagship's physics (``bench.paper_config``) on 6 x 4 quads, 24
    timepoints over 1.5 ms, 4 substeps, the pulse at 600 Hz."""

    cfg = bench.paper_config("verlet_ckpt", 4)
    cfg.update(n1_blocks=N1, n2_blocks=N2, n_timepoints=24,
               damping=np.asarray(cfg["damping"][:N1 * N2]), loading_rate=600.0,
               input_delay=0.0, simulation_time=1.5e-3, n_blocks_clamped_corner=1)
    cfg.update(changes)
    return jax_quads.ForwardProblem(**cfg)


def unit_small(**changes):
    """The physics of the families' example scripts
    (``examples/quads_spin_optimization.py``: unit spacing and density) on
    6 x 4 quads, 13 timepoints over 3 time units, 4 substeps."""

    cfg = dict(n1_blocks=N1, n2_blocks=N2, spacing=1.0, bond_length=0.1, k_stretch=1.0,
               k_shear=0.02, k_rot=1e-3, density=1.0, damping=0.02, amplitude=0.2,
               loading_rate=0.5, input_delay=0.0, n_excited_blocks=2, loaded_side="left",
               simulation_time=3.0, n_timepoints=13, n_substeps=4, method="verlet_ckpt",
               n_blocks_clamped_corner=1)
    cfg.update(changes)
    return jax_quads.ForwardProblem(**cfg)


def static_small():
    """``examples/quads_static_tuning_optimization.py``'s physics on 6 x 4
    quads: 13 dynamic timepoints over 3 time units and 6 static ones, 4
    substeps."""

    return jax_static.ForwardProblem(
        n1_blocks=N1, n2_blocks=N2, spacing=1.0, bond_length=0.1, k_stretch=1.0,
        k_shear=0.02, k_rot=1e-3, density=1.0, damping=0.1, n_excited_blocks=2,
        simulation_time_dynamic=3.0, n_timepoints=13, n_timepoints_static=6, n_substeps=4,
        method="verlet_ckpt",
    )


def kagome_small():
    """The kagome configuration's physics at 4 x 3 cells (as
    ``tests/test_torch_kagome.py`` builds it)."""

    from difflexmm_tpu_torch.models import kagome_config

    cfg = dict(kagome_config.KAGOME_CONFIG["forward"], method="verlet_ckpt")
    cfg.update(n1_cells=4, n2_cells=3, n_timepoints=12, n_substeps=4, simulation_time=3.0,
               n_excited_blocks=1, n_blocks_clamped_corner=1)
    return jax_kagome.ForwardProblem(**cfg)


def _rotated_square(spacing, bond_length, angle):
    """The shifts of the rotated square at ``angle`` on 6 x 4 quads, numpy
    (from the port's geometry: numpy inputs for both packages)."""

    from difflexmm_tpu_torch.geometry.quad import QuadGeometry

    geometry = QuadGeometry(N1, N2, spacing=spacing, bond_length=bond_length)
    return [x.numpy() for x in geometry.get_design_from_rotated_square(angle, device="cpu")]


def flagship_design(seed=0):
    """The rotated square at 25 degrees plus noise of 0.05, numpy."""

    rng = np.random.default_rng(seed)
    return tuple(x + 0.05 * rng.standard_normal(x.shape)
                 for x in _rotated_square(15.0, 2.25, 25 * math.pi / 180))


def unit_design(seed=1):
    """The rotated square at 0.25 rad plus noise of 0.02 (unit spacing),
    numpy."""

    rng = np.random.default_rng(seed)
    return tuple(x + 0.02 * rng.standard_normal(x.shape) for x in _rotated_square(1.0, 0.1, 0.25))


def kagome_design(seed=3):
    rng = np.random.default_rng(seed)
    return tuple(0.03 * rng.standard_normal(s) for s in ((5, 3, 2), (4, 4, 2), (4, 3, 2)))


def excited(lib):
    """A drive of one scalar time, for ``setup(excited_blocks_fn=)``, in
    ``lib`` (jax.numpy or torch): a quarter-amplitude pulse ramp with a
    tail."""

    def fn(t, scale=1.0, rate=1.0):
        return scale * lib.sin(rate * t) ** 2 * lib.exp(-0.5 * rate * t)

    return fn


# Each family: a JAX OptimizationProblem on the small unit problem, and
# the design its objective is taken at.

def family_problems():
    design = unit_design()
    fp = unit_small()
    restricted = jax_restricted.OptimizationProblem(
        fp, target_size=(2, 2), target_shift=(1, 0),
        initial_guess_all=tuple(jnp.asarray(x) for x in design), design_patch_size=3)
    rng = np.random.default_rng(5)
    masks = (restricted.horizontal_shifts_mask, restricted.vertical_shifts_mask)
    reduced = tuple(x[np.asarray(mask)] + 0.01 * rng.standard_normal(int(np.sum(mask)))
                    for x, mask in zip(design, masks))
    static = static_small()
    static_input = jax_static.ForwardInput(
        *design, amplitude=(0.15, 0.15), loading_rate=(0.5, 0.5),
        compressive_strain=(0.02, 0.08), compressive_strain_rate=(0.05, 0.05))
    return {
        "multi_input": (jax_multi.OptimizationProblem(
            [fp, unit_small(loaded_side="bottom", amplitude=0.15)], target_size=(2, 2),
            target_shift=(1, 0), weights=(1.0, 0.5)), design),
        "energy_splitting": (jax_splitting.OptimizationProblem(
            fp, target_sizes=((2, 2), (1, 1)), target_shifts=((1, 0), (-2, 1)),
            weights=(1.0, -0.5)), design),
        "restricted_space": (restricted, reduced),
        "spin": (jax_spin.OptimizationProblem(
            fp, jax_spin.ForwardInput(*design), target_size=(2, 2), target_shift=(1, 0)),
            design),
        "static_tuning": (jax_static.OptimizationProblem(
            static, static_input, target_sizes=((2, 2), (2, 2)),
            target_shifts=((1, 0), (1, 0)), weights=(1.0, -1.0)), design),
    }


def scenario_references() -> dict:
    """``scenarios_small.npz``: on ``flagship_small`` at ``flagship_design``,
    three ``solve_scenario`` calls, the weighted sum of their target kinetic
    energies and its design gradient, the robustness map, the response data
    of scenario 1, and the fields of ``excited(jnp)`` on quads and kagome."""

    jo = jax_quads.OptimizationProblem(flagship_small(), target_size=(2, 2),
                                       target_shift=(1, 0))
    jo.setup_objective()
    fp = jo.forward_problem
    design = tuple(jnp.asarray(x) for x in flagship_design())
    amplitudes = [f * fp.amplitude for f in SCENARIO_FACTORS]
    out = {}
    for b, (a, r) in enumerate(zip(amplitudes, SCENARIO_RATES)):
        solution = fp.solve_scenario(design, a, r)
        out[f"scenario{b}_fields"] = np.asarray(solution.fields)
    response = fp.compute_response_data(fp.solve_scenario(design, amplitudes[1],
                                                          SCENARIO_RATES[1]))
    for key in ("strain_energy_stretch", "strain_energy_shear", "strain_energy_bending",
                "kinetic_energy"):
        out[f"response_{key}"] = np.asarray(response[key])

    target = jo.target_blocks

    def weighted(d):
        inertia = compute_inertia(fp.geometry.centroid_node_vectors(*d), fp.density)[target]

        def one(a, r):
            return kinetic_energy(fp.solve_scenario(d, a, r).fields[:, 1, target, :], inertia)

        values = jax.vmap(one)(jnp.asarray(amplitudes), jnp.asarray(SCENARIO_RATES))
        return jnp.asarray(SCENARIO_WEIGHTS) @ values

    value, grads = jax.jit(jax.value_and_grad(weighted))(design)
    out["weighted_value"] = float(value)
    out.update({f"weighted_grad{i}": np.asarray(g) for i, g in enumerate(grads)})
    out["robustness_map"] = np.asarray(jo.compute_robustness_map(
        design, [f * fp.amplitude for f in MAP_FACTORS], list(MAP_RATES)))

    quads = flagship_small()
    quads.setup(excited_blocks_fn=lambda t: excited(jnp)(t, 3.0, 2000.0))
    out["excited_quads_fields"] = np.asarray(quads.solve(design).fields)
    kagome = kagome_small()
    kagome.setup(excited_blocks_fn=lambda t: excited(jnp)(t, 0.2, 1.5))
    out["excited_kagome_fields"] = np.asarray(
        kagome.solve(tuple(jnp.asarray(x) for x in kagome_design())).fields)
    return out


def family_references() -> dict:
    """``families_small.npz``: each family's objective, its individual
    values where it has them, and its design gradient at its design."""

    out = {}
    for name, (problem, design) in family_problems().items():
        problem.setup_objective()
        d = tuple(jnp.asarray(x) for x in design)
        value, grads = jax.jit(jax.value_and_grad(problem.objective_fn))(d)
        out[f"{name}_value"] = float(value)
        out.update({f"{name}_grad{i}": np.asarray(g) for i, g in enumerate(grads)})
        if hasattr(problem, "objective_fn_individual"):
            out[f"{name}_individual"] = np.asarray(jax.jit(problem.objective_fn_individual)(d))
    return out


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from jax_references import record_or_check

    sets = {"scenarios_small": scenario_references, "families_small": family_references}
    for name in sys.argv[1:] or sorted(sets):
        record_or_check(name, sets[name]())
        print(f"tests/data/{name}.npz recorded (or matched)")
