"""The JAX package's float64 results for the port's optimizer and
solver-remnant tests (``tests/test_torch_optim_loops.py``,
``tests/test_torch_observability.py``, ``tests/test_torch_solver_remnants.py``)
and for ``chip_smoke.py`` main path 13.

``optimizer_small`` (``tests/data/optimizer_small.npz``): the runner's optax
path and the MMA checkpoint/resume on the 6 x 6 problem of
``difflexmm_tpu_torch/models/small_configs.py`` (method "verlet_ckpt", the
runner's ``guard="auto"``), the periodic kagome at 6 x 6 cells through the
kagome grid solver, and the dense rk4, semi-implicit and guarded Verlet
trajectories of the remnant lattice with their design gradients. The
flagship's optax history and the periodic kagome at the configuration's
16 x 16 cells are constants of ``models/flagship.py`` and
``models/kagome_config.py``, printed by this script's ``constants``.
Tracing and compiling all of it takes minutes, so the results are recorded.
To make the file again after a change to the JAX side, delete it and run,
from the repository's root::

    python tests/jax_optimizer_references.py [optimizer_small] [constants]

or the ``slow`` tests that hold a recomputation against the file and the
constants (``test_optimizer_references_match_jax``,
``test_flagship_optax_references_match_jax``,
``test_periodic_kagome_references_match_jax``).
"""

import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402
from difflexmm_tpu.geometry import QuadGeometry as JaxQuadGeometry  # noqa: E402
from difflexmm_tpu.geometry.kagome import KagomePeriodicGeometry as JaxPeriodic  # noqa: E402
from difflexmm_tpu.models import base as jax_base  # noqa: E402
from difflexmm_tpu.models import kagome_focusing as jax_kagome  # noqa: E402
from difflexmm_tpu.models import quads_focusing as jax_quads  # noqa: E402
from difflexmm_tpu.ops.assembly import (  # noqa: E402
    build_strain_energy,
    combine_block_energies,
)
from difflexmm_tpu.ops.bonds import ligament_energy  # noqa: E402
from difflexmm_tpu.ops.contact import build_contact_energy  # noqa: E402
from difflexmm_tpu.ops.loading import build_node_loading  # noqa: E402
from difflexmm_tpu.solver import setup_dynamic_solver  # noqa: E402
from difflexmm_tpu.utils import (  # noqa: E402
    ContactParams,
    ControlParams,
    GeometricalParams,
    LigamentParams,
    MechanicalParams,
)
from difflexmm_tpu.utils.observability import (  # noqa: E402
    MetricsLogger,
    OptimizationCheckpoint,
)
from difflexmm_tpu_torch.models import kagome_config as kg  # noqa: E402
from difflexmm_tpu_torch.models import small_configs as sc  # noqa: E402
from difflexmm_tpu_torch.models.flagship import (  # noqa: E402
    MMA_DESIGN_PROBE_SEED,
    design_stats,
)

#: The runner's optax iterations on the 6 x 6 problem and on the flagship.
OPTAX_ITERATIONS = 2
#: The small periodic kagome: the configuration cut to 6 x 6 cells, two
#: driven rows and its first second (its physics, step and target
#: otherwise).
PERIODIC_SMALL = dict(n1_cells=6, n2_cells=6, n_excited_blocks=2, n_timepoints=11,
                      simulation_time=1.0)

assert MMA_DESIGN_PROBE_SEED == 0


def checkpoint_problem():
    """The JAX 6 x 6 problem and its design (small_configs)."""

    problem = jax_quads.ForwardProblem(**sc.CHECKPOINT_PROBLEM, method="verlet_ckpt")
    optimization = jax_quads.OptimizationProblem(problem, target_size=sc.CHECKPOINT_TARGET)
    optimization.setup_objective()
    return optimization, problem.geometry.get_design_from_rotated_square(sc.CHECKPOINT_ANGLE)


def _designs(prefix, designs) -> dict:
    return {f"{prefix}_design{k}_{i}": np.asarray(x)
            for k, d in enumerate(designs) for i, x in enumerate(d)}


def runner_optax() -> dict:
    optimization, design = checkpoint_problem()
    final = optimization.run_optimization_optax(design, n_iterations=OPTAX_ITERATIONS,
                                                verbose=False)
    out = {"optax_values": np.asarray(optimization.objective_values)}
    out.update(_designs("optax", optimization.design_values))
    out.update({f"optax_final_{i}": np.asarray(x) for i, x in enumerate(final)})
    return out


def checkpoint_run(tmp_dir) -> dict:
    """Two MMA iterations with a logger and a checkpoint every iteration,
    then a fresh problem resuming for one more."""

    ckpt = OptimizationCheckpoint(Path(tmp_dir) / "opt.ckpt", every=1)
    logger = MetricsLogger(Path(tmp_dir) / "opt.jsonl")
    first, design = checkpoint_problem()
    first.run_optimization_mma(design, n_iterations=sc.CHECKPOINT_ITERATIONS[0],
                               metrics_logger=logger, checkpoint=ckpt, **sc.CHECKPOINT_MMA)
    second, design = checkpoint_problem()
    final = second.run_optimization_mma(design, n_iterations=sc.CHECKPOINT_ITERATIONS[1],
                                        checkpoint=ckpt, resume=True, **sc.CHECKPOINT_MMA)
    records = logger.read()
    out = {"ckpt_values": np.asarray(second.objective_values),
           "ckpt_first_values": np.asarray(first.objective_values),
           "ckpt_logged_steps": np.asarray([r["step"] for r in records]),
           "ckpt_logged_objectives": np.asarray([r["objective"] for r in records]),
           "ckpt_logged_violations": np.asarray([r["constraint_violation"] for r in records])}
    out.update(_designs("ckpt", second.design_values))
    out.update({f"ckpt_violation_{name}": np.asarray(v)
                for name, v in second.constraints_violation.items()})
    out.update({f"ckpt_final_{i}": np.asarray(x) for i, x in enumerate(final)})
    return out


def periodic_objective(**changes):
    """The JAX kagome configuration (cut by ``changes``) with its geometry
    made by ``KagomePeriodicGeometry``: ``objective(shifts (3, 2))``. The
    model builds its lattice by the name ``KagomeGeometry``; the periodic
    class takes the same arguments, so the name is swapped while the
    problem is set up."""

    config = dict(kg.KAGOME_CONFIG["forward"], method="verlet_ckpt", **changes)
    saved = jax_kagome.KagomeGeometry
    jax_kagome.KagomeGeometry = JaxPeriodic
    try:
        problem = jax_kagome.ForwardProblem(**config)
        optimization = jax_kagome.OptimizationProblem(
            problem, target_size=tuple(kg.KAGOME_CONFIG["optimization"]["target_size"]))
        optimization.setup_objective()
    finally:
        jax_kagome.KagomeGeometry = saved

    def objective(shifts):
        return optimization.objective_fn((shifts,))

    return objective


def periodic_small() -> dict:
    shifts = jnp.asarray(kg.periodic_shifts(device="cpu").numpy())
    value, grad = jax.jit(jax.value_and_grad(periodic_objective(**PERIODIC_SMALL)))(shifts)
    return {"periodic_value": np.asarray(value), "periodic_grad": np.asarray(grad)}


def remnant_problem(design, method, guard):
    """``small_configs.remnant_problem`` in the JAX package."""

    n1, n2 = sc.REMNANT_N1, sc.REMNANT_N2
    geometry = JaxQuadGeometry(n1, n2)
    bc, cnv, bonds, rbv = geometry.get_parametrization()
    energy = combine_block_energies(build_strain_energy(bonds(), ligament_energy),
                                    build_contact_energy(bonds(), angle_based=False))
    left = np.arange(n2) * n1
    right = left + n1 - 1
    driven = np.stack([left, 0 * left], axis=1)
    triples = np.concatenate([np.stack([right, 0 * right, 0 * right], axis=1),
                              np.stack([right, 1 + 0 * right, 1 + 0 * right], axis=1)])
    loaded = jax_base.all_dofs_pairs(right)
    node_vectors = cnv(*design)
    node_loading = build_node_loading(geometry, triples, lambda state, t, force: force * t)

    def loading_fn(state, t, force):
        forces = node_loading(state, t, dict(force=force), node_vectors)
        return forces[loaded[:, 0], loaded[:, 1]]

    def drive(t, amplitude, rate):
        return jax_base.pulse(t, amplitude, rate)

    kwargs = {} if method is None else dict(method=method)
    solve = setup_dynamic_solver(
        geometry=geometry, energy_fn=energy, loaded_block_DOF_pairs=loaded,
        loading_fn=loading_fn, constrained_block_DOF_pairs=driven, constrained_DOFs_fn=drive,
        damped_blocks=np.arange(geometry.n_blocks), n_substeps=sc.REMNANT_SUBSTEPS,
        guard=guard, **kwargs)
    control_params = ControlParams(
        geometrical_params=GeometricalParams(bc(*design), node_vectors),
        mechanical_params=MechanicalParams(
            bond_params=LigamentParams(1.0, 0.02, 1e-3, rbv()), density=1.0, damping=0.05,
            contact_params=ContactParams(*sc.REMNANT_CONTACT)),
        loading_params=dict(force=0.02),
        constraint_params=dict(amplitude=0.05, rate=1.5),
    )
    state0 = jnp.zeros((2, geometry.n_blocks, 3))
    return solve(state0, jnp.asarray(sc.REMNANT_TIMEPOINTS), control_params)


def remnant_trajectories() -> dict:
    """Each run's fields and the design gradient of ``sum V^2``; and the
    solver's bare default (no ``method``)."""

    design = tuple(jnp.asarray(x) for x in sc.remnant_design())
    out = {}
    runs = dict(sc.REMNANT_RUNS, default=(None, None))
    for name, (method, guard) in runs.items():
        spec = None if guard is None else sc.REMNANT_GUARDS[guard]

        def value(d):
            fields = remnant_problem(d, method, spec)
            return jnp.sum(fields[:, 1] ** 2), fields

        (v, fields), grads = jax.value_and_grad(value, has_aux=True)(design)
        out[f"remnant_{name}_fields"] = np.asarray(fields)
        out[f"remnant_{name}_value"] = np.asarray(v)
        out.update({f"remnant_{name}_grad{i}": np.asarray(g) for i, g in enumerate(grads)})
    return out


def optimizer_small() -> dict:
    import tempfile

    out = {}
    out.update(runner_optax())
    with tempfile.TemporaryDirectory() as tmp:
        out.update(checkpoint_run(tmp))
    out.update(periodic_small())
    out.update(remnant_trajectories())
    return out


def flagship_optax() -> dict:
    """The runner's optax on the flagship (method "verlet_ckpt", guard
    "auto"): the values, the designs as summaries of their change from the
    start, and the returned design's."""

    problem = jax_quads.ForwardProblem(**bench.paper_config("verlet_ckpt", 10))
    optimization = jax_quads.OptimizationProblem(problem, target_size=(2, 2),
                                                 target_shift=(4, 5))
    optimization.setup_objective()
    design = problem.geometry.get_design_from_rotated_square(25 * jnp.pi / 180)
    final = optimization.run_optimization_optax(design, n_iterations=OPTAX_ITERATIONS,
                                                verbose=False)
    start = [np.asarray(x) for x in design]
    return {
        "JAX_F64_OPTAX_VALUES": tuple(float(v) for v in optimization.objective_values),
        "JAX_F64_OPTAX_DESIGN_STATS": tuple(design_stats([np.asarray(x) for x in d], start)
                                            for d in optimization.design_values),
        "JAX_F64_OPTAX_FINAL_STATS": design_stats([np.asarray(x) for x in final], start),
    }


def periodic_kagome() -> dict:
    """The periodic kagome at the configuration's size: the objective and
    its gradient with respect to the shift triple."""

    shifts = jnp.asarray(kg.periodic_shifts(device="cpu").numpy())
    value, grad = jax.jit(jax.value_and_grad(periodic_objective()))(shifts)
    return {"JAX_F64_PERIODIC_OBJECTIVE": float(value),
            "JAX_F64_PERIODIC_GRAD": tuple(float(g) for g in np.asarray(grad).reshape(-1))}


def checkpoint_constants(ref: dict) -> dict:
    """small_configs' constants from the recorded checkpoint run."""

    start = [ref["ckpt_design0_0"], ref["ckpt_design0_1"]]
    n = len(ref["ckpt_values"])
    return {
        "JAX_F64_CHECKPOINT_VALUES": tuple(float(v) for v in ref["ckpt_values"]),
        "JAX_F64_CHECKPOINT_DESIGN_STATS": tuple(
            design_stats([ref[f"ckpt_design{k}_0"], ref[f"ckpt_design{k}_1"]], start)
            for k in range(n)),
        "JAX_F64_CHECKPOINT_VIOLATIONS": {
            name: tuple(float(v) for v in ref[f"ckpt_violation_{name}"])
            for name in ("angles", "edge_lengths")},
    }


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from jax_references import record_or_check, stored

    wanted = sys.argv[1:] or ["optimizer_small", "constants"]
    if "optimizer_small" in wanted:
        record_or_check("optimizer_small", optimizer_small())
        print("tests/data/optimizer_small.npz recorded (or matched)")
    if "constants" in wanted:
        for name, value in {**checkpoint_constants(stored("optimizer_small")),
                            **flagship_optax(), **periodic_kagome()}.items():
            print(f"{name} = {value!r}")
