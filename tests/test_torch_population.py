"""The port's populations of designs against the JAX package, on the CPU at
float64: the design batch through the solver and the adjoint
(``parallel.population_value_and_grad`` on 8 x 6 quads and 4 x 3 kagome
cells, against JAX's over its design-tiled Pallas path in interpret mode),
the multistart MMA (JAX's analytic case and the small quads through the
model's runner, with the guarded finalist re-ranking), the finalist
re-ranking and the dense ``method="verlet"`` of both focusing models.

The JAX results that take tens of seconds to trace and compile are
recorded in ``tests/data/population_small.npz`` by the slow
``test_population_references_match_jax``, which makes them again with the
JAX package (about two minutes). On the CPU the kernel wrapper runs the
plain body.
"""

import contextlib
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from difflexmm_tpu.geometry import QuadGeometry as JaxQuadGeometry
from difflexmm_tpu.models import kagome_focusing as jax_kagome
from difflexmm_tpu.models import quads_focusing as jax_quads
from difflexmm_tpu.ops import mathx as jax_mathx
from difflexmm_tpu.parallel import multistart as jax_multistart
from jax_references import record_or_check, stored

from difflexmm_tpu_torch.models import kagome_config
from difflexmm_tpu_torch.models import kagome_focusing as port_kagome
from difflexmm_tpu_torch.models import quads_focusing as port_quads
from difflexmm_tpu_torch.models.flagship import MMA_SETTINGS, flat_numpy
from difflexmm_tpu_torch.ops.kernels import core
from difflexmm_tpu_torch.parallel import (
    population_value_and_grad,
    random_initial_designs,
    reevaluate_finalists,
    run_multistart_mma,
)
from difflexmm_tpu_torch.utils.convert import forward_problem_from_jax_dict

# One intra-op thread: the suite runs in several worker processes at once,
# and the port's many small tensor operations slow down several times over
# when each worker also runs a thread per core.
torch.set_num_threads(1)

# Per-design population values and gradients against JAX's tiled path:
# the same physics in another layout (JAX packs the designs side by side
# on lanes, with masked seams; the port stacks them on the batch), so only
# rounding separates them, as for one design (trajectories 1e-10 and
# gradients 1e-9 of their scales, tests/test_torch_flagship_parity.py).
POPULATION_TOL = 1e-9
# Multistart MMA iterates: the same update math in the same order (vmapped
# on both sides) on the objective above; the MMA step is bounded by the
# move limit, so the iterates stay within the gradients' tolerance.
ITERATE_TOL = 1e-9
# The dense method="verlet": the same operations in the same order as
# JAX's dense integrator, through 44 substeps.
DENSE_TOL = 1e-10

TARGET = dict(target_size=(2, 2), target_shift=(1, 1))
B = 3


def rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _numpy(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# ---------------------------------------------------------------------------
# The small problems (as kernel_checks.small_problem / small_kagome make
# them for the port) and their designs
# ---------------------------------------------------------------------------


def _jax_quads(method, **changes):
    """The flagship physics on 8 x 6 blocks, 12 timepoints of 4 substeps,
    the pulse sped up to 600 Hz (tests/test_torch_flagship_parity.py)."""

    cfg = bench.paper_config(method, 4)
    cfg.update(n1_blocks=8, n2_blocks=6, n_timepoints=12, damping=cfg["damping"][:48],
               loading_rate=600.0, input_delay=0.0, simulation_time=1.5e-3, **changes)
    return jax_quads.ForwardProblem(**cfg)


def _jax_kagome(method, **changes):
    """The kagome configuration's physics on 4 x 3 cells
    (tests/test_torch_kagome.py)."""

    cfg = dict(kagome_config.KAGOME_CONFIG["forward"], method=method)
    cfg.update(n1_cells=4, n2_cells=3, n_timepoints=12, n_substeps=4, simulation_time=3.0,
               n_excited_blocks=1, n_blocks_clamped_corner=1, **changes)
    return jax_kagome.ForwardProblem(**cfg)


FAMILIES = {"quad": (_jax_quads, jax_quads, port_quads, TARGET),
            "kagome": (_jax_kagome, jax_kagome, port_kagome, dict(target_size=(2, 2)))}


def _jax_dict(problem) -> dict:
    return {k: (np.asarray(v) if hasattr(v, "shape") else v)
            for k, v in problem.to_dict().items()}


def _designs(lattice, n=B, seed=0):
    """``n`` numpy designs stacked on a leading axis: the 25-degree rotated
    square with every hinge shifted by 0.05 N(0, 1) mm (quads), the regular
    kagome shifted by 0.02 N(0, 1) cell sizes (kagome)."""

    rng = np.random.default_rng(seed)
    if lattice == "quad":
        spacing = bench.paper_config("verlet_ckpt", 4)["spacing"]
        base = JaxQuadGeometry(8, 6, spacing, 0.15 * spacing).get_design_from_rotated_square(
            25 * math.pi / 180)
        return [np.stack([np.asarray(x) + 0.05 * rng.standard_normal(x.shape)
                          for _ in range(n)]) for x in base]
    shapes = ((5, 3, 2), (4, 4, 2), (4, 3, 2))  # the 4 x 3 cells' three shift grids
    return [0.02 * rng.standard_normal((n,) + shape) for shape in shapes]


def _port_problem(lattice, method="verlet_ckpt", **changes):
    """The port's optimization problem of a lattice, from the JAX dict."""

    make, _, port, target = FAMILIES[lattice]
    problem = forward_problem_from_jax_dict(_jax_dict(make(method, **changes)), device="cpu")
    optimization = port.OptimizationProblem(problem, **target)
    optimization.setup_objective()
    return optimization


def _tensors(arrays):
    return tuple(torch.tensor(x) for x in arrays)


# The analytic multistart case of tests/test_multistart.py:71: min |x - t|^2
# subject to sum(x) <= 1, three candidates, 40 iterations.
ANALYTIC_TARGET = np.array([1.0, 0.8, -0.2])
ANALYTIC_DESIGNS = np.stack([np.zeros(3), 0.3 * np.ones(3), -0.5 * np.ones(3)])
# The stability wall of tests/test_multistart.py:133: min |x - 1|^2, not
# finite wherever a coordinate passes WALL; two candidates, 25 iterations.
WALL, WALL_ITERATIONS = 0.6, 25
WALL_DESIGNS = np.stack([np.zeros(2), np.full((2,), -1.5)])
# The small quads' multistart: B candidates from _designs("quad", seed=1),
# 2 iterations with the flagship's MMA settings, 2 finalists.
MMA_ITERATIONS, N_FINALISTS = 2, 2
MMA_KWARGS = dict(lower_bound=MMA_SETTINGS["lower_bound"], upper_bound=MMA_SETTINGS["upper_bound"],
                  min_void_angle=MMA_SETTINGS["min_void_angle"],
                  min_block_angle=MMA_SETTINGS["min_block_angle"],
                  min_edge_length=MMA_SETTINGS["min_edge_length"],
                  move_limit=MMA_SETTINGS["move_limit"])


def jax_population_references(monkeypatch) -> dict:
    """The JAX package's float64 results that ``population_small.npz``
    records: population values and gradients over the design-tiled path
    (``verlet_pallas`` in interpret mode, under ``vmap``) for both
    lattices; the analytic multistart MMA and the one with a stability
    wall (full rejections); the small quads' model-level
    multistart MMA with its guarded finalists; and the dense
    ``method="verlet"`` objective and gradient of each focusing model for
    both ``grid_energy`` values.

    The JAX Pallas kernel swaps in a polynomial atan2 (``ops/mathx.py``,
    error below 2e-8 rad: Mosaic lowers no atan2), which moves the small
    quads' objective by 2e-6 and the kagome one by 4e-8; the port keeps
    the true atan2 (the polynomial is a TPU workaround that the port does
    not carry over, ROADMAP B). The tiled references are made with the true atan2 in the
    interpret-mode kernel, so that they differ from the port by the
    layout alone.
    """

    monkeypatch.setattr(jax_mathx, "pallas_math", contextlib.nullcontext)
    out = {}
    for lattice, (make, module, _, target) in FAMILIES.items():
        problem = make("verlet_pallas", pallas_interpret=True)
        optimization = module.OptimizationProblem(problem, **target)
        optimization.setup_objective()
        values, grads = jax.jit(
            lambda d, fn=optimization.objective_fn: jax_multistart.population_value_and_grad(
                fn, d))(tuple(jnp.asarray(x) for x in _designs(lattice)))
        out[f"{lattice}_values"] = np.asarray(values)
        out.update({f"{lattice}_grad{i}": np.asarray(g) for i, g in enumerate(grads)})
        one = tuple(jnp.asarray(x[0]) for x in _designs(lattice))
        for grid_energy in (True, False):
            dense = module.OptimizationProblem(make("verlet", grid_energy=grid_energy), **target)
            dense.setup_objective()
            value, grads = jax.jit(jax.value_and_grad(dense.objective_fn))(one)
            key = f"{lattice}_dense_grid{int(grid_energy)}"
            out[f"{key}_value"] = float(value)
            out.update({f"{key}_grad{i}": np.asarray(g) for i, g in enumerate(grads)})

    target = jnp.asarray(ANALYTIC_TARGET)
    result = jax_multistart.run_multistart_mma(
        lambda x: (jnp.sum((x - target) ** 2), 2.0 * (x - target)),
        jnp.asarray(ANALYTIC_DESIGNS), -2.0 * jnp.ones(3), 2.0 * jnp.ones(3), n_iterations=40,
        constraints_and_jac=lambda x: ((jnp.sum(x) - 1.0)[None], jnp.ones((1, 3))),
        move_limit=0.3)
    out.update(analytic_designs=np.asarray(result.designs),
               analytic_values=np.asarray(result.objective_values),
               analytic_best=int(result.best_index))

    def wall(x):
        bad = jnp.any(x > WALL)
        return (jnp.where(bad, jnp.nan, jnp.sum((x - 1.0) ** 2)),
                jnp.where(bad, jnp.nan, 2 * (x - 1.0)))

    result = jax_multistart.run_multistart_mma(
        wall, jnp.asarray(WALL_DESIGNS), -2.0 * jnp.ones(2), 2.0 * jnp.ones(2),
        n_iterations=WALL_ITERATIONS, move_limit=0.5)
    out.update(wall_designs=np.asarray(result.designs),
               wall_values=np.asarray(result.objective_values),
               wall_rejected=np.asarray(result.rejected), wall_best=int(result.best_index))

    optimization = jax_quads.OptimizationProblem(_jax_quads("verlet_ckpt"), **TARGET)
    optimization.setup_objective()
    guesses = [tuple(jnp.asarray(x[b]) for x in _designs("quad", seed=1)) for b in range(B)]
    result = optimization.run_multistart_mma(guesses, MMA_ITERATIONS, n_finalists=N_FINALISTS,
                                             **MMA_KWARGS)
    out.update(
        mma_designs=np.asarray(result.designs), mma_values=np.asarray(result.objective_values),
        mma_violation=np.asarray(result.constraints_violation),
        mma_rejected=np.asarray(result.rejected), mma_best=int(result.best_index),
        mma_finalists=np.asarray(result.finalists.indices),
        mma_finalist_values=np.asarray(result.finalists.values),
        mma_recorded=float(optimization.objective_values[-1]),
    )
    return out


@pytest.mark.slow
def test_population_references_match_jax(monkeypatch):
    """Make ``tests/data/population_small.npz`` again with the JAX package."""

    record_or_check("population_small", jax_population_references(monkeypatch))


@pytest.fixture(scope="module")
def ref():
    return stored("population_small")


# ---------------------------------------------------------------------------
# The design batch through the solver and the adjoint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lattice", ["quad", "kagome"])
def test_population_value_and_grad_matches_jax_tiled(ref, lattice):
    optimization = _port_problem(lattice)
    designs = _tensors(_designs(lattice))
    calls = core.plain_trajectory.calls
    values, grads = population_value_and_grad(optimization.population_objective_fn, designs)
    # One trajectory of the whole population.
    assert core.plain_trajectory.calls == calls + 1
    assert values.shape == (B,)
    assert rel(_numpy(values), ref[f"{lattice}_values"]) <= POPULATION_TOL
    for i, g in enumerate(grads):
        assert g.shape == designs[i].shape
        for b in range(B):  # each design's gradient on its own scale
            assert rel(_numpy(g[b]), ref[f"{lattice}_grad{i}"][b]) <= POPULATION_TOL


@pytest.mark.parametrize("lattice", ["quad", "kagome"])
def test_population_of_one_equals_the_unbatched_solve(lattice):
    optimization = _port_problem(lattice)
    one = _tensors([x[0] for x in _designs(lattice, n=1)])
    d = tuple(x.clone().requires_grad_() for x in one)
    value = optimization.objective_fn(d)
    grads = torch.autograd.grad(value, d)
    values, pgrads = population_value_and_grad(optimization.population_objective_fn,
                                               tuple(x[None] for x in one))
    assert torch.equal(values[0], value.detach())
    for g, pg in zip(grads, pgrads):
        assert torch.equal(pg[0], g)
    problem = optimization.forward_problem
    with torch.no_grad():
        assert torch.equal(problem.solve(tuple(x[None] for x in one)).fields[0],
                           problem.solve(one).fields)


def test_population_value_and_grad_chunks_as_jax():
    """``grad_chunk`` only schedules the work (JAX's
    test_population_value_and_grad_chunked_matches_straight)."""

    rng = np.random.default_rng(1)
    designs = (torch.tensor(rng.standard_normal((8, 5))), torch.tensor(rng.standard_normal((8, 3))))
    calls = []

    def objective(d):
        calls.append(d[0].shape[0])
        return torch.sum(torch.sin(d[0]), dim=1) * torch.sum(d[1] ** 2, dim=1)

    v0, g0 = population_value_and_grad(objective, designs, grad_chunk=None)
    v1, g1 = population_value_and_grad(objective, designs, grad_chunk=2)
    assert calls == [8, 2, 2, 2, 2]
    assert torch.allclose(v0, v1, rtol=1e-12)
    for a, b in zip(g0, g1):
        assert torch.allclose(a, b, rtol=1e-12)
    v2, _ = population_value_and_grad(objective, designs)  # "auto": one chunk at B = 8
    v3, _ = population_value_and_grad(objective, designs, grad_chunk=3)  # does not divide 8
    assert calls[-2:] == [8, 8] and torch.equal(v0, v2) and torch.equal(v0, v3)
    # The gradient of each design is its own: d/dx sum(sin x) * |y|^2.
    assert torch.allclose(g0[0], torch.cos(designs[0]) * torch.sum(designs[1] ** 2, 1)[:, None])


# ---------------------------------------------------------------------------
# The multistart MMA
# ---------------------------------------------------------------------------


def _analytic_run(**kwargs):
    target = torch.tensor(ANALYTIC_TARGET)
    return run_multistart_mma(
        lambda xs: torch.sum((xs - target) ** 2, dim=1), torch.tensor(ANALYTIC_DESIGNS),
        -2.0, 2.0, n_iterations=40,
        constraints_and_jac=lambda x: ((torch.sum(x) - 1.0)[None],
                                       torch.ones((1, 3), dtype=x.dtype)),
        move_limit=0.3, **kwargs)


def test_multistart_mma_matches_jax_on_the_analytic_case(ref):
    result = _analytic_run()
    assert result.objective_values.shape == (40, 3) and not bool(result.rejected.any())
    assert rel(_numpy(result.designs), ref["analytic_designs"]) <= ITERATE_TOL
    assert rel(_numpy(result.objective_values), ref["analytic_values"]) <= ITERATE_TOL
    assert result.best_index == int(ref["analytic_best"])
    assert float(torch.sum(result.best_design)) <= 1.0 + 1e-3
    with pytest.raises(NotImplementedError, match="A11"):
        _analytic_run(mesh=object())


def test_multistart_mma_rejects_nonfinite_candidates_as_jax(ref):
    """A candidate stepping past a stability wall retreats to its last
    accepted iterate, reuses its value and gradient and shrinks its move,
    while the other advances unaffected (JAX
    test_multistart_mma_rejects_nonfinite_candidates)."""

    def wall(xs):
        return torch.where(torch.any(xs > WALL, dim=1), torch.nan,
                           torch.sum((xs - 1.0) ** 2, dim=1))

    result = run_multistart_mma(wall, torch.tensor(WALL_DESIGNS), -2.0 * torch.ones(2),
                                2.0 * torch.ones(2), n_iterations=WALL_ITERATIONS,
                                move_limit=0.5)
    rejected = _numpy(result.rejected)
    assert rejected.any() and np.array_equal(rejected, ref["wall_rejected"])
    assert rel(_numpy(result.designs), ref["wall_designs"]) <= ITERATE_TOL
    assert rel(_numpy(result.objective_values), ref["wall_values"]) <= ITERATE_TOL
    assert result.best_index == int(ref["wall_best"])
    assert bool(torch.isfinite(result.objective_values[-1]).all())
    assert bool((result.designs <= WALL + 1e-9).all())
    assert bool((result.designs.max(dim=1).values > 0.4).all())


def test_multistart_mma_raises_on_a_nonfinite_initial_candidate():
    """As run_mma's iteration-0 guard (JAX
    test_multistart_mma_raises_on_nonfinite_initial_candidate)."""

    def objective(xs):
        return torch.where(torch.any(xs > 0.5, dim=1), torch.nan, torch.sum(xs**2, dim=1))

    designs = torch.stack([torch.zeros(2), torch.ones(2)])  # candidate 1 starts bad
    with pytest.raises(FloatingPointError, match=r"candidate\(s\) \[1\]"):
        run_multistart_mma(objective, designs, -2.0 * torch.ones(2), 2.0 * torch.ones(2),
                           n_iterations=5)


def test_model_multistart_mma_matches_jax_with_guarded_finalists(ref):
    optimization = _port_problem("quad")
    guesses = [_tensors([x[b] for x in _designs("quad", seed=1)]) for b in range(B)]
    result = optimization.run_multistart_mma(guesses, MMA_ITERATIONS, n_finalists=N_FINALISTS,
                                             **MMA_KWARGS)
    assert rel(_numpy(result.objective_values), ref["mma_values"]) <= ITERATE_TOL
    assert rel(_numpy(result.designs), ref["mma_designs"]) <= ITERATE_TOL
    assert rel(_numpy(result.constraints_violation), ref["mma_violation"]) <= ITERATE_TOL
    assert np.array_equal(_numpy(result.rejected), ref["mma_rejected"])
    finalists = result.finalists
    assert np.array_equal(_numpy(finalists.indices), ref["mma_finalists"])
    assert rel(_numpy(finalists.values), ref["mma_finalist_values"]) <= ITERATE_TOL
    assert result.best_index == int(ref["mma_best"])
    # One (value, design) pair in the histories: the winner's own value.
    assert len(optimization.objective_values) == len(optimization.design_values) == 1
    assert optimization.objective_values[0] == finalists.best_value
    assert abs(finalists.best_value - ref["mma_recorded"]) <= ITERATE_TOL * abs(ref["mma_recorded"])
    assert rel(flat_numpy(optimization.design_values[0]),
               ref["mma_designs"][int(ref["mma_best"])]) <= ITERATE_TOL


def test_model_multistart_records_the_winners_own_value():
    """A finalist whose re-evaluation is not finite never wins, and the
    history records the winner's own value (the JAX runner records the
    largest finalist value, NaN here: ROADMAP A14)."""

    optimization = _port_problem("quad")
    guesses = [_tensors([x[b] for x in _designs("quad", seed=1)]) for b in range(B)]
    seen = []

    def guarded(designs):
        values = optimization.population_objective_fn(designs)
        seen.append(values)
        return torch.where(torch.arange(len(values)) == 0, torch.nan, values)

    optimization._guarded_sibling = lambda guard: SimpleNamespace(population_objective_fn=guarded)
    result = optimization.run_multistart_mma(guesses, 1, n_finalists=2)
    finalists = result.finalists
    assert bool(torch.isnan(finalists.values[0])) and result.best_index == int(finalists.indices[1])
    assert optimization.objective_values == [float(seen[0][1])]
    assert math.isfinite(optimization.objective_values[0])


# ---------------------------------------------------------------------------
# The finalist re-ranking and the initial designs
# ---------------------------------------------------------------------------


def test_reevaluate_finalists_reranks_as_jax():
    designs, screen = np.arange(5.0), np.array([0.0, 10.0, 20.0, 30.0, 40.0])
    jres = jax_multistart.reevaluate_finalists(lambda d: -d["a"], {"a": jnp.asarray(designs)},
                                               jnp.asarray(screen), k=3, maximize=True)
    res = reevaluate_finalists(lambda d: -d, torch.tensor(designs), torch.tensor(screen), k=3)
    assert res.indices.tolist() == [int(i) for i in jres.indices] == [4, 3, 2]
    assert res.values.tolist() == [float(v) for v in jres.values] == [-4.0, -3.0, -2.0]
    assert res.screen_values.tolist() == [40.0, 30.0, 20.0]
    assert res.best_index == int(jres.best_index) == 2 and float(res.best_design) == 2.0
    assert res.best_value == -2.0


def test_reevaluate_finalists_nan_never_wins_as_jax():
    designs, screen = np.arange(4.0), np.array([np.nan, 1.0, 2.0, np.nan])
    jres = jax_multistart.reevaluate_finalists(
        lambda d: jnp.where(d["a"] == 2.0, jnp.nan, d["a"]), {"a": jnp.asarray(designs)},
        jnp.asarray(screen), k=2, maximize=True)
    calls = []

    def truth(d):
        calls.append(len(d))  # the finalists at once
        return torch.where(d == 2.0, torch.nan, d)

    res = reevaluate_finalists(truth, torch.tensor(designs), torch.tensor(screen), k=2)
    assert calls == [2]
    assert res.indices.tolist() == [int(i) for i in jres.indices] == [2, 1]
    assert res.best_index == int(jres.best_index) == 1 and res.best_value == 1.0
    # k beyond the population clips; minimizing ranks the other way; NaN
    # screening values come last.
    jres = jax_multistart.reevaluate_finalists(lambda d: d["a"], {"a": jnp.asarray(designs)},
                                               jnp.asarray(screen), k=10, maximize=False)
    res = reevaluate_finalists(lambda d: d, torch.tensor(designs), torch.tensor(screen), k=10,
                               maximize=False)
    assert res.indices.tolist() == [int(i) for i in jres.indices] == [1, 2, 0, 3]
    assert res.best_index == int(jres.best_index) == 0


def test_random_initial_designs_follow_the_generator():
    base = (torch.zeros(3, 2), torch.ones(4))
    a = random_initial_designs(torch.Generator().manual_seed(3), base, 5, scale=0.1)
    b = random_initial_designs(torch.Generator().manual_seed(3), base, 5, scale=0.1)
    assert [tuple(x.shape) for x in a] == [(5, 3, 2), (5, 4)]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert 0.0 < float(a[0].std()) < 0.3 and torch.allclose(a[1].mean(), torch.tensor(1.0),
                                                            atol=0.1)


# ---------------------------------------------------------------------------
# The dense method="verlet" of the focusing models (ROADMAP C2)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid_energy", [True, False])
@pytest.mark.parametrize("lattice", ["quad", "kagome"])
def test_dense_verlet_matches_jax(ref, lattice, grid_energy):
    optimization = _port_problem(lattice, method="verlet", grid_energy=grid_energy)
    assert optimization.forward_problem.method == "verlet"
    design = tuple(x.requires_grad_() for x in _tensors([x[0] for x in _designs(lattice)]))
    calls = core.plain_trajectory.calls
    value = optimization.objective_fn(design)
    grads = torch.autograd.grad(value, design)
    assert core.plain_trajectory.calls == calls  # the dense path, not the fast one
    key = f"{lattice}_dense_grid{int(grid_energy)}"
    assert abs(float(value.detach()) - ref[f"{key}_value"]) <= DENSE_TOL * abs(ref[f"{key}_value"])
    for i, g in enumerate(grads):
        assert rel(_numpy(g), ref[f"{key}_grad{i}"]) <= DENSE_TOL
