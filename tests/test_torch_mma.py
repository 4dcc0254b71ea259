"""The port's MMA optimizer, fabrication constraints and guarded
``run_optimization_mma`` against the JAX package, on the CPU at float64.

The analytic problems are those of ``tests/test_optim.py``; the model runs
are the flagship physics at 8 x 6 blocks (``tests/test_torch_flagship_parity.py``'s
small problem) and, marked ``slow``, the flagship itself.
"""

import dataclasses
import inspect
import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from difflexmm_tpu.geometry import QuadGeometry as JaxQuadGeometry
from difflexmm_tpu.models import base as jax_base
from difflexmm_tpu.models.quads_focusing import (
    ForwardProblem as JaxForwardProblem,
    OptimizationProblem as JaxOptimizationProblem,
)
from difflexmm_tpu.optim import mma as jax_mma
from jax_references import record_or_check, stored

from difflexmm_tpu_torch.geometry.quad import QuadGeometry
from difflexmm_tpu_torch.models import base
from difflexmm_tpu_torch.models.flagship import (
    JAX_F64_GRAD_STATS,
    JAX_F64_GUARDED_OBJECTIVE,
    JAX_F64_MMA_DESIGN_STATS,
    JAX_F64_MMA_GRAD_STATS,
    JAX_F64_MMA_VALUES,
    MMA_SETTINGS,
    SPACING,
    build_flagship,
    design_stats,
    flat_numpy,
    paper_config,
    vector_stats,
)
from difflexmm_tpu_torch.models.quads_focusing import ForwardProblem, OptimizationProblem
from difflexmm_tpu_torch.ops.kernels import core
from difflexmm_tpu_torch.optim import mma
from difflexmm_tpu_torch.utils.convert import (
    design_from_numpy,
    forward_problem_from_jax_dict,
    optimization_problem_from_jax_dict,
)

# One intra-op thread: the suite runs in several worker processes at once,
# and the port's many small tensor operations slow down several times over
# when each worker also runs a thread per core.
torch.set_num_threads(1)

# Same update math in the same order at float64: the packages differ in
# the last bits of matrix products and norms only.
ITERATE_TOL = 1e-10
# Guarded MMA at 8 x 6: each iteration adds a guarded trajectory and its
# adjoint (trajectory 1e-10, gradient 1e-9 apart) to the update, and the
# MMA step is bounded by the move limit, so histories stay within 1e-8.
HISTORY_TOL = 1e-8
# Constraints and their Jacobians: closed-form geometry, rounding only.
CONSTRAINT_TOL = 1e-12


def rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def flat(design):
    return np.concatenate([np.asarray(x.detach() if torch.is_tensor(x) else x).reshape(-1)
                           for x in design])


# ---------------------------------------------------------------------------
# Analytic problems of tests/test_optim.py, in both packages
# ---------------------------------------------------------------------------


def _ill_conditioned():
    n, m = 60, 500
    rng = np.random.default_rng(0)
    A = rng.normal(size=(m, n))
    A[m // 2:] = A[: m - m // 2] + 1e-4 * rng.normal(size=(m - m // 2, n))
    scales = np.logspace(0, -8, m)[:, None]
    return dict(target=rng.normal(size=n) * 2.0, x0=np.zeros(n), lo=-5.0, hi=5.0,
                A=A * scales, b=np.abs(rng.normal(size=m)) * scales[:, 0], n_it=30,
                move_limit=0.5)


PROBLEMS = {
    "quadratic": dict(target=np.array([1.0, -2.0, 0.5]), x0=np.zeros(3), lo=-5.0, hi=5.0,
                      n_it=40),
    "projection": dict(target=np.array([1.0, 2.0]), x0=np.zeros(2), lo=0.0, hi=3.0,
                       A=np.array([[1.0, 1.0]]), b=np.array([2.0]), n_it=60),
    "many_constraints": dict(target=np.ones(20), x0=np.zeros(20), lo=-2.0, hi=2.0,
                             A=np.concatenate([np.eye(20), -np.eye(20)]), b=0.3 * np.ones(40),
                             n_it=60),
    "ill_conditioned": _ill_conditioned(),
    # A "stability wall": the objective is NaN beyond x > 0.6, so steps are
    # bisected (host loop) or rejected (device loop).
    "wall": dict(target=np.ones(3), x0=np.zeros(3), lo=-2.0, hi=2.0, n_it=25, move_limit=0.5,
                 wall=0.6),
    # Infeasible start, two small steps: ends violated, then restored.
    "restoration": dict(target=2.0 * np.ones(2), x0=np.array([2.0, 2.0]), lo=-5.0, hi=5.0,
                        A=np.array([[1.0, 1.0]]), b=np.array([2.0]), n_it=2, move_limit=0.05,
                        feasibility_tol=1e-6),
}


def _jax_problem(p):
    target = jnp.asarray(p["target"])

    def f_and_g(x):
        value, grad = jax.value_and_grad(lambda z: jnp.sum((z - target) ** 2))(x)
        if "wall" in p:
            bad = jnp.any(x > p["wall"])
            value, grad = jnp.where(bad, jnp.nan, value), jnp.where(bad, jnp.nan, grad)
        return value, grad

    cons = None
    if "A" in p:
        A, b = jnp.asarray(p["A"]), jnp.asarray(p["b"])

        def cons(x):
            return A @ x - b, A

    return f_and_g, cons


def _torch_problem(p):
    target = torch.tensor(p["target"])

    def f_and_g(x):
        x = x.detach().requires_grad_()
        value = torch.sum((x - target) ** 2)
        (grad,) = torch.autograd.grad(value, x)
        value = value.detach()
        if "wall" in p:
            bad = torch.any(x > p["wall"])
            value = torch.where(bad, torch.nan, value)
            grad = torch.where(bad, torch.nan, grad)
        return value, grad

    cons = None
    if "A" in p:
        A, b = torch.tensor(p["A"]), torch.tensor(p["b"])

        def cons(x):
            return A @ x - b, A

    return f_and_g, cons


def _run(driver_name, p, **kwargs):
    """(JAX history, port history) of one driver on one problem."""

    n = len(p["x0"])
    common = dict(n_iterations=p["n_it"], move_limit=p.get("move_limit", 0.5),
                  feasibility_tol=p.get("feasibility_tol"), **kwargs)
    jf, jc = _jax_problem(p)
    _, jh = getattr(jax_mma, driver_name)(
        jax.jit(jf), jnp.asarray(p["x0"]), p["lo"] * jnp.ones(n), p["hi"] * jnp.ones(n),
        constraints_and_jac=jc, **common)
    tf, tc = _torch_problem(p)
    _, th = getattr(mma, driver_name)(
        tf, torch.tensor(p["x0"]), p["lo"] * torch.ones(n, dtype=torch.float64),
        p["hi"] * torch.ones(n, dtype=torch.float64), constraints_and_jac=tc, **common)
    return jh, th


def _assert_histories_match(jh, th, tol):
    assert len(jh["objective_values"]) == len(th["objective_values"]) > 0
    assert th["rejected"] == [bool(r) for r in jh["rejected"]]
    assert rel(th["objective_values"], jh["objective_values"]) <= tol
    assert rel(np.stack([np.asarray(x) for x in th["design_values"]]),
               np.stack([np.asarray(x) for x in jh["design_values"]])) <= tol
    assert rel(th["constraints_violation"], jh["constraints_violation"]) <= tol
    if "restoration" in jh:
        assert th["restoration"]["iterations"] == jh["restoration"]["iterations"]


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_run_mma_matches_jax(name):
    jh, th = _run("run_mma", PROBLEMS[name])
    _assert_histories_match(jh, th, ITERATE_TOL)
    if name == "wall":
        assert np.all(np.isfinite(th["objective_values"]))


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_run_mma_fused_matches_jax(name):
    # chunk=7: the ragged last chunk of 60 and 40 iterations.
    jh, th = _run("run_mma_fused", PROBLEMS[name], chunk=7)
    _assert_histories_match(jh, th, ITERATE_TOL)
    if name == "wall":
        assert any(th["rejected"])


@pytest.mark.parametrize("m", [0, 1, 7])
def test_mma_update_matches_jax(m):
    # Three updates from random gradients and constraints: the asymptotes'
    # fresh, growing and shrinking branches and the dual solve.
    rng = np.random.default_rng(m)
    n = 12
    x0 = rng.uniform(-1, 1, n)
    lo, hi = -2.0 * np.ones(n), 2.0 * np.ones(n)
    js = jax_mma.mma_init(jnp.asarray(x0), jnp.asarray(lo), jnp.asarray(hi))
    ts = mma.mma_init(torch.tensor(x0), torch.tensor(lo), torch.tensor(hi))
    for _ in range(4):
        df0 = rng.standard_normal(n)
        fi = rng.standard_normal(m) if m else None
        dfi = rng.standard_normal((m, n)) if m else None
        js = jax_mma.mma_update(js, jnp.asarray(df0), None if fi is None else jnp.asarray(fi),
                                None if dfi is None else jnp.asarray(dfi), jnp.asarray(lo),
                                jnp.asarray(hi), move_limit=0.3)
        ts = mma.mma_update(ts, torch.tensor(df0), None if fi is None else torch.tensor(fi),
                            None if dfi is None else torch.tensor(dfi), torch.tensor(lo),
                            torch.tensor(hi), move_limit=0.3)
        for field in ("x", "x_prev1", "x_prev2", "low", "upp"):
            assert rel(getattr(ts, field), getattr(js, field)) <= ITERATE_TOL, field
        assert int(ts.iteration) == int(js.iteration)


def test_run_mma_fused_stops_within_one_iteration_of_deadline():
    # The JAX package checks the deadline between chunks only and can
    # overrun it by a whole chunk; the port checks before every iteration.
    pause = 0.05

    def slow(x):
        time.sleep(pause)
        return torch.sum(x**2), 2.0 * x

    budget = 0.3
    t0 = time.monotonic()
    _, history = mma.run_mma_fused(slow, torch.ones(2, dtype=torch.float64),
                                   -2.0 * torch.ones(2, dtype=torch.float64),
                                   2.0 * torch.ones(2, dtype=torch.float64),
                                   n_iterations=10_000, chunk=1_000, max_seconds=budget)
    elapsed = time.monotonic() - t0
    assert history["stopped_early"] == "max_seconds"
    n = len(history["objective_values"])
    assert 0 < n <= budget / pause + 1
    # Stopped at the first iteration that began after the deadline.
    assert elapsed <= budget + pause + 0.25


def test_run_mma_fused_raises_on_bad_initial_design():
    def nan(x):
        return torch.nan * torch.sum(x), torch.nan * x

    with pytest.raises(FloatingPointError, match="iteration 0"):
        mma.run_mma_fused(nan, torch.ones(2, dtype=torch.float64),
                          -2.0 * torch.ones(2, dtype=torch.float64),
                          2.0 * torch.ones(2, dtype=torch.float64), n_iterations=4)


# ---------------------------------------------------------------------------
# Fabrication constraints
# ---------------------------------------------------------------------------


FLAGSHIP_N1, FLAGSHIP_N2 = 24, 16


def _constraint_design():
    """The flagship's 25-degree rotated square plus noise of 0.3 (numpy,
    seed 0), the design both packages' constraints are taken at."""

    geometry = QuadGeometry(FLAGSHIP_N1, FLAGSHIP_N2, SPACING, 0.15 * SPACING)
    rng = np.random.default_rng(0)
    return [np.asarray(x) + 0.3 * rng.standard_normal(tuple(x.shape))
            for x in geometry.get_design_from_rotated_square(25 * math.pi / 180)]


def _constraint_fns(lib_base, geometry, boundary):
    bounds = lib_base.quad_boundary_node_ids(FLAGSHIP_N1, FLAGSHIP_N2) if boundary else None
    geometry.get_parametrization()
    return [lib_base.build_angle_constraints(geometry.centroid_node_vectors,
                                             geometry.bond_connectivity(), 0.1, 0.2, bounds),
            lib_base.build_edge_length_constraints(geometry.centroid_node_vectors, 0.75)]


def jax_constraint_references() -> dict:
    """The JAX package's fabrication constraints and their Jacobians at
    ``_constraint_design()``, with and without the boundary angles, that
    ``tests/data/flagship_constraints.npz`` records: values, and each
    Jacobian (mostly zeros) as its shape, the flat indices of its nonzero
    entries and their values."""

    jgeo = JaxQuadGeometry(FLAGSHIP_N1, FLAGSHIP_N2, SPACING, 0.15 * SPACING)
    design = _constraint_design()
    out = {"design0": design[0], "design1": design[1]}
    for boundary in (False, True):
        for k, jfn in enumerate(_constraint_fns(jax_base, jgeo, boundary)):
            jd = tuple(jnp.asarray(x) for x in design)
            key = f"{'boundary' if boundary else 'plain'}{k}"
            out[f"{key}_values"] = np.asarray(jfn(jd))
            jacobians = jax.jacobian(lambda *d: jfn(d), argnums=(0, 1))(*jd)
            for a, jac in enumerate(jacobians):
                jac = np.asarray(jac)
                nonzero = np.flatnonzero(jac)
                out[f"{key}_jac{a}_shape"] = np.asarray(jac.shape)
                out[f"{key}_jac{a}_index"] = nonzero
                out[f"{key}_jac{a}_value"] = jac.reshape(-1)[nonzero]
    return out


@pytest.mark.slow
def test_flagship_constraint_references_match_jax():
    """Make ``tests/data/flagship_constraints.npz`` again with the JAX package."""

    record_or_check("flagship_constraints", jax_constraint_references())


@pytest.mark.parametrize("boundary", [False, True])
def test_constraints_and_jacobians_match_jax_at_flagship_design(boundary):
    # JAX's values and Jacobians (tens of seconds of eager JAX) are recorded
    # (``jax_constraint_references``).
    ref = stored("flagship_constraints")
    np.testing.assert_array_equal(base.quad_boundary_node_ids(FLAGSHIP_N1, FLAGSHIP_N2),
                                  jax_base.quad_boundary_node_ids(FLAGSHIP_N1, FLAGSHIP_N2))
    design = _constraint_design()
    for x, r in zip(design, (ref["design0"], ref["design1"])):
        np.testing.assert_array_equal(x, r)
    tgeo = QuadGeometry(FLAGSHIP_N1, FLAGSHIP_N2, SPACING, 0.15 * SPACING)
    for k, tfn in enumerate(_constraint_fns(base, tgeo, boundary)):
        key = f"{'boundary' if boundary else 'plain'}{k}"
        jv = ref[f"{key}_values"]
        td = tuple(torch.tensor(x) for x in design)
        tv = tfn(td)
        tj = torch.func.jacrev(lambda *d: tfn(d), argnums=(0, 1))(*td)
        assert tv.shape == jv.shape
        assert rel(tv, jv) <= CONSTRAINT_TOL
        for a, got in enumerate(tj):
            jac = np.zeros(tuple(ref[f"{key}_jac{a}_shape"]))
            jac.reshape(-1)[ref[f"{key}_jac{a}_index"]] = ref[f"{key}_jac{a}_value"]
            assert rel(got, jac) <= CONSTRAINT_TOL


# ---------------------------------------------------------------------------
# Models: guard resolution, runner helpers, guarded MMA
# ---------------------------------------------------------------------------


def test_flagship_guard_resolves_like_jax():
    cfg = paper_config(device="cpu")
    spec = base.resolve_model_guard("auto", cfg["min_angle"], cfg["cutoff_angle"], cfg["spacing"])
    assert spec == jax_base.resolve_model_guard("auto", cfg["min_angle"], cfg["cutoff_angle"],
                                                cfg["spacing"])
    guard = core.resolve_guard(spec, (2,))
    window = math.radians(5.0)
    assert guard["threshold"] == pytest.approx(0.02 * window, rel=1e-12)
    assert guard["proximity"] == pytest.approx(2 * window, rel=1e-12)
    assert guard["hard"] == pytest.approx(0.1 * window, rel=1e-12)
    assert guard["length_scale"] == SPACING and guard["translation"] == "relative"
    assert guard["refine"] == 16 and guard["levels"] == 1


def test_runner_rearms_the_guard_only_where_asked():
    problem = ForwardProblem(**paper_config(method="verlet_ckpt", device="cpu"))
    opt = OptimizationProblem(problem, target_size=(2, 2), target_shift=(4, 5))
    assert opt._guarded_objective_fn("auto") is not None  # a guarded sibling...
    assert opt.forward_problem.guard is None  # ...leaves self as it was
    opt._ensure_guarded(None)
    assert opt.forward_problem.guard is None
    opt._ensure_guarded("auto")
    assert opt.forward_problem.guard == "auto" and not opt.is_setup
    opt.setup_objective()
    assert opt._guarded_objective_fn("auto") is opt.objective_fn
    # The runner takes JAX's metrics, checkpoint and resume keywords
    # (tests/test_torch_observability.py runs them).
    params = inspect.signature(opt.run_optimization_mma).parameters
    assert {"metrics_logger", "checkpoint", "resume"} <= set(params)
    assert params["resume"].default is False


def _small_jax_problem():
    cfg = bench.paper_config("verlet_ckpt", 4)
    cfg.update(n1_blocks=8, n2_blocks=6, n_timepoints=12, damping=cfg["damping"][:48],
               loading_rate=600.0, input_delay=0.0, simulation_time=1.5e-3,
               amplitude=0.1 * cfg["amplitude"])
    return JaxForwardProblem(**cfg)


GUARDED_8X6_ITERATIONS = 3


def _jax_guarded_mma_8x6():
    """The JAX package's guarded MMA at 8 x 6 (see the test below): the
    histories that ``tests/data/guarded_mma_8x6.npz`` records."""

    jp = _small_jax_problem()
    jo = JaxOptimizationProblem(jp, target_size=(2, 2), target_shift=(1, 1))
    jo.setup_objective()
    design = jp.geometry.get_design_from_rotated_square(25 * math.pi / 180)
    jo.run_optimization_mma(design, n_iterations=GUARDED_8X6_ITERATIONS, verbose=False,
                            **MMA_SETTINGS)
    out = {"objective_values": np.asarray(jo.objective_values, dtype=np.float64)}
    out.update({f"design{k}_{i}": np.asarray(x)
                for k, d in enumerate(jo.design_values) for i, x in enumerate(d)})
    out.update({f"violation_{name}": np.asarray(v, dtype=np.float64)
                for name, v in jo.constraints_violation.items()})
    return out


@pytest.mark.slow
def test_guarded_mma_8x6_references_match_jax():
    """Make ``tests/data/guarded_mma_8x6.npz`` again with the JAX package."""

    record_or_check("guarded_mma_8x6", _jax_guarded_mma_8x6())


def test_guarded_mma_matches_jax_at_8x6():
    # The 8 x 6 flagship physics with a tenth of the pulse amplitude: the
    # guard fires on a share of the substeps of each iteration. JAX's run
    # (about a minute of tracing and compiling) is recorded.
    jp = _small_jax_problem()
    jp.setup()
    ref = stored("guarded_mma_8x6")
    design = jp.geometry.get_design_from_rotated_square(25 * math.pi / 180)
    jo = JaxOptimizationProblem(
        jp, target_size=(2, 2), target_shift=(1, 1),
        objective_values=[float(v) for v in ref["objective_values"]],
        design_values=[(ref[f"design{k}_0"], ref[f"design{k}_1"])
                       for k in range(GUARDED_8X6_ITERATIONS)],
        constraints_violation={name: ref[f"violation_{name}"].tolist()
                               for name in ("angles", "edge_lengths")})

    jax_dict = {k: (np.asarray(v) if hasattr(v, "shape") else v)
                for k, v in jp.to_dict().items()}
    to = OptimizationProblem(forward_problem_from_jax_dict(jax_dict, device="cpu"),
                             target_size=(2, 2), target_shift=(1, 1))
    calls = core.plain_trajectory.calls
    final = to.run_optimization_mma(
        design_from_numpy([np.asarray(x) for x in design], device="cpu"),
        n_iterations=GUARDED_8X6_ITERATIONS, verbose=False, **MMA_SETTINGS)
    assert core.plain_trajectory.calls > calls  # CPU tensors: the plain body
    spec = to.forward_problem.solve_dynamics.trajectory_args(
        to.forward_problem.state0, to.forward_problem.timepoints,
        to.forward_problem.control_params(final)).spec
    assert spec.guard is not None and spec.guard["proximity"] is not None
    assert len(to.objective_values) == len(jo.objective_values) == GUARDED_8X6_ITERATIONS
    assert rel(to.objective_values, jo.objective_values) <= HISTORY_TOL
    for a, b in zip(to.design_values, jo.design_values):
        assert rel(flat(a), flat(b)) <= HISTORY_TOL
    for name in ("angles", "edge_lengths"):
        assert rel(to.constraints_violation[name], jo.constraints_violation[name]) <= HISTORY_TOL
    assert rel(flat(final), flat(jo.design_values[-1])) <= HISTORY_TOL
    # The optimization problem itself crosses over from the JAX dict.
    again = optimization_problem_from_jax_dict(
        {**dataclasses.asdict(jo), "forward_problem": jax_dict}, device="cpu")
    assert again.objective_values == [float(v) for v in jo.objective_values]
    assert rel(flat(again.design_values[-1]), flat(jo.design_values[-1])) == 0.0


@pytest.mark.slow
def test_flagship_references_match_jax():
    """Make the recorded JAX references of ``models/flagship.py`` again."""

    def objective(guard):
        problem = JaxForwardProblem(guard=guard, **bench.paper_config("verlet_ckpt", 10))
        opt = JaxOptimizationProblem(problem, target_size=(2, 2), target_shift=(4, 5))
        opt.setup_objective()
        return problem, opt, jax.jit(jax.value_and_grad(opt.objective_fn))

    def grad_close(grad, stats):
        # Summaries relative to |g|: the sum is zero to rounding.
        got = vector_stats(flat_numpy(grad))
        assert max(abs(a - b) for a, b in zip(got, stats)) <= 1e-10 * stats[0]

    problem, _, value_and_grad = objective(None)
    design = problem.geometry.get_design_from_rotated_square(25 * jnp.pi / 180)
    grad_close(value_and_grad(design)[1], JAX_F64_GRAD_STATS)

    _, opt, value_and_grad = objective("auto")
    value = float(value_and_grad(design)[0])
    assert abs(value - JAX_F64_GUARDED_OBJECTIVE) <= 1e-12 * value
    opt.run_optimization_mma(design, n_iterations=2, verbose=False, **MMA_SETTINGS)
    assert rel(opt.objective_values, JAX_F64_MMA_VALUES) <= 1e-12
    for d, stats, grad_stats in zip(opt.design_values, JAX_F64_MMA_DESIGN_STATS,
                                    JAX_F64_MMA_GRAD_STATS):
        got = design_stats([np.asarray(x) for x in d], [np.asarray(x) for x in design])
        assert np.allclose(got, stats, rtol=1e-12, atol=1e-12)
        grad_close(value_and_grad(d)[1], grad_stats)


@pytest.mark.slow
def test_flagship_guarded_objective_matches_jax_reference():
    optimization, design = build_flagship(device="cpu", guard="auto")
    with torch.no_grad():
        value = float(optimization.objective_fn(design))
    assert abs(value - JAX_F64_GUARDED_OBJECTIVE) <= 1e-8 * JAX_F64_GUARDED_OBJECTIVE
