"""The port's gradient loops (``optim/loops.py``), the population loop
``run_multistart_optax`` and the runner's optax path against the JAX
package, on the CPU at float64.

The analytic problems run in both packages as the test goes; the runner's
optax path on the 6 x 6 problem of ``models/small_configs.py`` is held
against JAX's history recorded in ``tests/data/optimizer_small.npz``
(``tests/jax_optimizer_references.py``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from difflexmm_tpu.optim import loops as jax_loops
from difflexmm_tpu.parallel import multistart as jax_multistart
from jax_references import stored

from difflexmm_tpu_torch.models import flagship as fl
from difflexmm_tpu_torch.models import small_configs as sc
from difflexmm_tpu_torch.optim import loops
from difflexmm_tpu_torch.parallel import multistart

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

# The same elementwise updates in the same order at float64: Adam's moments
# are formed with lerp/addcmul in torch and with products and sums in
# optax, so the two differ in the last bits, which five steps keep there.
LOOP_TOL = 1e-12
# The runner's optax path: each iteration a guarded trajectory and its
# adjoint (1e-10 and 1e-9 of their scales against JAX), then an Adam step,
# whose first moves are lr * sign(g) and so take no rounding from g.
HISTORY_TOL = 1e-10
# The returned design, after a second step: Adam divides gradient entries
# that are zero by symmetry (rounding noise, about 1e-17) by its eps of
# 1e-8, so each package's noise moves such an entry by lr * 1e-17 / 1e-8
# = 1e-11, about 1e-10 of the design's scale (0.1).
FINAL_TOL = 1e-9


def rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _numpy(design):
    return [np.asarray(x.detach() if torch.is_tensor(x) else x) for x in design]


def _start(seed=0):
    """A two-tensor design (numpy): shapes (3,) and (2, 2)."""

    rng = np.random.default_rng(seed)
    return [rng.uniform(-0.5, 0.5, 3), rng.uniform(-0.5, 0.5, (2, 2))]


def _objective(lib):
    """A smooth, non-quadratic objective of the two-tensor design."""

    def f(design):
        a, b = design
        return lib.sum(lib.sin(3 * a) * a) - lib.sum((b - 0.2) ** 2) + lib.sum(a[:2] * b[0])

    return f


@pytest.mark.parametrize("bounds", ["scalar", "per_leaf"])
def test_project_box_matches_jax(bounds):
    # Entries exactly at a bound: jnp.maximum and torch.maximum split the
    # gradient there; clamp would not.
    design = [np.array([-0.7, 0.1, 0.4, 0.3]), np.array([[0.6, -0.2], [0.35, -0.3]])]
    if bounds == "scalar":
        lo, hi = -0.3, 0.3
    else:
        lo = (np.full(4, -0.2), np.array([[-0.5, -0.2], [0.0, -0.1]]))
        hi = (np.array([0.1, 0.2, 0.3, 0.4]), np.full((2, 2), 0.35))
    weights = [np.arange(1.0, 5.0), np.array([[2.0, -1.0], [0.5, 3.0]])]

    def jax_scalar(*d):
        jlo = lo if bounds == "scalar" else tuple(jnp.asarray(x) for x in lo)
        jhi = hi if bounds == "scalar" else tuple(jnp.asarray(x) for x in hi)
        out = jax_loops.project_box(tuple(d), jlo, jhi)
        return sum(jnp.sum(w * x) for w, x in zip(weights, out)), out

    (jv, jout), jg = jax.value_and_grad(jax_scalar, argnums=(0, 1), has_aux=True)(
        *(jnp.asarray(x) for x in design))
    td = tuple(torch.tensor(x, requires_grad=True) for x in design)
    tlo = lo if bounds == "scalar" else tuple(torch.tensor(x) for x in lo)
    thi = hi if bounds == "scalar" else tuple(torch.tensor(x) for x in hi)
    tout = loops.project_box(td, tlo, thi)
    tv = sum(torch.sum(torch.tensor(w) * x) for w, x in zip(weights, tout))
    tg = torch.autograd.grad(tv, td)
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    for a, b in zip(tg, jg):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert float(tv.detach()) == float(jv)


def test_naive_gd_matches_jax():
    start = _start(1)
    jf, tf = _objective(jnp), _objective(torch)
    jd, jvals, jdesigns = jax_loops.naive_gd(
        jax.value_and_grad(jf), tuple(jnp.asarray(x) for x in start), 6, 0.05,
        lower_bound=-0.45, upper_bound=0.45, maximize=True)

    def t_value_and_grad(design):
        design = tuple(x.detach().requires_grad_() for x in design)
        value = tf(design)
        return value, torch.autograd.grad(value, design)

    seen = []
    td, tvals, tdesigns = loops.naive_gd(
        t_value_and_grad, tuple(torch.tensor(x) for x in start), 6, 0.05, lower_bound=-0.45,
        upper_bound=0.45, maximize=True, callback=lambda it, d, v: seen.append((it, v)))
    assert rel(tvals, jvals) <= LOOP_TOL
    for a, b in zip(tdesigns, jdesigns):
        assert rel(np.concatenate([x.ravel() for x in _numpy(a)]),
                   np.concatenate([np.asarray(x).ravel() for x in b])) <= LOOP_TOL
    # As in JAX, the recorded design is the one after each step.
    assert all(np.array_equal(a, b) for a, b in zip(_numpy(td), _numpy(tdesigns[-1])))
    assert seen == list(enumerate(tvals))


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_run_optimization_optax_matches_optax(name):
    start = _start(2)
    jopt = optax.adam(1e-2) if name == "adam" else optax.sgd(0.05)
    topt = None if name == "adam" else (lambda params: torch.optim.SGD(params, lr=0.05))
    jres = jax_loops.run_optimization_optax(_objective(jnp), tuple(jnp.asarray(x) for x in start),
                                            5, optimizer=jopt, lower_bound=-0.45,
                                            upper_bound=0.45)
    seen = []
    initial = tuple(torch.tensor(x) for x in start)
    tres = loops.run_optimization_optax(_objective(torch), initial, 5, optimizer=topt,
                                        lower_bound=-0.45, upper_bound=0.45,
                                        callback=lambda it, d, v: seen.append((it, d, v)))
    assert len(tres.objective_values) == 5
    assert rel(tres.objective_values, jres.objective_values) <= LOOP_TOL
    for a, b in zip(tres.design_values, jres.design_values):
        for x, y in zip(_numpy(a), b):
            assert rel(x, y) <= LOOP_TOL
    for x, y in zip(_numpy(tres.design), jres.design):
        assert rel(x, y) <= LOOP_TOL
    # The value and design of iteration k are those before step k; the
    # returned design is the one after the last step, never evaluated.
    for x, y in zip(_numpy(tres.design_values[0]), start):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(_numpy(tres.design)[0], _numpy(tres.design_values[-1])[0])
    assert [(it, v) for it, _, v in seen] == list(enumerate(tres.objective_values))
    # History entries are copies: the in-place steps leave them as they were.
    assert seen[0][1][0] is tres.design_values[0][0]
    for x, y in zip(initial, start):
        np.testing.assert_array_equal(x.numpy(), y)
        assert not x.requires_grad


def test_run_multistart_optax_matches_jax_with_a_nan_candidate():
    # Candidate 2 starts where sqrt(a0) is NaN: its value, gradient and
    # designs stay NaN, and it never ranks best.
    B = 4
    rng = np.random.default_rng(3)
    a = rng.uniform(0.1, 0.6, (B, 3))
    a[2, 0] = -0.5
    b = rng.uniform(-0.5, 0.5, (B, 2, 2))

    def jax_one(design):
        x, y = design
        return jnp.sqrt(x[0]) - jnp.sum((x - 0.3) ** 2) - jnp.sum(y**2) + x[1] * y[0, 0]

    def torch_population(designs):
        x, y = designs
        return (torch.sqrt(x[:, 0]) - torch.sum((x - 0.3) ** 2, dim=1)
                - torch.sum(y**2, dim=(1, 2)) + x[:, 1] * y[:, 0, 0])

    jres = jax_multistart.run_multistart_optax(jax_one, (jnp.asarray(a), jnp.asarray(b)), 4,
                                               lower_bound=-0.8, upper_bound=0.8)
    tres = multistart.run_multistart_optax(torch_population, (torch.tensor(a), torch.tensor(b)),
                                           4, lower_bound=-0.8, upper_bound=0.8)
    jvals, tvals = np.asarray(jres.objective_values), tres.objective_values.numpy()
    assert tvals.shape == jvals.shape == (4, B)
    assert np.array_equal(np.isnan(tvals), np.isnan(jvals)) and np.isnan(tvals[:, 2]).all()
    finite = ~np.isnan(jvals)
    assert rel(tvals[finite], jvals[finite]) <= LOOP_TOL
    for x, y in zip(tres.designs, jres.designs):
        x, y = x.numpy(), np.asarray(y)
        assert np.array_equal(np.isnan(x), np.isnan(y))
        assert rel(x[~np.isnan(y)], y[~np.isnan(y)]) <= LOOP_TOL
    assert tres.best_index == int(jres.best_index) != 2
    for x, y in zip(tres.best_design, jres.best_design):
        assert rel(x, y) <= LOOP_TOL
    # The designs returned are the evaluated iterates: the last values are
    # the objective at them.
    with torch.no_grad():
        again = torch_population(tres.designs)
    assert rel(again.numpy()[finite[-1]], tvals[-1][finite[-1]]) <= LOOP_TOL
    with pytest.raises(NotImplementedError, match="A11"):
        multistart.run_multistart_optax(torch_population, (torch.tensor(a), torch.tensor(b)), 1,
                                        mesh=object())


def test_ravel_pytree_round_trips():
    design = (torch.arange(6.0).reshape(2, 3), torch.tensor([7.0, 8.0]))
    flat, unflatten = loops.ravel_pytree(design)
    assert flat.tolist() == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 7.0, 8.0]
    back = unflatten(flat)
    assert isinstance(back, tuple) and all(torch.equal(x, y) for x, y in zip(back, design))
    population = loops.population_unflatten(design)(torch.stack([flat, 2 * flat]))
    assert population[0].shape == (2, 2, 3) and torch.equal(population[1][1], 2 * design[1])


def test_runner_optax_matches_jax_at_6x6():
    # The runner re-arms guard="auto" on the problem and records each
    # iteration's value and evaluated design (JAX's history, recorded).
    ref = stored("optimizer_small")
    optimization, design = sc.checkpoint_problem(device="cpu")
    assert optimization.forward_problem.guard is None
    final = optimization.run_optimization_optax(design, n_iterations=len(ref["optax_values"]),
                                                verbose=False)
    assert optimization.forward_problem.guard == "auto"
    assert rel(optimization.objective_values, ref["optax_values"]) <= HISTORY_TOL
    for k, d in enumerate(optimization.design_values):
        for i, x in enumerate(d):
            assert rel(x.numpy(), ref[f"optax_design{k}_{i}"]) <= HISTORY_TOL
    for i, x in enumerate(final):
        assert rel(x.numpy(), ref[f"optax_final_{i}"]) <= FINAL_TOL
    assert optimization.forward_problem.solution_data is not None


@pytest.mark.slow
def test_flagship_optax_references_match_jax():
    """The flagship's optax history of ``models/flagship.py`` (about 10
    minutes of JAX on the CPU)."""

    import jax_optimizer_references as refs

    got = refs.flagship_optax()
    assert rel(got["JAX_F64_OPTAX_VALUES"], fl.JAX_F64_OPTAX_VALUES) <= 1e-12
    assert np.allclose(got["JAX_F64_OPTAX_DESIGN_STATS"], fl.JAX_F64_OPTAX_DESIGN_STATS,
                       rtol=1e-12, atol=1e-12)
    assert np.allclose(got["JAX_F64_OPTAX_FINAL_STATS"], fl.JAX_F64_OPTAX_FINAL_STATS,
                       rtol=1e-12, atol=1e-12)


@pytest.mark.slow
def test_flagship_optax_matches_jax_reference():
    optimization, design = fl.build_flagship(device="cpu")
    final = optimization.run_optimization_optax(design, n_iterations=2, verbose=False)
    assert rel(optimization.objective_values, fl.JAX_F64_OPTAX_VALUES) <= 1e-8
    for d, stats in zip(optimization.design_values, fl.JAX_F64_OPTAX_DESIGN_STATS):
        assert max(abs(a - b) for a, b in zip(fl.design_stats(d, design), stats)) <= \
            1e-8 * max(abs(x) for x in stats) + 1e-12
    assert math.isfinite(fl.design_stats(final, design)[0])
