"""The port's hinge characterization (``models/hinge_characterization.py``)
against the JAX package's on the CPU at float64: ``resample`` against
``jnp.interp``; the fit of ``examples/hinge_characterization_fit.py`` on
samples of 1 x 2 cells, tension and shear, through the grid fast path
(``method="verlet_pallas"``: the plain body on CPU tensors, kernel 1 on
CUDA ones) against JAX's ``"verlet_ckpt"`` and through ``method="static"``
against JAX's static run: the squared error, its stiffness gradient and
the Newton iterations of every load step. (Two ``run_optimization_GD``
iterations are recorded too; ``chip_smoke.py`` main path 14 holds them at
the example's size, and the slow ``test_hinge_gd_matches_jax`` here.)

The JAX results are recorded in ``tests/data/analysis_small.npz``; the
constants of ``models/analysis_configs.py`` (the example's and the
flagship's sizes, ``chip_smoke.py`` main path 14) are checked by the slow
``test_analysis_constants_match_jax``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_analysis_references import HINGE_SMALL
from jax_references import stored

from difflexmm_tpu_torch.models import analysis_configs as ac
from difflexmm_tpu_torch.models.hinge_characterization import resample

torch.set_num_threads(1)

# Through the fast path: the plain body's steps in JAX's order, as the
# flagship's value (1e-10) and design gradient (1e-9).
VALUE_TOL, GRAD_TOL = 1e-10, 1e-9
# Through Newton: equilibria a few ulps apart (LU), gradients through the
# implicit adjoint.
EQ_TOL, IFT_TOL = 1e-9, 1e-7


def rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.fixture(scope="module")
def ref():
    return stored("analysis_small")


def targets(ref):
    return {lt: ref[f"hinge_targets_{lt}"] for lt in ac.HINGE_LOADINGS}


def test_resample_matches_jnp_interp():
    rng = np.random.default_rng(4)
    x = np.sort(rng.uniform(0.0, 1.0, 17))
    x[5] = x[4]  # a repeated abscissa
    y = rng.standard_normal(17)
    got = resample(torch.tensor(x), torch.tensor(y), 23)
    want = jnp.interp(jnp.linspace(jnp.min(x), jnp.max(x), 23), jnp.asarray(x), jnp.asarray(y))
    assert rel(got, want) < 1e-12


METHODS = [("verlet_pallas", "verlet_ckpt"), ("static", "static")]


@pytest.mark.parametrize("method, jax_method", METHODS)
def test_hinge_fit_matches_jax(ref, method, jax_method):
    out = ac.run_hinge(method, device="cpu", gd=False, targets=targets(ref), **HINGE_SMALL)
    value_tol, grad_tol = (VALUE_TOL, GRAD_TOL) if method != "static" else (EQ_TOL, IFT_TOL)
    key = f"hinge_{jax_method}"
    assert rel(out["value"], ref[f"{key}_value"]) < value_tol
    assert rel(out["grad"], ref[f"{key}_grad"]) < grad_tol
    if method == "static":
        for lt in ac.HINGE_LOADINGS:
            assert out["iterations"][lt] == list(ref[f"hinge_static_iterations_{lt}"])


@pytest.mark.slow
@pytest.mark.parametrize("method, jax_method", METHODS)
def test_hinge_gd_matches_jax(ref, method, jax_method):
    out = ac.run_hinge(method, device="cpu", targets=targets(ref), **HINGE_SMALL)
    grad_tol = GRAD_TOL if method != "static" else IFT_TOL
    key = f"hinge_{jax_method}"
    for name in ("gd_values", "gd_designs", "gd_final"):
        assert rel(out[name], ref[f"{key}_{name}"]) < grad_tol


def test_hinge_curve_is_the_drive_and_the_reaction():
    problem = ac.hinge_problem("tension", "static", device="cpu", **HINGE_SMALL)
    problem.setup()
    solution, cp = problem.solve(ac.HINGE_TRUE_K)
    u, f = problem.force_displacement(solution, cp)
    assert torch.equal(u, problem.applied_displacement(problem.timepoints, 0.05, 0.01))
    assert float(f[0]) == 0.0 and bool((f[1:] > 0).all())
    round_trip = type(problem).from_dict(problem.to_dict())
    assert round_trip.n2_cells == problem.n2_cells and not round_trip.is_setup


def same(got, recorded, name):
    """A recomputed constant against the recorded one: dicts key by key,
    integers and flags exactly, floats within 1e-12 of their scale."""

    if isinstance(got, dict):
        assert sorted(got) == sorted(recorded), name
        for key, value in got.items():
            same(value, recorded[key], f"{name}[{key!r}]")
    elif got is None:
        assert recorded is None, name
    else:
        got, recorded = np.asarray(got), np.asarray(recorded)
        assert got.shape == recorded.shape, name
        if got.dtype.kind in "biu" or got.size == 0:
            assert np.array_equal(got, recorded), name
        else:
            assert rel(got, recorded) <= 1e-12, name


@pytest.mark.slow
def test_analysis_constants_match_jax():
    import jax_analysis_references

    for name, value in jax_analysis_references.constants().items():
        same(value, getattr(ac, f"JAX_F64_{name}"), name)
