"""The five other quad families of the port against the JAX package, on the
CPU at float64: multi-input focusing, energy splitting, the restricted
design space, spin and static tuning. Each is built from its JAX
``OptimizationProblem.to_dict()`` through ``utils.convert``; its objective
is held within 1e-10 relative of JAX's, its individual values likewise,
and its design gradient within 1e-8 (each to the largest magnitude of its
reference).

The JAX results are recorded in ``tests/data/families_small.npz`` by
``tests/jax_family_references.py`` (run it, or the slow
``test_family_references_match_jax``, to make the file again).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax_family_references as refs
from jax_references import record_or_check, stored

from difflexmm_tpu_torch.models import (
    quads_energy_splitting,
    quads_focusing_multi_input,
    quads_focusing_restricted_space,
    quads_spin,
    quads_static_tuning,
)
from difflexmm_tpu_torch.utils.convert import (
    design_from_numpy,
    optimization_problem_from_jax_dict,
)

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

VALUE_TOL = 1e-10
GRAD_TOL = 1e-8

MODULES = {
    "multi_input": quads_focusing_multi_input,
    "energy_splitting": quads_energy_splitting,
    "restricted_space": quads_focusing_restricted_space,
    "spin": quads_spin,
    "static_tuning": quads_static_tuning,
}


def rel(a, b) -> float:
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.fixture(scope="module")
def ref():
    return stored("families_small")


@pytest.fixture(scope="module")
def jax_problems():
    return refs.family_problems()


def _port(jax_problems, name):
    """The port's problem of family ``name`` from the JAX problem's dict,
    set up, and its design as tensors."""

    problem, design = jax_problems[name]
    port = optimization_problem_from_jax_dict(refs.numpy_dict(problem), device="cpu")
    port.setup_objective()
    return port, design_from_numpy(design, device="cpu")


@pytest.mark.parametrize("name", sorted(MODULES))
def test_family_objective_and_gradient_match_jax(jax_problems, ref, name):
    port, design = _port(jax_problems, name)
    assert isinstance(port, MODULES[name].OptimizationProblem)
    design = tuple(x.requires_grad_() for x in design)
    value = port.objective_fn(design)
    grads = torch.autograd.grad(value, design)
    want = ref[f"{name}_value"]
    assert abs(float(value.detach()) - want) <= VALUE_TOL * abs(want)
    for i, g in enumerate(grads):
        assert rel(g, ref[f"{name}_grad{i}"]) <= GRAD_TOL
    if f"{name}_individual" in ref:
        with torch.no_grad():
            assert rel(port.objective_fn_individual(design), ref[f"{name}_individual"]) \
                <= VALUE_TOL


@pytest.mark.parametrize("name", ["energy_splitting", "multi_input", "restricted_space", "spin"])
def test_family_population_objective_is_its_designs_objectives(jax_problems, ref, name):
    """``population_objective_fn`` of two designs (one solve of the pair):
    the first against JAX's value, the second against its own solve."""

    port, design = _port(jax_problems, name)
    second = tuple(x * 0.9 for x in design)
    with torch.no_grad():
        pair = port.population_objective_fn(tuple(torch.stack([a, b])
                                                  for a, b in zip(design, second)))
        alone = float(port.objective_fn(second))
    assert pair.shape == (2,)
    want = ref[f"{name}_value"]
    assert abs(float(pair[0]) - want) <= VALUE_TOL * abs(want)
    assert abs(float(pair[1]) - alone) <= VALUE_TOL * abs(alone)


def test_restricted_space_maps_round_trip(jax_problems):
    problem, reduced = jax_problems["restricted_space"]
    port, reduced_t = _port(jax_problems, "restricted_space")
    full = port.reduced_to_all_shifts(reduced_t)
    want = problem.reduced_to_all_shifts(tuple(np.asarray(x) for x in reduced))
    for f, w in zip(full, want):
        assert rel(f, w) == 0.0
    for r, again in zip(reduced_t, port.all_to_reduced_shifts(full)):
        assert torch.equal(r, again)


def test_families_round_trip_their_dicts(jax_problems):
    for name, module in MODULES.items():
        port, _ = _port(jax_problems, name)
        again = module.OptimizationProblem.from_dict(port.to_dict())
        assert again.name == port.name and not again.is_setup
        record = module.OptimizationProblem.from_data(port.to_data())
        assert dataclasses.asdict(record).keys() == dataclasses.asdict(port).keys()


def test_static_tuning_full_solution_chains_the_phases(jax_problems):
    port, design = _port(jax_problems, "static_tuning")
    fp = port.forward_problem
    with torch.no_grad():
        full = fp.solve_full(design, 0.15, 0.5, 0.02, 0.05)
        dynamic = fp.solve_dynamic(design, 0.15, 0.5, 0.02, 0.05)
    n_static = fp.n_timepoints_static
    assert full.fields.shape[0] == n_static + fp.n_timepoints - 1
    assert torch.equal(full.fields[n_static:], dynamic.fields[1:])
    t_start = 0.02 / 0.05 + 0.1 / 0.5
    assert rel(full.timepoints[n_static - 1:] - t_start, dynamic.timepoints) <= 1e-15
    with pytest.raises(NotImplementedError, match="A11"):
        port.setup_objective(mesh=object())


@pytest.mark.slow
def test_family_references_match_jax():
    """Make ``tests/data/families_small.npz`` again with the JAX package."""

    record_or_check("families_small", refs.family_references())
