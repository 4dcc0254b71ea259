"""The port's pickle IO (``utils.types.save_data`` / ``load_data``) and the
carrying of ``solution_data`` across from the JAX package
(``utils.convert``), on the CPU. A pickle that the JAX package's
``save_data`` wrote with numpy arrays loads without JAX in
``tests/test_torch_import_hygiene.py``."""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_family_references as refs
from difflexmm_tpu.utils import types as jax_types

from difflexmm_tpu_torch.models import quads_focusing, quads_static_tuning
from difflexmm_tpu_torch.utils.convert import (
    forward_problem_from_jax_dict,
    optimization_problem_from_jax_dict,
    solution_data_from_numpy,
)
from difflexmm_tpu_torch.utils.types import EigenmodeData, SolutionData, load_data, save_data

torch.set_num_threads(1)


def _solution(seed=0, n_blocks=refs.N1 * refs.N2):
    rng = np.random.default_rng(seed)
    return dict(block_centroids=rng.standard_normal((n_blocks, 2)),
                centroid_node_vectors=rng.standard_normal((n_blocks, 4, 2)),
                bond_connectivity=rng.integers(0, 4 * n_blocks, (38, 2)),
                timepoints=np.linspace(0.0, 1.0, 5),
                fields=rng.standard_normal((5, 2, n_blocks, 3)))


def test_save_and_load_round_trip(tmp_path):
    arrays = _solution()
    solution = SolutionData(**{k: torch.as_tensor(v) for k, v in arrays.items()})
    modes = EigenmodeData(*(torch.as_tensor(arrays[k]) for k in
                            ("block_centroids", "centroid_node_vectors", "timepoints",
                             "block_centroids")))
    save_data(tmp_path / "nested" / "data.pkl",
              dict(solution=solution, modes=[modes], note="x", value=1.5))
    # The file holds numpy arrays only.
    with open(tmp_path / "nested" / "data.pkl", "rb") as f:
        raw = pickle.load(f)
    assert isinstance(raw["solution"].fields, np.ndarray)
    data = load_data(tmp_path / "nested" / "data.pkl", device="cpu")
    assert isinstance(data["solution"], SolutionData) and isinstance(data["modes"][0],
                                                                     EigenmodeData)
    assert data["note"] == "x" and data["value"] == 1.5
    for key, value in arrays.items():
        got = getattr(data["solution"], key)
        assert isinstance(got, torch.Tensor) and np.array_equal(got.numpy(), value), key
    assert data["solution"].bond_connectivity.dtype == torch.int64


def test_problem_records_round_trip(tmp_path):
    """A model's ``to_data()`` (with its solution) pickles and loads back as
    the same family, ready for ``setup``."""

    fp = forward_problem_from_jax_dict(refs.numpy_dict(refs.unit_small()), device="cpu")
    fp.solution_data = SolutionData(**{k: torch.as_tensor(v) for k, v in _solution().items()})
    save_data(tmp_path / "fp.pkl", fp.to_data())
    back = quads_focusing.ForwardProblem.from_data(load_data(tmp_path / "fp.pkl", device="cpu"))
    assert isinstance(back, quads_focusing.ForwardProblem) and not back.is_setup
    assert torch.equal(back.solution_data.fields, fp.solution_data.fields)
    problem, _ = refs.family_problems()["static_tuning"]
    port = optimization_problem_from_jax_dict(refs.numpy_dict(problem), device="cpu")
    save_data(tmp_path / "static.pkl", port.to_data())
    back = quads_static_tuning.OptimizationProblem.from_data(
        load_data(tmp_path / "static.pkl", device="cpu"))
    assert isinstance(back.forward_input, quads_static_tuning.ForwardInput)
    assert torch.equal(back.forward_input.horizontal_shifts,
                       port.forward_input.horizontal_shifts)
    assert back.weights == (1.0, -1.0) and not back.forward_problem.is_setup


def test_jax_array_pickle_is_refused(tmp_path):
    jax_types.save_data(tmp_path / "jax.pkl", jax_types.SolutionData(
        *(jnp.asarray(v) for v in _solution().values())))
    with pytest.raises(pickle.UnpicklingError, match="numpy arrays"):
        load_data(tmp_path / "jax.pkl", device="cpu")


def test_solution_data_crosses_over(tmp_path):
    """``solution_data`` of a JAX dict, as numpy arrays or as the path of
    a pickle the JAX package wrote with numpy arrays."""

    arrays = _solution(seed=1)
    jax_types.save_data(tmp_path / "solution.pkl", jax_types.SolutionData(**arrays))
    base = refs.numpy_dict(refs.unit_small())
    for given in (arrays, [arrays, arrays], str(tmp_path / "solution.pkl")):
        problem = forward_problem_from_jax_dict({**base, "solution_data": given}, device="cpu")
        solutions = problem.solution_data if isinstance(given, list) else [problem.solution_data]
        for solution in solutions:
            assert isinstance(solution, SolutionData)
            assert solution.fields.dtype == torch.float64
            assert np.array_equal(solution.fields.numpy(), arrays["fields"])
            assert np.array_equal(solution.bond_connectivity.numpy(),
                                  arrays["bond_connectivity"])
    assert solution_data_from_numpy(None) is None
