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


def test_hinge_pickle_crosses_over(tmp_path):
    """A hinge fit the JAX package pickled (its ``to_dict()`` with numpy
    arrays, both samples' dicts inside) loads without JAX, converts, and
    reproduces the JAX force-displacement curve (1e-9) and squared error
    (1e-10) of ``tests/data/analysis_small.npz``."""

    from jax_analysis_references import HINGE_SMALL, hinge_jax
    from jax_references import stored

    from difflexmm_tpu.models import hinge_characterization as jax_hinge
    from difflexmm_tpu_torch.models import analysis_configs as ac
    from difflexmm_tpu_torch.models import hinge_characterization

    ref = stored("analysis_small")
    targets = {lt: ref[f"hinge_targets_{lt}"] for lt in ac.HINGE_LOADINGS}
    fit = jax_hinge.OptimizationProblem(
        [hinge_jax(lt, "verlet_ckpt") for lt in ac.HINGE_LOADINGS], targets,
        objective_values=[1.0], design_values=[tuple(np.asarray(ac.HINGE_GUESS))])
    jax_types.save_data(tmp_path / "fit.pkl", fit.to_dict())
    loaded = load_data(tmp_path / "fit.pkl", device="cpu")
    port = optimization_problem_from_jax_dict(loaded, device="cpu")
    assert isinstance(port, hinge_characterization.OptimizationProblem)
    assert [type(p).__name__ for p in port.forward_problems] == ["ForwardProblem"] * 2
    assert port.forward_problems[0].n2_cells == HINGE_SMALL["n2_cells"]
    # The noise-free curve at the true stiffnesses: the targets' noise undone.
    rng = np.random.default_rng(ac.HINGE_SEED)
    for problem in port.forward_problems:
        u, f_noisy, _ = targets[problem.loading_type]
        noise = 1 + ac.HINGE_NOISE * rng.standard_normal(f_noisy.shape)
        problem.setup()
        curve = problem.force_displacement(*problem.solve(ac.HINGE_TRUE_K)).detach()
        assert np.max(np.abs(curve[0].numpy() - u)) <= 1e-15 * np.max(np.abs(u))
        assert np.max(np.abs(curve[1].numpy() - f_noisy / noise)) <= 1e-9 * np.max(np.abs(f_noisy))
    port.setup_objective()
    value = float(port.objective_fn(ac.HINGE_GUESS))
    assert abs(value - float(ref["hinge_verlet_ckpt_value"])) <= 1e-10 * abs(value)
    quads = forward_problem_from_jax_dict(
        {**jax_hinge.ForwardProblemQuads(
            n1_blocks=4, n2_blocks=3, spacing=1.0, bond_length=0.1,
            horizontal_shifts=np.zeros((5, 3, 2)), vertical_shifts=np.zeros((4, 4, 2)),
            k_stretch=1.0, k_shear=0.05, k_rot=0.01, density=1.0, damping=1.0).to_dict()},
        device="cpu")
    assert isinstance(quads, hinge_characterization.ForwardProblemQuads)


def test_bloch_cell_crosses_over():
    """A JAX ``BlochCell`` with numpy leaves becomes the port's: the cell
    the port builds itself."""

    import jax

    from difflexmm_tpu.solver import bloch as jax_bloch
    from difflexmm_tpu_torch.solver import bloch
    from difflexmm_tpu_torch.utils.convert import bloch_cell_from_numpy

    cell = jax.tree_util.tree_map(np.asarray, jax_bloch.rotated_square_cell(0.3, k_rot=0.02))
    port = bloch_cell_from_numpy(cell, device="cpu")
    assert port.bond_blocks.dtype == torch.int64 and port.bond_params["k_shear"] == 1.0
    built = bloch.rotated_square_cell(0.3, k_rot=0.02, device="cpu")
    for got, want in zip(port, built):
        if isinstance(got, dict):
            assert sorted(got) == sorted(want)
            got, want = (torch.as_tensor(got["reference_vector"]),
                         torch.as_tensor(want["reference_vector"]))
        assert got.dtype == want.dtype
        assert float(torch.max(torch.abs(got - want))) <= 1e-15
