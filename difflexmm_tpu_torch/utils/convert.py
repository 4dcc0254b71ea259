"""State carried across from the JAX package.

``design_from_numpy`` turns a numpy design into tensors,
``forward_problem_from_jax_dict`` rebuilds a JAX ``ForwardProblem`` (its
``to_dict()``, arrays as numpy; the substep ``guard`` and ``solution_data``
included) as this port's ``ForwardProblem`` of the same family (the dict's
``name``, a key of :data:`FAMILIES`),
``reference_design_from_config`` does the same for a run configuration
file's ``"forward"`` section (``examples/configs/pulse_forward.json``),
``loading_params_from_numpy`` turns JAX loading parameters into tensors,
``params_from_numpy`` turns a JAX parameter container (``LigamentParams``,
``StretchingTorsionalSpringParams``, ``MagneticParams``, ``ContactParams``,
``MechanicalParams`` ...; numpy leaves) into the port's same-named one,
and
``optimization_problem_from_jax_dict`` does the same for a JAX
``OptimizationProblem`` of any family (targets, weights, forward inputs,
the restricted space's initial guess, the hinge fit's target and fitted
curves and the iteration histories), so that one dict and one numpy design
drive both packages, and ``bloch_cell_from_numpy`` turns a JAX
``BlochCell`` (numpy leaves) into the port's.
"""

import dataclasses
from pathlib import Path

import numpy as np
import torch

from difflexmm_tpu_torch.models import (
    hinge_characterization,
    kagome_focusing,
    quads_energy_splitting,
    quads_focusing,
    quads_focusing_multi_input,
    quads_focusing_restricted_space,
    quads_spin,
    quads_static_tuning,
    reference_design,
)
from difflexmm_tpu_torch.utils import types
from difflexmm_tpu_torch.utils.types import SolutionData, load_data

#: The model families the port has, by the JAX problem's ``name``.
FAMILIES = {
    "quads_focusing": quads_focusing,
    "kagome_focusing": kagome_focusing,
    "reference_design": reference_design,
    "quads_focusing_multi_input": quads_focusing_multi_input,
    "quads_energy_splitting": quads_energy_splitting,
    "quads_focusing_restricted_space": quads_focusing_restricted_space,
    "quads_spin": quads_spin,
    "quads_kinetic_energy_static_tuning": quads_static_tuning,
    "hinge_characterization": hinge_characterization,
    "hinge_characterization_quads": hinge_characterization,
}

#: Forward problem classes of the families whose class is not the module's
#: ``ForwardProblem``.
_FORWARD_CLASSES = {"hinge_characterization_quads": hinge_characterization.ForwardProblemQuads}

# JAX ForwardProblem fields that this port does not carry:
# atol / rtol tune the odeint backend only, which the fast path never runs.
_INERT_FIELDS = ("atol", "rtol")


def _family(d: dict):
    name = d.get("name", "quads_focusing")
    if name not in FAMILIES:
        raise NotImplementedError(f"model family {name!r} is not ported yet")
    return FAMILIES[name]


def known_fields(cls) -> set:
    """The field names of a dataclass."""

    return {f.name for f in dataclasses.fields(cls)}


def design_from_numpy(design, device="cuda", dtype=torch.float64):
    """A design's numpy arrays (quads: the two shift grids; kagome: the
    three) -> tensors; a rotated-square design, one angle, -> a 0-dim
    tensor."""

    if not isinstance(design, (tuple, list)):
        return torch.tensor(float(design), device=device, dtype=dtype)
    return tuple(torch.tensor(np.asarray(x), device=device, dtype=dtype) for x in design)


def _tensor(x, device, dtype):
    """A numeric array -> a tensor on ``device``, floats in ``dtype``,
    integers as int64."""

    x = np.asarray(x)
    if x.dtype.kind in "iub":
        return torch.as_tensor(x, device=device)
    return torch.tensor(x, device=device, dtype=dtype)


def solution_data_from_numpy(solution, device="cuda", dtype=torch.float64):
    """A JAX ``solution_data`` -> this port's: a dict of its fields or a
    ``SolutionData`` (numpy arrays), a list of them, or the path of a
    pickle that :func:`utils.types.load_data` reads."""

    if solution is None:
        return None
    if isinstance(solution, (str, Path)):
        solution = load_data(solution, device=device)
    if isinstance(solution, list):
        return [solution_data_from_numpy(s, device, dtype) for s in solution]
    fields = solution if isinstance(solution, dict) else solution._asdict()
    return SolutionData(**{k: _tensor(v.cpu() if isinstance(v, torch.Tensor) else v,
                                      device, dtype)
                           for k, v in fields.items()})


def forward_problem_from_jax_dict(d: dict, device="cuda", dtype=torch.float64):
    """This port's ``ForwardProblem`` from the dict of the JAX
    ``ForwardProblem.to_dict()``. Options the port lacks raise."""

    ForwardProblem = _FORWARD_CLASSES.get(d.get("name"), _family(d).ForwardProblem)
    data = {k: v for k, v in d.items() if k not in _INERT_FIELDS}
    if data.pop("pallas_interpret", False):
        raise ValueError("pallas_interpret has no meaning in the port (there is no Pallas)")
    data["solution_data"] = solution_data_from_numpy(data.get("solution_data"), device, dtype)
    unknown = set(data) - known_fields(ForwardProblem)
    if unknown:
        raise ValueError(f"JAX ForwardProblem fields the port does not know: {sorted(unknown)}")
    data.update(device=device, dtype=dtype, is_setup=False)
    return ForwardProblem(**data)


def reference_design_from_config(forward: dict, device="cuda", dtype=torch.float64, **overrides):
    """The rotated-square ``reference_design.ForwardProblem`` of a run
    configuration's ``"forward"`` section (the JAX ``ForwardProblem``
    keywords, e.g. ``examples/configs/pulse_forward.json``), with
    ``overrides`` (``method``, ``guard``, ...) on top."""

    data = dict(forward, **overrides)
    return forward_problem_from_jax_dict(dict(data, name="reference_design"), device, dtype)


def loading_params_from_numpy(loading_params: dict, device="cuda", dtype=torch.float64) -> dict:
    """JAX ``loading_params`` (numbers or arrays) -> tensors."""

    return {k: torch.tensor(np.asarray(v), device=device, dtype=dtype)
            for k, v in loading_params.items()}


def params_from_numpy(params, device="cuda", dtype=torch.float64):
    """A JAX parameter container -> the port's container of the same name
    (``utils.types``), nested containers and dicts too, every numeric leaf
    a tensor (floats in ``dtype``); None stays None."""

    if params is None or isinstance(params, str):
        return params
    if isinstance(params, tuple) and hasattr(params, "_fields"):
        cls = getattr(types, type(params).__name__, None)
        if not (isinstance(cls, type) and issubclass(cls, tuple) and hasattr(cls, "_fields")):
            raise TypeError(f"{type(params).__name__} has no counterpart in the port's "
                            "utils.types")
        return cls(*(params_from_numpy(x, device, dtype) for x in params))
    if isinstance(params, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in params.items()}
    return _tensor(params, device, dtype)


def forward_input_from_numpy(family, forward_input, device="cuda", dtype=torch.float64):
    """A JAX ``ForwardInput`` (its dict, numpy shift grids) -> the
    family's ``ForwardInput``: the shift grids as tensors, the scenario
    tuples as tuples of floats."""

    data = dict(forward_input if isinstance(forward_input, dict)
                else dataclasses.asdict(forward_input))
    for key, value in data.items():
        if key in ("horizontal_shifts", "vertical_shifts"):
            data[key] = _tensor(value, device, dtype)
        else:
            data[key] = tuple(float(x) for x in np.asarray(value).reshape(-1))
    return family.ForwardInput(**data)


def _pairs(values):
    """A pair or a sequence of pairs as tuples of ints."""

    values = np.asarray(values)
    if values.ndim == 1:
        return tuple(int(x) for x in values)
    return tuple(tuple(int(x) for x in row) for row in values)


def optimization_problem_from_jax_dict(d: dict, device="cuda", dtype=torch.float64):
    """This port's ``OptimizationProblem`` from the dict of the JAX
    ``OptimizationProblem.to_dict()`` of any family in :data:`FAMILIES`
    (its forward problems as above; the histories' designs as tuples of
    numpy arrays)."""

    family = _family(d)
    OptimizationProblem = family.OptimizationProblem
    data = dict(d)
    unknown = set(data) - {f.name for f in dataclasses.fields(OptimizationProblem)}
    if unknown:
        raise ValueError(f"JAX OptimizationProblem fields the port does not know: "
                         f"{sorted(unknown)}")
    if "forward_problem" in data:
        data["forward_problem"] = forward_problem_from_jax_dict(
            data["forward_problem"], device=device, dtype=dtype)
    if "forward_problems" in data:
        data["forward_problems"] = [forward_problem_from_jax_dict(p, device=device, dtype=dtype)
                                    for p in data["forward_problems"]]
    if data.get("forward_input") is not None:
        data["forward_input"] = forward_input_from_numpy(family, data["forward_input"],
                                                         device, dtype)
    if "initial_guess_all" in data:
        data["initial_guess_all"] = design_from_numpy(data["initial_guess_all"], device, dtype)
    if not isinstance(data.get("spin_center", "center"), str):
        data["spin_center"] = _tensor(data["spin_center"], device, dtype)
    for key in ("target_size", "target_shift", "target_sizes", "target_shifts"):
        if key in data:
            data[key] = _pairs(data[key])
    for key in ("target_responses", "fitted_responses"):
        if data.get(key) is not None:
            data[key] = {k: _tensor(v, device, dtype) for k, v in data[key].items()}
    if "weights" in data:
        data["weights"] = tuple(float(w) for w in np.asarray(data["weights"]).reshape(-1))
    data["objective_values"] = [float(v) for v in data.get("objective_values") or []]
    if "objective_values_individual" in data:
        data["objective_values_individual"] = [
            _tensor(v, device, dtype) for v in data.get("objective_values_individual") or []]
    data["design_values"] = [design_from_numpy(x, device, dtype)
                             for x in data.get("design_values") or []]
    violation = data.get("constraints_violation")
    if violation is not None:
        data["constraints_violation"] = {k: [float(v) for v in vs] for k, vs in violation.items()}
    data["is_setup"] = False
    return OptimizationProblem(**data)


def bloch_cell_from_numpy(cell, device="cuda", dtype=torch.float64):
    """A JAX ``BlochCell`` (numpy leaves, or its ``_asdict()``) -> the
    port's ``solver.bloch.BlochCell``: float arrays as tensors in
    ``dtype``, the bond tables as int64 tensors, numbers in
    ``bond_params`` kept as they are."""

    from difflexmm_tpu_torch.solver.bloch import BlochCell

    fields = cell if isinstance(cell, dict) else cell._asdict()

    def leaf(x):
        return x if isinstance(x, (int, float)) else _tensor(x, device, dtype)

    data = {k: leaf(v) for k, v in fields.items() if k != "bond_params"}
    for key in ("bond_blocks", "bond_nodes", "bond_offsets"):
        data[key] = data[key].to(torch.int64)
    data["bond_params"] = {k: leaf(v) for k, v in fields["bond_params"].items()}
    return BlochCell(**data)
