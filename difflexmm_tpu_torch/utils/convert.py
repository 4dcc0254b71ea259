"""State carried across from the JAX package.

``design_from_numpy`` turns a numpy design into tensors,
``forward_problem_from_jax_dict`` rebuilds a JAX ``ForwardProblem`` (its
``to_dict()``, arrays as numpy; the substep ``guard`` included) as this
port's ``ForwardProblem`` of the same family (the dict's ``name``:
``"quads_focusing"``, ``"kagome_focusing"`` or ``"reference_design"``),
``reference_design_from_config`` does the same for a run configuration
file's ``"forward"`` section (``examples/configs/pulse_forward.json``),
``loading_params_from_numpy`` turns JAX loading parameters into tensors,
and
``optimization_problem_from_jax_dict`` does the same for a JAX
``OptimizationProblem`` (target patch and iteration histories), so that one
dict and one numpy design drive both packages.
"""

import dataclasses

import numpy as np
import torch

from difflexmm_tpu_torch.models import kagome_focusing, quads_focusing, reference_design

#: The model families the port has, by the JAX problem's ``name``.
FAMILIES = {"quads_focusing": quads_focusing, "kagome_focusing": kagome_focusing,
            "reference_design": reference_design}

# JAX ForwardProblem fields that this port does not carry:
# atol / rtol tune the odeint backend only, which the fast path never runs.
_INERT_FIELDS = ("atol", "rtol")


def _family(d: dict):
    name = d.get("name", "quads_focusing")
    if name not in FAMILIES:
        raise NotImplementedError(f"model family {name!r} is not ported yet (ROADMAP A10)")
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


def forward_problem_from_jax_dict(d: dict, device="cuda", dtype=torch.float64):
    """This port's ``ForwardProblem`` from the dict of the JAX
    ``ForwardProblem.to_dict()``. Options the port lacks raise."""

    ForwardProblem = _family(d).ForwardProblem
    data = {k: v for k, v in d.items() if k not in _INERT_FIELDS}
    if data.pop("pallas_interpret", False):
        raise ValueError("pallas_interpret has no meaning in the port (there is no Pallas)")
    if data.get("solution_data") is not None:
        raise NotImplementedError("carrying solution_data across is ROADMAP A2.")
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


def optimization_problem_from_jax_dict(d: dict, device="cuda", dtype=torch.float64):
    """This port's ``OptimizationProblem`` from the dict of the JAX
    ``OptimizationProblem.to_dict()`` (its forward problem as above; the
    histories' designs as tuples of numpy arrays)."""

    OptimizationProblem = _family(d).OptimizationProblem
    data = dict(d)
    unknown = set(data) - {f.name for f in dataclasses.fields(OptimizationProblem)}
    if unknown:
        raise ValueError(f"JAX OptimizationProblem fields the port does not know: "
                         f"{sorted(unknown)}")
    data["forward_problem"] = forward_problem_from_jax_dict(
        data["forward_problem"], device=device, dtype=dtype)
    data["objective_values"] = [float(v) for v in data.get("objective_values") or []]
    data["design_values"] = [design_from_numpy(x, device, dtype)
                             for x in data.get("design_values") or []]
    violation = data.get("constraints_violation")
    if violation is not None:
        data["constraints_violation"] = {k: [float(v) for v in vs] for k, vs in violation.items()}
    data.update(target_size=tuple(data["target_size"]), target_shift=tuple(data["target_shift"]),
                is_setup=False)
    return OptimizationProblem(**data)
