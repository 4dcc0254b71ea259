"""State carried across from the JAX package.

``design_from_numpy`` turns a numpy design into tensors, and
``forward_problem_from_jax_dict`` rebuilds a JAX ``ForwardProblem`` (its
``to_dict()``, arrays as numpy) as this port's ``ForwardProblem``, so that
one dict and one numpy design drive both packages.
"""

import dataclasses

import numpy as np
import torch

from difflexmm_tpu_torch.models.quads_focusing import ForwardProblem

# JAX ForwardProblem fields that this port does not carry:
# atol / rtol tune the odeint backend only, which the fast path never runs.
_INERT_FIELDS = ("atol", "rtol")


def design_from_numpy(design, device=None, dtype=torch.float64):
    """``(horizontal_shifts, vertical_shifts)`` numpy arrays -> tensors."""

    return tuple(torch.as_tensor(np.asarray(x), device=device, dtype=dtype) for x in design)


def forward_problem_from_jax_dict(d: dict, device="cpu", dtype=torch.float64) -> ForwardProblem:
    """This port's ``ForwardProblem`` from the dict of the JAX
    ``ForwardProblem.to_dict()``. Options the port lacks raise."""

    data = {k: v for k, v in d.items() if k not in _INERT_FIELDS}
    if data.pop("pallas_interpret", False):
        raise ValueError("pallas_interpret has no meaning in the port (there is no Pallas)")
    if not data.pop("grid_energy", True):
        raise NotImplementedError("grid_energy=False (dense assembly) is ROADMAP A3.")
    if data.get("solution_data") is not None:
        raise NotImplementedError("carrying solution_data across is ROADMAP A2.")
    known = {f.name for f in dataclasses.fields(ForwardProblem)}
    unknown = set(data) - known
    if unknown:
        raise ValueError(f"JAX ForwardProblem fields the port does not know: {sorted(unknown)}")
    data.update(device=device, dtype=dtype, is_setup=False)
    return ForwardProblem(**data)
