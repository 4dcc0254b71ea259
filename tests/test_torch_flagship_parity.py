"""The flagship slice end to end: the PyTorch port against the JAX package.

One JAX ``ForwardProblem`` dict and one numpy design drive both packages:
the JAX side runs ``method="verlet_ckpt"`` (the Pallas kernel's interval
body in XLA, with the true atan2), the port its plain body on the CPU.
Float64 throughout.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from difflexmm_tpu.geometry.polygon import compute_inertia as jax_compute_inertia
from difflexmm_tpu.models.quads_focusing import (
    ForwardProblem as JaxForwardProblem,
    OptimizationProblem as JaxOptimizationProblem,
)
from difflexmm_tpu.ops.observables import kinetic_energy as jax_kinetic_energy
from difflexmm_tpu_torch.models.flagship import JAX_F64_OBJECTIVE, build_flagship
from difflexmm_tpu_torch.models.quads_focusing import (
    ForwardProblem,
    OptimizationProblem,
)
from difflexmm_tpu_torch.utils.convert import design_from_numpy, forward_problem_from_jax_dict

# One intra-op thread: the suite runs in several worker processes at once,
# and the port's many small tensor operations slow down several times over
# when each worker also runs a thread per core.
torch.set_num_threads(1)

TARGET = dict(target_size=(2, 2), target_shift=(1, 1))


def _jax_dict(problem) -> dict:
    return {k: (np.asarray(v) if hasattr(v, "shape") else v)
            for k, v in problem.to_dict().items()}


@pytest.fixture(scope="module")
def small():
    """The flagship physics on 8 x 6 blocks, 12 timepoints, 4 substeps
    (the pulse sped up to 600 Hz to fit 1.5 ms); a random design."""

    cfg = bench.paper_config("verlet_ckpt", 4)
    cfg.update(n1_blocks=8, n2_blocks=6, n_timepoints=12, damping=cfg["damping"][:48],
               loading_rate=600.0, input_delay=0.0, simulation_time=1.5e-3)
    jp = JaxForwardProblem(**cfg)
    jo = JaxOptimizationProblem(jp, **TARGET)
    jo.setup_objective()
    rng = np.random.default_rng(0)
    base = jp.geometry.get_design_from_rotated_square(25 * math.pi / 180)
    design = [np.asarray(x) + 0.05 * rng.standard_normal(x.shape) for x in base]

    def objective_and_fields(d):
        sol = jp.solve(d)
        inertia = jax_compute_inertia(sol.centroid_node_vectors, jp.density)
        value = jax_kinetic_energy(sol.fields[:, 1, jo.target_blocks, :],
                                   inertia[jo.target_blocks])
        return value, sol.fields

    (value, fields), grads = jax.jit(jax.value_and_grad(objective_and_fields, has_aux=True))(
        tuple(jnp.asarray(x) for x in design)
    )
    return dict(
        jax_dict=_jax_dict(jp), design=design, value=float(value),
        fields=np.asarray(fields), grads=[np.asarray(g) for g in grads],
    )


def _port(jax_dict):
    problem = forward_problem_from_jax_dict(jax_dict, device="cpu")
    optimization = OptimizationProblem(problem, **TARGET)
    optimization.setup_objective()
    return optimization


def test_trajectory_matches_jax(small):
    optimization = _port(small["jax_dict"])
    with torch.no_grad():
        design = design_from_numpy(small["design"], device="cpu")
        fields = optimization.forward_problem.solve(design).fields
    ref = small["fields"]
    assert fields.shape == ref.shape
    assert np.abs(ref).max() > 1.0  # the pulse went through
    err = float(np.abs(fields.numpy() - ref).max() / np.abs(ref).max())
    assert err <= 1e-10


def test_objective_and_design_gradient_match_jax(small):
    optimization = _port(small["jax_dict"])
    design = tuple(x.requires_grad_() for x in design_from_numpy(small["design"], device="cpu"))
    value = optimization.objective_fn(design)
    grads = torch.autograd.grad(value, design)
    assert abs(float(value.detach()) - small["value"]) <= 1e-10 * abs(small["value"])
    for g, ref in zip(grads, small["grads"]):
        assert float(np.abs(g.numpy() - ref).max() / np.abs(ref).max()) <= 1e-9


def test_forward_problem_dict_roundtrip(small):
    problem = forward_problem_from_jax_dict(small["jax_dict"], device="cpu")
    again = ForwardProblem.from_dict(problem.to_dict())
    assert again.to_dict().keys() == problem.to_dict().keys()
    assert again.n1_blocks == 8 and again.method == "verlet_ckpt" and not again.is_setup


@pytest.mark.parametrize(
    "change, error",
    [
        (dict(pallas_interpret=True), ValueError),
        (dict(name="no_such_family"), NotImplementedError),
        (dict(not_a_field=1), ValueError),
    ],
)
def test_jax_dict_options_the_port_lacks_raise(small, change, error):
    with pytest.raises(error):
        forward_problem_from_jax_dict({**small["jax_dict"], **change}, device="cpu")


@pytest.mark.slow
def test_flagship_f64_objective_matches_jax_verlet():
    optimization, design = build_flagship(device="cpu")
    with torch.no_grad():
        value = float(optimization.objective_fn(design))
    assert abs(value - JAX_F64_OBJECTIVE) <= 1e-8 * JAX_F64_OBJECTIVE
