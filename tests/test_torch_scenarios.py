"""The scenario layer of the port against the JAX package, on the CPU at
float64: the observables, a batch of loading scenarios in one
``solve_scenario`` call, the robustness map, the response data,
``excited_blocks_fn`` on quads and kagome, and the design gradient of a
weighted sum over a scenario batch.

The JAX results of the solves are recorded in
``tests/data/scenarios_small.npz`` by ``tests/jax_family_references.py``
(run it, or the slow ``test_scenario_references_match_jax``, to make the
file again). Values are held within 1e-10 relative of JAX and design
gradients within 1e-8, each to the largest magnitude of its reference.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_family_references as refs
from difflexmm_tpu.ops import observables as jax_observables
from jax_references import record_or_check, stored

from difflexmm_tpu_torch.geometry.polygon import compute_inertia
from difflexmm_tpu_torch.geometry.quad import QuadGeometry
from difflexmm_tpu_torch.models.quads_focusing import OptimizationProblem
from difflexmm_tpu_torch.ops import observables
from difflexmm_tpu_torch.ops.observables import trajectory_kinetic_energy
from difflexmm_tpu_torch.utils.convert import design_from_numpy, forward_problem_from_jax_dict

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

VALUE_TOL = 1e-10
GRAD_TOL = 1e-8


def rel(a, b) -> float:
    """Largest |a - b| over the largest |b|."""

    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.fixture(scope="module")
def ref():
    return stored("scenarios_small")


@pytest.fixture(scope="module")
def port():
    """The port's flagship-physics problem on 6 x 4 quads, built from the
    JAX problem's dict, its design, and the three scenarios solved in one
    call."""

    fp = forward_problem_from_jax_dict(refs.numpy_dict(refs.flagship_small()), device="cpu")
    optimization = OptimizationProblem(fp, target_size=(2, 2), target_shift=(1, 0))
    optimization.setup_objective()
    design = design_from_numpy(refs.flagship_design(), device="cpu")
    amplitudes = torch.tensor(refs.SCENARIO_FACTORS, dtype=torch.float64) * fp.amplitude
    rates = torch.tensor(refs.SCENARIO_RATES, dtype=torch.float64)
    with torch.no_grad():
        batch = fp.solve_scenario(design, amplitudes, rates)
    return SimpleNamespace(fp=fp, optimization=optimization, design=design,
                           amplitudes=amplitudes, rates=rates, batch=batch)


# ---------------------------------------------------------------------------
# Observables
# ---------------------------------------------------------------------------


def _lattice(seed=0):
    """A 6 x 4 quad lattice's node vectors, bonds and reference vectors at
    a random design (numpy, from the port's geometry), and random states of
    two designs at three times."""

    geometry = QuadGeometry(refs.N1, refs.N2, spacing=1.0, bond_length=0.1)
    rng = np.random.default_rng(seed)
    design = [x.numpy() + 0.02 * rng.standard_normal(tuple(x.shape))
              for x in geometry.get_design_from_rotated_square(0.3, device="cpu")]
    _, cnv_fn, bond_fn, ref_fn = geometry.get_parametrization()
    states = 0.05 * rng.standard_normal((2, 3, geometry.n_blocks, 3))
    cnv = cnv_fn(*(torch.tensor(x) for x in design))
    return cnv.numpy(), np.asarray(bond_fn()), ref_fn().numpy(), states


def test_angular_momentum_matches_jax():
    rng = np.random.default_rng(1)
    position, velocity = rng.standard_normal((2, 2, 3, 5, 3))
    inertia = rng.uniform(0.5, 2.0, (5, 3))
    point = np.array([0.3, -0.2])
    for reference_point in ((0.0, 0.0), point):
        got = observables.angular_momentum(
            torch.tensor(position[..., :2]), torch.tensor(velocity), torch.tensor(inertia),
            reference_point=torch.tensor(reference_point, dtype=torch.float64))
        want = np.stack([np.asarray(jax_observables.angular_momentum(
            jnp.asarray(position[i, ..., :2]), jnp.asarray(velocity[i]), jnp.asarray(inertia),
            reference_point=jnp.asarray(reference_point))) for i in range(2)])
        assert got.shape == (2, 3, 5)
        assert rel(got, want) <= VALUE_TOL


def test_ligament_strains_match_jax():
    cnv, bonds, ref_vectors, states = _lattice()
    got = observables.compute_ligament_strains(torch.tensor(states[:, 0]), torch.tensor(cnv),
                                               bonds, torch.tensor(ref_vectors))
    for b in range(2):
        want = jax_observables.compute_ligament_strains(
            jnp.asarray(states[b, 0]), jnp.asarray(cnv), jnp.asarray(bonds),
            jnp.asarray(ref_vectors))
        for g, w in zip(got, want):
            assert g.shape == (2, len(bonds))
            assert rel(g[b], w) <= VALUE_TOL


def test_ligament_strain_histories_match_jax():
    cnv, bonds, ref_vectors, states = _lattice(seed=2)
    # A population: each design its own node vectors (the second scaled).
    cnvs = np.stack([cnv, 1.01 * cnv])
    got = observables.compute_ligament_strains_history(
        torch.tensor(states), torch.tensor(cnvs), bonds, torch.tensor(ref_vectors))
    shared = observables.compute_ligament_strains_history(
        torch.tensor(states), torch.tensor(cnv), bonds, torch.tensor(ref_vectors))
    for b in range(2):
        want = jax_observables.compute_ligament_strains_history(
            jnp.asarray(states[b]), jnp.asarray(cnvs[b]), jnp.asarray(bonds),
            jnp.asarray(ref_vectors))
        want_shared = jax_observables.compute_ligament_strains_history(
            jnp.asarray(states[b]), jnp.asarray(cnv), jnp.asarray(bonds),
            jnp.asarray(ref_vectors))
        for g, s, w, ws in zip(got, shared, want, want_shared):
            assert g.shape == (2, 3, len(bonds))
            assert rel(g[b], w) <= VALUE_TOL and rel(s[b], ws) <= VALUE_TOL


# ---------------------------------------------------------------------------
# Scenarios
# ---------------------------------------------------------------------------


def test_solve_scenario_batch_matches_jax(port, ref):
    """Three scenarios in one call against three JAX ``solve_scenario``
    calls."""

    assert port.batch.fields.shape == (3, 24, 2, refs.N1 * refs.N2, 3)
    for b in range(3):
        assert rel(port.batch.fields[b], ref[f"scenario{b}_fields"]) <= VALUE_TOL


def test_robustness_map_matches_jax(port, ref):
    with torch.no_grad():
        values = port.optimization.compute_robustness_map(
            port.design, [f * port.fp.amplitude for f in refs.MAP_FACTORS], refs.MAP_RATES)
    assert values.shape == (2, 3)
    assert rel(values, ref["robustness_map"]) <= VALUE_TOL
    with pytest.raises(NotImplementedError, match="A11"):
        port.optimization.compute_robustness_map(port.design, [1.0], [1.0], mesh=object())


def test_response_data_matches_jax(port, ref):
    """``compute_response_data`` of the batch, key for key against JAX's of
    scenario 1 alone."""

    with torch.no_grad():
        response = port.fp.compute_response_data(port.batch)
    assert set(response) == {"block_centroids", "centroid_node_vectors", "bond_connectivity",
                             "timepoints", "fields", "strain_energy_stretch",
                             "strain_energy_shear", "strain_energy_bending", "kinetic_energy"}
    for key in ("strain_energy_stretch", "strain_energy_shear", "strain_energy_bending",
                "kinetic_energy"):
        assert response[key].shape[0] == 3
        assert rel(response[key][1], ref[f"response_{key}"]) <= VALUE_TOL, key


def test_weighted_scenario_gradient_matches_jax(port, ref):
    """The design gradient of a weighted sum of the three scenarios' target
    kinetic energies, one batched solve; the drive tables need no gradient
    (so that the adjoint on the card keeps its graph replay)."""

    fp, target = port.fp, torch.as_tensor(port.optimization.target_blocks)
    design = tuple(x.clone().requires_grad_() for x in port.design)
    args = fp.solve_dynamics.trajectory_args(
        fp.state0, fp.timepoints, fp.control_params(design, port.amplitudes, port.rates))
    assert args.drive.shape[0] == 3 and not args.drive.requires_grad
    assert not any(m.requires_grad for m in args.micro)
    solution = fp.solve_scenario(design, port.amplitudes, port.rates)
    inertia = compute_inertia(fp.geometry.centroid_node_vectors(*design), fp.density)[target]
    values = trajectory_kinetic_energy(solution.fields[..., 1, target, :], inertia)
    value = torch.dot(torch.tensor(refs.SCENARIO_WEIGHTS, dtype=torch.float64), values)
    grads = torch.autograd.grad(value, design)
    want = float(ref["weighted_value"])
    assert abs(float(value.detach()) - want) <= VALUE_TOL * abs(want)
    for i, g in enumerate(grads):
        assert rel(g, ref[f"weighted_grad{i}"]) <= GRAD_TOL


def test_scenario_batches_must_agree(port):
    two_designs = tuple(torch.stack([x, x]) for x in port.design)
    with pytest.raises(ValueError, match="different sizes"):
        port.fp.solve_scenario(two_designs, port.amplitudes, port.rates)
    with pytest.raises(ValueError, match="different sizes"):
        port.fp.solve_scenario(port.design, port.amplitudes, port.rates[:2])


def test_excited_blocks_fn_on_quads_matches_jax(ref):
    fp = forward_problem_from_jax_dict(refs.numpy_dict(refs.flagship_small()), device="cpu")
    fp.setup(excited_blocks_fn=lambda t: refs.excited(torch)(t, 3.0, 2000.0))
    with torch.no_grad():
        fields = fp.solve(design_from_numpy(refs.flagship_design(), device="cpu")).fields
    assert rel(fields, ref["excited_quads_fields"]) <= VALUE_TOL


def test_excited_blocks_fn_on_kagome_matches_jax(ref):
    fp = forward_problem_from_jax_dict(refs.numpy_dict(refs.kagome_small()), device="cpu")
    fp.setup(excited_blocks_fn=lambda t: refs.excited(torch)(t, 0.2, 1.5))
    with torch.no_grad():
        fields = fp.solve(design_from_numpy(refs.kagome_design(), device="cpu")).fields
    assert rel(fields, ref["excited_kagome_fields"]) <= VALUE_TOL


@pytest.mark.slow
def test_scenario_references_match_jax():
    """Make ``tests/data/scenarios_small.npz`` again with the JAX package."""

    record_or_check("scenarios_small", refs.scenario_references())
