"""The port's objectives (``objectives.py``), magnetic energy
(``ops/magnetic.py``) and trajectory diagnostics (``solver/diagnose.py``)
against the JAX package's on the CPU at float64, both run as the test
goes (each compiles in about a second): the FFT cross-correlations (full,
pinned lags, the 1D form, the space-time peak and delay, the lag range
check), the k-omega spectrum, the dipole energy and its gradient (alone and
through ``build_magnetic_energy`` on ``ControlParams.magnetic_params``),
and the tunneling report of a trajectory that blows up (identical
``first_nonfinite`` and risky flags).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difflexmm_tpu import objectives as jax_objectives
from difflexmm_tpu.ops import magnetic as jax_magnetic
from difflexmm_tpu.solver import diagnose as jax_diagnose
from difflexmm_tpu.utils import types as jax_types

from difflexmm_tpu_torch import objectives
from difflexmm_tpu_torch.ops import magnetic
from difflexmm_tpu_torch.solver import diagnose
from difflexmm_tpu_torch.utils import types

torch.set_num_threads(1)

# Closed-form functions and FFTs of the same length: only the last bits of
# the libraries' transforms and transcendentals differ.
TIGHT = 1e-12


def rel(a, b):
    a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.fixture(scope="module")
def signals():
    rng = np.random.default_rng(0)
    return rng.standard_normal((7, 11)), rng.standard_normal((7, 13))


@pytest.mark.parametrize("shift", [(None, None), (0, None), (None, -3), (2, 4)])
def test_xcorr2d_matches_jax(signals, shift):
    a, b = signals
    got = objectives.compute_xcorr2d(torch.tensor(a), torch.tensor(b), shift)
    assert rel(got, jax_objectives.compute_xcorr2d(a, b, shift)) < TIGHT


def test_xcorr_1d_space_time_and_spectrum_match_jax(signals):
    a, b = signals
    assert rel(objectives.compute_xcorr(torch.tensor(a[0]), torch.tensor(b[0])),
               jax_objectives.compute_xcorr(a[0], b[0])) < TIGHT
    assert rel(objectives.compute_xcorr(torch.tensor(a[0]), torch.tensor(b[0]), -4),
               jax_objectives.compute_xcorr(a[0], b[0], -4)) < TIGHT
    value, delay = objectives.compute_space_time_xcorr(torch.tensor(a), torch.tensor(b))
    jax_value, jax_delay = jax_objectives.compute_space_time_xcorr(a, b)
    assert rel(value, jax_value) < TIGHT and int(delay) == int(jax_delay)
    # A self-correlation peaks at exactly 1 (the same FFT path).
    assert float(objectives.compute_xcorr2d(torch.tensor(a), torch.tensor(a)).max()) == 1.0
    with pytest.raises(ValueError, match="outside the valid lag range"):
        objectives.compute_xcorr(torch.tensor(a[0]), torch.tensor(b[0]), 20)
    for got, want in zip(objectives.spectral_dispersion(torch.tensor(a), 0.1, 1.0),
                         jax_objectives.spectral_dispersion(a, 0.1, 1.0)):
        assert rel(got, want) < TIGHT


def test_magnetic_energy_and_gradient_match_jax():
    rng = np.random.default_rng(1)
    positions = 3.0 * rng.standard_normal((6, 2))
    positions[1] = positions[0] + 0.05  # inside the core radius
    rotations, angles = rng.standard_normal(6), rng.standard_normal((6, 2))
    strengths = rng.uniform(0.5, 1.5, 6)

    def jax_energy(p, r, a):
        return jax_magnetic.magnetic_dipole_energy(p, r, a, strengths, prefactor=0.3,
                                                   min_distance=0.2)

    value, grads = jax.value_and_grad(jax_energy, argnums=(0, 1, 2))(positions, rotations,
                                                                    angles)
    args = [torch.tensor(x, requires_grad=True) for x in (positions, rotations, angles)]
    got = magnetic.magnetic_dipole_energy(*args, torch.tensor(strengths), prefactor=0.3,
                                          min_distance=0.2)
    assert rel(got, value) < TIGHT
    for g, want in zip(torch.autograd.grad(got, args), grads):
        assert rel(g, want) < TIGHT


def test_magnetic_energy_reads_control_params():
    rng = np.random.default_rng(2)
    centroids, u = rng.standard_normal((5, 2)) * 2.0, 0.1 * rng.standard_normal((5, 3))
    angles = rng.standard_normal((5, 2))

    def jax_cp(magnetic_params):
        return jax_types.ControlParams(
            geometrical_params=jax_types.GeometricalParams(centroids, np.zeros((5, 4, 2))),
            mechanical_params=jax_types.MechanicalParams(None, 1.0),
            magnetic_params=magnetic_params)

    jax_fn = jax_magnetic.build_magnetic_energy(prefactor=1e-3)
    want = jax.grad(jax_fn)(jnp.asarray(u), jax_cp(jax_types.MagneticParams(angles, 1.5)))
    cp = types.ControlParams(
        geometrical_params=types.GeometricalParams(torch.tensor(centroids),
                                                   torch.zeros((5, 4, 2))),
        mechanical_params=types.MechanicalParams(None, 1.0),
        magnetic_params=types.MagneticParams(torch.tensor(angles), 1.5))
    fn = magnetic.build_magnetic_energy(prefactor=1e-3)
    uu = torch.tensor(u, requires_grad=True)
    assert rel(torch.autograd.grad(fn(uu, cp), uu)[0], want) < TIGHT
    assert float(fn(uu, cp._replace(magnetic_params=None))) == 0.0


def test_tunneling_report_matches_jax():
    rng = np.random.default_rng(3)
    solution = rng.standard_normal((9, 2, 5, 3))
    solution[6:, 1, 2, 2] = np.nan
    solution[3, 1, 4, 2] = 40.0  # a spike: risky intervals 2 and 3
    timepoints = np.linspace(0.0, 1.0, 9)
    want = jax_diagnose.contact_tunneling_report(solution, timepoints, 4, 0.0, 0.3)
    got = diagnose.contact_tunneling_report(torch.tensor(solution), torch.tensor(timepoints), 4,
                                            0.0, 0.3)
    assert got.first_nonfinite == want.first_nonfinite == 6
    assert np.array_equal(got.risky_intervals.numpy(), np.asarray(want.risky_intervals))
    finite = np.isfinite(np.asarray(want.window_fraction))
    assert rel(got.window_fraction.numpy()[finite], np.asarray(want.window_fraction)[finite]) \
        < TIGHT
    assert np.array_equal(np.isinf(got.window_fraction.numpy()), ~finite)
    assert diagnose.first_nonfinite_timepoint(torch.tensor(solution[:5])) is None
    with pytest.raises(ValueError, match="non-positive barrier window"):
        diagnose.contact_tunneling_report(torch.tensor(solution), torch.tensor(timepoints), 4,
                                          0.3, 0.3)
