"""The float32 force pulse of ``examples/pulse_rotated_squares.py`` leaves
the float64 pulse at its 14th interval in the JAX package as in the port:
a property of the physics at float32, not a fault of the port.

The pulse (10 x 5 rotated-square cells, 100 timepoints of 16 substeps)
runs in JAX's dense ``method="verlet"`` at float32 and at float64 on the
CPU, and in the port's fast path (the plain body) and dense path at
float32. Each float32 run is held against JAX's float64 run, timepoint by
timepoint, on the displacement and velocity fields relative to their
scales. Marked ``slow`` (about a minute); ``-s`` prints the numbers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difflexmm_tpu.geometry import RotatedSquareGeometry
from difflexmm_tpu.ops import build_strain_energy, ligament_energy
from difflexmm_tpu.solver import setup_dynamic_solver
from difflexmm_tpu.utils import ControlParams, GeometricalParams, LigamentParams, MechanicalParams

from difflexmm_tpu_torch.models import loaded_configs as lc

torch.set_num_threads(1)

# The interval (timepoint) at which the float32 pulse leaves float64.
DEPARTURE = 14


def jax_pulse(x64: bool) -> np.ndarray:
    """The example's fields ``(T, 2, n_blocks, 3)`` from JAX's dense
    verlet, at float64 or (every input float32, x64 off) float32."""

    with jax.enable_x64(x64):
        dt = jnp.float64 if x64 else jnp.float32
        p = lc.PULSE
        geometry = RotatedSquareGeometry(n1_cells=p["n1_cells"], n2_cells=p["n2_cells"],
                                         spacing=p["spacing"])
        bc, cnv, bonds, rbv = geometry.get_parametrization()
        angle = jnp.asarray(p["angle"], dt)
        rows = jnp.array([geometry.n2_blocks // 2 - 1, geometry.n2_blocks // 2])
        pairs = jnp.stack([rows * geometry.n1_blocks, jnp.zeros_like(rows)], axis=1)

        def loading(state, t, amplitude, rate):
            return amplitude * jnp.where((t > 0) & (t < 1 / rate),
                                         jnp.sin(jnp.pi * rate * t) ** 2, 0.0)

        solve = setup_dynamic_solver(
            geometry=geometry, energy_fn=build_strain_energy(bonds(), ligament_energy),
            loaded_block_DOF_pairs=pairs, loading_fn=loading,
            damped_blocks=jnp.arange(geometry.n_blocks), method="verlet",
            n_substeps=p["n_substeps"])
        control_params = ControlParams(
            geometrical_params=GeometricalParams(bc(angle), cnv(angle)),
            mechanical_params=MechanicalParams(
                bond_params=LigamentParams(*(jnp.asarray(k, dt) for k in p["bond_params"]),
                                           jnp.asarray(rbv(), dt)),
                density=jnp.asarray(p["density"], dt), damping=jnp.asarray(p["damping"], dt)),
            loading_params=dict(amplitude=jnp.asarray(p["amplitude"], dt),
                                rate=jnp.asarray(p["rate"], dt)))
        timepoints = jnp.linspace(0.0, p["simulation_time"], p["n_timepoints"], dtype=dt)
        state0 = jnp.zeros((2, geometry.n_blocks, 3), dt)
        return np.asarray(solve(state0, timepoints, control_params), dtype=np.float64)


def port_pulse(method: str) -> np.ndarray:
    """The port's float32 fields of the pulse (``verlet_pallas``: the fast
    path, the plain body on the CPU; ``verlet``: the dense path)."""

    with torch.no_grad():
        _, fields = lc.pulse_kinetic_energy(lc.pulse_problem("cpu", torch.float32, method),
                                            *lc.pulse_inputs("cpu", torch.float32))
    return fields.double().numpy()


def departure(fields, reference) -> np.ndarray:
    """``(T, 2)``: each timepoint's largest difference from ``reference`` in
    the displacement and in the velocity field, relative to that field's
    largest value over the run."""

    scale = np.abs(reference).max(axis=(0, 2, 3))
    return np.abs(fields - reference).max(axis=(2, 3)) / scale


@pytest.mark.slow
def test_float32_pulse_leaves_float64_in_jax_as_in_the_port():
    reference = jax_pulse(True)
    runs = {"JAX float32": jax_pulse(False), "port float32 (fast path)": port_pulse("verlet_pallas"),
            "port float32 (dense)": port_pulse("verlet")}
    for name, fields in runs.items():
        err = departure(fields, reference)
        velocity = err[:, 1]
        print(f"{name}: velocity error at timepoints 12-16 "
              f"{[f'{e:.2e}' for e in velocity[12:17]]}, largest over the run U "
              f"{err[:, 0].max():.3e} V {velocity.max():.3e}")
        # Close to float64 up to the departure; a jump of more than ten times
        # at it; far from float64 over the whole pulse.
        assert velocity[DEPARTURE - 1] < 1e-5
        assert velocity[DEPARTURE] > 10 * velocity[DEPARTURE - 1]
        assert err.max() > 1e-2
