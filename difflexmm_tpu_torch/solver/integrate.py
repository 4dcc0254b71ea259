"""Fixed-step explicit integrators on the dense state (counterpart of
``difflexmm_tpu/solver/integrate.py``): classic fourth-order Runge-Kutta
and semi-implicit (symplectic) Euler, stepping ``n_substeps`` times per
output interval. Plain PyTorch, differentiated by ordinary autograd
through every step.

``method="odeint"`` (adaptive Dormand-Prince) stays the JAX package's
accuracy oracle: the port has no adaptive integrator (torchdiffeq is not
installed), so it raises.
"""

from typing import Callable

import torch


def rk4_step(rhs: Callable, y: torch.Tensor, t, dt, args) -> torch.Tensor:
    """One classic fourth-order Runge-Kutta step of ``dy/dt = rhs(y, t,
    *args)``."""

    half = dt / 2
    k1 = rhs(y, t, *args)
    k2 = rhs(y + half * k1, t + half, *args)
    k3 = rhs(y + half * k2, t + half, *args)
    k4 = rhs(y + dt * k3, t + dt, *args)
    return y + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)


def semi_implicit_euler_step(rhs: Callable, y: torch.Tensor, t, dt, args) -> torch.Tensor:
    """Symplectic (semi-implicit) Euler for a second-order system: ``y`` is
    ``(2, ...)`` (position, velocity) and ``rhs``'s first component the
    velocity. The velocity updates first; the position then moves with the
    new velocity."""

    dy = rhs(y, t, *args)
    v_new = y[1] + dt * dy[1]
    u_new = y[0] + dt * v_new
    return torch.stack([u_new, v_new])


#: Why ``method="odeint"`` raises.
ODEINT_UNAVAILABLE = (
    "method='odeint' is not ported, by design: the JAX package keeps its adaptive odeint as "
    "the accuracy oracle that the port's fixed-step methods are held against (and torchdiffeq "
    "is not installed). Use 'rk4', 'semi_implicit' or a Verlet method.")

FIXED_STEPPERS = {
    "rk4": rk4_step,
    "semi_implicit": semi_implicit_euler_step,
}


def integrate(rhs: Callable, y0: torch.Tensor, timepoints: torch.Tensor, args=(),
              method: str = "rk4", n_substeps: int = 64) -> torch.Tensor:
    """Integrate ``dy/dt = rhs(y, t, *args)`` and return the states at
    ``timepoints`` ``(T,)`` (the first is the initial time), ``(T,) +
    y0.shape`` with ``y0`` first. Interval k takes ``n_substeps`` steps of
    ``dt = (t[k+1] - t[k]) / n_substeps`` starting at ``t[k] + i dt``, as
    the JAX package's scan does."""

    if method == "odeint":
        raise NotImplementedError(ODEINT_UNAVAILABLE)
    if method not in FIXED_STEPPERS:
        raise ValueError(f"unknown fixed-step method {method!r}; one of {sorted(FIXED_STEPPERS)}")
    step = FIXED_STEPPERS[method]
    y, out = y0, [y0]
    for k in range(timepoints.shape[0] - 1):
        t0 = timepoints[k]
        dt = (timepoints[k + 1] - t0) / n_substeps
        for i in range(n_substeps):
            y = step(rhs, y, t0 + i * dt, dt, args)
        out.append(y)
    return torch.stack(out)
