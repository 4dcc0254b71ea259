"""Angle-based contact barrier (counterpart of ``contact_energy`` in
``difflexmm_tpu/ops/contact.py``)."""

import torch


def contact_energy(current_void_angles: torch.Tensor, min_angle, cutoff_angle, k_contact):
    """C^1 ~1/x barrier with asymptote at min_angle, zero beyond cutoff.

    With x = (phi - cutoff)/(cutoff - min): E = k/4 (cutoff-min)^2
    (1/(x+1) - 1/(x-1) - 2) on [min, cutoff), else 0.

    x is clamped to the active window before the reciprocals, with a margin
    of 64 machine epsilons of the compute dtype: a fixed margin such as
    1e-12 rounds away in float32, and a void angle at or below min_angle
    would then divide by zero and poison the gradient with 0 * inf.
    """

    span = cutoff_angle - min_angle
    x = (current_void_angles - cutoff_angle) / span
    eps = torch.finfo(x.dtype).eps
    x_safe = torch.clamp(x, -1.0 + 64.0 * eps, 0.0)
    barrier = k_contact / 4 * span**2 * (
        1.0 / (x_safe + 1.0) - 1.0 / (x_safe - 1.0) - 2.0
    )
    active = (current_void_angles >= min_angle) & (current_void_angles < cutoff_angle)
    return torch.where(active, barrier, torch.zeros_like(barrier))
