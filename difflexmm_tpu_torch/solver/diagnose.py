"""Trajectory health diagnostics (counterpart of
``difflexmm_tpu/solver/diagnose.py``): locate blow-ups and explain them.

The fixed-step path's one numerical hazard is contact-barrier tunneling:
a strong pulse slams a void shut, a block rotates a large fraction of the
barrier window in one substep, and the substep lands next to the
barrier's 1/x asymptote (inf forces, NaN state) or crosses it. These
helpers find the first non-finite output and report which intervals
rotated blocks fast enough, relative to the window, to be at risk. Pure
post-processing of a ``(T, 2, n_blocks, 3)`` solution.
"""

from typing import NamedTuple, Optional

import torch


class TunnelingReport(NamedTuple):
    """Per-trajectory contact-tunneling risk summary.

    Attributes:
        first_nonfinite: index of the first output timepoint with a
            non-finite field value, or ``None`` for a finite solution.
        max_rotation_per_substep: (T-1,) largest |dtheta| of any block in
            one substep of each output interval (from the larger of the
            interval's two endpoint angular velocities).
        window_fraction: (T-1,) ``max_rotation_per_substep`` over the
            barrier window ``cutoff_angle - min_angle``; non-finite
            endpoints give inf. A spike confined to an interval's interior
            can be missed (endpoint sampling).
        risky_intervals: (T-1,) bool, ``window_fraction >= threshold``.
    """

    first_nonfinite: Optional[int]
    max_rotation_per_substep: torch.Tensor
    window_fraction: torch.Tensor
    risky_intervals: torch.Tensor


def first_nonfinite_timepoint(solution: torch.Tensor) -> Optional[int]:
    """Index of the first output timepoint of a ``(T, 2, n_blocks, 3)``
    solution whose fields are not all finite, or ``None``."""

    bad = ~torch.isfinite(solution).reshape(solution.shape[0], -1).all(dim=1)
    if not bool(bad.any()):
        return None
    return int(torch.argmax(bad.to(torch.uint8)))


def contact_tunneling_report(
    solution: torch.Tensor,
    timepoints: torch.Tensor,
    n_substeps: int,
    min_angle: float,
    cutoff_angle: float,
    threshold: float = 0.5,
) -> TunnelingReport:
    """Flag the output intervals where fixed-step integration can tunnel
    through the contact barrier ``(min_angle, cutoff_angle)``: those where
    a block rotates at least ``threshold`` of the window in one substep,
    estimated from the solved angular velocities at the interval's
    endpoints (non-finite endpoints always flag). For protection inside
    the loop use the solver's ``guard``."""

    window = float(cutoff_angle) - float(min_angle)
    if window <= 0:
        raise ValueError(
            f"cutoff_angle ({cutoff_angle}) must exceed min_angle "
            f"({min_angle}); got a non-positive barrier window."
        )
    solution = torch.as_tensor(solution)
    timepoints = torch.as_tensor(timepoints, dtype=torch.float64, device=solution.device)
    dt = torch.diff(timepoints) / n_substeps  # (T-1,) substep lengths

    omega = torch.abs(solution[:, 1, :, 2])  # (T, n_blocks)
    omega = torch.nan_to_num(omega, nan=float("inf"), posinf=float("inf"))
    omega_iv = torch.maximum(omega[:-1], omega[1:]).amax(dim=1)  # (T-1,)

    per_substep = omega_iv * dt
    frac = per_substep / window
    return TunnelingReport(
        first_nonfinite=first_nonfinite_timepoint(solution),
        max_rotation_per_substep=per_substep,
        window_fraction=frac,
        risky_intervals=frac >= threshold,
    )
