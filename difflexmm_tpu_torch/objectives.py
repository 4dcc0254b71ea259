"""Objective functions for inverse design and experiment matching
(counterpart of ``difflexmm_tpu/objectives.py``): space-time
cross-correlation on ``torch.fft``, and the k-omega spectrum of a
space-time field.

Lag convention: the full linear cross-correlation of ``a`` against ``b``
along one axis has length ``len_a + len_b - 1`` and entry ``len_b - 1 +
lag`` holds ``sum_n a[n + lag] * b[n]`` (lag 0: the signals aligned), the
layout of ``scipy.signal.correlate(a, b)``.
"""

import math
from typing import Literal, Optional, Tuple

import torch

from difflexmm_tpu_torch.ops.observables import angular_momentum, kinetic_energy  # noqa: F401


def _corr_full(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full linear cross-correlation of two real nD tensors by FFT: a
    circular correlation on a zero-padded grid of shape ``a.shape +
    b.shape - 1`` (no wrap-around aliasing), rolled so that index
    ``b.shape[d] - 1`` along each axis is the zero lag."""

    full_shape = tuple(na + nb - 1 for na, nb in zip(a.shape, b.shape))
    dims = tuple(range(a.dim()))
    spec = torch.fft.rfftn(a, full_shape, dim=dims) * torch.conj(
        torch.fft.rfftn(b, full_shape, dim=dims))
    circular = torch.fft.irfftn(spec, full_shape, dim=dims)
    return torch.roll(circular, tuple(nb - 1 for nb in b.shape), dims=dims)


def _pinned_index(n_a: int, n_b: int, lag: int, axis: int) -> int:
    """Index of a pinned ``lag`` on the full-correlation axis; lags outside
    ``[-(n_b - 1), n_a - 1]`` raise (a negative index would wrap)."""

    if not -(n_b - 1) <= lag <= n_a - 1:
        raise ValueError(
            f"shift {lag} along axis {axis} is outside the valid lag range "
            f"[{-(n_b - 1)}, {n_a - 1}] for signal lengths ({n_a}, {n_b})"
        )
    return n_b - 1 + lag


def compute_xcorr2d(signal0: torch.Tensor, signal1: torch.Tensor,
                    shift: Tuple[Optional[int], Optional[int]] = (None, None)):
    """Full 2D cross-correlation normalized by signal0's autocorrelation
    peak (through the same FFT path, so that a self-correlation peaks at
    exactly 1). ``shift`` pins the lag along either axis, which is then
    sliced out of the result."""

    corr = _corr_full(signal0, signal1) / _corr_full(signal0, signal0).max()
    index = tuple(
        slice(None) if lag is None
        else _pinned_index(signal0.shape[axis], signal1.shape[axis], lag, axis)
        for axis, lag in enumerate(shift)
    )
    return corr[index]


def compute_xcorr(signal0: torch.Tensor, signal1: torch.Tensor, shift: Optional[int] = None):
    """1D cross-correlation normalized by signal0's autocorrelation peak."""

    corr = _corr_full(signal0, signal1) / _corr_full(signal0, signal0).max()
    if shift is None:
        return corr
    return corr[_pinned_index(signal0.shape[0], signal1.shape[0], shift, 0)]


def compute_max_xcorr2d_at_shift(signal0: torch.Tensor, signal1: torch.Tensor, shift: int,
                                 shift_axis: Literal[0, 1] = 0):
    """Peak correlation and delay along the free axis at a pinned lag:
    ``(peak value, delay)``, the delay the negative of the peak's lag (a
    positive delay: ``signal1`` lags ``signal0``)."""

    free_axis = 1 - shift_axis
    pinned = (shift, None) if shift_axis == 0 else (None, shift)
    curve = compute_xcorr2d(signal0, signal1, shift=pinned)
    peak_index = curve.argmax()
    peak_lag = peak_index - (signal1.shape[free_axis] - 1)
    return curve.max(), -peak_lag


def compute_space_time_xcorr(space_time0: torch.Tensor, space_time1: torch.Tensor):
    """Largest space-aligned cross-correlation and the time delay between
    two ``(space, time)`` fields: ``(max_xcorr, time_delay)``."""

    return compute_max_xcorr2d_at_shift(space_time0, space_time1, shift=0, shift_axis=0)


def spectral_dispersion(space_time: torch.Tensor, dt: float, dx: float,
                        window: bool = True):
    """The 2D Fourier transform of a ``(n_t, n_x)`` space-time field into
    the (k, omega) plane, Hann-windowed where ``window``: ``(omegas
    (n_t // 2 + 1,), ks (n_x,) centred on zero, |FFT| (n_omega, n_k))``.
    Its ridges trace the lattice's dispersion branches."""

    f = torch.as_tensor(space_time)
    n_t, n_x = f.shape
    like = dict(dtype=f.dtype, device=f.device)
    if window:
        hann_t = 0.5 - 0.5 * torch.cos(2 * math.pi * torch.arange(n_t, **like) / (n_t - 1))
        hann_x = 0.5 - 0.5 * torch.cos(2 * math.pi * torch.arange(n_x, **like) / (n_x - 1))
        f = f * hann_t[:, None] * hann_x[None, :]
    spectrum = torch.fft.fft(torch.fft.rfft(f, dim=0), dim=1)
    amplitude = torch.abs(torch.fft.fftshift(spectrum, dim=1))
    omegas = 2 * math.pi * torch.fft.rfftfreq(n_t, d=dt, **like)
    ks = 2 * math.pi * torch.fft.fftshift(torch.fft.fftfreq(n_x, d=dx, **like))
    return omegas, ks, amplitude
