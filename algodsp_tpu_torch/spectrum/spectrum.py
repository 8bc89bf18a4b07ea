"""Spectrum extraction utilities (counterpart of
`algodsp_tpu/spectrum/spectrum.py`).

Capability parity with `dsp/spectrum/spectrum.go`: magnitude / power /
phase from complex bins, phase unwrapping (`spectrum.go:180-205`), group
delay from unwrapped phase (`:209-260`), piecewise-linear curve
resampling (`:264-303`), and 1/N-fractional-octave smoothing
(`:305-350`).

All functions are elementwise tensor ops over the *last* axis on the
input's device, broadcasting over leading channel/batch dims.
`unwrap_phase` accumulates the jump corrections with one cumulative
sum; `smooth_fractional_octave` turns the per-bin band averaging into
prefix sums and two `searchsorted` lookups.
"""

from __future__ import annotations

import math

import torch


def magnitude(bins):
    """|X[k]| per complex bin (`spectrum.go:70-90`)."""
    return torch.abs(bins)


def magnitude_from_parts(re, im):
    """sqrt(re^2 + im^2) fast path (`spectrum.go:93-101`)."""
    return torch.sqrt(re * re + im * im)


def power(bins):
    """|X[k]|^2 per complex bin (`spectrum.go:113-133`)."""
    if bins.is_complex():
        return bins.real ** 2 + bins.imag ** 2
    return bins ** 2


def power_from_parts(re, im):
    """re^2 + im^2 fast path (`spectrum.go:139-143`)."""
    return re * re + im * im


def phase(bins):
    """arg(X[k]) in radians (`spectrum.go:160-175`)."""
    return torch.angle(bins)


def unwrap_phase(ph):
    """Remove +-2 pi discontinuities along the last axis
    (`spectrum.go:180-205`): the per-step jump corrections, computed
    elementwise, accumulated by a cumulative sum."""
    if ph.shape[-1] == 0:
        return ph
    d = torch.diff(ph, dim=-1)
    two_pi = 2.0 * math.pi
    zero = torch.zeros_like(d)
    step = torch.where(d > math.pi, zero - two_pi,
                       torch.where(d < -math.pi, zero + two_pi, zero))
    offset = torch.cumsum(step, dim=-1)
    return ph + torch.cat([ph.new_zeros(ph.shape[:-1] + (1,)), offset], dim=-1)


def group_delay_from_phase(unwrapped, fft_size: int):
    """Group delay in samples from unwrapped phase (`spectrum.go:209-248`).

    Centered differences for interior bins, one-sided at the endpoints.
    """
    u = unwrapped
    if u.shape[-1] < 2:
        raise ValueError(f"group delay requires at least 2 phase points: {u.shape[-1]}")
    if fft_size <= 0:
        raise ValueError(f"group delay fft_size must be > 0: {fft_size}")
    dw = 2.0 * math.pi / fft_size
    first = u[..., 1:2] - u[..., 0:1]
    last = u[..., -1:] - u[..., -2:-1]
    mid = (u[..., 2:] - u[..., :-2]) / 2.0
    dphi = torch.cat([first, mid, last], dim=-1)
    return -dphi / dw


def group_delay_seconds(unwrapped, fft_size: int, sample_rate: float):
    """Group delay in seconds (`spectrum.go:251-263`)."""
    if sample_rate <= 0:
        raise ValueError(f"sample_rate must be > 0: {sample_rate}")
    return group_delay_from_phase(unwrapped, fft_size) / sample_rate


def interpolate_linear(x, y, query_x):
    """Piecewise-linear interpolation with edge clamping
    (`spectrum.go:266-303`), over 1-D knots x (ascending) and values y,
    with the reference's formula (`jnp.interp`'s)."""
    if x.shape[-1] != y.shape[-1]:
        raise ValueError(f"x/y length mismatch: {x.shape[-1]} != {y.shape[-1]}")
    q = torch.as_tensor(query_x, dtype=x.dtype, device=x.device)
    i = torch.clamp(torch.searchsorted(x, q, right=True), 1, x.shape[-1] - 1)
    df = y[i] - y[i - 1]
    dx = x[i] - x[i - 1]
    delta = q - x[i - 1]
    dx0 = torch.abs(dx) <= torch.finfo(x.dtype).eps * torch.finfo(x.dtype).eps
    f = torch.where(dx0, y[i - 1],
                    y[i - 1] + (delta / torch.where(dx0, torch.ones_like(dx),
                                                    dx)) * df)
    f = torch.where(q < x[0], y[0], f)
    return torch.where(q > x[-1], y[-1], f)


def smooth_fractional_octave(freq_hz, values, fraction: int):
    """1/N-octave arithmetic-mean smoothing (`spectrum.go:305-350`).

    For each bin i with frequency f, averages values over bins whose
    frequency lies in [f/2^(1/2N), f*2^(1/2N)] (inclusive low edge,
    inclusive high edge, matching the Go sort.Search conditions).
    """
    f, v = freq_hz, values
    if f.shape[-1] != v.shape[-1]:
        raise ValueError(f"length mismatch: {f.shape[-1]} != {v.shape[-1]}")
    if fraction <= 0:
        raise ValueError(f"fraction must be > 0: {fraction}")
    half_band = 2.0 ** (1.0 / (2.0 * fraction))
    lo = f / half_band
    hi = f * half_band
    # i0 = first index with freq >= lo ; i1 = first index with freq > hi.
    i0 = torch.searchsorted(f, lo, right=False)
    i1 = torch.searchsorted(f, hi, right=True)
    csum = torch.cat([v.new_zeros(v.shape[:-1] + (1,)),
                      torch.cumsum(v, dim=-1)], dim=-1)
    count = i1 - i0
    band_sum = (torch.index_select(csum, -1, i1)
                - torch.index_select(csum, -1, i0))
    safe = torch.clamp(count, min=1).to(v.dtype)
    return torch.where(count > 0, band_sum / safe, v)
