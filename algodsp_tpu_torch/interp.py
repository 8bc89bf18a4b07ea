"""Fractional-sample interpolation kernels (counterpart of
`algodsp_tpu/interp.py`).

Capability parity with `dsp/interp/interp.go`: Linear2, Hermite4,
Lagrange4, LanczosN/Lanczos6, SincInterp (Blackman-windowed), the
Thiran first-order allpass coefficient, and the mode enum.

Every kernel is an elementwise PyTorch expression over broadcastable
tensors: `t` and each sample point may be Python numbers or tensors.
Gather-based users (`delayline.py`) assemble the sample points with one
vectorized gather.
"""

from __future__ import annotations

import enum
import math

import torch


class Mode(enum.Enum):
    LINEAR = "linear"
    HERMITE = "hermite"
    LAGRANGE3 = "lagrange3"
    LANCZOS3 = "lanczos3"
    SINC = "sinc"
    ALLPASS = "allpass"


def linear2(t, x0, x1):
    """2-point linear interpolation (`interp.go:44-46`)."""
    return x0 + t * (x1 - x0)


def hermite4(t, xm1, x0, x1, x2):
    """4-point cubic Hermite (Catmull-Rom style) (`interp.go:51-59`)."""
    c0 = x0
    c1 = 0.5 * (x1 - xm1)
    c2 = xm1 - 2.5 * x0 + 2.0 * x1 - 0.5 * x2
    c3 = 0.5 * (x2 - xm1) + 1.5 * (x0 - x1)
    return ((c3 * t + c2) * t + c1) * t + c0


def lagrange4(t, xm1, x0, x1, x2):
    """4-point 3rd-order Lagrange (`interp.go:63-75`)."""
    d0 = t
    d1 = t - 1.0
    d2 = t + 1.0
    l0 = -d0 * d1 * (t - 2.0) / 6.0
    l1 = d2 * d1 * (t - 2.0) / 2.0
    l2 = -d2 * d0 * (t - 2.0) / 2.0
    l3 = d2 * d0 * d1 / 6.0
    return l0 * xm1 + l1 * x0 + l2 * x1 + l3 * x2


def sinc_normalized(x):
    px = math.pi * x
    zero = x == 0
    safe = torch.where(zero, torch.ones_like(px), px)
    return torch.where(zero, torch.ones_like(px), torch.sin(safe) / safe)


def lanczos_window(x, a: int):
    inside = torch.logical_and(x > -a, x < a)
    return torch.where(inside, sinc_normalized(x / a), torch.zeros_like(x))


def _normalized_sum(w, samples):
    wsum = torch.sum(w, dim=-1)
    out = torch.sum(w * samples, dim=-1)
    zero = wsum == 0
    return torch.where(zero, torch.zeros_like(out),
                       out / torch.where(zero, torch.ones_like(wsum), wsum))


def _as_tensor_like(t, samples):
    return torch.as_tensor(t, dtype=samples.dtype, device=samples.device)


def lanczos_n(t, samples, a: int):
    """Lanczos windowed-sinc over 2a points (`interp.go:104-122`).

    samples: (..., 2a) stacked on the last axis; samples[..., a-1] and
    samples[..., a] bracket t.
    """
    t = _as_tensor_like(t, samples)[..., None]
    i = torch.arange(2 * a, device=samples.device)
    d = (i - (a - 1)) - t
    w = sinc_normalized(d) * lanczos_window(d, a)
    return _normalized_sum(w, samples)


def lanczos6(t, samples):
    """Lanczos a=3 over 6 points (`interp.go:124-126`)."""
    return lanczos_n(t, samples, 3)


def sinc_interp(t, samples, n: int):
    """Blackman-windowed sinc over 2n points (`interp.go:134-155`)."""
    t = _as_tensor_like(t, samples)[..., None]
    taps = 2 * n
    i = torch.arange(taps, device=samples.device)
    d = (i - (n - 1)) - t
    wn = (i + (1.0 - t)) / taps
    bw = (0.42 - 0.5 * torch.cos(2 * math.pi * wn)
          + 0.08 * torch.cos(4 * math.pi * wn))
    w = sinc_normalized(d) * bw
    return _normalized_sum(w, samples)


def allpass_coeff(t):
    """Thiran first-order allpass coefficient (`interp.go:163-165`)."""
    return (1.0 - t) / (1.0 + t)


def allpass_tick(t, x0, x1, state):
    """One allpass interpolation step; returns (out, new_state)
    (`interp.go:171-177`)."""
    eta = allpass_coeff(t)
    out = x1 + eta * (x0 - state)
    return out, out


def points_needed(mode: Mode, sinc_half_width: int = 8) -> tuple[int, int]:
    """(points_before_bracket, total_points) for each mode: how many
    integer sample points around the bracket the mode consumes."""
    if mode == Mode.LINEAR or mode == Mode.ALLPASS:
        return 0, 2
    if mode in (Mode.HERMITE, Mode.LAGRANGE3):
        return 1, 4
    if mode == Mode.LANCZOS3:
        return 2, 6
    if mode == Mode.SINC:
        return sinc_half_width - 1, 2 * sinc_half_width
    raise ValueError(f"unknown mode {mode}")


class LagrangeInterpolator:
    """Configurable-order fractional interpolator (the legacy wrapper,
    `interp.go:188-228`): order 1 = linear over samples[0:2]; order 3 =
    4-point Hermite-style over samples[0:4] (bracket samples[1:3]);
    other orders fall back to linear, matching the reference."""

    def __init__(self, order: int = 3):
        self.order = order

    def interpolate(self, samples, frac):
        samples = torch.as_tensor(samples)
        n = samples.shape[-1]
        if n == 0:
            raise ValueError("interp: empty samples")
        if self.order == 3 and n >= 4:
            return hermite4(frac, samples[..., 0], samples[..., 1],
                            samples[..., 2], samples[..., 3])
        if n < 2:
            return samples[..., 0]
        return linear2(frac, samples[..., 0], samples[..., 1])
