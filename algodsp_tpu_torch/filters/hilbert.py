"""Polyphase IIR Hilbert transformer, analytic signal and envelope
(counterpart of `algodsp_tpu/filters/hilbert.py`).

Capability parity with `dsp/filter/hilbert/`: elliptic-quality allpass
coefficient designer with transition-bandwidth -> attenuation model
(`designer.go:18-159`, host float64, the reference's code), and the
two-path polyphase allpass processor (`hilbert64.go:283-306`): outputs
A (in-phase) and B (quadrature, ~90 degrees shifted), envelope =
hypot(A, B).

The Go per-sample chain is two interleaved allpass cascades, each
section a *first-order linear recurrence* in the half-rate domain:
    y_n = c*u_n - u_{n-1} + c*y_{n-1}   (allpass (c - z^-1)/(1 - c z^-1))
so each chain is a `BiquadChain` of first-order allpass sections
([c, -1, 0, -c, 0]) run on the even/odd deinterleaved streams. The two
streams of a chain go through it as one batch. Their poles are real
(|c| < 1), never slow complex ones, so auto dispatch runs float32 chains
on the fused CUDA cascade kernel (`csrc/biquad_cascade.cu`) on the card
and float64 ones on the blocked engine.

Chain A uses coefficients 0,2,4,... on x[n]; chain B uses 1,3,5,...
on x[n-1] (`hilbert64.go:288-300`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from algodsp_tpu_torch.filters.biquad import BiquadChain

DEFAULT_COEFFICIENT_COUNT = 8
DEFAULT_TRANSITION = 0.1


class Preset:
    """Coefficient-count/transition design profiles (`preset.go:5-45`)."""
    FAST = "fast"                       # legacy default, low cost
    BALANCED = "balanced"               # better low-mid image rejection
    LOW_FREQUENCY = "low_frequency"     # prioritizes LF quadrature


_PRESETS = {
    Preset.FAST: (8, 0.1),
    Preset.BALANCED: (12, 0.06),
    Preset.LOW_FREQUENCY: (20, 0.02),
}


def preset_config(preset: str) -> tuple[int, float]:
    """(number_of_coeffs, transition) for a preset (`preset.go:34-45`)."""
    try:
        return _PRESETS[preset]
    except KeyError:
        raise ValueError(f"hilbert: invalid preset: {preset!r}") from None


def _transition_params(transition: float) -> tuple[float, float]:
    """(k, q) elliptic modulus/nome from transition BW (`designer.go:96-105`)."""
    k = math.tan((1.0 - transition * 2.0) * math.pi * 0.25) ** 2
    kksqrt = (1.0 - k * k) ** 0.25
    e = 0.5 * (1.0 - kksqrt) / (1.0 + kksqrt)
    e4 = e ** 4
    q = e * (1.0 + e4 * (2.0 + e4 * (15.0 + 150.0 * e4)))
    return k, q


def _acc_num(q: float, order: int, c: int) -> float:
    result, i, sign = 0.0, 0, 1.0
    while True:
        term = q ** (i * (i + 1)) * math.sin((i * 2 + 1) * c * math.pi / order) * sign
        result += term
        sign = -sign
        i += 1
        if abs(term) <= 1e-100:
            return result


def _acc_den(q: float, order: int, c: int) -> float:
    result, i, sign = 0.0, 1, -1.0
    while True:
        term = q ** (i * i) * math.cos(2 * i * c * math.pi / order) * sign
        result += term
        sign = -sign
        i += 1
        if abs(term) <= 1e-100:
            return result


def design_coefficients(number_of_coeffs: int, transition: float) -> np.ndarray:
    """Polyphase Hilbert allpass coefficients (`designer.go:18-33,107-121`)."""
    if number_of_coeffs < 1:
        raise ValueError(
            f"hilbert designer needs at least one allpass coefficient pair, "
            f"got {number_of_coeffs}")
    if not (0.0 < transition < 0.5) or not math.isfinite(transition):
        raise ValueError(
            f"hilbert designer: transition bandwidth {transition} is outside "
            f"the open interval (0, 0.5) of normalized frequency")
    k, q = _transition_params(transition)
    order = number_of_coeffs * 2 + 1
    out = np.empty(number_of_coeffs)
    for i in range(number_of_coeffs):
        c = i + 1
        num = _acc_num(q, order, c) * q ** 0.25
        den = _acc_den(q, order, c) + 0.5
        ww = (num * num) / (den * den)
        r = math.sqrt((1.0 - ww * k) * (1.0 - ww / k)) / (1.0 + ww)
        out[i] = (1.0 - r) / (1.0 + r)
    return out


def attenuation_from_order_tbw(number_of_coeffs: int, transition: float) -> float:
    """Stopband attenuation model (`designer.go:36-47,102-105`)."""
    _, q = _transition_params(transition)
    order = number_of_coeffs * 2 + 1
    v = 4.0 * math.exp(order * 0.5 * math.log(q))
    return -10.0 * math.log10(v / (1.0 + v))


def _allpass_chain(coeffs: np.ndarray) -> BiquadChain:
    sos = np.stack([np.array([c, -1.0, 0.0, -c, 0.0]) for c in coeffs])
    return BiquadChain(sos)


class HilbertTransformer:
    """Analytic-signal processor (Processor64/32 equivalent)."""

    def __init__(self, number_of_coeffs: int = DEFAULT_COEFFICIENT_COUNT,
                 transition: float = DEFAULT_TRANSITION,
                 coefficients=None):
        if coefficients is not None:
            self.coeffs = np.asarray(coefficients, dtype=np.float64).reshape(-1)
            if np.any(np.abs(self.coeffs) >= 1.0) or not np.all(np.isfinite(self.coeffs)):
                raise ValueError("hilbert: coefficients must be finite with |c| < 1")
            self.transition = math.nan
            self.attenuation_db = math.nan
        else:
            self.coeffs = design_coefficients(number_of_coeffs, transition)
            self.transition = transition
            self.attenuation_db = attenuation_from_order_tbw(
                number_of_coeffs, transition)
        if self.coeffs.size < 2:
            raise ValueError("hilbert: need at least 2 coefficients (one per path)")
        self.chain_a = _allpass_chain(self.coeffs[0::2])
        self.chain_b = _allpass_chain(self.coeffs[1::2])
        # outputA comes from the second-to-last section, outputB from the
        # last (`hilbert64.go:298-300`): with the split above, A ends the
        # even-indexed chain and B the odd-indexed chain when the total
        # count is even; for odd counts A is the longer chain.
        self._a_is_even_chain = (self.coeffs.size % 2 == 0)

    @classmethod
    def from_preset(cls, preset: str) -> "HilbertTransformer":
        """Build from a named profile (`preset.go:47-63` New64Preset)."""
        n, tr = preset_config(preset)
        return cls(n, tr)

    def process(self, x):
        """x: (..., N) -> (a, b): in-phase and quadrature outputs.

        a[n] pairs with b[n]; the analytic signal is a + j*b up to the
        design's passband accuracy.
        """
        n = x.shape[-1]
        pad = n % 2
        if pad:
            x = torch.cat([x, x.new_zeros(x.shape[:-1] + (1,))], dim=-1)
        x_prev = torch.cat(  # x[n-1] stream
            [x.new_zeros(x.shape[:-1] + (1,)), x[..., :-1]], dim=-1)
        # each chain takes its two deinterleaved streams as one batch
        even_parts = self.chain_a.process(
            torch.stack([x[..., 0::2], x[..., 1::2]])).unbind(0)
        odd_parts = self.chain_b.process(
            torch.stack([x_prev[..., 0::2], x_prev[..., 1::2]])).unbind(0)
        if self._a_is_even_chain:
            # even count: chain ending at index last-1 is the even chain
            a_parts, b_parts = even_parts, odd_parts
        else:
            # odd count: the even-indexed chain ends at `last` -> output B
            a_parts, b_parts = odd_parts, even_parts

        def interleave(even, odd):
            stacked = torch.stack([even, odd], dim=-1)
            return stacked.reshape(stacked.shape[:-2] + (-1,))

        a = interleave(*a_parts)
        b = interleave(*b_parts)
        if pad:
            a = a[..., :n]
            b = b[..., :n]
        return a, b

    def envelope(self, x):
        """Analytic magnitude hypot(a, b) (`hilbert64.go:130-134`)."""
        a, b = self.process(x)
        return torch.sqrt(a * a + b * b)
