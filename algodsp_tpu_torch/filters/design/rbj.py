"""RBJ cookbook biquad designers (host-side float64).

Capability parity with `dsp/filter/design/design.go:37-225` and
`pass/butterworth.go:57-123`: Lowpass/Highpass/Bandpass/Notch/Allpass/
Peak/LowShelf/HighShelf from the Robert Bristow-Johnson Audio EQ
Cookbook, with the reference's edge-case conventions: invalid
frequency/sample-rate → zero coefficients; q <= 0 → Q = 1/sqrt(2)
(`design.go:192-211`).

All designers return a (5,) float64 array [b0, b1, b2, a1, a2]
(a0 normalized), composable into (S, 5) SOS arrays.
"""

from __future__ import annotations

import math

import numpy as np

DEFAULT_Q = 1.0 / math.sqrt(2.0)

_ZERO = np.zeros(5, dtype=np.float64)


def _w0(freq: float, sample_rate: float):
    if (sample_rate <= 0 or not math.isfinite(sample_rate)
            or freq <= 0 or freq >= sample_rate / 2 or not math.isfinite(freq)):
        return None
    return 2.0 * math.pi * freq / sample_rate


def _q_or_default(q: float) -> float:
    if q <= 0 or not math.isfinite(q):
        return DEFAULT_Q
    return q


def _normalize(b0, b1, b2, a0, a1, a2) -> np.ndarray:
    if a0 == 0 or not math.isfinite(a0):
        return _ZERO.copy()
    return np.array([b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0],
                    dtype=np.float64)


def bilinear_transform(s_coeffs, sample_rate: float) -> np.ndarray:
    """Analog 2nd-order polynomial c0 s^2 + c1 s + c2 → digital
    (1, d1, d2) via the bilinear transform (`design.go:17-34`)."""
    if sample_rate <= 0:
        return np.array([1.0, 0.0, 0.0])
    c0, c1, c2 = (float(v) for v in s_coeffs)
    k = 2.0 * sample_rate
    d0 = c0 * k * k + c1 * k + c2
    d1 = -2.0 * c0 * k * k + 2.0 * c2
    d2 = c0 * k * k - c1 * k + c2
    if d0 == 0 or not math.isfinite(d0):
        return np.array([1.0, 0.0, 0.0])
    return np.array([1.0, d1 / d0, d2 / d0])


def lowpass(freq: float, q: float, sample_rate: float) -> np.ndarray:
    """RBJ lowpass (`pass/butterworth.go:57-90`)."""
    w0 = _w0(freq, sample_rate)
    if w0 is None:
        return _ZERO.copy()
    q = _q_or_default(q)
    cw, sw = math.cos(w0), math.sin(w0)
    alpha = sw / (2.0 * q)
    return _normalize((1 - cw) / 2, 1 - cw, (1 - cw) / 2,
                      1 + alpha, -2 * cw, 1 - alpha)


def highpass(freq: float, q: float, sample_rate: float) -> np.ndarray:
    """RBJ highpass (`pass/butterworth.go:92-123`)."""
    w0 = _w0(freq, sample_rate)
    if w0 is None:
        return _ZERO.copy()
    q = _q_or_default(q)
    cw, sw = math.cos(w0), math.sin(w0)
    alpha = sw / (2.0 * q)
    return _normalize((1 + cw) / 2, -(1 + cw), (1 + cw) / 2,
                      1 + alpha, -2 * cw, 1 - alpha)


def bandpass(freq: float, q: float, sample_rate: float) -> np.ndarray:
    """RBJ constant-skirt bandpass (`design.go:49-69`)."""
    w0 = _w0(freq, sample_rate)
    if w0 is None:
        return _ZERO.copy()
    q = _q_or_default(q)
    cw, sw = math.cos(w0), math.sin(w0)
    alpha = sw / (2.0 * q)
    return _normalize(sw / 2, 0.0, -sw / 2, 1 + alpha, -2 * cw, 1 - alpha)


def notch(freq: float, q: float, sample_rate: float) -> np.ndarray:
    """RBJ notch (`design.go:72-90`)."""
    w0 = _w0(freq, sample_rate)
    if w0 is None:
        return _ZERO.copy()
    q = _q_or_default(q)
    cw, sw = math.cos(w0), math.sin(w0)
    alpha = sw / (2.0 * q)
    return _normalize(1.0, -2 * cw, 1.0, 1 + alpha, -2 * cw, 1 - alpha)


def allpass(freq: float, q: float, sample_rate: float) -> np.ndarray:
    """RBJ allpass (`design.go:93-112`)."""
    w0 = _w0(freq, sample_rate)
    if w0 is None:
        return _ZERO.copy()
    q = _q_or_default(q)
    cw, sw = math.cos(w0), math.sin(w0)
    alpha = sw / (2.0 * q)
    return _normalize(1 - alpha, -2 * cw, 1 + alpha,
                      1 + alpha, -2 * cw, 1 - alpha)


def peak(freq: float, gain_db: float, q: float, sample_rate: float,
         *, dc_gain_db: float | None = None,
         nyquist_gain_db: float | None = None,
         band_edge_gain_db: float | None = None) -> np.ndarray:
    """Peaking EQ. Plain RBJ by default (`design.go:122-142`); passing
    dc/nyquist/band-edge gains activates the Orfanidis prescribed-gain
    design with silent fallback to RBJ when constraints can't be met
    (`design.go:112-120`, `peak_orfanidis.go`)."""
    if dc_gain_db is not None or nyquist_gain_db is not None \
            or band_edge_gain_db is not None:
        from algodsp_tpu_torch.filters.design.orfanidis import peak_orfanidis
        out = peak_orfanidis(freq, gain_db, q, sample_rate,
                             dc_gain_db=dc_gain_db,
                             nyquist_gain_db=nyquist_gain_db,
                             band_edge_gain_db=band_edge_gain_db)
        if out is not None:
            return out
    w0 = _w0(freq, sample_rate)
    if w0 is None:
        return _ZERO.copy()
    q = _q_or_default(q)
    cw, sw = math.cos(w0), math.sin(w0)
    alpha = sw / (2.0 * q)
    a = 10.0 ** (gain_db / 40.0)
    return _normalize(1 + alpha * a, -2 * cw, 1 - alpha * a,
                      1 + alpha / a, -2 * cw, 1 - alpha / a)


def low_shelf(freq: float, gain_db: float, q: float, sample_rate: float) -> np.ndarray:
    """RBJ low shelf (`design.go:145-169`)."""
    w0 = _w0(freq, sample_rate)
    if w0 is None:
        return _ZERO.copy()
    q = _q_or_default(q)
    cw, sw = math.cos(w0), math.sin(w0)
    alpha = sw / (2.0 * q)
    a = 10.0 ** (gain_db / 40.0)
    beta = 2.0 * math.sqrt(a) * alpha
    return _normalize(
        a * ((a + 1) - (a - 1) * cw + beta),
        2 * a * ((a - 1) - (a + 1) * cw),
        a * ((a + 1) - (a - 1) * cw - beta),
        (a + 1) + (a - 1) * cw + beta,
        -2 * ((a - 1) + (a + 1) * cw),
        (a + 1) + (a - 1) * cw - beta)


def high_shelf(freq: float, gain_db: float, q: float, sample_rate: float) -> np.ndarray:
    """RBJ high shelf (`design.go:172-196`)."""
    w0 = _w0(freq, sample_rate)
    if w0 is None:
        return _ZERO.copy()
    q = _q_or_default(q)
    cw, sw = math.cos(w0), math.sin(w0)
    alpha = sw / (2.0 * q)
    a = 10.0 ** (gain_db / 40.0)
    beta = 2.0 * math.sqrt(a) * alpha
    return _normalize(
        a * ((a + 1) + (a - 1) * cw + beta),
        -2 * a * ((a - 1) + (a + 1) * cw),
        a * ((a + 1) + (a - 1) * cw - beta),
        (a + 1) - (a - 1) * cw + beta,
        2 * ((a - 1) - (a + 1) * cw),
        (a + 1) - (a - 1) * cw - beta)
