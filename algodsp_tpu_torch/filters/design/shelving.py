"""High-order shelving filter designers.

Capability parity with `dsp/filter/design/shelving/`: Butterworth /
Chebyshev I / Chebyshev II low & high shelf (`butterworth.go:9-46`,
`chebyshev1.go:9-53`, `chebyshev2.go:9-67`, `lowshelf.go`): analog
shelf prototype with numerator poles scaled by P = G^(1/order),
bilinear transform at K = tan(pi f/sr) (high shelf: 1/tan with odd-power
negation), Chebyshev II realized as gain-shifted Butterworth with
boost/cut inversion.

gain_db == 0 returns a single passthrough section.
"""

from __future__ import annotations

import math

import numpy as np

_LN10_OVER_20 = math.log(10.0) / 20.0


class ShelvingParamError(ValueError):
    pass


def _db2lin(db: float) -> float:
    return math.exp(db * _LN10_OVER_20)


def _validate(sample_rate: float, freq: float, order: int):
    if sample_rate <= 0 or freq <= 0 or order < 1:
        raise ShelvingParamError("invalid parameters")
    if freq >= sample_rate * 0.5:
        raise ShelvingParamError("frequency above Nyquist")


def _passthrough() -> np.ndarray:
    return np.array([[1.0, 0.0, 0.0, 0.0, 0.0]])


def _bilinear_sos(K, den_sigma, den_r2, num_sigma, num_r2) -> np.ndarray:
    K2 = K * K
    D = 1.0 + 2.0 * K * den_sigma + K2 * den_r2
    return np.array([
        (1.0 + 2.0 * K * num_sigma + K2 * num_r2) / D,
        (2.0 * K2 * num_r2 - 2.0) / D,
        (1.0 - 2.0 * K * num_sigma + K2 * num_r2) / D,
        (2.0 * K2 * den_r2 - 2.0) / D,
        (1.0 - 2.0 * K * den_sigma + K2 * den_r2) / D])


def _bilinear_fos(K, den_sigma, num_sigma) -> np.ndarray:
    Kd, Kn = K * den_sigma, K * num_sigma
    D = 1.0 + Kd
    return np.array([(1.0 + Kn) / D, (Kn - 1.0) / D, 0.0, (Kd - 1.0) / D, 0.0])


def _butterworth_poles(order: int):
    pairs = []
    for m in range(1, order // 2 + 1):
        cm = math.cos((0.5 - (2.0 * m - 1.0) / (2.0 * order)) * math.pi)
        pairs.append((cm, 1.0))
    real_sigma = 1.0 if order % 2 == 1 else 0.0
    return pairs, real_sigma


def _chebyshev1_poles(order: int, ripple_db: float):
    eps = math.sqrt(10.0 ** (ripple_db / 10.0) - 1.0)
    v0 = math.asinh(1.0 / eps) / order
    sh, ch = math.sinh(v0), math.cosh(v0)
    pairs = []
    for m in range(1, order // 2 + 1):
        theta = (2 * m - 1) / (2.0 * order) * math.pi
        s = sh * math.sin(theta)
        w = ch * math.cos(theta)
        pairs.append((s, s * s + w * w))
    real_sigma = sh if order % 2 == 1 else 0.0
    return pairs, real_sigma


def _low_shelf_sections(K, P, pairs, real_sigma) -> np.ndarray:
    rows = [_bilinear_sos(K, s, r2, P * s, P * P * r2) for s, r2 in pairs]
    if real_sigma > 0:
        rows.append(_bilinear_fos(K, real_sigma, P * real_sigma))
    return np.stack(rows)


def _negate_odd_powers(sos: np.ndarray) -> np.ndarray:
    sos = sos.copy()
    sos[:, 1] = -sos[:, 1]
    sos[:, 3] = -sos[:, 3]
    return sos


def _invert_sections(sos: np.ndarray) -> np.ndarray:
    """1/H(z) per section (`common.go` invertSections)."""
    out = np.empty_like(sos)
    for i, (b0, b1, b2, a1, a2) in enumerate(sos):
        if b0 == 0 or not math.isfinite(b0):
            raise ShelvingParamError("non-invertible section")
        inv = 1.0 / b0
        out[i] = [inv, a1 * inv, a2 * inv, b1 * inv, b2 * inv]
    return out


def butterworth_low_shelf(sample_rate: float, freq_hz: float, gain_db: float,
                          order: int) -> np.ndarray:
    """Butterworth low shelf (`shelving/butterworth.go:9-26`)."""
    _validate(sample_rate, freq_hz, order)
    if gain_db == 0:
        return _passthrough()
    P = _db2lin(gain_db) ** (1.0 / order)
    K = math.tan(math.pi * freq_hz / sample_rate)
    return _low_shelf_sections(K, P, *_butterworth_poles(order))


def butterworth_high_shelf(sample_rate: float, freq_hz: float, gain_db: float,
                           order: int) -> np.ndarray:
    """Butterworth high shelf (`shelving/butterworth.go:28-46`)."""
    _validate(sample_rate, freq_hz, order)
    if gain_db == 0:
        return _passthrough()
    P = _db2lin(gain_db) ** (1.0 / order)
    K = 1.0 / math.tan(math.pi * freq_hz / sample_rate)
    return _negate_odd_powers(_low_shelf_sections(K, P, *_butterworth_poles(order)))


def chebyshev1_low_shelf(sample_rate: float, freq_hz: float, gain_db: float,
                         ripple_db: float, order: int) -> np.ndarray:
    """Chebyshev I low shelf (`shelving/chebyshev1.go:9-29`)."""
    _validate(sample_rate, freq_hz, order)
    if ripple_db <= 0:
        raise ShelvingParamError("ripple must be > 0")
    if gain_db == 0:
        return _passthrough()
    P = _db2lin(gain_db) ** (1.0 / order)
    K = math.tan(math.pi * freq_hz / sample_rate)
    return _low_shelf_sections(K, P, *_chebyshev1_poles(order, ripple_db))


def chebyshev1_high_shelf(sample_rate: float, freq_hz: float, gain_db: float,
                          ripple_db: float, order: int) -> np.ndarray:
    """Chebyshev I high shelf (`shelving/chebyshev1.go:31-53`)."""
    _validate(sample_rate, freq_hz, order)
    if ripple_db <= 0:
        raise ShelvingParamError("ripple must be > 0")
    if gain_db == 0:
        return _passthrough()
    P = _db2lin(gain_db) ** (1.0 / order)
    K = 1.0 / math.tan(math.pi * freq_hz / sample_rate)
    return _negate_odd_powers(
        _low_shelf_sections(K, P, *_chebyshev1_poles(order, ripple_db)))


def chebyshev2_low_shelf(sample_rate: float, freq_hz: float, gain_db: float,
                         stopband_db: float, order: int) -> np.ndarray:
    """Chebyshev II low shelf: gain-shifted Butterworth, inverted for cut
    (`shelving/chebyshev2.go:9-37`)."""
    _validate(sample_rate, freq_hz, order)
    if stopband_db <= 0:
        raise ShelvingParamError("stopband must be > 0")
    if gain_db == 0:
        return _passthrough()
    if abs(stopband_db) >= abs(gain_db):
        raise ShelvingParamError("stopband must be smaller than gain")
    if gain_db > 0:
        return butterworth_low_shelf(sample_rate, freq_hz, gain_db - stopband_db, order)
    boost = butterworth_low_shelf(sample_rate, freq_hz, -gain_db - stopband_db, order)
    return _invert_sections(boost)


def chebyshev2_high_shelf(sample_rate: float, freq_hz: float, gain_db: float,
                          stopband_db: float, order: int) -> np.ndarray:
    """Chebyshev II high shelf (`shelving/chebyshev2.go:39-67`)."""
    _validate(sample_rate, freq_hz, order)
    if stopband_db <= 0:
        raise ShelvingParamError("stopband must be > 0")
    if gain_db == 0:
        return _passthrough()
    if abs(stopband_db) >= abs(gain_db):
        raise ShelvingParamError("stopband must be smaller than gain")
    if gain_db > 0:
        return butterworth_high_shelf(sample_rate, freq_hz, gain_db - stopband_db, order)
    boost = butterworth_high_shelf(sample_rate, freq_hz, -gain_db - stopband_db, order)
    return _invert_sections(boost)
