"""High-order band boost/cut EQ designers (Orfanidis parametric EQ).

Capability parity with `dsp/filter/design/band/`: ButterworthBand
(`butterworth_band.go:13-99`), Chebyshev1Band (`chebyshev1_band.go`),
Chebyshev2Band (`chebyshev2_band.go`), EllipticBand (`elliptic_band.go`
+ `elliptic.go`) — analog band prototypes mapped to 4th-order digital
sections via the cos(w0) bandpass bilinear transform, then factored
into biquad pairs with `utils.polyroot`.

gain_db == 0 returns a single passthrough section, as in the reference.
"""

from __future__ import annotations

import math

import numpy as np

from algodsp_tpu_torch.utils import ellipticmath as em
from algodsp_tpu_torch.utils.polyroot import split_fourth_order, DegeneratePolynomialError


class BandParamError(ValueError):
    pass


_LN10_OVER_20 = math.log(10.0) / 20.0


def _db2lin(db: float) -> float:
    return math.exp(db * _LN10_OVER_20)


def _passthrough() -> np.ndarray:
    return np.array([[1.0, 0.0, 0.0, 0.0, 0.0]])


def _band_params(sample_rate, f0, bw, order):
    """Validate and convert to rad/sample (`band/common.go:14-42`)."""
    if sample_rate <= 0 or f0 <= 0 or bw <= 0:
        raise BandParamError("invalid parameters")
    if f0 >= sample_rate * 0.5:
        raise BandParamError("center frequency above Nyquist")
    if order <= 2 or order % 2 != 0:
        raise BandParamError("order must be even and > 2")
    fl, fh = f0 - bw * 0.5, f0 + bw * 0.5
    if fl <= 0 or fh >= sample_rate * 0.5:
        raise BandParamError("band extends out of range")
    w0 = 2.0 * math.pi * f0 / sample_rate
    wb = 2.0 * math.pi * bw / sample_rate
    if not (0 < w0 < math.pi and 0 < wb < math.pi):
        raise BandParamError("invalid band parameters")
    return w0, wb


def _fourth_order_rows(B, A) -> np.ndarray:
    try:
        return split_fourth_order(B, A)
    except DegeneratePolynomialError as e:
        raise BandParamError(str(e)) from e


def butterworth_band(sample_rate: float, f0_hz: float, bandwidth_hz: float,
                     gain_db: float, order: int) -> np.ndarray:
    """Butterworth band boost/cut (`butterworth_band.go:13-99`)."""
    if gain_db == 0:
        return _passthrough()
    w0, wb = _band_params(sample_rate, f0_hz, bandwidth_hz, order)
    if gain_db < -3:
        gb_db = gain_db + 3
    elif gain_db < 3:
        gb_db = gain_db / math.sqrt(2.0)
    else:
        gb_db = gain_db - 3
    G0, G, Gb = 1.0, _db2lin(gain_db), _db2lin(gb_db)
    if Gb * Gb == G0 * G0:
        raise BandParamError("degenerate bandwidth gain")
    e = math.sqrt((G * G - Gb * Gb) / (Gb * Gb - G0 * G0))
    g = G ** (1.0 / order)
    g0 = G0 ** (1.0 / order)
    beta = e ** (-1.0 / order) * math.tan(wb / 2.0)
    c0 = math.cos(w0)
    rows = []
    for i in range(1, order // 2 + 1):
        ui = (2.0 * i - 1.0) / order
        si = math.sin(math.pi * ui * 0.5)
        Di = beta * beta + 2 * si * beta + 1
        if Di == 0:
            raise BandParamError("degenerate section")
        B = [(g * g * beta * beta + 2 * g * g0 * si * beta + g0 * g0) / Di,
             -4 * c0 * (g0 * g0 + g * g0 * si * beta) / Di,
             2 * (g0 * g0 * (1 + 2 * c0 * c0) - g * g * beta * beta) / Di,
             -4 * c0 * (g0 * g0 - g * g0 * si * beta) / Di,
             (g * g * beta * beta - 2 * g * g0 * si * beta + g0 * g0) / Di]
        A = [1.0,
             -4 * c0 * (1 + si * beta) / Di,
             2 * (1 + 2 * c0 * c0 - beta * beta) / Di,
             -4 * c0 * (1 - si * beta) / Di,
             (beta * beta - 2 * si * beta + 1) / Di]
        rows.append(_fourth_order_rows(B, A))
    return np.concatenate(rows)


def chebyshev1_band(sample_rate: float, f0_hz: float, bandwidth_hz: float,
                    gain_db: float, order: int) -> np.ndarray:
    """Chebyshev I band boost/cut (`chebyshev1_band.go`)."""
    if gain_db == 0:
        return _passthrough()
    w0, wb = _band_params(sample_rate, f0_hz, bandwidth_hz, order)
    gb_db = gain_db + 0.1 if gain_db < 0 else gain_db - 0.1
    G0, G, Gb = 1.0, _db2lin(gain_db), _db2lin(gb_db)
    if Gb * Gb == G0 * G0:
        raise BandParamError("degenerate bandwidth gain")
    e = math.sqrt((G * G - Gb * Gb) / (Gb * Gb - G0 * G0))
    g0 = G0 ** (1.0 / order)
    alfa = (1.0 / e + math.sqrt(1 + e ** -2.0)) ** (1.0 / order)
    beta = (G / e + Gb * math.sqrt(1 + e ** -2.0)) ** (1.0 / order)
    A_ = 0.5 * (alfa - 1.0 / alfa)
    B_ = 0.5 * (beta - g0 * g0 / beta)
    tb = math.tan(wb * 0.5)
    c0 = math.cos(w0)
    rows = []
    for i in range(1, order // 2 + 1):
        ui = (2.0 * i - 1.0) / order
        ci, si = math.cos(math.pi * ui * 0.5), math.sin(math.pi * ui * 0.5)
        Di = (A_ * A_ + ci * ci) * tb * tb + 2.0 * A_ * si * tb + 1
        if Di == 0:
            raise BandParamError("degenerate section")
        B = [((B_ * B_ + g0 * g0 * ci * ci) * tb * tb + 2 * g0 * B_ * si * tb + g0 * g0) / Di,
             -4 * c0 * (g0 * g0 + g0 * B_ * si * tb) / Di,
             2 * (g0 * g0 * (1 + 2 * c0 * c0) - (B_ * B_ + g0 * g0 * ci * ci) * tb * tb) / Di,
             -4 * c0 * (g0 * g0 - g0 * B_ * si * tb) / Di,
             ((B_ * B_ + g0 * g0 * ci * ci) * tb * tb - 2 * g0 * B_ * si * tb + g0 * g0) / Di]
        A = [1.0,
             -4 * c0 * (1 + A_ * si * tb) / Di,
             2 * (1 + 2 * c0 * c0 - (A_ * A_ + ci * ci) * tb * tb) / Di,
             -4 * c0 * (1 - A_ * si * tb) / Di,
             ((A_ * A_ + ci * ci) * tb * tb - 2 * A_ * si * tb + 1) / Di]
        rows.append(_fourth_order_rows(B, A))
    return np.concatenate(rows)


def chebyshev2_band(sample_rate: float, f0_hz: float, bandwidth_hz: float,
                    gain_db: float, order: int) -> np.ndarray:
    """Chebyshev II band boost/cut (`chebyshev2_band.go`)."""
    if gain_db == 0:
        return _passthrough()
    w0, wb = _band_params(sample_rate, f0_hz, bandwidth_hz, order)
    gb_db = -0.1 if gain_db < 0 else 0.1
    G0, G, Gb = 1.0, _db2lin(gain_db), _db2lin(gb_db)
    if Gb * Gb == G0 * G0:
        raise BandParamError("degenerate bandwidth gain")
    e = math.sqrt((G * G - Gb * Gb) / (Gb * Gb - G0 * G0))
    g = G ** (1.0 / order)
    eu = (e + math.sqrt(1 + e * e)) ** (1.0 / order)
    ew = (G0 * e + Gb * math.sqrt(1.0 + e * e)) ** (1.0 / order)
    A_ = (eu - 1.0 / eu) * 0.5
    B_ = (ew - g * g / ew) * 0.5
    tb = math.tan(wb * 0.5)
    c0 = math.cos(w0)
    rows = []
    for i in range(1, order // 2 + 1):
        ui = (2.0 * i - 1.0) / order
        ci, si = math.cos(math.pi * ui * 0.5), math.sin(math.pi * ui * 0.5)
        Di = tb * tb + 2 * A_ * si * tb + A_ * A_ + ci * ci
        if Di == 0:
            raise BandParamError("degenerate section")
        B = [(g * g * tb * tb + 2.0 * g * B_ * si * tb + B_ * B_ + g * g * ci * ci) / Di,
             -4 * c0 * (B_ * B_ + g * g * ci * ci + g * B_ * si * tb) / Di,
             2 * ((B_ * B_ + g * g * ci * ci) * (1.0 + 2.0 * c0 * c0) - g * g * tb * tb) / Di,
             -4 * c0 * (B_ * B_ + g * g * ci * ci - g * B_ * si * tb) / Di,
             (g * g * tb * tb - 2 * g * B_ * si * tb + B_ * B_ + g * g * ci * ci) / Di]
        A = [1.0,
             -4 * c0 * (A_ * A_ + ci * ci + A_ * si * tb) / Di,
             2 * ((A_ * A_ + ci * ci) * (1 + 2 * c0 * c0) - tb * tb) / Di,
             -4 * c0 * (A_ * A_ + ci * ci - A_ * si * tb) / Di,
             (tb * tb - 2 * A_ * si * tb + A_ * A_ + ci * ci) / Di]
        rows.append(_fourth_order_rows(B, A))
    return np.concatenate(rows)


def elliptic_band(sample_rate: float, f0_hz: float, bandwidth_hz: float,
                  gain_db: float, order: int) -> np.ndarray:
    """Elliptic band boost/cut (`elliptic_band.go` + `band/elliptic.go`)."""
    if gain_db == 0:
        return _passthrough()
    w0, wb = _band_params(sample_rate, f0_hz, bandwidth_hz, order)
    gb_db = gain_db + 0.05 if gain_db < 0 else gain_db - 0.05

    G0, G, Gb = 1.0, _db2lin(gain_db), _db2lin(gb_db)
    Gs = _db2lin(gain_db - gb_db)
    WB = math.tan(wb * 0.5)
    e = math.sqrt((G * G - Gb * Gb) / (Gb * Gb - G0 * G0))
    es = math.sqrt((G * G - Gs * Gs) / (Gs * Gs - G0 * G0))
    k1 = e / es
    k = em.ellipdeg(order, k1)

    ju0 = em.asne(1j * G / (e * G0), k1) / order
    jv0 = em.asne(1j / e, k1) / order

    L = order // 2

    # Analog prototype sections (so: b0,b1,b2,a0,a1,a2). Even order: gain
    # stage at Gb (band/elliptic.go:53-57).
    a_sections = [(Gb, 0.0, 0.0, 1.0, 0.0, 0.0)]
    for i in range(1, L + 1):
        ui = (2.0 * i - 1.0) / order
        zi = 1j * em.cde(ui - ju0, k)
        pi = 1j * em.cde(ui - jv0, k)
        inv_z, inv_p = 1.0 / zi, 1.0 / pi
        a_sections.append((
            WB * WB, -2 * WB * float(np.real(inv_z)), abs(inv_z) ** 2,
            WB * WB, -2 * WB * float(np.real(inv_p)), abs(inv_p) ** 2))

    # bilinear + LP->BP transform around cos(w0) (band/elliptic.go:141-220)
    c0 = math.cos(w0)
    c0c0 = c0 * c0
    degenerate = abs(abs(c0) - 1.0) < 1e-12
    rows = []
    for (b0, b1, b2, a0, a1, a2) in a_sections:
        has_first = b1 != 0 or a1 != 0
        has_second = b2 != 0 or a2 != 0
        if not has_first and not has_second:
            bh = [b0 / a0, 0.0, 0.0]
            ah = [1.0, 0.0, 0.0]
        elif not has_second:
            D = a0 + a1
            bh = [(b0 + b1) / D, (b0 - b1) / D, 0.0]
            ah = [1.0, (a0 - a1) / D, 0.0]
        else:
            D = a0 + a1 + a2
            bh = [(b0 + b1 + b2) / D, 2 * (b0 - b2) / D, (b0 - b1 + b2) / D]
            ah = [1.0, 2 * (a0 - a2) / D, (a0 - a1 + a2) / D]

        if degenerate:
            B = [bh[0], bh[1] * c0, bh[2], 0.0, 0.0]
            A = [ah[0], ah[1] * c0, ah[2], 0.0, 0.0]
        elif not has_first and not has_second:
            B = [bh[0], 0.0, 0.0, 0.0, 0.0]
            A = [1.0, 0.0, 0.0, 0.0, 0.0]
        elif not has_second:
            B = [bh[0], c0 * (bh[1] - bh[0]), -bh[1], 0.0, 0.0]
            A = [1.0, c0 * (ah[1] - 1), -ah[1], 0.0, 0.0]
        else:
            B = [bh[0], c0 * (bh[1] - 2 * bh[0]),
                 (bh[0] - bh[1] + bh[2]) * c0c0 - bh[1],
                 c0 * (bh[1] - 2 * bh[2]), bh[2]]
            A = [1.0, c0 * (ah[1] - 2),
                 (1 - ah[1] + ah[2]) * c0c0 - ah[1],
                 c0 * (ah[1] - 2 * ah[2]), ah[2]]

        # factor into biquads (band/elliptic.go:101-137)
        if all(abs(v) < 1e-14 for v in B[1:]) and all(abs(v) < 1e-14 for v in A[1:]):
            rows.append(np.array([[B[0] / A[0], 0.0, 0.0, 0.0, 0.0]]))
        elif abs(B[3]) < 1e-14 and abs(B[4]) < 1e-14 \
                and abs(A[3]) < 1e-14 and abs(A[4]) < 1e-14:
            a0d = A[0]
            rows.append(np.array([[B[0] / a0d, B[1] / a0d, B[2] / a0d,
                                   A[1] / a0d, A[2] / a0d]]))
        else:
            rows.append(_fourth_order_rows(B, A))
    return np.concatenate(rows)
