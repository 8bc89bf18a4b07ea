"""High-order LP/HP cascade designers (host-side float64).

Capability parity with `dsp/filter/design/pass/`:
Butterworth (`butterworth.go:12-55` — RBJ Q-ladder + first-order tail
for odd orders), Chebyshev Type I (`chebyshev1.go:13-96` — legacy
MFFilter.pas formulas, including the mu = asinh(rippleDB)/order ripple
convention and Butterworth first-order tail for odd orders),
Chebyshev Type II (`chebyshev2.go:18-191` — inverted Type-I poles with
imaginary-axis zeros, bilinear transform, unity DC/Nyquist
normalization), Bessel (`bessel.go:14-235` — C.R. Bond -3 dB-normalized
pole tables, orders 1-10), and Linkwitz-Riley
(`linkwitz_riley.go:7-122` — squared-Butterworth with polarity
helpers).

All designers return an (S, 5) float64 SOS array, or None for invalid
parameters (the analog of the reference returning nil).
"""

from __future__ import annotations

import math

import numpy as np

from algodsp_tpu_torch.filters.design.rbj import lowpass as rbj_lowpass
from algodsp_tpu_torch.filters.design.rbj import highpass as rbj_highpass

_SQRT2_INV = 1.0 / math.sqrt(2.0)


def _valid_fc(freq: float, sample_rate: float) -> bool:
    return sample_rate > 0 and 0 < freq < sample_rate / 2


def _bilinear_k(freq: float, sample_rate: float) -> float | None:
    """tan(pi*f/sr) pre-warp factor (`pass/common.go:11-18`)."""
    if not _valid_fc(freq, sample_rate):
        return None
    return math.tan(math.pi * freq / sample_rate)


def _butterworth_q(order: int, index: int) -> float:
    theta = math.pi * (2 * index + 1) / (2.0 * order)
    s = math.sin(theta)
    return _SQRT2_INV if s == 0 else 1.0 / (2.0 * s)


def _first_order_lp(freq: float, sample_rate: float) -> np.ndarray:
    k = math.tan(math.pi * freq / sample_rate)
    norm = 1.0 / (1.0 + k)
    return np.array([k * norm, k * norm, 0.0, (k - 1.0) * norm, 0.0])


def _first_order_hp(freq: float, sample_rate: float) -> np.ndarray:
    k = math.tan(math.pi * freq / sample_rate)
    norm = 1.0 / (1.0 + k)
    return np.array([norm, -norm, 0.0, (k - 1.0) * norm, 0.0])


def butterworth_lp(freq: float, order: int, sample_rate: float) -> np.ndarray | None:
    """Lowpass Butterworth cascade (`butterworth.go:12-31`)."""
    if order <= 0 or not _valid_fc(freq, sample_rate):
        return None
    rows = [rbj_lowpass(freq, _butterworth_q(order, i), sample_rate)
            for i in range(order // 2 - 1, -1, -1)]
    if order % 2:
        rows.append(_first_order_lp(freq, sample_rate))
    return np.stack(rows)


def butterworth_hp(freq: float, order: int, sample_rate: float) -> np.ndarray | None:
    """Highpass Butterworth cascade (`butterworth.go:33-55`)."""
    if order <= 0 or not _valid_fc(freq, sample_rate):
        return None
    rows = [rbj_highpass(freq, _butterworth_q(order, i), sample_rate)
            for i in range(order // 2 - 1, -1, -1)]
    if order % 2:
        rows.append(_first_order_hp(freq, sample_rate))
    return np.stack(rows)


def _cheby1_ripple_factors(order: int, ripple_db: float) -> tuple[float, float]:
    """(cosh^2 t, sinh t) with t = asinh(rippleDB)/order — note the
    legacy convention of asinh on the dB value itself
    (`pass/common.go:71-86`)."""
    if order <= 0:
        return 1.0, 0.0
    if ripple_db <= 0:
        ripple_db = 1.0
    t = math.asinh(ripple_db) / order
    return math.cosh(t) ** 2, math.sinh(t)


def chebyshev1_lp(freq: float, order: int, ripple_db: float,
                  sample_rate: float) -> np.ndarray | None:
    """Lowpass Chebyshev I cascade (`chebyshev1.go:13-49`)."""
    if order <= 0:
        return None
    k = _bilinear_k(freq, sample_rate)
    if k is None:
        return None
    r0, r1 = _cheby1_ripple_factors(order, ripple_db)
    k2 = k * k
    rows = []
    for i in range(order // 2 - 1, -1, -1):
        tt = math.cos((2 * i + 1) * math.pi / (2.0 * order))
        b = 1.0 / (r0 - tt * tt)
        a = k * 2.0 * b * r1 * tt
        t = 1.0 / (a + b + k2)
        rows.append(np.array([k2 * t, 2 * k2 * t, k2 * t,
                              -2.0 * (b - k2) * t, -(a - k2 - b) * t]))
    if order % 2:
        rows.append(_first_order_lp(freq, sample_rate))
    return np.stack(rows)


def chebyshev1_hp(freq: float, order: int, ripple_db: float,
                  sample_rate: float) -> np.ndarray | None:
    """Highpass Chebyshev I cascade (`chebyshev1.go:51-96`)."""
    if order <= 0:
        return None
    k = _bilinear_k(freq, sample_rate)
    if k is None:
        return None
    r0, r1 = _cheby1_ripple_factors(order, ripple_db)
    k2 = k * k
    rows = []
    for i in range(order // 2 - 1, -1, -1):
        s = math.sin((2 * i + 1) * math.pi / (4.0 * order))
        tt = s * s
        a = 1.0 / (r0 + 4.0 * tt - 4.0 * tt * tt - 1.0)
        b = 2.0 * k * a * r1 * (1.0 - 2.0 * tt)
        t = 1.0 / (b + 1.0 + a * k2)
        rows.append(np.array([t, -2.0 * t, t,
                              -2.0 * (1.0 - a * k2) * t,
                              -(b - 1.0 - a * k2) * t]))
    if order % 2:
        rows.append(_first_order_hp(freq, sample_rate))
    return np.stack(rows)


def _cheby2_mu(order: int, ripple: float) -> float:
    if ripple <= 0:
        ripple = 1.0
    return math.asinh(ripple) / order


def chebyshev2_lp(freq: float, order: int, ripple_db: float,
                  sample_rate: float) -> np.ndarray | None:
    """Lowpass Chebyshev II (inverse) cascade (`chebyshev2.go:18-90`)."""
    if order <= 0 or not _valid_fc(freq, sample_rate):
        return None
    wc = math.tan(math.pi * freq / sample_rate)
    mu = _cheby2_mu(order, ripple_db)
    rows = []
    for i in range(order // 2):
        phi = math.pi * (2 * i + 1) / (2.0 * order)
        sigma1 = math.sinh(mu) * math.sin(phi)
        omega1 = math.cosh(mu) * math.cos(phi)
        mag2 = sigma1 * sigma1 + omega1 * omega1
        sigma_p = sigma1 / mag2
        omega_p = omega1 / mag2
        omega_z = 1.0 / math.cos(phi)

        wpr = wc * sigma_p
        wz = wc * omega_z
        wp2 = wpr * wpr + (wc * omega_p) ** 2

        wz2 = wz * wz
        bn = np.array([1 + wz2, -2 + 2 * wz2, 1 + wz2])
        ad0 = 1 + 2 * wpr + wp2
        ad1 = -2 + 2 * wp2
        ad2 = 1 - 2 * wpr + wp2

        b = bn / ad0
        a1, a2 = ad1 / ad0, ad2 / ad0
        dc = (b[0] + b[1] + b[2]) / (1 + a1 + a2)
        b /= dc
        rows.append(np.array([b[0], b[1], b[2], a1, a2]))
    if order % 2:
        sp = wc / math.sinh(mu)
        g = sp / (1 + sp)
        rows.append(np.array([g, g, 0.0, (sp - 1) / (1 + sp), 0.0]))
    return np.stack(rows)


def chebyshev2_hp(freq: float, order: int, ripple_db: float,
                  sample_rate: float) -> np.ndarray | None:
    """Highpass Chebyshev II cascade (`chebyshev2.go:92-160`)."""
    if order <= 0 or not _valid_fc(freq, sample_rate):
        return None
    wc = math.tan(math.pi * freq / sample_rate)
    mu = _cheby2_mu(order, ripple_db)
    rows = []
    for i in range(order // 2):
        phi = math.pi * (2 * i + 1) / (2.0 * order)
        sigma1 = math.sinh(mu) * math.sin(phi)
        omega1 = math.cosh(mu) * math.cos(phi)
        hp_sigma = wc * sigma1
        hp_omega = wc * omega1
        hp_wz = wc * math.cos(phi)

        hp2 = hp_sigma * hp_sigma + hp_omega * hp_omega
        wz2 = hp_wz * hp_wz
        bn = np.array([1 + wz2, -2 + 2 * wz2, 1 + wz2])
        ad0 = 1 + 2 * hp_sigma + hp2
        ad1 = -2 + 2 * hp2
        ad2 = 1 - 2 * hp_sigma + hp2

        b = bn / ad0
        a1, a2 = ad1 / ad0, ad2 / ad0
        nyq = (b[0] - b[1] + b[2]) / (1 - a1 + a2)
        b /= nyq
        rows.append(np.array([b[0], b[1], b[2], a1, a2]))
    if order % 2:
        sp = wc * math.sinh(mu)
        g = 1.0 / (1 + sp)
        rows.append(np.array([g, -g, 0.0, (sp - 1) / (1 + sp), 0.0]))
    return np.stack(rows)


# -- Bessel -----------------------------------------------------------------

_MAX_BESSEL_ORDER = 10

# Delay-normalized Bessel poles (unique pole per conjugate pair, real pole
# last for odd orders) and -3 dB frequency scale factors.
# Published constants: C.R. Bond, "Bessel Filter Constants"
# (reference mirror: pass/bessel.go:160-235).
_BESSEL_DELAY_POLES: dict[int, list[complex]] = {
    1: [complex(-1.0, 0.0)],
    2: [complex(-1.5, 0.8660254038)],
    3: [complex(-1.8389073227, 1.7543809598), complex(-2.3221853546, 0.0)],
    4: [complex(-2.1037893972, 2.6574180419), complex(-2.8962106028, 0.8672341289)],
    5: [complex(-2.3246743032, 3.5710229203), complex(-3.3519563992, 1.7426614162),
        complex(-3.6467385953, 0.0)],
    6: [complex(-2.5159322478, 4.4926729537), complex(-3.7357083563, 2.6262723114),
        complex(-4.2483593959, 0.8675096732)],
    7: [complex(-2.6856768789, 5.4206941307), complex(-4.0701391636, 3.5171740477),
        complex(-4.7582905282, 1.7392860613), complex(-4.9717868585, 0.0)],
    8: [complex(-2.8389839177, 6.3539112470), complex(-4.3682892668, 4.4144425006),
        complex(-5.2048407906, 2.6161751538), complex(-5.5878860022, 0.8676144454)],
    9: [complex(-2.9792607983, 7.2914651564), complex(-4.6384398714, 5.3172716754),
        complex(-5.6044218195, 3.4981415816), complex(-6.1293679040, 1.7378483835),
        complex(-6.2970079817, 0.0)],
    10: [complex(-3.1088931555, 8.2324678728), complex(-4.8862195924, 6.2249854825),
         complex(-5.9675283089, 4.3849471924), complex(-6.6152909655, 2.6115679208),
         complex(-6.9220449048, 0.8676594792)],
}

_BESSEL_SCALE = {
    1: 1.0, 2: 1.36165412871613, 3: 1.75567236868121, 4: 2.11391767490422,
    5: 2.42741070215263, 6: 2.70339506120292, 7: 2.95172214703872,
    8: 3.17961723751065, 9: 3.39169313891166, 10: 3.59098059456916,
}


def _bessel_poles(order: int) -> list[complex]:
    s = _BESSEL_SCALE[order]
    return [complex(p.real / s, p.imag / s) for p in _BESSEL_DELAY_POLES[order]]


def bessel_lp(freq: float, order: int, sample_rate: float) -> np.ndarray | None:
    """Lowpass Bessel cascade, orders 1-10 (`bessel.go:14-41`)."""
    if order <= 0 or order > _MAX_BESSEL_ORDER or not _valid_fc(freq, sample_rate):
        return None
    wc = math.tan(math.pi * freq / sample_rate)
    rows = []
    for p in _bessel_poles(order):
        sigma, omega = -p.real, p.imag
        if omega == 0:
            sp = sigma * wc
            norm = 1.0 / (1.0 + sp)
            rows.append(np.array([sp * norm, sp * norm, 0.0, (sp - 1) * norm, 0.0]))
        else:
            a = sigma * wc
            b = omega * wc
            p2 = a * a + b * b
            a0 = 1 + 2 * a + p2
            rows.append(np.array([p2 / a0, 2 * p2 / a0, p2 / a0,
                                  (-2 + 2 * p2) / a0, (1 - 2 * a + p2) / a0]))
    return np.stack(rows)


def bessel_hp(freq: float, order: int, sample_rate: float) -> np.ndarray | None:
    """Highpass Bessel cascade, orders 1-10 (`bessel.go:43-141`)."""
    if order <= 0 or order > _MAX_BESSEL_ORDER or not _valid_fc(freq, sample_rate):
        return None
    wc = math.tan(math.pi * freq / sample_rate)
    rows = []
    for p in _bessel_poles(order):
        sigma, omega = -p.real, p.imag
        if omega == 0:
            norm = 1.0 / (wc + sigma)
            rows.append(np.array([sigma * norm, -sigma * norm, 0.0,
                                  (wc - sigma) * norm, 0.0]))
        else:
            p2 = sigma * sigma + omega * omega
            wc2 = wc * wc
            a0 = wc2 + 2 * sigma * wc + p2
            rows.append(np.array([p2 / a0, -2 * p2 / a0, p2 / a0,
                                  (2 * wc2 - 2 * p2) / a0,
                                  (wc2 - 2 * sigma * wc + p2) / a0]))
    return np.stack(rows)


# -- Linkwitz-Riley ---------------------------------------------------------

def _lr_prototype_orders(order: int) -> tuple[int, int] | None:
    if order < 2:
        return None
    return order // 2, (order + 1) // 2


def linkwitz_riley_lp(freq: float, order: int, sample_rate: float) -> np.ndarray | None:
    """Lowpass Linkwitz-Riley: two cascaded Butterworth prototypes of
    half order each (adjacent orders when odd) (`linkwitz_riley.go:7-46`)."""
    orders = _lr_prototype_orders(order)
    if orders is None or not _valid_fc(freq, sample_rate):
        return None
    low = butterworth_lp(freq, orders[0], sample_rate)
    high = butterworth_lp(freq, orders[1], sample_rate)
    if low is None or high is None:
        return None
    return np.concatenate([low, high])


def linkwitz_riley_hp(freq: float, order: int, sample_rate: float) -> np.ndarray | None:
    """Highpass Linkwitz-Riley (`linkwitz_riley.go:48-84`)."""
    orders = _lr_prototype_orders(order)
    if orders is None or not _valid_fc(freq, sample_rate):
        return None
    low = butterworth_hp(freq, orders[0], sample_rate)
    high = butterworth_hp(freq, orders[1], sample_rate)
    if low is None or high is None:
        return None
    return np.concatenate([low, high])


def linkwitz_riley_hp_inverted(freq: float, order: int,
                               sample_rate: float) -> np.ndarray | None:
    """HP Linkwitz-Riley with inverted polarity — for allpass summation
    at orders ≡ 2 mod 4 (`linkwitz_riley.go:86-104`)."""
    sos = linkwitz_riley_hp(freq, order, sample_rate)
    if sos is None:
        return None
    sos = sos.copy()
    sos[0, :3] = -sos[0, :3]
    return sos


def linkwitz_riley_needs_hp_invert(order: int) -> bool:
    """True for even orders ≡ 2 mod 4 (`linkwitz_riley.go:106-113`)."""
    return order > 0 and order % 2 == 0 and order % 4 == 2
