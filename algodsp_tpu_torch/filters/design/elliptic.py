"""Elliptic (Cauer) filter cascade designers.

Capability parity with `dsp/filter/design/pass/elliptic.go:23-707`:
analog elliptic prototype via Jacobi elliptic functions (zeros on the
imaginary axis at j/(k·sn), poles at Orfanidis' j·cd(u - j v0)), LP→HP
zpk transform, bilinear zpk transform, conjugate-pair grouping into
second-order sections, and unity passband-gain normalization (DC for
LP, Nyquist for HP).

ripple_db is the passband ripple, stopband_db the minimum stopband
attenuation; both use the 10^(x/10)-1 epsilon convention
(`elliptic.go:645-647`).
"""

from __future__ import annotations

import math

import numpy as np

from algodsp_tpu_torch.utils import ellipticmath as em

_ROOT_TOL = 1e-9
_EPS = 2.220446049250313e-16


def _db_to_eps_sq(db: float) -> float:
    return math.expm1(math.log(10.0) * db / 10.0)


def _analog_prototype(order: int, ripple_db: float, stopband_db: float):
    """Analog elliptic prototype (zeros, poles, gain), cutoff = 1 rad/s.

    Mirrors `ellipticAnalogPrototype` (`elliptic.go:115-246`).
    """
    eps_sq = _db_to_eps_sq(ripple_db)
    stop_sq = _db_to_eps_sq(stopband_db)
    if eps_sq <= 0 or stop_sq <= 0:
        return None
    ck1_sq = eps_sq / stop_sq
    if not (0.0 < ck1_sq < 1.0):
        return None

    if order == 1:
        p = -math.sqrt(1.0 / eps_sq)
        return np.array([], dtype=np.complex128), np.array([p + 0j]), -p

    m = em.ellipdeg_param(order, ck1_sq)
    if not (0.0 < m < 1.0):
        return None
    kmod = math.sqrt(m)
    capk, _ = em.ellipk(kmod)
    ck1 = math.sqrt(ck1_sq)
    k1_K, _ = em.ellipk(ck1)
    if not (math.isfinite(capk) and math.isfinite(k1_K)) or capk == 0 or k1_K == 0:
        return None

    start = 1 - order % 2
    sn_l, cn_l, dn_l = [], [], []
    zeros_base = []
    for j in range(start, order, 2):
        u = j / order  # normalized argument (times K internally)
        sn = float(np.real(em.sne(u, kmod)))
        dn2 = max(0.0, 1.0 - m * sn * sn)
        dn = math.sqrt(dn2)
        cd = float(np.real(em.cde(u, kmod)))
        cn = cd * dn
        sn_l.append(sn)
        cn_l.append(cn)
        dn_l.append(dn)
        if abs(sn) > _EPS:
            zeros_base.append(1j / (kmod * sn))

    eps = math.sqrt(eps_sq)
    # v0 from inverse sn: asne(j/eps, k1) is purely imaginary; r = Im part
    z = em.asne(1j / eps, ck1)
    r = z.imag * k1_K  # un-normalize (asne returns u with actual arg u*K1)
    if not (r > 0) or not math.isfinite(r):
        return None
    v0 = capk * r / (order * k1_K)

    kp = math.sqrt(1.0 - m)
    sv = float(np.real(em.sne(v0 / em.ellipk(kp)[0], kp)))
    dn2 = max(0.0, 1.0 - kp * kp * sv * sv)
    dv = math.sqrt(dn2)
    cv = float(np.real(em.cde(v0 / em.ellipk(kp)[0], kp))) * dv

    poles_base = []
    for sn, cn, dn in zip(sn_l, cn_l, dn_l):
        den = 1.0 - (dn * sv) ** 2
        if abs(den) <= _EPS:
            return None
        num = complex(cn * dn * sv * cv, sn * dv)
        poles_base.append(-num / den)

    poles = list(poles_base)
    if order % 2 == 1:
        norm2 = sum(abs(p) ** 2 for p in poles_base)
        thr = _EPS * math.sqrt(norm2)
        for p in poles_base:
            if abs(p.imag) > thr:
                poles.append(p.conjugate())
    else:
        for p in poles_base:
            poles.append(p.conjugate())

    zeros = []
    for z0 in zeros_base:
        zeros.extend([z0, z0.conjugate()])

    prod_p = np.prod([-p for p in poles]) if poles else 1.0
    prod_z = np.prod([-z0 for z0 in zeros]) if zeros else 1.0
    if prod_z == 0:
        return None
    gain = float(np.real(prod_p / prod_z))
    if order % 2 == 0:
        gain /= math.sqrt(1.0 + eps_sq)
    if gain == 0 or not math.isfinite(gain):
        return None
    return (np.array(zeros, dtype=np.complex128),
            np.array(poles, dtype=np.complex128), gain)


def _lp_to_hp_zpk(z, p, k):
    """s → 1/s transform (`elliptic.go:248-299`)."""
    degree = len(p) - len(z)
    if degree < 0 or np.any(z == 0) or np.any(p == 0):
        return None
    zh = np.concatenate([1.0 / z, np.zeros(degree, dtype=np.complex128)])
    ph = 1.0 / p
    kh = k
    if len(z):
        kh *= float(np.real(np.prod(-z)))
    den = float(np.real(np.prod(-p)))
    if den == 0 or not math.isfinite(den):
        return None
    kh /= den
    if kh == 0 or not math.isfinite(kh):
        return None
    return zh, ph, kh


def _bilinear_zpk(z, p, gain, k):
    """s = (1/k)(z-1)/(z+1) bilinear transform of a zpk system
    (`elliptic.go:301-344`)."""
    degree = len(p) - len(z)
    if degree < 0:
        return None
    if np.any(1.0 - k * z == 0) or np.any(1.0 - k * p == 0):
        return None
    zd = np.concatenate([(1.0 + k * z) / (1.0 - k * z),
                         -np.ones(degree, dtype=np.complex128)])
    pd = (1.0 + k * p) / (1.0 - k * p)
    num = np.prod(1.0 - k * z) if len(z) else 1.0
    den = np.prod(1.0 - k * p) if len(p) else 1.0
    if den == 0:
        return None
    kd = gain * float(np.real(num / den))
    if kd == 0 or not math.isfinite(kd):
        return None
    return zd, pd, kd


def _group_roots(roots):
    """Group conjugate pairs; pair up leftover reals (`elliptic.go:415-487`)."""
    if len(roots) == 0:
        return []
    order = sorted(range(len(roots)),
                   key=lambda i: (-roots[i].imag, roots[i].real))
    rs = [roots[i] for i in order]
    used = [False] * len(rs)
    groups, reals = [], []
    for i, r in enumerate(rs):
        if used[i]:
            continue
        if abs(r.imag) <= _ROOT_TOL:
            used[i] = True
            reals.append(complex(r.real, 0.0))
            continue
        target = r.conjugate()
        best, best_d = -1, math.inf
        for j, rr in enumerate(rs):
            if j == i or used[j]:
                continue
            d = abs(rr - target)
            if d < best_d:
                best_d, best = d, j
        used[i] = True
        if best != -1 and best_d <= 1e-4:
            used[best] = True
            groups.append([r, rs[best]])
        else:
            groups.append([r])
    reals.sort(key=lambda c: c.real)
    for i in range(0, len(reals) - 1, 2):
        groups.append([reals[i], reals[i + 1]])
    if len(reals) % 2 == 1:
        groups.append([reals[-1]])
    return groups


def _quad_from_roots(group):
    if len(group) == 0:
        return 0.0, 0.0
    if len(group) == 1:
        return -group[0].real, 0.0
    r1, r2 = group[0], group[1]
    return float(np.real(-(r1 + r2))), float(np.real(r1 * r2))


def _zpk_to_sections(z, p, gain):
    """Pair pole/zero groups into SOS rows (`elliptic.go:346-413`)."""
    p_groups = _group_roots(list(p))
    if not p_groups:
        return None
    p_groups.sort(key=lambda g: (-len(g), -max((abs(r.imag) for r in g), default=0.0)))
    z_groups = _group_roots(list(z))
    z_complex = [g for g in z_groups if len(g) == 2]
    z_single = [g for g in z_groups if len(g) != 2]

    rows = []
    for pg in p_groups:
        zg = None
        if len(pg) == 2:
            if z_complex:
                zg = z_complex.pop(0)
            elif z_single:
                zg = z_single.pop(0)
        else:
            if z_single:
                zg = z_single.pop(0)
            elif z_complex:
                zg = z_complex.pop(0)
        b1, b2 = _quad_from_roots(zg or [])
        a1, a2 = _quad_from_roots(pg)
        rows.append([1.0, b1, b2, a1, a2])
    rows = np.array(rows, dtype=np.float64)
    if math.isfinite(gain) and gain != 0:
        rows[0, :3] *= gain
    return rows


def _normalize_cascade(sos: np.ndarray, at_nyquist: bool) -> np.ndarray:
    """Scale the first section for unity gain at DC (LP) or Nyquist (HP)
    (`elliptic.go:649-707`)."""
    sign = -1.0 if at_nyquist else 1.0
    gain = 1.0
    for b0, b1, b2, a1, a2 in sos:
        den = 1.0 + sign * a1 + a2
        if den == 0:
            return sos
        gain *= (b0 + sign * b1 + b2) / den
    if gain == 0 or not math.isfinite(gain):
        return sos
    sos = sos.copy()
    sos[0, :3] /= gain
    return sos


def elliptic_lp(freq: float, order: int, ripple_db: float, stopband_db: float,
                sample_rate: float) -> np.ndarray | None:
    """Lowpass elliptic cascade (`elliptic.go:23-66`)."""
    if order <= 0 or sample_rate <= 0 or freq <= 0 or freq >= sample_rate / 2:
        return None
    if ripple_db <= 0 or stopband_db <= ripple_db:
        return None
    k = math.tan(math.pi * freq / sample_rate)
    proto = _analog_prototype(order, ripple_db, stopband_db)
    if proto is None:
        return None
    d = _bilinear_zpk(*proto, k)
    if d is None:
        return None
    sos = _zpk_to_sections(*d)
    if sos is None or len(sos) == 0:
        return None
    return _normalize_cascade(sos, at_nyquist=False)


def elliptic_hp(freq: float, order: int, ripple_db: float, stopband_db: float,
                sample_rate: float) -> np.ndarray | None:
    """Highpass elliptic cascade (`elliptic.go:68-113`)."""
    if order <= 0 or sample_rate <= 0 or freq <= 0 or freq >= sample_rate / 2:
        return None
    if ripple_db <= 0 or stopband_db <= ripple_db:
        return None
    k = math.tan(math.pi * freq / sample_rate)
    proto = _analog_prototype(order, ripple_db, stopband_db)
    if proto is None:
        return None
    h = _lp_to_hp_zpk(*proto)
    if h is None:
        return None
    d = _bilinear_zpk(*h, k)
    if d is None:
        return None
    sos = _zpk_to_sections(*d)
    if sos is None or len(sos) == 0:
        return None
    return _normalize_cascade(sos, at_nyquist=True)
