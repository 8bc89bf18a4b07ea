"""Jacobi elliptic functions via Landen transformations.

Capability parity with `internal/ellipticmath/ellipticmath.go`: Landen
descending-moduli sequence, complete elliptic integral K(k), Jacobi
cd/sn and their inverses, and the elliptic degree equation — the
backbone of elliptic (Cauer) filter design. Host-side float64/complex128
NumPy; design-time only.

Algorithms follow the standard Landen-recursion formulation (Orfanidis,
"Lecture Notes on Elliptic Filter Design").
"""

from __future__ import annotations

import math

import numpy as np

_TOL = 2.2e-16
_SERIES_LEN = 7


def landen(k: float, tol: float = _TOL) -> list[float]:
    """Descending Landen sequence of moduli (`ellipticmath.go:10-35`)."""
    if k == 0.0 or k == 1.0:
        return [k]
    v = []
    if tol < 1:
        while k > tol:
            t = k / (1.0 + math.sqrt((1.0 - k) * (1.0 + k)))
            k = t * t
            v.append(k)
    else:
        for _ in range(int(tol)):
            t = k / (1.0 + math.sqrt((1.0 - k) * (1.0 + k)))
            k = t * t
            v.append(k)
    return v


def landen_K(v: list[float]) -> float:
    """K(k) = (pi/2) * prod(1 + v_i) (`ellipticmath.go:38-46`)."""
    prod = 1.0
    for x in v:
        prod *= 1.0 + x
    return prod * math.pi * 0.5


def ellipk(k: float, tol: float = _TOL) -> tuple[float, float]:
    """Complete elliptic integrals (K(k), K'(k)) with the same
    small/large-modulus log expansions as the reference
    (`ellipticmath.go:49-86`)."""
    kmin = 1e-6
    kmax = math.sqrt(1.0 - kmin * kmin)

    if k == 1.0:
        K = math.inf
    elif k > kmax:
        kp = math.sqrt((1.0 - k) * (1.0 + k))
        L = -math.log(kp / 4.0)
        K = L + (L - 1.0) * kp * kp / 4.0
    else:
        K = landen_K(landen(k, tol))

    if k == 0.0:
        Kp = math.inf
    elif k < kmin:
        L = -math.log(k / 4.0)
        Kp = L + (L - 1.0) * k * k / 4.0
    else:
        kp = math.sqrt((1.0 - k) * (1.0 + k))
        Kp = landen_K(landen(kp, tol))
    return K, Kp


def cde(u, k: float, tol: float = _TOL):
    """Jacobi cd(u*K, k) for normalized (complex) argument u
    (`ellipticmath.go:151-162`)."""
    v = landen(k, tol)
    w = np.cos(np.asarray(u, dtype=np.complex128) * (math.pi * 0.5))
    for vi in reversed(v):
        w = (1.0 + vi) * w / (1.0 + vi * w * w)
    return w


def sne(u, k: float, tol: float = _TOL):
    """Jacobi sn(u*K, k) for normalized (real or complex) argument u
    (`ellipticmath.go:165-181`)."""
    v = landen(k, tol)
    u_arr = np.asarray(u)
    w = np.sin(u_arr * (math.pi * 0.5))
    for vi in reversed(v):
        w = (1.0 + vi) * w / (1.0 + vi * w * w)
    return w


def _sym_remainder(x: float, y: float) -> float:
    """x mod y mapped to approximately [-y/2, y/2] (`ellipticmath.go:117-127`)."""
    z = math.remainder(x, y)
    if abs(z) > y / 2.0:
        z -= y * math.copysign(1.0, z)
    return z


def acde(w, k: float, tol: float = _TOL) -> complex:
    """Inverse cd: u with cd(u*K, k) = w, normalized (`ellipticmath.go:130-144`)."""
    v = landen(k, tol)
    w = complex(w)
    for i, vi in enumerate(v):
        v1 = k if i == 0 else v[i - 1]
        w = w / (1.0 + np.sqrt(complex(1.0) - w * w * (v1 * v1))) * 2.0 / (1.0 + vi)
    u = 2.0 / math.pi * np.arccos(complex(w))
    K, Kp = ellipk(k, tol)
    return complex(_sym_remainder(u.real, 4.0),
                   _sym_remainder(u.imag, 2.0 * (Kp / K)))


def asne(w, k: float, tol: float = _TOL) -> complex:
    """Inverse sn, normalized: asne(w) = 1 - acde(w) (`ellipticmath.go:147-149`)."""
    return 1.0 - acde(w, k, tol)


def ellipdeg(n: int, k1: float, tol: float = _TOL) -> float:
    """Solve the elliptic degree equation: given order n and selectivity
    modulus k1, return modulus k (`ellipticmath.go:184-209` + the nome
    series `EllipDeg2`/`ellipdegParam` in `pass/elliptic.go:617-643`)."""
    kmin = 1e-6
    if k1 < kmin:
        # nome-series approximation for tiny k1
        K, Kp = ellipk(k1, tol)
        q = math.exp(-math.pi * Kp / K)
        q1 = q ** (1.0 / n)
        num = sum(q1 ** (m * (m + 1)) for m in range(_SERIES_LEN))
        den = 1.0 + 2.0 * sum(q1 ** (m * m) for m in range(1, _SERIES_LEN))
        return 16.0 * q1 * (num / den) ** 4
    L = n // 2
    ui = [(2.0 * i - 1.0) / n for i in range(1, L + 1)]
    kc = math.sqrt((1.0 - k1) * (1.0 + k1))
    w = sne(np.array(ui), kc, tol)
    kp = kc ** n * float(np.prod(w)) ** 4
    return math.sqrt(1.0 - kp * kp)


def ellipdeg_param(n: int, m1: float, tol: float = _TOL) -> float:
    """Nome-series solution for squared-modulus input m1 = k1^2
    (`pass/elliptic.go:617-643`): returns m = k^2."""
    if n <= 0 or not (0.0 < m1 < 1.0):
        return math.nan
    k1 = math.sqrt(m1)
    K1, _ = ellipk(k1, tol)
    K1p, _ = ellipk(math.sqrt(1.0 - m1), tol)
    if K1 <= 0 or K1p <= 0 or not math.isfinite(K1) or not math.isfinite(K1p):
        return math.nan
    q1 = math.exp(-math.pi * K1p / K1)
    q = q1 ** (1.0 / n)
    num = sum(q ** (m * (m + 1)) for m in range(_SERIES_LEN))
    den = 1.0 + 2.0 * sum(q ** (m * m) for m in range(1, _SERIES_LEN))
    return 16.0 * q * (num / den) ** 4
