"""Polynomial root utilities for filter design.

Capability parity with `internal/polyroot/polyroot.go`: root finding,
conjugate pairing, and splitting fourth-order digital sections into two
cascaded biquads (used by the band EQ designers). Root finding uses
NumPy's companion-matrix eigenvalues instead of the reference's
Durand-Kerner iteration — same roots, library-grade robustness.
"""

from __future__ import annotations

import numpy as np


class DegeneratePolynomialError(ValueError):
    """Degenerate coefficients (zero leading coeff, pairing failure)."""


def roots_from_poly_asc(c) -> np.ndarray:
    """Roots of c[0] + c[1] z + ... + c[n] z^n (`polyroot.go:88-117`)."""
    c = np.asarray(c, dtype=np.float64)
    if c[-1] == 0 and np.all(c == 0):
        raise DegeneratePolynomialError("zero polynomial")
    # np.roots wants descending order
    r = np.roots(c[::-1])
    return r.astype(np.complex128)


def pair_conjugates(roots: np.ndarray) -> list[tuple[complex, complex]]:
    """Group roots into conjugate (or real) pairs (`polyroot.go` PairConjugates)."""
    roots = list(np.asarray(roots, dtype=np.complex128))
    if len(roots) % 2 != 0:
        raise DegeneratePolynomialError("odd number of roots")
    used = [False] * len(roots)
    pairs = []
    tol = 1e-6
    for i, r in enumerate(roots):
        if used[i]:
            continue
        used[i] = True
        if abs(r.imag) <= tol * max(1.0, abs(r)):
            # real root: pair with the nearest unused real root
            best, best_d = -1, np.inf
            for j in range(i + 1, len(roots)):
                if used[j] or abs(roots[j].imag) > tol * max(1.0, abs(roots[j])):
                    continue
                d = abs(roots[j].real - r.real)
                if d < best_d:
                    best_d, best = d, j
            if best == -1:
                raise DegeneratePolynomialError("unpaired real root")
            used[best] = True
            pairs.append((r, roots[best]))
        else:
            target = r.conjugate()
            best, best_d = -1, np.inf
            for j in range(len(roots)):
                if used[j]:
                    continue
                d = abs(roots[j] - target)
                if d < best_d:
                    best_d, best = d, j
            if best == -1 or best_d > 1e-3 * max(1.0, abs(r)):
                raise DegeneratePolynomialError("unpaired complex root")
            used[best] = True
            pairs.append((r, roots[best]))
    return pairs


def quad_from_roots(pair) -> tuple[float, float, float]:
    """(1, -(r1+r2), r1*r2) as real coefficients (`polyroot.go:120-135`)."""
    r1, r2 = pair
    return 1.0, float(np.real(-(r1 + r2))), float(np.real(r1 * r2))


def split_fourth_order(b, a) -> np.ndarray:
    """Factor a 4th-order digital section (ascending-power b[5], a[5])
    into two cascaded biquad SOS rows (`polyroot.go:25-86`). The leading
    b[0] is applied as gain on the first section."""
    b = np.asarray(b, dtype=np.float64)
    a = np.asarray(a, dtype=np.float64)
    if a[0] == 0 or b[0] == 0:
        raise DegeneratePolynomialError("zero leading coefficient")

    # roots in z^-1: factor as products of (1 - r z^-1) pairs.
    # The reference finds roots of the ascending polynomial in z then
    # inverts; equivalently find roots of the reversed (descending) poly.
    num_roots = roots_from_poly_asc(b)
    den_roots = roots_from_poly_asc(a)
    if np.any(num_roots == 0) or np.any(den_roots == 0):
        raise DegeneratePolynomialError("root at zero")
    num_pairs = pair_conjugates(1.0 / num_roots)
    den_pairs = pair_conjugates(1.0 / den_roots)

    rows = []
    scale = b[0]
    for i in range(2):
        b0, b1, b2 = quad_from_roots(num_pairs[i])
        a0, a1, a2 = quad_from_roots(den_pairs[i])
        if i == 0:
            b0, b1, b2 = b0 * scale, b1 * scale, b2 * scale
        if a0 == 0:
            raise DegeneratePolynomialError("zero a0")
        rows.append([b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0])
    return np.array(rows, dtype=np.float64)
