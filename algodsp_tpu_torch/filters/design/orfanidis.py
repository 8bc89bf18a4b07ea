"""Orfanidis prescribed-gain peaking EQ.

Capability parity with `dsp/filter/design/peak_orfanidis.go`:
`peak_raw` designs a biquad with exact prescribed gains at DC (G0),
Nyquist (G1), center (G), and band edges (GB) — S. Orfanidis,
"Digital parametric equalizer design with prescribed Nyquist-frequency
gain", JAES 1997. `peak_orfanidis` wraps it with the audio-style
(freq, gainDB, Q) parameterization and validates the center gain,
returning None so `design.peak` can fall back to RBJ
(`design.go:112-120`).
"""

from __future__ import annotations

import math

import numpy as np

from algodsp_tpu_torch.filters.biquad import magnitude_squared


class PeakParamError(ValueError):
    pass


def peak_raw(G0: float, G1: float, G: float, GB: float,
             w0: float, dw: float) -> np.ndarray:
    """Prescribed-gain peaking biquad (`peak_orfanidis.go:28-126`).

    All gains linear; w0/dw in rad/sample.
    """
    if not (G0 > 0 and G1 > 0 and G > 0 and GB > 0):
        raise PeakParamError("gains must be positive")
    if not (0 < w0 < math.pi) or not (0 < dw < math.pi):
        raise PeakParamError("w0/dw out of range")

    Omega0 = math.tan(w0 / 2.0)
    if Omega0 == 0 or not math.isfinite(Omega0):
        raise PeakParamError("degenerate center")

    # Orfanidis 1997 eq. set (the paper's peq algebra with arbitrary
    # Nyquist gain G1). DOCUMENTED DEVIATION from the reference: the Go
    # port (`peak_orfanidis.go:80-133`) drops the square roots on
    # W2/DeltaOmega and replaces sqrt(G00*G11)/sqrt(F00*F11) with signed
    # products, so its realized center gain misses the prescription and
    # its own verification step rejects the result — the reference's
    # Orfanidis path always silently falls back to RBJ
    # (`design.go:112-120`). This implementation realizes the
    # prescribed gains exactly (asserted closed-form in
    # tests/test_parity_closed_form.py).
    gb2, g02, g12, g2 = GB * GB, G0 * G0, G1 * G1, G * G
    F = abs(g2 - gb2)
    G00, F00 = abs(g2 - g02), abs(gb2 - g02)
    G01, F01 = abs(g2 - G0 * G1), abs(gb2 - G0 * G1)
    G11, F11 = abs(g2 - g12), abs(gb2 - g12)
    if 0 in (F, G00, F11):
        raise PeakParamError("degenerate gain constraints")

    W2 = math.sqrt(G11 / G00) * Omega0 * Omega0
    if W2 <= 0 or not math.isfinite(W2):
        raise PeakParamError("invalid W2")
    DeltaOmega = (1.0 + math.sqrt(F00 / F11) * W2) * math.tan(dw / 2.0)
    if DeltaOmega <= 0 or not math.isfinite(DeltaOmega):
        raise PeakParamError("invalid bandwidth")

    C = (F11 * DeltaOmega * DeltaOmega
         - 2.0 * W2 * (F01 - math.sqrt(F00 * F11)))
    D = 2.0 * W2 * (G01 - math.sqrt(G00 * G11))
    if (C + D) <= 0:
        raise PeakParamError("unsatisfiable constraints")
    A = math.sqrt((C + D) / F)
    B = math.sqrt((g2 * C + gb2 * D) / F)
    if not (math.isfinite(A) and math.isfinite(B)):
        raise PeakParamError("unsatisfiable constraints")

    den = 1.0 + W2 + A
    if den == 0 or not math.isfinite(den):
        raise PeakParamError("degenerate denominator")

    out = np.array([
        (G1 + G0 * W2 + B) / den,
        -2.0 * (G1 - G0 * W2) / den,
        (G1 + G0 * W2 - B) / den,
        -2.0 * (1.0 - W2) / den,
        (1.0 + W2 - A) / den])
    if not np.all(np.isfinite(out)):
        raise PeakParamError("non-finite coefficients")
    return out


def peak_orfanidis(freq: float, gain_db: float, q: float, sample_rate: float,
                   *, dc_gain_db: float | None = None,
                   nyquist_gain_db: float | None = None,
                   band_edge_gain_db: float | None = None) -> np.ndarray | None:
    """Audio-parameter Orfanidis peak (`peak_orfanidis.go:157-204`).

    Returns None if constraints can't be met (caller falls back to RBJ).
    """
    if sample_rate <= 0 or freq <= 0 or freq >= sample_rate / 2 or q <= 0:
        return None
    w0 = 2.0 * math.pi * freq / sample_rate
    G0 = 10.0 ** (dc_gain_db / 20.0) if dc_gain_db is not None else 1.0
    G1 = 10.0 ** (nyquist_gain_db / 20.0) if nyquist_gain_db is not None else 1.0
    # Direct dB mapping, default band-edge gain = half-gain in dB.
    # (The reference inverts the sign here, `peak_orfanidis.go:170-177`
    # — combined with its algebra bugs this makes its Orfanidis path
    # always fall back to RBJ; see peak_raw's deviation note.)
    G = 10.0 ** (gain_db / 20.0)
    GB = (10.0 ** (band_edge_gain_db / 20.0) if band_edge_gain_db is not None
          else 10.0 ** (gain_db / 40.0))

    dw = 2.0 * w0 * math.sinh((math.sin(w0) / w0) * math.asinh(1.0 / (2.0 * q)))
    if not (0 < dw < math.pi):
        return None
    try:
        c = peak_raw(G0, G1, G, GB, w0, dw)
    except PeakParamError:
        return None

    # Verify the realized center gain (peak_orfanidis.go:190-200)
    want = 10.0 ** (gain_db / 20.0)
    got_sq = float(magnitude_squared(c, freq, sample_rate)[0])
    if got_sq > 0 and math.isfinite(got_sq):
        got = math.sqrt(got_sq)
        if abs(got - want) <= 1e-2 * max(abs(got), abs(want)):
            return c
    return None


def peak_cascade(sample_rate: float, f0_hz: float, q: float, gain_db: float,
                 sections: int, **peak_kwargs) -> np.ndarray:
    """Cascade of identical peak sections sharing the total gain
    (`peak_orfanidis.go:128-155`)."""
    if sections <= 0:
        raise PeakParamError("sections must be > 0")
    if sample_rate <= 0 or f0_hz <= 0 or f0_hz >= sample_rate / 2 or q <= 0:
        raise PeakParamError("invalid parameters")
    from algodsp_tpu_torch.filters.design.rbj import peak as rbj_peak
    gain_per = gain_db / sections
    rows = [rbj_peak(f0_hz, gain_per, q, sample_rate, **peak_kwargs)
            for _ in range(sections)]
    out = np.stack(rows)
    if np.all(out == 0):
        raise PeakParamError("invalid peak parameters")
    return out
