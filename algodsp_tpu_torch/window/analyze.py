"""Numeric window analysis via DFT search (counterpart of
`algodsp_tpu/window/analyze.py`).

Parity with `dsp/window/analyze.go:24-216`: coherent gain, ENBW, 3 dB
bandwidth (bisection), first spectral null (coarse scan + golden-section
refine), highest sidelobe (coarse scan + fine refine), scallop loss at
half-bin offset.

This is design-time analysis, so it runs host-side in NumPy float64.
The DFT magnitude evaluation is vectorized over the coefficient axis
(the Go code's per-sample loop `analyze.go:77-88` becomes a dot
product), which makes the coarse scans matmuls over all probe
frequencies at once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_GOLDEN = 0.6180339887498949


@dataclasses.dataclass(frozen=True)
class Analysis:
    coherent_gain: float
    enbw: float
    bandwidth_3db: float
    highest_sidelobe_db: float
    first_minimum_bins: float
    scallop_loss_db: float


def _dft_magsq(coeffs: np.ndarray, freqs) -> np.ndarray:
    """|DFT(f)|^2 at normalized frequencies, vectorized over freqs."""
    freqs = np.atleast_1d(np.asarray(freqs, dtype=np.float64))
    k = np.arange(coeffs.size, dtype=np.float64)
    phase = 2.0 * np.pi * np.outer(freqs, k)
    re = np.cos(phase) @ coeffs
    im = -np.sin(phase) @ coeffs
    return re * re + im * im


def analyze(coeffs) -> Analysis:
    """Numeric properties of a window (`analyze.go:24-90`); takes a
    NumPy array or a tensor on any device."""
    if isinstance(coeffs, torch.Tensor):
        coeffs = coeffs.detach().to("cpu", torch.float64).numpy()
    c = np.asarray(coeffs, dtype=np.float64)
    n = c.size
    if n == 0:
        return Analysis(0.0, 0.0, 0.0, 0.0, 0.0, 0.0)

    dc_ref = float(_dft_magsq(c, 0.0)[0])
    if dc_ref == 0:
        return Analysis(0.0, 0.0, 0.0, 0.0, 0.0, 0.0)

    s = c.sum()
    coherent_gain = s / n
    enbw = n * float((c * c).sum()) / (s * s)

    half_bin = float(_dft_magsq(c, 0.5 / n)[0])
    scallop = 10.0 * np.log10(half_bin / dc_ref) if half_bin > 0 else 0.0

    # 3 dB bandwidth by bisection on [0, 0.5] (analyze.go:92-113).
    lo, hi = 0.0, 0.5
    inv_ref = 1.0 / dc_ref
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if float(_dft_magsq(c, mid)[0]) * inv_ref > 0.5:
            lo = mid
        else:
            hi = mid
    bw3 = 2.0 * lo * n

    first_min = _first_minimum(c, n, dc_ref)
    sidelobe = _highest_sidelobe(c, n, dc_ref, first_min)

    return Analysis(float(coherent_gain), float(enbw), float(bw3),
                    float(sidelobe), float(first_min), float(scallop))


def _first_minimum(c: np.ndarray, n: int, dc_val: float) -> float:
    # Coarse scan at 1/8-bin steps for the first turn-around below the 10%
    # plateau threshold (analyze.go:117-139), then golden-section refine.
    step = 1.0 / (n * 8)
    freqs = np.arange(step, 0.5, step)
    vals = _dft_magsq(c, freqs)
    threshold = dc_val * 0.1

    prev = np.concatenate(([dc_val], vals[:-1]))
    turn = (prev < threshold) & (vals > prev)
    idx = np.argmax(turn) if turn.any() else None
    coarse = freqs[idx] - step if idx is not None else step

    a = max(coarse - 2 * step, 0.0)
    b = min(coarse + 2 * step, 0.5)
    x1 = b - _GOLDEN * (b - a)
    x2 = a + _GOLDEN * (b - a)
    for _ in range(80):
        f1 = float(_dft_magsq(c, x1)[0])
        f2 = float(_dft_magsq(c, x2)[0])
        if f1 < f2:
            b = x2
        else:
            a = x1
        x1 = b - _GOLDEN * (b - a)
        x2 = a + _GOLDEN * (b - a)
    return 0.5 * (a + b) * n


def _highest_sidelobe(c: np.ndarray, n: int, dc_ref: float, first_min_bins: float) -> float:
    start = first_min_bins / n
    step = 1.0 / (n * 8)
    freqs = np.arange(start, 0.5, step)
    if freqs.size == 0:
        return -np.inf
    vals = _dft_magsq(c, freqs)
    pk = int(np.argmax(vals))
    peak_val = float(vals[pk])
    peak_freq = float(freqs[pk])

    fine = np.arange(peak_freq - step, peak_freq + step, step / 32)
    fine = fine[fine >= 0]
    if fine.size:
        peak_val = max(peak_val, float(_dft_magsq(c, fine).max()))

    if peak_val <= 0 or dc_ref <= 0:
        return -np.inf
    return 10.0 * np.log10(peak_val / dc_ref)
