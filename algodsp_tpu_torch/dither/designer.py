"""Stochastic noise-shaper designer against the absolute threshold of
hearing (counterpart of `algodsp_tpu/dither/designer.py`, host-side
NumPy, kept here as a copy so that the port stands alone).

Capability parity with `dsp/dither/design/`: optimizes FIR
error-feedback coefficients so the shaped quantization-noise spectrum
hugs the ATH curve (`design/designer.go:22-70`, `design/ath.go`), with
deterministic seeding and a progress callback.

Each candidate's ATH-weighted cost is
|1 - C(e^{jw})|^2-weighted noise power over a frequency grid — all
candidates of a generation evaluate in one batched matmul, so the
stochastic search is generation-parallel.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def ath_weight_db(freq_hz: np.ndarray) -> np.ndarray:
    """Absolute threshold of hearing (Terhardt's approximation), dB SPL."""
    f = np.maximum(np.asarray(freq_hz, dtype=np.float64), 20.0) / 1000.0
    return (3.64 * f ** -0.8
            - 6.5 * np.exp(-0.6 * (f - 3.3) ** 2)
            + 1e-3 * f ** 4)


def _shaped_noise_cost(coeffs: np.ndarray, freqs: np.ndarray,
                       inv_ath_lin: np.ndarray, sample_rate: float) -> np.ndarray:
    """Cost per candidate: mean ATH-weighted shaped-noise power.

    coeffs: (C, K); returns (C,). Error feedback gives noise transfer
    N(z) = 1 - sum_k c_k z^-(k+1).
    """
    k = np.arange(1, coeffs.shape[1] + 1)
    w = 2.0 * np.pi * freqs / sample_rate
    basis = np.exp(-1j * np.outer(w, k))          # (F, K)
    ntf = 1.0 - coeffs @ basis.T                   # (C, F)
    power = np.abs(ntf) ** 2
    return (power * inv_ath_lin[None, :]).mean(axis=1)


def design_shaper(sample_rate: float, order: int = 9, *,
                  iterations: int = 200, population: int = 64,
                  seed: int = 1,
                  progress: Callable[[int, float], None] | None = None
                  ) -> np.ndarray:
    """Evolve FIR shaper coefficients against the ATH curve.

    Deterministic per seed; `progress(iteration, best_cost)` mirrors the
    reference's callback (`design/designer.go:22-70`).
    """
    if order < 1 or order > 32:
        raise ValueError(f"designer: order must be in [1, 32]: {order}")
    rng = np.random.default_rng(seed)
    freqs = np.linspace(20.0, sample_rate / 2 * 0.95, 256)
    ath = ath_weight_db(freqs)
    # weight = inverse of permissible noise: lower ATH -> more weight
    inv_ath_lin = 10.0 ** (-(ath - ath.min()) / 10.0)

    best = np.zeros(order)
    best_cost = float(_shaped_noise_cost(best[None, :], freqs,
                                         inv_ath_lin, sample_rate)[0])
    scale = 1.0
    for it in range(iterations):
        cands = best[None, :] + rng.standard_normal((population, order)) * scale
        # stability guard: keep noise-gain bounded
        cands = np.clip(cands, -4.0, 4.0)
        costs = _shaped_noise_cost(cands, freqs, inv_ath_lin, sample_rate)
        i = int(np.argmin(costs))
        if costs[i] < best_cost:
            best, best_cost = cands[i], float(costs[i])
        else:
            scale *= 0.97
        if progress is not None:
            progress(it, best_cost)
    return best
