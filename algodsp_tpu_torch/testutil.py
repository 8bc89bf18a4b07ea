"""Deterministic test signals and tolerance helpers (counterpart of
`algodsp_tpu/testutil.py`).

Capability parity with `internal/testutil/` (`signals.go:9-55`,
`tolerance.go:11,39`): seeded deterministic signals and SNR/max-diff
assertions, exposed publicly so downstream users can test their own
DSP the same way the framework tests itself. The signals are host
float64 NumPy arrays (the oracles' side); the comparisons take NumPy
arrays or tensors on any device.
"""

from __future__ import annotations

import numpy as np
import torch


def _host64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().to("cpu")
        if a.is_complex():
            a = a.to(torch.complex128)
        elif a.dtype != torch.float64:
            a = a.to(torch.float64)
        return a.numpy()
    return np.asarray(a, dtype=np.float64)


def sine(freq_hz: float, sample_rate: float, n: int,
         amplitude: float = 1.0) -> np.ndarray:
    return amplitude * np.sin(2.0 * np.pi * freq_hz * np.arange(n) / sample_rate)


def seeded_noise(n: int, seed: int = 1, amplitude: float = 1.0) -> np.ndarray:
    return amplitude * np.random.default_rng(seed).standard_normal(n)


def impulse(n: int, pos: int = 0, amplitude: float = 1.0) -> np.ndarray:
    out = np.zeros(n)
    out[pos] = amplitude
    return out


def dc(n: int, value: float = 1.0) -> np.ndarray:
    return np.full(n, value)


def max_abs_diff(a, b) -> float:
    """Largest absolute elementwise difference (`tolerance.go:39`)."""
    return float(np.max(np.abs(_host64(a) - _host64(b))))


def snr_db(reference, test) -> float:
    """Signal-to-error ratio in dB, the parity metric used throughout
    the test suite."""
    reference = _host64(reference)
    test = _host64(test)
    err = reference - test
    p_sig = float(np.sum(reference * reference))
    p_err = float(np.sum(err * err))
    if p_err == 0:
        return np.inf
    if p_sig == 0:
        return -np.inf
    return 10.0 * np.log10(p_sig / p_err)


def require_slice_nearly_equal(a, b, tolerance: float = 1e-9,
                               message: str = ""):
    """Assert elementwise closeness (`tolerance.go:11`)."""
    d = max_abs_diff(a, b)
    if d > tolerance:
        raise AssertionError(
            f"{message or 'slices differ'}: max abs diff {d} > {tolerance}")
