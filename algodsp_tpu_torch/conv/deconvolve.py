"""Spectral deconvolution (counterpart of `algodsp_tpu/conv/deconvolve.py`).

Naive spectral division (`deconvolve.go:98-170`, raising on near-zero
kernel bins), Tikhonov-regularized (`:172-242`), Wiener with
noise-variance estimation (`:244-330`), FIR inverse-filter design
(`:359-415`), and the SNR metric (`:417`). The Wiener estimate of the
signal variance is the population variance, as `jnp.var` computes it.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from algodsp_tpu_torch.core.numeric import next_pow2


class DeconvMethod(enum.Enum):
    NAIVE = "naive"
    REGULARIZED = "regularized"
    WIENER = "wiener"


@dataclasses.dataclass(frozen=True)
class DeconvOptions:
    method: DeconvMethod = DeconvMethod.REGULARIZED
    epsilon: float = 1e-6
    noise_variance: float = 0.0
    signal_variance: float = 0.0


class DivisionByZeroError(ValueError):
    pass


def _out_len(n: int, m: int) -> int:
    out = n - m + 1
    return out if out > 0 else n


def _regularized(sf, kf, c: float):
    return sf * torch.conj(kf) / (torch.abs(kf) ** 2 + c)


def deconvolve(signal, kernel, options: DeconvOptions = DeconvOptions()):
    """Recover x from y = conv(x, h) (`deconvolve.go:72-96`), on the
    signal's device.

    signal: (..., N) tensor; kernel: (M,). Returns (..., N-M+1) (or N).
    """
    kernel = torch.as_tensor(kernel).reshape(-1).to(signal.device, signal.dtype)
    n, m = signal.shape[-1], kernel.shape[-1]
    if n == 0 or m == 0:
        raise ValueError("deconvolve: empty input")
    out_len = _out_len(n, m)
    size = next_pow2(n)
    sf = torch.fft.rfft(signal, size)
    kf = torch.fft.rfft(kernel, size)

    if options.method == DeconvMethod.NAIVE:
        if bool(torch.any(torch.abs(kf) < 1e-15)):
            raise DivisionByZeroError("deconvolve: kernel spectrum has near-zero bins")
        rf = sf / kf
    elif options.method == DeconvMethod.REGULARIZED:
        eps = options.epsilon if options.epsilon > 0 else 1e-6
        rf = _regularized(sf, kf, eps)
    elif options.method == DeconvMethod.WIENER:
        signal_var = options.signal_variance
        if signal_var <= 0:
            signal_var = float(torch.var(signal, correction=0))
        noise_var = options.noise_variance
        if noise_var <= 0:
            noise_var = signal_var * 0.01  # 1% heuristic (deconvolve.go:262-265)
        nsr = noise_var / signal_var if signal_var > 0 else 1e-6
        if nsr <= 0:
            nsr = 1e-6
        rf = _regularized(sf, kf, nsr)
    else:
        raise ValueError(f"unknown method {options.method}")

    return torch.fft.irfft(rf, size)[..., :out_len].to(signal.dtype)


def inverse_filter(kernel, length: int, epsilon: float = 1e-6) -> np.ndarray:
    """FIR approximation of 1/H (`deconvolve.go:359-415`). Host-side."""
    kernel = np.asarray(_host(kernel), dtype=np.float64).reshape(-1)
    if kernel.size == 0:
        raise ValueError("inverse_filter: empty kernel")
    if epsilon <= 0:
        epsilon = 1e-6
    size = next_pow2(length)
    kf = np.fft.rfft(kernel, size)
    inv = np.conj(kf) / (np.abs(kf) ** 2 + epsilon)
    return np.fft.irfft(inv, size)[:length]


def _host(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else a


def snr(original, recovered) -> float:
    """SNR in dB; noise = original - recovered (`deconvolve.go:417-440`).
    Host-side."""
    original = np.asarray(_host(original), dtype=np.float64)
    recovered = np.asarray(_host(recovered), dtype=np.float64)
    n = min(original.shape[-1], recovered.shape[-1])
    o = original[..., :n]
    r = recovered[..., :n]
    p_sig = float(np.sum(o * o))
    p_noise = float(np.sum((o - r) ** 2))
    if p_noise == 0:
        return np.inf
    if p_sig == 0:
        return -np.inf
    return 10.0 * np.log10(p_sig / p_noise)
