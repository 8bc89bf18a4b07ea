"""Goertzel single/multi-bin tone analysis as a matrix product
(counterpart of `algodsp_tpu/spectrum/goertzel.py`).

Capability parity with `dsp/spectrum/goertzel.go` (NewGoertzel,
ProcessSample/ProcessBlock, Power/Magnitude/PowerDB, MultiGoertzel,
AnalyzeBlock).

The Goertzel recurrence
    s_n = x_n + 2cos(w)*s_{n-1} - s_{n-2}          (goertzel.go:72-76)
is a constant-coefficient linear recurrence, so its end state after a
block has the closed form

    s0 = sum_j x_j * U_{N-1-j}(cos w)
    s1 = sum_j x_j * U_{N-2-j}(cos w)

with U_k the Chebyshev polynomials of the second kind
(U_k(cos w) = sin((k+1)w)/sin(w)). The two basis vectors per target
frequency are designed on the host in float64 (the reference's code),
made a tensor once per (frequencies, rate, length, type, device), and a
block is one (..., N) x (N, 2K) product for K frequencies. Streaming
continuity across blocks is an exact 2x2 state propagation
A^N = [[U_N, -U_{N-1}], [U_{N-1}, -U_{N-2}]]. Both products run in full
float32 under `linrec.full_float32()` (the reference pins
`Precision.HIGHEST`), whatever the caller set.

Power = s0^2 + s1^2 - coeff*s0*s1 (`goertzel.go:95-97`).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from algodsp_tpu_torch._device import resolve_device
from algodsp_tpu_torch.ops.linrec import full_float32

_TINY_SIN = 1e-12


def _cheb_u(ks: np.ndarray, omega: np.ndarray) -> np.ndarray:
    """U_k(cos w) = sin((k+1)w)/sin(w), vectorized; k=-1 gives 0.

    Degenerate w (sin w ~ 0, i.e. DC/Nyquist): U_k(±1) = (k+1)(±1)^k.
    ks: (...,) ints; omega: broadcastable.
    """
    ks = np.asarray(ks, dtype=np.float64)
    omega = np.asarray(omega, dtype=np.float64)
    s = np.sin(omega)
    degenerate = np.abs(s) < _TINY_SIN
    safe_s = np.where(degenerate, 1.0, s)
    regular = np.sin((ks + 1.0) * omega) / safe_s
    sign = np.where(np.cos(omega) >= 0, 1.0, (-1.0) ** np.mod(ks, 2))
    limit = (ks + 1.0) * sign
    return np.where(degenerate, limit, regular)


@lru_cache(maxsize=64)
def _basis_cached(freqs_key: tuple[float, ...], sample_rate: float, n: int):
    """Basis (N, K, 2) with [:, :, 0] -> s0 weights, [:, :, 1] -> s1 weights,
    plus the per-frequency 2x2 block propagation matrices (K, 2, 2)."""
    freqs = np.asarray(freqs_key, dtype=np.float64)
    omega = 2.0 * np.pi * freqs / sample_rate  # (K,)
    j = np.arange(n, dtype=np.float64)[:, None]  # (N, 1)
    u0 = _cheb_u(n - 1 - j, omega[None, :])  # U_{N-1-j}
    u1 = _cheb_u(n - 2 - j, omega[None, :])  # U_{N-2-j}; j=N-1 -> U_{-1}=0
    basis = np.stack([u0, u1], axis=-1)  # (N, K, 2)

    un = _cheb_u(np.asarray([n, n - 1, n - 2], dtype=np.float64)[:, None], omega[None, :])
    prop = np.empty((freqs.size, 2, 2), dtype=np.float64)
    prop[:, 0, 0] = un[0]
    prop[:, 0, 1] = -un[1]
    prop[:, 1, 0] = un[1]
    prop[:, 1, 1] = -un[2]
    return basis, prop


def _validate(freqs: np.ndarray, sample_rate: float):
    if not (sample_rate > 0) or not np.isfinite(sample_rate):
        raise ValueError(f"goertzel: sample rate must be > 0: {sample_rate}")
    if np.any(freqs < 0) or np.any(freqs > sample_rate / 2) or not np.all(np.isfinite(freqs)):
        raise ValueError("goertzel: frequency must be between 0 and sampleRate/2")


@lru_cache(maxsize=64)
def _device_basis(freqs_key: tuple[float, ...], sample_rate: float, n: int,
                  dtype: torch.dtype, device: torch.device):
    """The basis as an (N, 2K) tensor (columns [s0_k, s1_k] per
    frequency) and the propagation (K, 2, 2), of `dtype` on `device`."""
    basis, prop = _basis_cached(freqs_key, sample_rate, n)
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                     device=device)
    return as_t(basis.reshape(n, -1)), as_t(prop)


class Goertzel:
    """Multi-frequency Goertzel analyzer with streaming state.

    One object covers both `Goertzel` and `MultiGoertzel` from the
    reference: pass one or many target frequencies. State is an explicit
    (..., K, 2) tensor.
    """

    def __init__(self, frequencies, sample_rate: float):
        freqs = np.atleast_1d(np.asarray(frequencies, dtype=np.float64))
        _validate(freqs, float(sample_rate))
        self.frequencies = freqs
        self.sample_rate = float(sample_rate)
        self._coeff = 2.0 * np.cos(2.0 * np.pi * freqs / sample_rate)

    @property
    def coeff(self) -> np.ndarray:
        return self._coeff

    def init_state(self, batch_shape: tuple[int, ...] = (),
                   dtype=torch.float32, device=None):
        """Zero state (..., K, 2), on the CUDA card unless `device` says
        otherwise."""
        return torch.zeros(tuple(batch_shape) + (self.frequencies.size, 2),
                           dtype=dtype, device=resolve_device(device))

    def process_block(self, state, x):
        """Fold a block of samples (last axis = time) into the state.

        Equivalent to per-sample iteration of `goertzel.go:72-88`, but
        evaluated as a basis product plus a 2x2 state propagation, in
        x's type on its device.
        """
        n = x.shape[-1]
        k = self.frequencies.size
        basis, prop = _device_basis(tuple(self.frequencies), self.sample_rate,
                                    n, x.dtype, x.device)
        with full_float32():
            driven = torch.matmul(x.reshape(-1, n), basis).reshape(
                x.shape[:-1] + (k, 2))
            carried = torch.einsum("kst,...kt->...ks", prop,
                                   state.to(x.dtype))
        return carried + driven

    def power(self, state):
        """|X|^2 from state (`goertzel.go:95-97`)."""
        s0 = state[..., 0]
        s1 = state[..., 1]
        coeff = torch.as_tensor(self._coeff, dtype=state.dtype,
                                device=state.device)
        return s0 * s0 + s1 * s1 - coeff * s0 * s1

    def magnitude(self, state):
        return torch.sqrt(torch.clamp(self.power(state), min=0.0))

    def power_db(self, state):
        """Power in dB floored at -300 (`goertzel.go:109-115`)."""
        return _power_db(self.power(state))


def _power_db(p):
    return torch.where(p <= 1e-30, torch.full_like(p, -300.0),
                       10.0 * torch.log10(torch.clamp(p, min=1e-300)))


def goertzel_power(x, frequencies, sample_rate: float):
    """One-shot block power, the analog of `AnalyzeBlock`
    (`goertzel.go:149-158`), on x's device.

    x: (..., N); frequencies: scalar or (K,). Returns (...,) or (..., K).
    """
    g = Goertzel(frequencies, sample_rate)
    state = g.init_state(x.shape[:-1], dtype=x.dtype, device=x.device)
    p = g.power(g.process_block(state, x))
    if np.isscalar(frequencies) or np.ndim(frequencies) == 0:
        return p[..., 0]
    return p


def goertzel_magnitude(x, frequencies, sample_rate: float):
    p = goertzel_power(x, frequencies, sample_rate)
    return torch.sqrt(torch.clamp(p, min=0.0))


def goertzel_power_db(x, frequencies, sample_rate: float):
    return _power_db(goertzel_power(x, frequencies, sample_rate))
