"""FIR filter runtime (counterpart of `algodsp_tpu/filters/fir.py`).

Streaming FIR with state carry (`filter.go:36-59`), block processing
(`filter.go:61-105`) and frequency response (`filter.go:179`). The
causal convolution runs directly for kernels of up to 64 taps and by
FFT above (`conv.conv.fftconvolve`, which sends float32 calls on the
card with 4096 taps or more to the FDL kernel). Streaming state is the
last taps-1 input samples.

The direct path is a sum of shifted, scaled copies of the input: plain
elementwise multiply-adds in the input's own precision. A float32
`conv1d` on the card would go through cuDNN in TF32 (about three
decimal digits) unless a global flag were flipped for the caller.
"""

from __future__ import annotations

import numpy as np
import torch

from algodsp_tpu_torch._device import resolve_device
from algodsp_tpu_torch.conv.conv import fftconvolve
from algodsp_tpu_torch.ops.fdlconv import kernel_spectra

# above this tap count the FFT path runs (the reference's 32-tap SIMD
# switch, `filter.go:61-105`, as the JAX package sets it)
_FFT_TAPS = 64
_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


class FIRFilter:
    """FIR filter with one-shot and streaming processing."""

    def __init__(self, coeffs):
        self.coeffs = np.asarray(coeffs, dtype=np.float64).reshape(-1)
        if self.coeffs.size == 0:
            raise ValueError("fir: empty coefficients")
        self._cache: dict[tuple, torch.Tensor] = {}

    @property
    def num_taps(self) -> int:
        return self.coeffs.size

    def _kernel(self, x) -> torch.Tensor:
        """The taps in x's dtype on x's device, copied there once."""
        key = ("taps", x.dtype, str(x.device))
        h = self._cache.get(key)
        if h is None:
            h = torch.as_tensor(self.coeffs).to(x.device, x.dtype)
            self._cache[key] = h
        return h

    def _spectra(self, B: int, device) -> torch.Tensor:
        """FDL partition spectra at block B on `device`, made once."""
        key = ("spectra", B, str(device))
        h = self._cache.get(key)
        if h is None:
            h = torch.as_tensor(kernel_spectra(self.coeffs, B)).to(device)
            self._cache[key] = h
        return h

    def _causal_conv(self, x):
        """y[n] = sum_k h[k] x[n-k] over the last axis, zero history."""
        t, n = self.num_taps, x.shape[-1]
        if t > _FFT_TAPS:
            return fftconvolve(x, self._kernel(x), "full",
                               spectra=self._spectra)[..., :n]
        # the taps rounded to x's dtype, as Python scalars
        h = self.coeffs.astype(_NP_DTYPES.get(x.dtype, np.float64)).tolist()
        xp = torch.nn.functional.pad(x, (t - 1, 0))
        y = h[0] * x
        for k in range(1, t):
            y = y + h[k] * xp[..., t - 1 - k:t - 1 - k + n]
        return y

    def process(self, x):
        """One-shot filtering from zero history (`filter.go:61-105`)."""
        return self._causal_conv(x)

    def init_state(self, batch_shape: tuple[int, ...] = (),
                   dtype=torch.float32, device=None):
        """History of the last taps-1 inputs (oldest first), on the CUDA
        card unless `device` says otherwise."""
        return torch.zeros(tuple(batch_shape) + (max(self.num_taps - 1, 0),),
                           dtype=dtype, device=resolve_device(device))

    def process_stream(self, state, x):
        """(state, x) -> (state, y) streaming blocks of any length."""
        t = self.num_taps
        if t == 1:
            return state, x * float(self.coeffs.astype(
                _NP_DTYPES.get(x.dtype, np.float64))[0])
        ext = torch.cat([state.to(x.dtype), x], dim=-1)
        y = self._causal_conv(ext)[..., t - 1:]
        return ext[..., -(t - 1):], y

    def frequency_response(self, freqs, sample_rate: float) -> np.ndarray:
        """Complex response H(e^{jw}) = sum h[k] e^{-jwk} (`filter.go:179`)."""
        f = np.atleast_1d(np.asarray(freqs, dtype=np.float64))
        w = 2.0 * np.pi * f / sample_rate
        k = np.arange(self.coeffs.size)
        return np.exp(-1j * np.outer(w, k)) @ self.coeffs
