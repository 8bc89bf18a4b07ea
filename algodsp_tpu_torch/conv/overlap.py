"""Overlap-add / overlap-save FFT block convolution with streaming state
(counterpart of `algodsp_tpu/conv/overlap.py`).

Fixed-configuration block convolvers carrying history across calls
(`overlap_add.go`, `overlap_save.go`, `streaming*.go`), plus one-shot
conveniences. A whole multi-hop input block is framed into (K, fft)
hops (a strided `unfold` view) and processed with one batched rfft,
bin product and irfft. Streaming state is explicit: overlap-save keeps
the last kernel_len-1 input samples, overlap-add the pending output
tail. Each convolver keeps its kernel's spectrum on a device once, per
device and type.
"""

from __future__ import annotations

import functools as _functools

import numpy as np
import torch

from algodsp_tpu_torch._device import resolve_device
from algodsp_tpu_torch.core.numeric import next_pow2

_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}


class _SpectrumOnDevice:
    """The kernel spectrum `_kfft` (complex128 NumPy) as a tensor, copied
    to each (device, type) once."""

    def _spectrum(self, like):
        ctype = _COMPLEX.get(like.dtype, torch.complex128)
        key = (like.device, ctype)
        spec = self._kfft_on.get(key)
        if spec is None:
            spec = torch.as_tensor(self._kfft).to(like.device, ctype)
            self._kfft_on[key] = spec
        return spec


class OverlapSave(_SpectrumOnDevice):
    """Overlap-save convolver (`overlap_save.go:32-257`).

    fft_size must be a power of two > kernel length. Step size =
    fft_size - kernel_len + 1; each hop keeps the last fft-step output
    samples (discarding the wrap-around prefix).
    """

    def __init__(self, kernel, fft_size: int | None = None):
        self.kernel = np.asarray(kernel, dtype=np.float64).reshape(-1)
        m = self.kernel.size
        if m == 0:
            raise ValueError("overlap-save: empty kernel")
        if fft_size is None:
            fft_size = max(next_pow2(4 * m), 64)
        if fft_size < next_pow2(m + 1) or fft_size & (fft_size - 1):
            raise ValueError(
                f"overlap-save: fft_size {fft_size} must be a power of two > kernel {m}")
        self.fft_size = int(fft_size)
        self.step = self.fft_size - m + 1
        self._kfft = np.fft.rfft(self.kernel, self.fft_size)
        self._kfft_on = {}

    @property
    def kernel_len(self) -> int:
        return self.kernel.size

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        """History = previous kernel_len-1 input samples (`overlap_save.go:47`)."""
        return torch.zeros(tuple(batch_shape) + (self.kernel_len - 1,),
                           dtype=dtype, device=resolve_device(device))

    def process_stream(self, state, x):
        """(state, x) -> (state, y): y is the causal convolution segment
        aligned with x (length = len(x))."""
        n = x.shape[-1]
        m = self.kernel_len
        ext = torch.cat([state.to(x.dtype), x], dim=-1)
        pad = (-n) % self.step
        ext_p = torch.nn.functional.pad(ext, (0, pad)) if pad else ext
        k = (n + pad) // self.step
        frames = ext_p.unfold(-1, self.fft_size, self.step)     # (..., k, fft)
        spec = torch.fft.rfft(frames, self.fft_size) * self._spectrum(x)
        out = torch.fft.irfft(spec, self.fft_size)[..., m - 1:].to(x.dtype)
        y = out.reshape(out.shape[:-2] + (k * self.step,))[..., :n]
        new_state = ext[..., ext.shape[-1] - (m - 1):]
        return new_state, y

    def process(self, x):
        """One-shot from zero history."""
        state = self.init_state(x.shape[:-1], x.dtype, x.device)
        _, y = self.process_stream(state, x)
        return y


class OverlapAdd(_SpectrumOnDevice):
    """Overlap-add convolver (`overlap_add.go:24-185`).

    Splits input into blocks of block_size, convolves each with the
    kernel at fft_size = next_pow2(block+kernel-1), overlap-adds tails.
    Streaming state = the pending output tail (kernel_len-1 samples).
    """

    def __init__(self, kernel, block_size: int):
        self.kernel = np.asarray(kernel, dtype=np.float64).reshape(-1)
        if self.kernel.size == 0:
            raise ValueError("overlap-add: empty kernel")
        if block_size <= 0:
            raise ValueError("overlap-add: block size must be > 0")
        self.block_size = int(block_size)
        self.fft_size = next_pow2(self.block_size + self.kernel.size - 1)
        self._kfft = np.fft.rfft(self.kernel, self.fft_size)
        self._kfft_on = {}

    @property
    def kernel_len(self) -> int:
        return self.kernel.size

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        return torch.zeros(tuple(batch_shape) + (max(self.kernel_len - 1, 1),),
                           dtype=dtype, device=resolve_device(device))

    def process_stream(self, state, x):
        """(state, x) -> (state, y). len(x) must be a multiple of
        block_size; y aligns with x (causal convolution segment)."""
        n = x.shape[-1]
        b = self.block_size
        if n % b:
            raise ValueError(f"overlap-add: input length {n} not a multiple of block {b}")
        k = n // b
        tail_len = state.shape[-1]
        lead = x.shape[:-1]
        blocks = x.reshape(lead + (k, b))
        spec = torch.fft.rfft(blocks, self.fft_size) * self._spectrum(x)
        conv = torch.fft.irfft(spec, self.fft_size)[..., :b + tail_len].to(x.dtype)
        if conv.shape[-1] < b + tail_len:
            conv = torch.nn.functional.pad(conv, (0, b + tail_len - conv.shape[-1]))
        # overlap-add the K frames (each b + tail_len long, one hop of b
        # apart) into one (k*b + tail) timeline: col2im on a 1-row image
        flat = conv.reshape(-1, k, b + tail_len).transpose(1, 2)
        y_full = torch.nn.functional.fold(
            flat, output_size=(1, k * b + tail_len), kernel_size=(1, b + tail_len),
            stride=(1, b)).reshape(lead + (k * b + tail_len,))
        y_full = torch.cat([y_full[..., :tail_len] + state.to(x.dtype),
                            y_full[..., tail_len:]], dim=-1)
        return y_full[..., n:], y_full[..., :n]

    def process(self, x):
        state = self.init_state(x.shape[:-1], x.dtype, x.device)
        _, y = self.process_stream(state, x)
        return y


# One-shot conveniences reuse convolver instances per (kernel, size),
# the analog of the reference's per-FFT-size sync.Pool
# (`overlap_add.go:190,221`), and with them their kernel spectra on the
# device.
@_functools.lru_cache(maxsize=32)
def _oa_cached(kernel_bytes: bytes, block_size: int) -> OverlapAdd:
    # .copy(): frombuffer views are read-only; cached instances must
    # behave identically to directly-constructed ones
    return OverlapAdd(np.frombuffer(kernel_bytes, np.float64).copy(), block_size)


@_functools.lru_cache(maxsize=32)
def _ols_cached(kernel_bytes: bytes, fft_size: int | None) -> OverlapSave:
    return OverlapSave(np.frombuffer(kernel_bytes, np.float64).copy(), fft_size)


def _host_kernel(kernel) -> np.ndarray:
    if torch.is_tensor(kernel):
        kernel = kernel.detach().cpu().numpy()
    return np.asarray(kernel, dtype=np.float64).reshape(-1)


def overlap_add_convolve(signal, kernel, block_size: int | None = None):
    """One-shot OA convolution, full length N+M-1 (`overlap_add.go:221-254`)."""
    kernel = _host_kernel(kernel)
    if block_size is None:
        block_size = max(next_pow2(kernel.size), 64)
    oa = _oa_cached(kernel.tobytes(), int(block_size))
    n, m = signal.shape[-1], kernel.size
    pad = (-n) % block_size + block_size  # room for the tail
    y = oa.process(torch.nn.functional.pad(signal, (0, pad)))
    return y[..., :n + m - 1]


def overlap_save_convolve(signal, kernel, fft_size: int | None = None):
    """One-shot OLS convolution, full length N+M-1 (`overlap_save.go:313-343`)."""
    kernel = _host_kernel(kernel)
    osv = _ols_cached(kernel.tobytes(),
                      None if fft_size is None else int(fft_size))
    n, m = signal.shape[-1], kernel.size
    y = osv.process(torch.nn.functional.pad(signal, (0, m - 1)))
    return y[..., :n + m - 1]
