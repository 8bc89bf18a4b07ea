"""Linear and circular convolution (counterpart of
`algodsp_tpu/conv/conv.py`).

Direct (time-domain, `conv.go:76-127`), DirectCircular
(`conv.go:158-192`), Convolve with automatic direct-vs-FFT selection at
kernel length >= FFT_THRESHOLD (`conv.go:194-218`), and one-shot FFT
convolution, with Full/Same/Valid output modes (`conv.go:56-69`); the
signal broadcasts over leading dims, the kernel is 1-D.

`direct` is one `conv1d` with the flipped kernel (conv1d is a
cross-correlation), run under `linrec.full_float32_conv()`: cuDNN would
otherwise round float32 products to TF32 by default, where the reference
pins `Precision.HIGHEST`.

`fftconvolve`: float32 calls on the card with a kernel of 4096 taps or
more run the FDL kernel of `ops/fdlconv.py` (as the JAX package sends
them to its fused Pallas FDL); everything else runs one `torch.fft`
product at the next power of two. Both branches are differentiable in
`a` and in a tensor `b`: the FDL branch through `ops.fdlconv.FDLConvFn`,
with the spectra of a `b` that requires grad computed on the device by
`kernel_spectra_torch` (as the reference's `_fftconvolve_jit` does
through `kernel_spectra_jax`).
"""

from __future__ import annotations

import numpy as np
import torch

from algodsp_tpu_torch import _build
from algodsp_tpu_torch.core.numeric import next_pow2
from algodsp_tpu_torch.ops.fdlconv import (
    fdl_conv, kernel_spectra, kernel_spectra_torch, pick_block)
from algodsp_tpu_torch.ops.linrec import full_float32_conv

__all__ = ["FFT_THRESHOLD", "convolve", "direct", "direct_circular",
           "fftconvolve", "next_pow2"]

# Kernel length at which Convolve switches to FFT (conv.go:24-28).
FFT_THRESHOLD = 32

_MODES = ("full", "same", "valid")
FDL_MIN_TAPS = 4096


def _trim_to_mode(full, len_a: int, len_b: int, mode: str):
    """Full/Same/Valid windowing of the full convolution (`conv.go:229-248`)."""
    if mode == "full":
        return full
    if mode == "same":
        start = (len_b - 1) // 2
        return full[..., start:start + len_a]
    if mode == "valid":
        n = max(len_a, len_b) - min(len_a, len_b) + 1
        start = min(len_a, len_b) - 1
        return full[..., start:start + n]
    raise ValueError(f"unknown mode {mode!r}; expected one of {_MODES}")


def _kernel_of(b, a):
    """The 1-D kernel b (a tensor or array-like) on a's device, in a's
    type."""
    return torch.as_tensor(b).reshape(-1).to(a.device, a.dtype)


def direct(a, b, mode: str = "full"):
    """Time-domain linear convolution (`conv.go:76-127`), on a's device.

    a: (..., N) signal tensor; b: (M,) kernel. Output (..., N+M-1) for
    "full".
    """
    b = _kernel_of(b, a)
    n, m = a.shape[-1], b.shape[-1]
    if n == 0 or m == 0:
        raise ValueError("conv: empty input")
    with full_float32_conv():
        y = torch.nn.functional.conv1d(a.reshape(-1, 1, n),
                                       b.flip(0).reshape(1, 1, m),
                                       padding=m - 1)
    full = y.reshape(a.shape[:-1] + (n + m - 1,))
    return _trim_to_mode(full, n, m, mode)


def direct_circular(a, b):
    """Circular convolution of length N = len(a) (`conv.go:158-192`).

    b is zero-padded (or wrapped) to N.
    """
    b = _kernel_of(b, a)
    n, m = a.shape[-1], b.shape[-1]
    if n == 0 or m == 0:
        raise ValueError("conv: empty input")
    full = direct(a, b, mode="full")
    head, tail = full[..., :n], full[..., n:]
    if tail.shape[-1] == 0:
        return head
    tail = torch.nn.functional.pad(tail, (0, (-tail.shape[-1]) % n))
    return head + tail.reshape(tail.shape[:-1] + (-1, n)).sum(dim=-2)


def convolve(a, b, mode: str = "full"):
    """Auto-selecting convolution: direct for short kernels, FFT once the
    kernel reaches FFT_THRESHOLD taps (`conv.go:194-218`)."""
    if int(np.prod(np.shape(b))) >= FFT_THRESHOLD:
        return fftconvolve(a, b, mode)
    return direct(a, b, mode)


def fftconvolve(a, b, mode: str = "full", *, spectra=None):
    """Linear convolution of a (..., N) with the 1-D kernel b (a tensor or
    a NumPy array) by FFT.

    spectra: optional `(B, device) -> hspec` giving the kernel's FDL
    partition spectra (`ops.fdlconv.kernel_spectra` layout), so a caller
    that convolves with one kernel many times keeps them on the device
    instead of computing them on every call. A `b` that requires grad
    (in grad mode) bypasses it: a cached spectrum would cut the
    gradient."""
    n, m = a.shape[-1], int(np.prod(np.shape(b)))
    if n == 0 or m == 0:
        raise ValueError("conv: empty input")
    total = n + m - 1
    if (a.device.type == "cuda" and a.dtype == torch.float32
            and m >= FDL_MIN_TAPS):
        B = pick_block(m, n)
        if _build.wants_grad(b):
            hspec = kernel_spectra_torch(b.to(a.device, torch.float32), B,
                                         -(-m // B))
        elif spectra is not None:
            hspec = spectra(B, a.device)
        else:
            h = (b.detach().to("cpu", torch.float64).numpy()
                 if torch.is_tensor(b) else np.asarray(b, np.float64))
            hspec = torch.as_tensor(kernel_spectra(h, B)).to(a.device)
        padded = -(-total // B) * B
        flat = torch.nn.functional.pad(a.reshape(-1, n), (0, padded - n))
        y = fdl_conv(flat.contiguous(), hspec, B)[:, :total]
        return _trim_to_mode(y.reshape(a.shape[:-1] + (total,)), n, m, mode)
    b = torch.as_tensor(b).reshape(-1).to(a.device, a.dtype)
    size = next_pow2(total)
    full = torch.fft.irfft(torch.fft.rfft(a, size) * torch.fft.rfft(b, size),
                           size)[..., :total]
    return _trim_to_mode(full, n, m, mode)
