"""Zero-state uniformly partitioned FDL convolution: the CUDA kernel
`csrc/fdlconv.cu` and its plain PyTorch version.

Replaces the Pallas kernels `algodsp_tpu/ops/fdlconv.py::_fdl_fused_multi`
(C >= 2) and `::_fdl_fused_single` (C = 1), front door
`fdl_conv_fused`: one kernel family here serves every channel count.

Contract: x (C, N) float32 with N % B == 0, convolved from zero state
with the kernel whose partition spectra are `hspec`; overlap-save frames
of 2B samples, 50% overlap, the B kept samples per frame. The spectra
layout is this port's own: `kernel_spectra` gives (P, B+1, 2) float32,
the rfft of each B-tap partition at 2B points in natural bin order
(re, im), not the TPU's (k1, k2) grid.

`fdl_conv` launches the kernel for CUDA tensors and uses
`fdl_conv_plain` (torch.fft frames -> P-tap MAC -> irfft) only for CPU
tensors. Forward only: the custom VJP comes with the `diff.py` slice.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import numpy as np
import torch

from algodsp_tpu_torch import _build

MAX_BLOCK = 8192  # a 2B-point complex frame must fit in 227 KB of shared memory
# fdl_conv_f32(x, H, tw, X, y, C, N, B, P, stream)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def kernel_spectra(kernel, B: int) -> np.ndarray:
    """Partition spectra (P, B+1, 2) float32: rfft of each B-tap
    partition of `kernel` zero-padded to 2B points (float64 on the host)."""
    kernel = np.asarray(kernel, np.float64).reshape(-1)
    P = -(-kernel.size // B)
    padded = np.zeros(P * B)
    padded[:kernel.size] = kernel
    spec = np.fft.rfft(padded.reshape(P, B), 2 * B, axis=-1)   # (P, B+1)
    return np.stack([spec.real, spec.imag], -1).astype(np.float32)


def fdl_conv_plain(x, hspec, B: int):
    """Plain PyTorch FDL: rfft of the 2B-sample frames, the P-tap
    spectral MAC along the frame axis, irfft, keep the second half."""
    C, N = x.shape
    nf = N // B
    ext = torch.cat([x.new_zeros(C, B), x], dim=-1)
    frames = ext.unfold(-1, 2 * B, B)                           # (C, nf, 2B)
    X = torch.fft.rfft(frames, dim=-1)                          # (C, nf, B+1)
    H = torch.view_as_complex(hspec.to(x.dtype).contiguous())   # (P, B+1)
    acc = torch.zeros_like(X)
    for p in range(min(H.shape[0], nf)):
        acc[:, p:] += H[p] * X[:, :nf - p]
    y = torch.fft.irfft(acc, n=2 * B, dim=-1)[..., B:]
    return y.reshape(C, N)


@lru_cache(maxsize=16)
def _twiddles(B: int, device: str) -> torch.Tensor:
    """exp(-i pi k / B) for k < B as (B, 2) float32, computed in float64
    on the host and kept on `device`."""
    ang = np.arange(B) * (-math.pi / B)
    tw = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    return torch.as_tensor(tw).to(device)


def fdl_conv(x, hspec, B: int):
    """Zero-state FDL convolution of x (C, N) with partition spectra
    hspec (P, B+1, 2). CUDA tensors run the kernel (float32, contiguous,
    B a power of two up to MAX_BLOCK); CPU tensors run `fdl_conv_plain`."""
    if x.ndim != 2 or x.shape[-1] % B:
        raise ValueError(f"fdl_conv: x must be (C, N) with N % {B} == 0, "
                         f"got {tuple(x.shape)}")
    if hspec.ndim != 3 or hspec.shape[1:] != (B + 1, 2):
        raise ValueError(f"fdl_conv: hspec must be (P, {B + 1}, 2), "
                         f"got {tuple(hspec.shape)}")
    if x.device.type == "cpu":
        return fdl_conv_plain(x, hspec, B)
    if x.device.type != "cuda":
        raise ValueError(f"fdl_conv: unsupported device {x.device}")
    fn = _build.entry("fdlconv", "fdl_conv_f32", _ARGTYPES)
    C, N = x.shape
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"fdl_conv: the kernel takes contiguous float32, "
                         f"got {x.dtype}")
    if (hspec.dtype != torch.float32 or hspec.device != x.device
            or not hspec.is_contiguous()):
        raise ValueError("fdl_conv: hspec must be contiguous float32 on "
                         f"{x.device}")
    if B < 2 or B > MAX_BLOCK or B & (B - 1) or not 1 <= C <= 65535 or N < B:
        raise ValueError(f"fdl_conv: the kernel takes B a power of two in "
                         f"[2, {MAX_BLOCK}], 1 <= C <= 65535 and N >= B; got "
                         f"B={B}, C={C}, N={N}")
    P = hspec.shape[0]
    tw = _twiddles(B, str(x.device))
    scratch = torch.empty((C, N // B, B + 1, 2), dtype=torch.float32,
                          device=x.device)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = fn(_build.ptr(x), _build.ptr(hspec), _build.ptr(tw),
                  _build.ptr(scratch), _build.ptr(y), C, N, B, P,
                  _build.stream_of(x))
        fdl_conv.launches += 1
    _build.check("fdlconv", code, "fdl_conv")
    return y


fdl_conv.launches = 0


def pick_block(m: int, n: int) -> int | None:
    """Partition size for a one-shot FDL convolution of an m-tap kernel
    over n samples (counterpart of `algodsp_tpu/ops/fdlconv.py::
    pick_block`, sized to this kernel's limits instead of the v5e's
    VMEM): the kernel's length rounded up to a power of two, at most
    MAX_BLOCK (a 2B-point complex frame must fit in shared memory); None
    when that is below 2^10 or an input is empty."""
    if n < 1 or m < 1:
        return None
    B = 1 << (min(m, MAX_BLOCK) - 1).bit_length()
    return B if B >= 1024 else None
