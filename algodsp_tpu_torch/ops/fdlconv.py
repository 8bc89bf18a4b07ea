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
from functools import lru_cache

import numpy as np
import torch

from algodsp_tpu_torch import _build

MAX_BLOCK = 8192        # the largest partition the kernel takes
FFT_RADIX = 16          # points a thread holds in registers
FFT_BLOCK_THREADS = 256  # threads of an FFT block, unless one FFT needs more
MAC_THREADS = 128       # bins of one MAC block
SMS = 132               # H100 SXM streaming multiprocessors
# fdl_conv_f32(x, H, tw, X, Y, y, C, N, B, P, n16, rem, T, fpb, G, stream)
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


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


def fft_plan(B: int) -> tuple[int, int, int, int]:
    """How the kernel transforms a 2B-sample real frame, as the B-point
    complex FFT of its even/odd sample pairs: (n16, rem, threads,
    frames_per_block). B = 16**n16 * rem: n16 radix-16 stages, then one
    of radix rem (none when rem == 1); each of the `threads` threads of
    one FFT holds FFT_RADIX points (one thread below 16 points), and a
    block holds `frames_per_block` FFTs, FFT_BLOCK_THREADS threads in
    all where one FFT needs fewer."""
    n16, rem = 0, B
    while rem >= FFT_RADIX:
        rem //= FFT_RADIX
        n16 += 1
    threads = max(1, B // FFT_RADIX)
    return n16, rem, threads, max(1, FFT_BLOCK_THREADS // threads)


def mac_plan(C: int, nf: int, B: int) -> tuple[int, tuple[int, int, int]]:
    """Frames per MAC group G and the MAC grid (groups, bin slices, C).
    A thread holds G output sums and G frame spectra in registers, and
    reads a frame spectrum (G + P - 1) / G times: G is the largest power
    of two up to 16 (and up to the frame count) that still gives the
    card two blocks per SM."""
    slices = -(-(B + 1) // MAC_THREADS)
    G = min(16, 1 << (nf - 1).bit_length())
    while G > 1 and C * slices * -(-nf // G) < 2 * SMS:
        G //= 2
    return G, (-(-nf // G), slices, C)


def twiddle_table(B: int) -> np.ndarray:
    """The kernel's twiddles as (entries, 2) float32, computed in float64:
    the split table exp(-i pi k / B) for k < B, then for each FFT stage
    after the first (Ns > 1 points transformed so far, radix R) the
    factors W_{Ns R}^{jj i} = exp(-2 pi i jj i / (Ns R)) at
    [(i - 1) Ns + jj], i = 1..R-1, jj < Ns, so that a warp's loads of
    one stage are coalesced."""
    n16, rem, _, _ = fft_plan(B)
    parts = [np.exp(-1j * np.pi * np.arange(B) / B)]
    ns = 1
    for r in [FFT_RADIX] * n16 + ([rem] if rem > 1 else []):
        if ns > 1:
            i, jj = np.meshgrid(np.arange(1, r), np.arange(ns), indexing="ij")
            parts.append(np.exp(-2j * np.pi * (jj * i) / (ns * r)).reshape(-1))
        ns *= r
    tw = np.concatenate(parts)
    return np.stack([tw.real, tw.imag], -1).astype(np.float32)


@lru_cache(maxsize=16)
def _twiddles(B: int, device: str) -> torch.Tensor:
    """`twiddle_table(B)`, kept on `device`."""
    return torch.as_tensor(twiddle_table(B)).to(device)


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
    return _launch(x, hspec, B, mac_plan(C, N // B, B)[0])


def _launch(x, hspec, B: int, G: int):
    """Launch the kernel on checked arguments, with G frames per MAC
    group (chip_smoke.py also times other G at the main shapes)."""
    fn = _build.entry("fdlconv", "fdl_conv_f32", _ARGTYPES)
    # the kernel reads sample pairs and complex bins as float2
    if x.data_ptr() % 8:
        x = x.clone()
    if hspec.data_ptr() % 8:
        hspec = hspec.clone()
    C, N = x.shape
    P = hspec.shape[0]
    n16, rem, threads, fpb = fft_plan(B)
    tw = _twiddles(B, str(x.device))
    spectra = torch.empty((2, C, N // B, B + 1, 2), dtype=torch.float32,
                          device=x.device)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = fn(_build.ptr(x), _build.ptr(hspec), _build.ptr(tw),
                  _build.ptr(spectra[0]), _build.ptr(spectra[1]),
                  _build.ptr(y), C, N, B, P, n16, rem, threads, fpb, G,
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
    MAX_BLOCK (the kernel's largest partition); None
    when that is below 2^10 or an input is empty."""
    if n < 1 or m < 1:
        return None
    B = 1 << (min(m, MAX_BLOCK) - 1).bit_length()
    return B if B >= 1024 else None
