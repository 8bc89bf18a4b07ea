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
tensors. It is differentiable in both arguments through `FDLConvFn`, the
port of the reference's custom VJP `_fdl_bwd`: the signal adjoint is one
more launch of the same kernel on the time-reversed cotangent, the
spectra adjoint is the kernel `fdl_spectra_adjoint` of the same source
(plain version `fdl_spectra_adjoint_plain` on the CPU).
`kernel_spectra_torch` computes the spectra from an IR on the device,
differentiably, so an IR is learnable through the kernel.
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
SPEC_ADJ_THREADS = 64   # bins of one spectra-adjoint block
SPEC_ADJ_MAX_G = 8      # lags a spectra-adjoint thread holds
SMS = 132               # H100 SXM streaming multiprocessors
# fdl_conv_f32(x, H, tw, X, Y, y, C, N, B, P, n16, rem, T, fpb, G, stream)
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
# fdl_spectra_adjoint_f32(X, dV, dH, C, nf, B, P, G, stream)
_ADJ_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def kernel_spectra(kernel, B: int) -> np.ndarray:
    """Partition spectra (P, B+1, 2) float32: rfft of each B-tap
    partition of `kernel` zero-padded to 2B points (float64 on the host)."""
    kernel = np.asarray(kernel, np.float64).reshape(-1)
    P = -(-kernel.size // B)
    padded = np.zeros(P * B)
    padded[:kernel.size] = kernel
    spec = np.fft.rfft(padded.reshape(P, B), 2 * B, axis=-1)   # (P, B+1)
    return np.stack([spec.real, spec.imag], -1).astype(np.float32)


def kernel_spectra_torch(h, B: int, P: int):
    """Partition spectra (P, B+1, 2) of the IR tensor `h` on its own
    device, differentiable in `h` (counterpart of the reference's
    `kernel_spectra_jax`): rfft of each B-tap partition of h, zero-padded
    to P*B taps, at 2B points. float32 unless h is float64."""
    h = h.reshape(-1)
    if h.dtype != torch.float64:
        h = h.to(torch.float32)
    if h.numel() > P * B:
        raise ValueError(f"kernel_spectra_torch: {h.numel()} taps exceed "
                         f"P * B = {P * B}")
    parts = torch.nn.functional.pad(h, (0, P * B - h.numel())).reshape(P, B)
    return torch.view_as_real(torch.fft.rfft(parts, 2 * B, dim=-1))


def frame_spectra_plain(x, B: int):
    """rfft of the overlap-save frames x[(f-1)B : (f+1)B] (x < 0 read as
    0) of x (C, N): (C, N/B, B+1) complex."""
    C = x.shape[0]
    ext = torch.cat([x.new_zeros(C, B), x], dim=-1)
    return torch.fft.rfft(ext.unfold(-1, 2 * B, B), dim=-1)


def _fdl_from_spectra(X, hspec, B: int, dtype):
    """The P-tap MAC along the frame axis of the frame spectra X, irfft,
    the second half of each frame kept: (C, N)."""
    C, nf = X.shape[:2]
    H = torch.view_as_complex(hspec.to(dtype).contiguous())     # (P, B+1)
    acc = torch.zeros_like(X)
    for p in range(min(H.shape[0], nf)):
        acc[:, p:] += H[p] * X[:, :nf - p]
    return torch.fft.irfft(acc, n=2 * B, dim=-1)[..., B:].reshape(C, nf * B)


def fdl_conv_plain(x, hspec, B: int):
    """Plain PyTorch FDL: rfft of the 2B-sample frames, the P-tap
    spectral MAC along the frame axis, irfft, keep the second half."""
    return _fdl_from_spectra(frame_spectra_plain(x, B), hspec, B, x.dtype)


def cotangent_spectra(g, B: int):
    """dV of the FDL's spectra adjoint: the rfft of each cotangent block
    g_f embedded as the kept half of a 2B-sample frame, [0_B, g_f], as
    (C, N/B, B+1, 2). One `torch.fft.rfft` call on the card: K1's forward
    FFT reads the overlapping frames of a signal, not zero-embedded
    blocks, so it cannot be pointed at these without a copy of twice the
    cotangent's size."""
    C, N = g.shape
    blocks = g.reshape(C, N // B, B)
    frames = torch.cat([torch.zeros_like(blocks), blocks], dim=-1)
    return torch.view_as_real(torch.fft.rfft(frames, dim=-1))


def fdl_spectra_adjoint_plain(X, dV, P: int):
    """Plain PyTorch spectra adjoint: dH (P, B+1, 2) with
    dH[p, k] = w_k sum_c sum_{f >= p} dV[c, f, k] conj(X[c, f-p, k]) for
    p < nf and 0 beyond, w_k = c_k / 2B (c_k = 2 on the interior bins, 1
    at DC and Nyquist), the imaginary parts at DC and Nyquist 0. X and dV
    are (C, nf, B+1, 2)."""
    Xc, Vc = torch.view_as_complex(X), torch.view_as_complex(dV)
    nf, B = X.shape[1], X.shape[2] - 1
    dH = Vc.new_zeros(P, B + 1)
    for p in range(min(P, nf)):
        dH[p] = torch.sum(Vc[:, p:] * torch.conj(Xc[:, :nf - p]), dim=(0, 1))
    w = torch.full((B + 1,), 1.0 / B, dtype=X.dtype, device=X.device)
    w[0] = w[B] = 0.5 / B
    dH = torch.view_as_real(dH * w).clone()
    dH[:, 0, 1] = 0.0
    dH[:, B, 1] = 0.0
    return dH


def fdl_spectra_adjoint(X, dV, P: int):
    """The spectra adjoint (`fdl_spectra_adjoint_plain`'s function) of
    X, dV (C, nf, B+1, 2): CUDA tensors run the kernel (float32,
    contiguous; G lags a thread from `spectra_adjoint_plan`), CPU
    tensors the plain version."""
    if X.ndim != 4 or X.shape[-1] != 2 or dV.shape != X.shape:
        raise ValueError("fdl_spectra_adjoint: X and dV must be (C, nf, B+1, "
                         f"2) alike, got {tuple(X.shape)} and "
                         f"{tuple(dV.shape)}")
    if X.device.type == "cpu":
        return fdl_spectra_adjoint_plain(X, dV, P)
    if X.device.type != "cuda":
        raise ValueError(f"fdl_spectra_adjoint: unsupported device {X.device}")
    for name, t in (("X", X), ("dV", dV)):
        if (t.dtype != torch.float32 or t.device != X.device
                or not t.is_contiguous() or t.data_ptr() % 8):
            raise ValueError(f"fdl_spectra_adjoint: {name} must be contiguous, "
                             f"8-byte aligned float32 on {X.device}")
    C, nf, B = X.shape[0], X.shape[1], X.shape[2] - 1
    if not 1 <= C <= 65535 or not 2 <= B <= MAX_BLOCK or not 1 <= P <= 65535:
        raise ValueError(f"fdl_spectra_adjoint: the kernel takes 1 <= C, P <= "
                         f"65535 and B in [2, {MAX_BLOCK}]; got C={C}, P={P}, "
                         f"B={B}")
    G = spectra_adjoint_plan(nf, B, P, _build.sm_count(X.device))[0]
    return _spectra_adjoint_launch(X, dV, P, G)


def _spectra_adjoint_launch(X, dV, P: int, G: int):
    """Launch the spectra adjoint on checked arguments with G lags a
    thread (tools/adjoint_bench.py also times other G)."""
    fn = _build.entry("fdlconv", "fdl_spectra_adjoint_f32", _ADJ_ARGTYPES)
    C, nf, B = X.shape[0], X.shape[1], X.shape[2] - 1
    dH = torch.empty((P, B + 1, 2), dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        code = fn(_build.ptr(X), _build.ptr(dV), _build.ptr(dH), C, nf, B, P,
                  G, _build.stream_of(X))
        fdl_spectra_adjoint.launches += 1
    _build.check("fdlconv", code, "fdl_spectra_adjoint")
    return dH


fdl_spectra_adjoint.launches = 0


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


def spectra_adjoint_plan(nf: int, B: int, P: int,
                         sms: int) -> tuple[int, tuple[int, int]]:
    """Lags per thread G and the spectra adjoint's grid (bin slices,
    lag groups) on a card of `sms` SMs. A thread holds G lags' sums and a window of G frame
    spectra in registers, and reads a frame spectrum ceil(P / G) times:
    G is the largest power of two up to SPEC_ADJ_MAX_G (and up to the
    lags that meet the signal, min(P, nf)) whose groups of those lags
    still give every SM a block: a larger G converts fewer inputs per
    multiply-add, and a block per SM keeps every SM walking. Lag groups
    past nf only write their zero rows."""
    slices = -(-(B + 1) // SPEC_ADJ_THREADS)
    lags = min(P, nf)
    G = min(SPEC_ADJ_MAX_G, 1 << (lags - 1).bit_length())
    while G > 1 and slices * -(-lags // G) < sms:
        G //= 2
    return G, (slices, -(-P // G))


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


class FDLConvFn(torch.autograd.Function):
    """y = FDL(x, hspec), differentiable in both (the reference's
    `_fdl_vjp`). The forward keeps the frame spectra X only when hspec
    needs a gradient (at the folded shape they are ~0.5 GB). Backward:
    dx = flip(FDL(flip(g))) (exact: for the spectra of a real kernel the
    map is causal Toeplitz), and dhspec = fdl_spectra_adjoint(X, dV);
    each only where its input needs it. CUDA tensors run the kernels,
    CPU tensors the plain versions."""

    @staticmethod
    def forward(ctx, x, hspec, B):
        keep = ctx.needs_input_grad[1]
        if x.device.type == "cpu":
            X = frame_spectra_plain(x, B)
            y = _fdl_from_spectra(X, hspec, B, x.dtype)
            X = torch.view_as_real(X)
        else:
            y, X = _launch(x, hspec, B, mac_plan(x.shape[0], x.shape[1] // B,
                                                 B)[0])
        ctx.B = B
        ctx.save_for_backward(hspec, X if keep else None)
        return y

    @staticmethod
    def backward(ctx, g):
        hspec, X = ctx.saved_tensors
        B = ctx.B
        g = g.contiguous()
        dx = dh = None
        if ctx.needs_input_grad[0]:
            gr = torch.flip(g, (-1,)).contiguous()
            if g.device.type == "cpu":
                dr = fdl_conv_plain(gr, hspec, B)
            else:
                dr = _launch(gr, hspec, B, mac_plan(g.shape[0],
                                                    g.shape[1] // B, B)[0])[0]
            dx = torch.flip(dr, (-1,))
        if ctx.needs_input_grad[1]:
            dV = cotangent_spectra(g.to(X.dtype), B)
            dh = fdl_spectra_adjoint(X, dV, hspec.shape[0]).to(hspec.dtype)
        return dx, dh, None


def fdl_conv(x, hspec, B: int):
    """Zero-state FDL convolution of x (C, N) with partition spectra
    hspec (P, B+1, 2), differentiable in both (`FDLConvFn`). CUDA tensors
    run the kernel (float32, contiguous, B a power of two up to
    MAX_BLOCK); CPU tensors run the plain version."""
    if x.ndim != 2 or x.shape[-1] % B:
        raise ValueError(f"fdl_conv: x must be (C, N) with N % {B} == 0, "
                         f"got {tuple(x.shape)}")
    if hspec.ndim != 3 or hspec.shape[1:] != (B + 1, 2):
        raise ValueError(f"fdl_conv: hspec must be (P, {B + 1}, 2), "
                         f"got {tuple(hspec.shape)}")
    if x.device.type == "cpu":
        return FDLConvFn.apply(x, hspec, B)
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
    return FDLConvFn.apply(x, hspec, B)


def _launch(x, hspec, B: int, G: int):
    """Launch the kernel on checked arguments, with G frames per MAC
    group (chip_smoke.py also times other G at the main shapes). Returns
    (y, X): X the frame spectra (C, N/B, B+1, 2) that the first launch
    writes, which the spectra adjoint reads."""
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
    X, Y = (torch.empty((C, N // B, B + 1, 2), dtype=torch.float32,
                        device=x.device) for _ in range(2))
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = fn(_build.ptr(x), _build.ptr(hspec), _build.ptr(tw),
                  _build.ptr(X), _build.ptr(Y), _build.ptr(y), C, N, B, P,
                  n16, rem, threads, fpb, G, _build.stream_of(x))
        fdl_conv.launches += 1
    _build.check("fdlconv", code, "fdl_conv")
    return y, X


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
