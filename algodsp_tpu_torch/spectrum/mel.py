"""Mel filterbanks, mel spectrograms, and MFCCs (counterpart of
`algodsp_tpu/spectrum/mel.py`).

Beyond the reference (no perceptual-scale analysis in the Go library):
standard Slaney/HTK mel scales, triangular filterbanks, and DCT-II
cepstra. The filterbank and the DCT are designed on the host in NumPy
(the reference's code) and made tensors once per (parameters, type,
device); applying them is one product each over the batched power
spectrogram, run in full float32 under `linrec.full_float32()`, so
that a caller's TF32 setting cannot lower it.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from algodsp_tpu_torch.ops.linrec import full_float32
from algodsp_tpu_torch.spectrum.stft import stft
from algodsp_tpu_torch.window import WindowType


def hz_to_mel(f, *, htk: bool = False):
    """Slaney (default, librosa-compatible) or HTK mel scale."""
    f = np.asarray(f, np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # Slaney: linear below 1 kHz, log above
    f_sp, min_log_hz = 200.0 / 3.0, 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mel = f / f_sp
    above = f >= min_log_hz
    return np.where(above,
                    min_log_mel + np.log(np.maximum(f, min_log_hz)
                                         / min_log_hz) / logstep,
                    mel)


def mel_to_hz(m, *, htk: bool = False):
    m = np.asarray(m, np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_sp, min_log_hz = 200.0 / 3.0, 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    f_sp * m)


def mel_filterbank(n_mels: int, fft_size: int, sample_rate: float, *,
                   fmin: float = 0.0, fmax: float | None = None,
                   htk: bool = False, norm: str | None = "slaney",
                   dtype=np.float32) -> np.ndarray:
    """(fft_size//2+1, n_mels) triangular filterbank (host NumPy f64).

    `norm="slaney"` area-normalizes each triangle (equal energy per
    band); `norm=None` keeps unit peaks.
    """
    if n_mels < 1 or fft_size < 2 or sample_rate <= 0:
        raise ValueError("mel: invalid filterbank parameters")
    if fmax is None:
        fmax = sample_rate / 2.0
    if not (0.0 <= fmin < fmax <= sample_rate / 2.0 + 1e-9):
        raise ValueError(f"mel: need 0 <= fmin < fmax <= Nyquist: "
                         f"{fmin}/{fmax}")
    bins = fft_size // 2 + 1
    freqs = np.arange(bins) * sample_rate / fft_size
    edges = mel_to_hz(np.linspace(hz_to_mel(fmin, htk=htk),
                                  hz_to_mel(fmax, htk=htk),
                                  n_mels + 2), htk=htk)
    lo, center, hi = edges[:-2], edges[1:-1], edges[2:]
    up = (freqs[:, None] - lo[None, :]) / np.maximum(center - lo, 1e-12)
    down = (hi[None, :] - freqs[:, None]) / np.maximum(hi - center, 1e-12)
    fb = np.clip(np.minimum(up, down), 0.0, None)
    if norm == "slaney":
        fb *= (2.0 / (hi - lo))[None, :]
    elif norm is not None:
        raise ValueError(f"mel: unknown norm {norm!r}")
    return fb.astype(dtype)


@lru_cache(maxsize=64)
def _device_filterbank(n_mels: int, fft_size: int, sample_rate: float,
                       fmin: float, fmax, htk: bool, dtype: torch.dtype,
                       device: torch.device):
    # designed in float32 as the reference applies it; a float64 input
    # promotes the same float32 values
    fb = mel_filterbank(n_mels, fft_size, sample_rate, fmin=fmin, fmax=fmax,
                        htk=htk)
    return torch.as_tensor(fb, device=device).to(dtype)


@lru_cache(maxsize=64)
def _device_dct(n_out: int, n_in: int, dtype: torch.dtype,
                device: torch.device):
    return torch.as_tensor(dct_matrix(n_out, n_in), device=device).to(dtype)


def _matmul_last(a, b):
    """a (..., k) @ b (k, m) in full float32 whatever the caller set."""
    with full_float32():
        return torch.matmul(a, b)


def mel_spectrogram(x, sample_rate: float, *, n_mels: int = 64,
                    frame_size: int = 2048, hop_size: int = 512,
                    fmin: float = 0.0, fmax: float | None = None,
                    window: WindowType = WindowType.HANN,
                    htk: bool = False, log: bool = True,
                    floor_db: float = -200.0):
    """(..., n_frames, n_mels) mel power spectrogram (dB when log=True)."""
    p = torch.abs(stft(x, frame_size, hop_size, window=window)) ** 2
    fb = _device_filterbank(n_mels, frame_size, float(sample_rate),
                            float(fmin), fmax, bool(htk), p.dtype, p.device)
    m = _matmul_last(p, fb)  # one product over all frames and channels
    if not log:
        return m
    ref = torch.finfo(m.dtype).tiny
    return torch.clamp(10.0 * torch.log10(torch.clamp(m, min=ref)),
                       min=floor_db)


def dct_matrix(n_out: int, n_in: int, dtype=np.float32) -> np.ndarray:
    """Orthonormal DCT-II basis, (n_in, n_out)."""
    k = np.arange(n_out)[None, :]
    t = np.arange(n_in)[:, None]
    mat = np.cos(np.pi * k * (2 * t + 1) / (2.0 * n_in)) \
        * np.sqrt(2.0 / n_in)
    mat[:, 0] *= np.sqrt(0.5)
    return mat.astype(dtype)


def mfcc(x, sample_rate: float, *, n_mfcc: int = 13, n_mels: int = 64,
         frame_size: int = 2048, hop_size: int = 512,
         fmin: float = 0.0, fmax: float | None = None,
         window: WindowType = WindowType.HANN, htk: bool = False):
    """(..., n_frames, n_mfcc) cepstra: log-mel energies through an
    orthonormal DCT-II (two products end to end)."""
    if n_mfcc > n_mels:
        raise ValueError(f"mel: n_mfcc {n_mfcc} > n_mels {n_mels}")
    logmel = mel_spectrogram(x, sample_rate, n_mels=n_mels,
                             frame_size=frame_size, hop_size=hop_size,
                             fmin=fmin, fmax=fmax, window=window, htk=htk)
    return _matmul_last(logmel, _device_dct(n_mfcc, n_mels, logmel.dtype,
                                            logmel.device))
