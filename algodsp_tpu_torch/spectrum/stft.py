"""Short-time Fourier transform with exact weighted-overlap-add inverse
(counterpart of `algodsp_tpu/spectrum/stft.py`).

Beyond the reference: the Go library frames signals privately inside
its spectral effects (`dsp/effects/spectral_freeze.go:36-60`,
`pitch/pitch_shift_spectral.go:20-36`) but exposes no public STFT.

Framing is a strided view (`Tensor.unfold`) into (..., frames,
frame_size), the transform one batched `torch.fft.rfft`, and the
inverse one `torch.fft.irfft` plus an overlap-add (shifted sums where
the hop divides the frame, `index_add_` otherwise) with the
squared-window normalization. Everything runs on the input's device,
batched over leading channel dims.
"""

from __future__ import annotations

import numpy as np
import torch

from algodsp_tpu_torch._device import resolve_device
from algodsp_tpu_torch.window.window import WindowType, generate, window_tensor


def _window(wtype, frame_size: int, dtype, device):
    if isinstance(wtype, WindowType):
        return window_tensor(wtype, frame_size, dtype, device, periodic=True)
    return torch.as_tensor(np.asarray(wtype), dtype=dtype, device=device)


def _frames(x, n_frames: int, frame_size: int, hop_size: int):
    """(..., n_frames, frame_size) sliding frames of x, a strided view."""
    return x.unfold(-1, frame_size, hop_size)[..., :n_frames, :]


def _frame_idx(n_frames: int, frame_size: int, hop_size: int, device):
    """Flat output positions of every frame sample, frame by frame."""
    return (torch.arange(n_frames, device=device)[:, None] * hop_size
            + torch.arange(frame_size, device=device)[None, :]).reshape(-1)


def _validate(frame_size: int, hop_size: int) -> None:
    # odd frame_size is rejected because istft infers it from the
    # bin count as 2*(bins-1), which only inverts even frames
    if frame_size < 2 or frame_size % 2 or hop_size < 1 \
            or hop_size > frame_size:
        raise ValueError(
            f"stft: invalid frame/hop: {frame_size}/{hop_size}")


def _pad_last(x, left: int, right: int):
    if not (left or right):
        return x
    parts = [x.new_zeros(x.shape[:-1] + (left,))] if left else []
    parts.append(x)
    if right:
        parts.append(x.new_zeros(x.shape[:-1] + (right,)))
    return torch.cat(parts, dim=-1)


def stft(x, frame_size: int = 2048, hop_size: int = 512, *,
         window: WindowType = WindowType.HANN, center: bool = True):
    """Complex STFT of the last axis: returns (..., n_frames, bins).

    With `center=True` the signal is zero-padded by frame_size//2 on
    both ends so frame k is centered on sample k*hop_size (the
    convention that makes `istft` reconstruct the full length).
    """
    _validate(frame_size, hop_size)
    if center:
        x = _pad_last(x, frame_size // 2, frame_size // 2)
    # right-pad so the frame grid covers every sample (otherwise up to
    # hop_size-1 tail samples would be dropped and istft would zero them)
    n_frames = 1 + max(-(-(x.shape[-1] - frame_size) // hop_size), 0)
    covered = (n_frames - 1) * hop_size + frame_size
    x = _pad_last(x, 0, max(covered - x.shape[-1], 0))
    frames = _frames(x, n_frames, frame_size, hop_size) * _window(
        window, frame_size, x.dtype, x.device)
    return torch.fft.rfft(frames, dim=-1)


def _real_dtype(spec) -> torch.dtype:
    return spec.real.dtype if spec.is_complex() else spec.dtype


def istft(spec, hop_size: int = 512, *,
          window: WindowType = WindowType.HANN, center: bool = True,
          length: int | None = None):
    """Weighted-overlap-add inverse of `stft`.

    Exact reconstruction (up to FFT rounding) for any window/hop whose
    squared-window overlap-add is nonzero everywhere: the standard
    WOLA normalization y[t] = sum_k w*frame_k / sum_k w^2.
    """
    n_frames, bins = spec.shape[-2], spec.shape[-1]
    frame_size = 2 * (bins - 1)
    real_dtype = _real_dtype(spec)
    w = _window(window, frame_size, real_dtype, spec.device)
    frames = torch.fft.irfft(spec, n=frame_size, dim=-1) * w
    w2 = torch.broadcast_to(w * w, (n_frames, frame_size))

    total = (n_frames - 1) * hop_size + frame_size
    if frame_size % hop_size == 0 and frame_size // hop_size <= 16:
        # scatter-free overlap-add: frame row f, segment j (of k =
        # frame/hop) lands at output row f+j, so sum k shifted copies
        k = frame_size // hop_size

        def _ola(fr):  # fr: (..., n_frames, frame_size)
            segs = fr.reshape(fr.shape[:-1] + (k, hop_size))
            rows = fr.new_zeros(fr.shape[:-2] + (n_frames + k - 1, hop_size))
            for j in range(k):
                rows[..., j:j + n_frames, :] += segs[..., j, :]
            return rows.reshape(fr.shape[:-2] + (total,))

        y = _ola(frames)
        norm = _ola(w2)
    else:
        idx = _frame_idx(n_frames, frame_size, hop_size, spec.device)
        flat = frames.reshape(spec.shape[:-2] + (-1,))
        y = flat.new_zeros(spec.shape[:-2] + (total,)).index_add_(-1, idx, flat)
        norm = w.new_zeros((total,)).index_add_(0, idx, w2.reshape(-1))
    y = y / torch.clamp(norm, min=torch.finfo(real_dtype).tiny)

    if center:
        y = y[..., frame_size // 2: total - frame_size // 2]
    if length is not None:
        y = y[..., :length]
        y = _pad_last(y, 0, max(length - y.shape[-1], 0))
    return y


class StreamingSTFT:
    """Stateful STFT: feed (..., n) blocks with n a multiple of hop_size,
    get (..., n/hop, bins) frames per call, bit-identical to the one-shot
    `stft(..., center=False)` of the left-padded concatenated stream.

    Explicit state (the framework-wide streaming contract): the carried
    tail is the last frame_size - hop_size input samples.
    """

    def __init__(self, frame_size: int = 2048, hop_size: int = 512, *,
                 window: WindowType = WindowType.HANN):
        _validate(frame_size, hop_size)
        self.frame_size = frame_size
        self.hop_size = hop_size
        self.lag = frame_size - hop_size
        self.window = window

    def init_state(self, batch_shape: tuple[int, ...] = (),
                   dtype=torch.float32, device=None):
        """Zero tail, on the CUDA card unless `device` says otherwise."""
        return {"tail": torch.zeros(tuple(batch_shape) + (self.lag,),
                                    dtype=dtype,
                                    device=resolve_device(device))}

    def process(self, state, x):
        n = x.shape[-1]
        if n % self.hop_size:
            raise ValueError(
                f"stft: streaming block length {n} must be a multiple "
                f"of hop_size {self.hop_size}")
        concat = torch.cat([state["tail"].to(x.dtype), x], dim=-1)
        frames = _frames(concat, n // self.hop_size, self.frame_size,
                         self.hop_size) * _window(self.window, self.frame_size,
                                                  x.dtype, x.device)
        return ({"tail": concat[..., concat.shape[-1] - self.lag:]},
                torch.fft.rfft(frames, dim=-1))


class StreamingISTFT:
    """Stateful WOLA inverse of `StreamingSTFT`.

    Emits n output samples per n-sample input block at a fixed latency
    of frame_size - hop_size samples (the synthesis carry: the last
    frames' overlap region completes on later calls). Normalization
    uses the steady-state periodic squared-window sum, so the
    analysis -> synthesis chain is an exact delayed identity once the
    first frame has flushed through.
    """

    def __init__(self, frame_size: int = 2048, hop_size: int = 512, *,
                 window: WindowType = WindowType.HANN):
        _validate(frame_size, hop_size)
        self.frame_size = frame_size
        self.hop_size = hop_size
        self.lag = frame_size - hop_size
        self.window = window
        # steady-state periodic WOLA norm: norm[t mod hop] over all
        # frame offsets (constant for COLA window/hop pairs)
        w = np.asarray(generate(window, frame_size, periodic=True)
                       if isinstance(window, WindowType) else window,
                       np.float64) ** 2
        k = -(-frame_size // hop_size)
        padded = np.pad(w, (0, k * hop_size - frame_size))
        self._norm = padded.reshape(k, hop_size).sum(0)
        if self._norm.min() <= 0:
            raise ValueError("stft: window/hop pair is not COLA "
                             "(zero overlap-add of squared window)")

    def init_state(self, batch_shape: tuple[int, ...] = (),
                   dtype=torch.float32, device=None):
        """Zero synthesis carry, on the CUDA card unless `device` says
        otherwise."""
        return {"carry": torch.zeros(tuple(batch_shape) + (self.lag,),
                                     dtype=dtype,
                                     device=resolve_device(device))}

    def process(self, state, spec):
        n_frames = spec.shape[-2]
        n = n_frames * self.hop_size
        real_dtype = _real_dtype(spec)
        w = _window(self.window, self.frame_size, real_dtype, spec.device)
        frames = torch.fft.irfft(spec, n=self.frame_size, dim=-1) * w
        # dense overlap-add of this call's frames: (..., n + lag)
        total = n + self.lag
        idx = _frame_idx(n_frames, self.frame_size, self.hop_size,
                         spec.device)
        flat = frames.reshape(spec.shape[:-2] + (-1,))
        out = flat.new_zeros(spec.shape[:-2] + (total,)).index_add_(
            -1, idx, flat)
        out[..., :self.lag] += state["carry"].to(real_dtype)
        norm = torch.as_tensor(np.tile(self._norm, n_frames), dtype=real_dtype,
                               device=spec.device)
        return {"carry": out[..., n:]}, out[..., :n] / norm


def spectrogram(x, frame_size: int = 2048, hop_size: int = 512, *,
                window: WindowType = WindowType.HANN, center: bool = True,
                floor_db: float = -200.0):
    """Power spectrogram in dB: (..., n_frames, bins)."""
    p = torch.abs(stft(x, frame_size, hop_size, window=window,
                       center=center)) ** 2
    ref = torch.finfo(p.dtype).tiny
    return torch.clamp(10.0 * torch.log10(torch.clamp(p, min=ref)),
                       min=floor_db)
