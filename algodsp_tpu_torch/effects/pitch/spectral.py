"""Phase-vocoder spectral pitch shifter (counterpart of
`algodsp_tpu/effects/pitch/spectral.py`).

Capability parity with `dsp/effects/pitch/pitch_shift_spectral.go`:
hybrid approach — direct spectral bin shifting for |ratio-1| <= 0.15,
classic time-stretch + resample with identity phase locking
(Laroche & Dolson 1999) for larger shifts; Hann analysis windows,
frame 1024 / hop 256 defaults; mono one-shot buffer processing.

All frames process at once: framing is a gather, the FFTs are batched,
and the phase-vocoder's running phase accumulator is a cumulative sum
over frames (the per-frame recurrence sum_phase += delta is a prefix
sum). The overlap-adds are `effects.spectral.overlap_add` (no scatter).
"""

from __future__ import annotations

import numpy as np
import torch

from algodsp_tpu_torch import window as win
from algodsp_tpu_torch.window.window import window_tensor
from algodsp_tpu_torch.effects.spectral import overlap_add
from algodsp_tpu_torch.resample import Quality, Resampler

BIN_SHIFT_THRESHOLD = 0.15
_NORM_FLOOR = 1e-12


def _frame(x, frame_size: int, hop: int):
    """(frames (..., F, frame_size), F); reads past the end repeat the
    last sample."""
    n = x.shape[-1]
    n_frames = max(1 + (n - frame_size) // hop, 1)
    idx = (torch.arange(n_frames, device=x.device)[:, None] * hop
           + torch.arange(frame_size, device=x.device)[None, :])
    return x[..., torch.clamp(idx, max=n - 1)], n_frames


def _fit(y, n: int):
    """y cut or zero-padded to n samples."""
    if y.shape[-1] >= n:
        return y[..., :n]
    return torch.nn.functional.pad(y, (0, n - y.shape[-1]))


class SpectralPitchShifter:
    def __init__(self, sample_rate: float, *, pitch_ratio: float = 1.0,
                 frame_size: int = 1024, analysis_hop: int = 256,
                 window_type: win.WindowType = win.WindowType.HANN,
                 resample_quality: Quality = Quality.BALANCED):
        if sample_rate <= 0:
            raise ValueError("pitch: sample rate must be > 0")
        if frame_size < 64 or frame_size & (frame_size - 1):
            raise ValueError(f"pitch: frame size must be pow2 >= 64: {frame_size}")
        if not (0 < analysis_hop <= frame_size):
            raise ValueError(f"pitch: invalid analysis hop: {analysis_hop}")
        if not (0.25 <= pitch_ratio <= 4.0):
            raise ValueError(f"pitch: ratio must be in [0.25, 4]: {pitch_ratio}")
        self.sample_rate = sample_rate
        self.pitch_ratio = pitch_ratio
        self.frame_size = frame_size
        self.analysis_hop = analysis_hop
        self.window_type = window_type
        self.resample_quality = resample_quality
        self.window = win.generate(window_type, frame_size, periodic=True)

    @property
    def synthesis_hop(self) -> int:
        return max(int(round(self.analysis_hop * self.pitch_ratio)), 1)

    def effective_pitch_ratio(self) -> float:
        """Quantized ratio on the stretch path
        (`pitch_shift_spectral.go:108-115`)."""
        if self._use_bin_shift():
            return self.pitch_ratio
        return self.synthesis_hop / self.analysis_hop

    def set_pitch_semitones(self, semitones: float):
        self.pitch_ratio = 2.0 ** (semitones / 12.0)

    def _use_bin_shift(self) -> bool:
        return abs(self.pitch_ratio - 1.0) <= BIN_SHIFT_THRESHOLD

    def process(self, x):
        """One-shot pitch shift; output length == input length."""
        if self.pitch_ratio == 1.0:
            return x
        if self._use_bin_shift():
            return self._process_bin_shift(x)
        return self._process_stretch_resample(x)

    def _window(self, x):
        return window_tensor(self.window_type, self.frame_size, x.dtype,
                             x.device, periodic=True)

    # -- bin shifting path -------------------------------------------------
    def _process_bin_shift(self, x):
        n = x.shape[-1]
        fs, hop = self.frame_size, self.analysis_hop
        w = self._window(x)
        frames, n_frames = _frame(x, fs, hop)
        spec = torch.fft.rfft(frames * w, fs)  # (..., F, bins)
        mag = torch.abs(spec)
        phase = torch.angle(spec)
        bins = fs // 2 + 1
        r = self.pitch_ratio
        # target bin b gets energy from source bin b/r (linear interp);
        # the map and the accumulated phase advance depend on no sample,
        # so the host makes them in float64
        src = np.arange(bins) / r
        i0 = np.floor(src).astype(np.int64)
        frac = torch.as_tensor(src - i0, dtype=x.dtype, device=x.device)
        valid = torch.as_tensor(i0 < bins - 1, device=x.device)
        i0c = torch.as_tensor(np.clip(i0, 0, bins - 2), device=x.device)
        m = mag[..., i0c] * (1 - frac) + mag[..., i0c + 1] * frac
        m = torch.where(valid, m, torch.zeros((), dtype=m.dtype, device=m.device))
        # phase advance scaled by the ratio, accumulated over frames
        dphi_frame = 2.0 * np.pi * np.arange(bins) * hop / fs * (r - 1.0)
        acc = np.cumsum(np.broadcast_to(dphi_frame, (n_frames, bins)), axis=0)
        p = phase[..., i0c] + torch.as_tensor(acc, dtype=x.dtype, device=x.device)
        out_spec = torch.complex(m * torch.cos(p), m * torch.sin(p))
        synth = torch.fft.irfft(out_spec, fs).to(x.dtype) * w
        norm = _fit(overlap_add((w * w).expand(n_frames, fs), hop), n)
        y = _fit(overlap_add(synth, hop), n)
        return y / torch.clamp(norm, min=_NORM_FLOOR)

    # -- time-stretch + resample path -------------------------------------
    def _process_stretch_resample(self, x):
        n = x.shape[-1]
        fs = self.frame_size
        ha, hs = self.analysis_hop, self.synthesis_hop
        w = self._window(x)
        bins = fs // 2 + 1
        frames, n_frames = _frame(x, fs, ha)
        spec = torch.fft.rfft(frames * w, fs)
        mag = torch.abs(spec)
        phase = torch.angle(spec).to(x.dtype)
        omega = torch.as_tensor(2.0 * np.pi * np.arange(bins) / fs,
                                dtype=x.dtype, device=x.device)
        # instantaneous frequency: frame-to-frame phase difference, wrapped
        # by a floored modulo (jnp.mod)
        dphi = torch.diff(phase, dim=-2, prepend=phase[..., :1, :]) - omega * ha
        dphi = torch.remainder(dphi + np.pi, 2.0 * np.pi) - np.pi
        inst = omega + dphi / ha
        # synthesis phase: cumulative sum of inst*hs over frames
        # (the Go sumPhase recurrence is a prefix sum)
        synth_phase = phase[..., 0:1, :] + torch.cumsum(inst * hs, dim=-2) \
            - inst[..., 0:1, :] * hs
        out_spec = torch.complex(mag * torch.cos(synth_phase),
                                 mag * torch.sin(synth_phase))
        synth = torch.fft.irfft(out_spec, fs).to(x.dtype) * w
        norm = overlap_add((w * w).expand(n_frames, fs), hs)
        stretched = overlap_add(synth, hs) / torch.clamp(norm, min=_NORM_FLOOR)
        # resample back: stretch factor hs/ha, so resample by ha/hs
        rs = Resampler(ha, hs, quality=self.resample_quality)
        return _fit(rs.process(stretched), n)
