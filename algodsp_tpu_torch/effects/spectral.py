"""Spectral and granular texture effects (counterpart of
`algodsp_tpu/effects/spectral.py`).

SpectralFreeze — capability parity with `dsp/effects/spectral_freeze.go`:
STFT processing where, while frozen, every frame is resynthesized from a
captured magnitude spectrum with phase either held or advanced by the
bin frequency per hop (`spectral_freeze.go:229-300`); windowed
overlap-add with window-power normalization; wet/dry mix.

Granular — capability parity with `dsp/effects/granular.go`: overlap-add
grain scheduling over the input timeline with per-grain pitch
(playback-rate) and Hann envelopes, deterministic seeded position spray
(drawn on the host from `np.random.default_rng(seed)`, as the reference
draws it, so the grains land on the same samples).

Both are frame- or grain-parallel: framing is a gather, the FFTs are
batched, every grain is one interpolated read (`fractional_read`), and
the overlap-adds are the scatter-free `overlap_add` (a sum of shifted
group timelines in a fixed order, so two calls give the same bits on
the card, where a scatter-add's atomics would not).
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from algodsp_tpu_torch import window as win
from algodsp_tpu_torch.window.window import window_tensor
from algodsp_tpu_torch.delayline import fractional_read
from algodsp_tpu_torch.interp import Mode

_NORM_FLOOR = 1e-12


class FreezePhaseMode(enum.Enum):
    HOLD = "hold"
    ADVANCE = "advance"


def overlap_add(frames, hop: int):
    """Overlap-add of frames (..., F, L) at starts 0, hop, 2 hop, ...:
    (..., (F - 1) * hop + L). Frames f and f + R, R = ceil(L / hop), do
    not overlap, so the frames of each residue class mod R are laid end
    to end (each padded to R * hop) into one timeline, and the R
    timelines are added in order: no scatter, the same sum every call."""
    n_frames, length = frames.shape[-2], frames.shape[-1]
    total = (n_frames - 1) * hop + length
    groups = -(-length // hop)
    span = groups * hop
    out = frames.new_zeros(frames.shape[:-2] + (total,))
    for g in range(min(groups, n_frames)):
        sel = frames[..., g::groups, :]
        seq = torch.nn.functional.pad(sel, (0, span - length))
        seq = seq.reshape(sel.shape[:-2] + (-1,))
        width = min(seq.shape[-1], total - g * hop)
        out[..., g * hop:g * hop + width] += seq[..., :width]
    return out


def _finish_wet(x, wet, norm, mix: float):
    """Normalised wet path cut or padded to x's length, mixed with x."""
    n = x.shape[-1]
    wet = (wet / torch.clamp(norm, min=_NORM_FLOOR))[..., :n]
    if wet.shape[-1] < n:
        # the frame/grain grid ends before the signal does: the
        # uncovered tail has a silent wet path
        wet = torch.nn.functional.pad(wet, (0, n - wet.shape[-1]))
    return x * (1.0 - mix) + wet * mix


class SpectralFreeze:
    def __init__(self, sample_rate: float, *, frame_size: int = 2048,
                 hop_size: int = 512, frozen: bool = False,
                 phase_mode: FreezePhaseMode = FreezePhaseMode.ADVANCE,
                 mix: float = 1.0,
                 window_type: win.WindowType = win.WindowType.HANN):
        if frame_size < 64 or frame_size & (frame_size - 1):
            raise ValueError(f"spectral freeze: frame size must be pow2 >= 64: {frame_size}")
        if not (0 < hop_size <= frame_size):
            raise ValueError(f"spectral freeze: invalid hop: {hop_size}")
        self.sample_rate = sample_rate
        self.frame_size = frame_size
        self.hop_size = hop_size
        self.frozen = frozen
        self.phase_mode = phase_mode
        self.mix = mix
        self.window_type = window_type
        self.window = win.generate(window_type, frame_size, periodic=True)

    def process(self, x):
        """One-shot buffer processing (`spectral_freeze.go:193-320`).

        When frozen, the first frame's spectrum is captured and all
        frames resynthesize from it.
        """
        n = x.shape[-1]
        fs, hop = self.frame_size, self.hop_size
        w = window_tensor(self.window_type, fs, x.dtype, x.device, periodic=True)
        n_frames = 1 + (n - 1) // hop
        # reads past the end are 0
        padded = torch.nn.functional.pad(x, (0, (n_frames - 1) * hop + fs - n))
        frames = padded.unfold(-1, fs, hop)
        spec = torch.fft.rfft(frames * w, fs)
        mag = torch.abs(spec)
        phase = torch.angle(spec).to(x.dtype)

        if self.frozen:
            held_mag = mag[..., 0:1, :]
            held_phase = phase[..., 0:1, :]
            if self.phase_mode == FreezePhaseMode.ADVANCE:
                omega = torch.as_tensor(
                    2.0 * np.pi * np.arange(fs // 2 + 1) / fs, dtype=x.dtype,
                    device=x.device)
                adv = omega * hop
                steps = torch.arange(n_frames, dtype=x.dtype,
                                     device=x.device)[:, None]
                ph = held_phase + adv * steps
            else:
                ph = held_phase.expand(phase.shape)
            out_mag = held_mag.expand(mag.shape)
        else:
            out_mag, ph = mag, phase
        out_spec = torch.complex(out_mag * torch.cos(ph), out_mag * torch.sin(ph))
        synth = torch.fft.irfft(out_spec, fs).to(x.dtype) * w
        wet = overlap_add(synth, hop)
        norm = overlap_add((w * w).expand(n_frames, fs), hop)
        return _finish_wet(x, wet, norm, self.mix)


class Granular:
    """Overlap-add granular texture (`granular.go:218-280` semantics).

    Grains are scheduled at a fixed rate derived from grain length and
    overlap; each grain reads the input timeline at its own playback
    rate with a Hann envelope; spray adds deterministic position jitter.
    """

    def __init__(self, sample_rate: float, *, grain_seconds: float = 0.08,
                 overlap: float = 0.5, pitch: float = 1.0,
                 spray_seconds: float = 0.0, mix: float = 1.0, seed: int = 1):
        if not (0.005 <= grain_seconds <= 0.5):
            raise ValueError(f"granular grain seconds out of range: {grain_seconds}")
        if not (0.0 <= overlap <= 0.95):
            raise ValueError(f"granular overlap out of range: {overlap}")
        if not (0.25 <= pitch <= 4.0):
            raise ValueError(f"granular pitch out of range: {pitch}")
        self.sample_rate = sample_rate
        self.grain = max(int(grain_seconds * sample_rate), 8)
        self.hop = max(int(self.grain * (1.0 - overlap)), 1)
        self.pitch = pitch
        self.spray = int(spray_seconds * sample_rate)
        self.mix = mix
        self.seed = seed
        self.env = win.generate(win.WindowType.HANN, self.grain)

    def process(self, x):
        """One-shot granular resynthesis over the buffer."""
        n = x.shape[-1]
        g, hop = self.grain, self.hop
        n_grains = max((n - g) // hop + 1, 1)
        rng = np.random.default_rng(self.seed)
        spray = (rng.integers(-self.spray, self.spray + 1, n_grains)
                 if self.spray > 0 else np.zeros(n_grains, dtype=np.int64))
        starts = np.clip(np.arange(n_grains) * hop + spray, 0,
                         max(n - g, 0)).astype(np.float64)
        # each grain reads at its own rate: src = start + age*pitch
        ages = torch.arange(g, dtype=x.dtype, device=x.device)
        src = (torch.as_tensor(starts, dtype=x.dtype, device=x.device)[:, None]
               + ages[None, :] * self.pitch)
        # x gains a broadcast dim so the grain axis of src pairs with it
        # instead of merging into the channel batch: (..., 1, T) read at
        # (G, g) -> (..., G, g)
        grains = fractional_read(x[..., None, :], src, Mode.LINEAR)
        env = window_tensor(win.WindowType.HANN, g, x.dtype, x.device)
        wet = overlap_add(grains * env, hop)
        norm = overlap_add(env.expand(n_grains, g), hop)
        return _finish_wet(x, wet, norm, self.mix)
