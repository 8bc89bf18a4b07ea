"""WSOLA time-domain pitch shifter (counterpart of
`algodsp_tpu/effects/pitch/wsola.py`).

Capability parity with `dsp/effects/pitch/pitch_shifter.go`: SoundTouch-
style WSOLA with the music preset (sequence 82 ms / overlap 10 ms /
seek window 28 ms), autocorrelation-based segment alignment, time
stretch followed by resampling.

The per-segment search for the best offset within the seek window
(SURVEY.md §7 hard part #3) is W1 (`ops/wsola.py`, `csrc/wsola.cu`): one
launch walks every segment of every channel, each step scoring all its
offsets against the reference that the last step's choice fixed. The
segments are then one gather (through which a gradient with respect to
x flows), the tail crossfade a loop over the segments, and the
resampler the port's `Resampler`.
"""

from __future__ import annotations

import numpy as np
import torch

from algodsp_tpu_torch.ops.wsola import energy_prefix, wsola_search
from algodsp_tpu_torch.resample import Quality, Resampler, approximate_ratio


class WSOLAPitchShifter:
    def __init__(self, sample_rate: float, *, pitch_ratio: float = 1.0,
                 sequence_ms: float = 82.0, overlap_ms: float = 10.0,
                 seek_window_ms: float = 28.0,
                 resample_quality: Quality = Quality.BALANCED):
        if sample_rate <= 0:
            raise ValueError("wsola: sample rate must be > 0")
        if not (0.25 <= pitch_ratio <= 4.0):
            raise ValueError(f"wsola: ratio must be in [0.25, 4]: {pitch_ratio}")
        self.sample_rate = sample_rate
        self.pitch_ratio = pitch_ratio
        self.sequence = max(int(sequence_ms * 1e-3 * sample_rate), 32)
        self.overlap = max(int(overlap_ms * 1e-3 * sample_rate), 8)
        self.seek = max(int(seek_window_ms * 1e-3 * sample_rate), 4)
        # reference contract (`pitch_shifter.go:257-268`): ov < seq
        if self.overlap >= self.sequence:
            raise ValueError(
                f"wsola: overlap must be smaller than sequence: "
                f"overlap={overlap_ms} sequence={sequence_ms} ms")
        self.resample_quality = resample_quality

    def set_pitch_semitones(self, semitones: float):
        self.pitch_ratio = 2.0 ** (semitones / 12.0)

    def plan(self, n: int, rate: float):
        """The static grid of a stretch of n samples at `rate`: (region
        starts (S,) int32, boundary flags (S,), first tail, n_ext), as the
        reference lays it out (`wsola.py:68-96`)."""
        seq, ov, seek = self.sequence, self.overlap, self.seek
        flat = seq - ov
        # segment count from the TARGET output length (~n/rate), like the
        # reference's `for outLen < targetLen + seq` loop
        # (`pitch_shifter.go:299-319`)
        target_len = max(int(round(n / rate)), 1)
        out_segments = max(-(-(target_len - seq) // flat) + 1, 1)
        nominal = (np.arange(out_segments) * flat * rate).astype(np.int32) \
            + seek // 2
        region_starts = nominal - seek // 2
        # segments whose reads touch the zero-extended region take the
        # nominal offset (the independent C++ golden lands on the same one)
        boundary = (region_starts + (seek - 1 + ov) + seq) > n
        n_ext = max(int(nominal[-1]) + seek // 2 + seq + seek + 1, n)
        return region_starts, boundary, int(nominal[0]), n_ext

    def search(self, x2, rate: float):
        """The starts (S, C) int32 that W1 picks for the stretch of x2
        (C, n) at `rate`, with the zero-extended x2 (C, n_ext)."""
        region_starts, boundary, tail0, n_ext = self.plan(x2.shape[-1], rate)
        # reads past the input return zero (pitchSampleZero)
        x2 = torch.nn.functional.pad(x2, (0, n_ext - x2.shape[-1]))
        starts = wsola_search(x2, energy_prefix(x2), region_starts, boundary,
                              self.overlap, self.seek,
                              self.sequence - self.overlap, tail0)
        return starts, x2

    def _time_stretch(self, x, rate: float):
        """WSOLA stretch: the output advances by `seq - ov` a segment
        while the input nominally advances by (seq - ov) * rate, each
        segment aligned by maximum normalised cross-correlation within
        the seek window; then the reference's sequential tail crossfade
        (`pitch_shifter.go:328-337`), which for ov > flat re-fades carried
        samples and is a neighbour overlap-add where ov <= flat."""
        n = x.shape[-1]
        seq, ov = self.sequence, self.overlap
        flat = seq - ov
        batch = x.shape[:-1]
        starts, x2 = self.search(x.reshape(-1, n), rate)
        c, s_count = x2.shape[0], starts.shape[0]
        idx = (starts.t().long()[:, :, None]
               + torch.arange(seq, device=x.device)).reshape(c, -1)
        segments = torch.gather(x2, -1, idx).reshape(c, s_count, seq)

        fade_in = torch.as_tensor(np.linspace(0.0, 1.0, ov, endpoint=False),
                                  dtype=x.dtype, device=x.device)
        fade_out = 1.0 - fade_in
        carry = segments[:, 0, flat:]
        emitted = [segments[:, 0, :flat]]
        for s in range(1, s_count):
            seg = segments[:, s]
            t = fade_out * carry + fade_in * seg[:, :ov]
            full = torch.cat([t, seg[:, ov:]], dim=-1)
            emitted.append(full[:, :flat])
            carry = full[:, flat:]
        out = torch.cat(emitted + [carry], dim=-1)   # (S-1)*flat + seq
        return out.reshape(batch + (out.shape[-1],))

    def process(self, x):
        """One-shot pitch shift, output length == input length: time-
        STRETCH the signal to ~n*r samples (stretch rate 1/r, WSOLA keeps
        the pitch), then resample by 1/r back to n samples, which
        multiplies the pitch by r while events keep their timing
        (`pitch_shifter.go:225-240`)."""
        n = x.shape[-1]
        r = self.pitch_ratio
        if r == 1.0:
            return x
        min_len = self.sequence + self.seek + int(self.sequence * r) + 1
        if n < min_len:
            raise ValueError(f"wsola: input too short ({n} < {min_len})")
        stretched = self._time_stretch(x, 1.0 / r)      # ~n*r samples
        rs = Resampler(*approximate_ratio(1.0 / r, 512),
                       quality=self.resample_quality)
        y = rs.process(stretched)
        if y.shape[-1] >= n:
            return y[..., :n]
        return torch.nn.functional.pad(y, (0, n - y.shape[-1]))
