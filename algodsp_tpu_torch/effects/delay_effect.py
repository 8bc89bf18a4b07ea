"""Feedback delay effect (counterpart of `algodsp_tpu/effects/delay_effect.py`).

Fractional delay with linear-interpolation read, feedback in [0, 0.99],
wet/dry mix, smooth delay-time ramping toward a target
(`delay.go:140-166`), and the reference's fixed 2.0 s maximum buffer
(`delay.go:12,206`).

The smoothed delay-time trajectory is closed-form
(cur[n] = target + (cur0-target)*(1-sc)^(n+1), independent of the
audio), so it is computed vectorized upfront, here in PyTorch as the
reference computes it, and handed to the feedback loop: R1
(`ops/feedback.delay_feedback`) on the card, the reference's three tiers
in plain PyTorch on the CPU. The state is the reference's: the ring
(its length a whole number of 128-sample blocks), the int32 write
cursor and the smoothed current delay.
"""

from __future__ import annotations

import math

import torch

from algodsp_tpu_torch._device import resolve_device
from algodsp_tpu_torch.ops import feedback

_BLOCK = feedback.DELAY_BLOCK


class Delay:
    def __init__(self, sample_rate: float, *, delay_seconds: float = 0.25,
                 feedback: float = 0.35, mix: float = 0.25,
                 max_delay_seconds: float = 2.0, smooth_ms: float = 20.0):
        if sample_rate <= 0:
            raise ValueError("delay: sample rate must be > 0")
        if not (0.0 <= feedback <= 0.99):
            raise ValueError(f"delay feedback must be in [0, 0.99]: {feedback}")
        if not (0.0 <= mix <= 1.0):
            raise ValueError(f"delay mix must be in [0, 1]: {mix}")
        if not (0.0 < delay_seconds <= max_delay_seconds):
            raise ValueError(f"delay time out of range: {delay_seconds}")
        self.sample_rate = sample_rate
        self.delay_samples = round(delay_seconds * sample_rate)
        self.feedback = feedback
        self.mix = mix
        # ring length: max delay + interp/causality headroom, rounded up
        # to a whole number of blocks so aligned writes stay contiguous
        need = int(math.ceil(max_delay_seconds * sample_rate)) + 4
        self.buf_len = -(-need // _BLOCK) * _BLOCK
        self.smooth_coeff = (1.0 - math.exp(-1.0 / (smooth_ms * 1e-3 * sample_rate))
                             if smooth_ms > 0 else 1.0)

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        """State: ring history, write cursor, smoothed current delay; on the
        CUDA card unless `device` says otherwise."""
        device = resolve_device(device)
        return {"buf": torch.zeros(tuple(batch_shape) + (self.buf_len,),
                                   dtype=dtype, device=device),
                "write": torch.zeros((), dtype=torch.int32, device=device),
                "current": torch.tensor(float(self.delay_samples), dtype=dtype,
                                        device=device)}

    def trajectory(self, current, n: int, target_delay_samples=None):
        """The smoothed lag of each of the next n samples, clamped to the
        ring's representable lags (`delay_effect.py:172-182`)."""
        dtype, device = current.dtype, current.device
        target = torch.as_tensor(float(self.delay_samples)
                                 if target_delay_samples is None
                                 else target_delay_samples,
                                 dtype=dtype, device=device)
        sc = torch.tensor(self.smooth_coeff, dtype=dtype, device=device)
        k = torch.arange(n, dtype=dtype, device=device)
        cur = target + (current - target) * (1.0 - sc) ** (k + 1.0)
        return torch.clamp(cur, 1.0, float(self.buf_len - 2))

    def process(self, state, x, target_delay_samples=None):
        """(state, x:(..., N)) -> (state, y), optionally ramping toward a
        new delay (in samples). On the card the state's ring is updated
        in place."""
        N = x.shape[-1]
        cur = self.trajectory(state["current"].to(x.dtype), N,
                              target_delay_samples)
        new_cur = cur[-1] if N else state["current"]
        buf, write, y = feedback.delay_feedback(self, state["buf"],
                                                state["write"], x, cur)
        return {"buf": buf, "write": write, "current": new_cur}, y
