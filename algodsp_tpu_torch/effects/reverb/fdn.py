"""Feedback delay network reverb (counterpart of
`algodsp_tpu/effects/reverb/fdn.py`).

8 delay lines (prime-ish 44.1k tunings scaled to the sample rate), 8x8
Hadamard feedback matrix (1/sqrt(8) scaled), RT60-derived per-line
feedback gains 10^(-3*delay_sec/rt60), one-pole damping in the loop,
sinusoidal per-line delay modulation with 2*pi*i/8 phase offsets, and
fractional pre-delay (`dsp/effects/reverb/fdn_reverb.go:9-330`).

The pre-delay is a pure input delay, applied to the whole call as one
vectorized PyTorch step (`fdn.py:112-132`); the feedback loop then runs
through `ops/feedback.fdn_feedback`: R3 on the card (per sample, in
place on the lines), the reference's blocked engine on the CPU (full
`_block` blocks on the shift-register layout, the damping as a
Hillis-Steele scan, the tail per sample). Where the reference computes
a read position or the LFO phase differently in its blocked and
per-sample forms, R3 follows the form of each stretch of the call.
`process_scan` is the reference's per-sample walk, pre-delay included.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from algodsp_tpu_torch._device import resolve_device
from algodsp_tpu_torch.ops import feedback, ring
from algodsp_tpu_torch.streaming import scan_blocks

FDN_SIZE = 8
_DELAYS_441 = np.array([1537, 1753, 1999, 2251, 2473, 2689, 2851, 3067],
                       dtype=np.float64)
_REF_SR = 44100.0


def _hadamard8() -> np.ndarray:
    h = np.array([[1.0]])
    for _ in range(3):
        h = np.block([[h, h], [h, -h]])
    return h


class FDNReverb:
    def __init__(self, sample_rate: float, *, wet: float = 0.2, dry: float = 1.0,
                 rt60_seconds: float = 1.8, damp: float = 0.3,
                 pre_delay_seconds: float = 0.01,
                 mod_depth_seconds: float = 0.002, mod_rate_hz: float = 0.1):
        if sample_rate <= 0 or not math.isfinite(sample_rate):
            raise ValueError(f"fdn reverb sample rate must be > 0: {sample_rate}")
        if wet < 0 or dry < 0:
            raise ValueError("fdn reverb wet/dry must be >= 0")
        if rt60_seconds <= 0:
            raise ValueError("fdn reverb rt60 must be > 0")
        self.sample_rate = sample_rate
        self.wet, self.dry = wet, dry
        self.rt60 = rt60_seconds
        self.damp = damp
        scale = sample_rate / _REF_SR
        self.base_delays = _DELAYS_441 * scale
        self.mod_depth = mod_depth_seconds * sample_rate
        self.mod_rate = mod_rate_hz
        self.pre_delay = pre_delay_seconds * sample_rate
        self.gain = 1.0 / math.sqrt(FDN_SIZE)
        delay_seconds = self.base_delays / sample_rate
        self.feedback_gains = 10.0 ** (-3.0 * delay_seconds / rt60_seconds)
        self.line_len = int(np.ceil(self.base_delays.max() + self.mod_depth)) + 4
        self.pre_len = max(int(np.ceil(self.pre_delay)) + 4, 4)
        self.hadamard = _hadamard8() * self.gain
        # the reference's block: in-block feedback reads must only hit
        # earlier blocks (B < min line delay), and the LFO's drift over a
        # block stays small (`fdn.py:78-91`)
        B = int(min(1024, np.floor(self.base_delays.min()) - 2))
        drift = self.mod_depth * 2.0 * np.pi * self.mod_rate / sample_rate
        while B > 16 and drift * B > 8.0:
            B //= 2
        self._block = B

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        """Lines, pre-delay ring, damping states, LFO phase and step, on
        the CUDA card unless `device` says otherwise."""
        device = resolve_device(device)
        shape = tuple(batch_shape)
        return {
            "lines": torch.zeros(shape + (FDN_SIZE, self.line_len), dtype=dtype,
                                 device=device),
            "pre": torch.zeros(shape + (self.pre_len,), dtype=dtype, device=device),
            "filter": torch.zeros(shape + (FDN_SIZE,), dtype=dtype, device=device),
            "lfo_phase": torch.zeros((), dtype=dtype, device=device),
            "step": torch.zeros((), dtype=torch.int32, device=device),
        }

    def _apply_pre_delay(self, pre, n0, x):
        """(new pre-delay ring, pre-delayed input) for the whole call: the
        input at a constant fractional lag, two static slices of the
        history extended by x."""
        if self.pre_delay <= 0:
            return pre, x
        P, N = self.pre_len, x.shape[-1]
        ext = torch.cat([ring.ring_to_linear(pre, n0), x], dim=-1)
        c = P - self.pre_delay                 # >= 4 by pre_len construction
        i00 = int(math.floor(c))
        frac = torch.tensor(c - i00, dtype=x.dtype)
        inp = (ext[..., i00:i00 + N] * (1 - frac)
               + ext[..., i00 + 1:i00 + 1 + N] * frac)
        return ring.linear_to_ring(ext[..., ext.shape[-1] - P:], n0 + N), inp

    def process(self, state, x):
        """(state, x:(..., N)) -> (state, y). On the card the state's lines
        are updated in place."""
        pre, inp = self._apply_pre_delay(state["pre"], state["step"], x)
        lines, fstate, lfo, step, y = feedback.fdn_feedback(
            self, state["lines"], state["filter"], state["lfo_phase"],
            state["step"], x, inp)
        return ({"lines": lines, "pre": pre, "filter": fstate,
                 "lfo_phase": lfo, "step": step}, y)

    def process_blocks(self, state, x, *, block_size: int | None = None):
        """Streamed multi-block processing (`fdn.py:288-325`): where N is a
        multiple of the internal block (`_block`, 1024 at 48 kHz), one
        `process` call (the reference's single scan: the same per-block
        algebra); tiny-delay configurations and ragged lengths run
        `process` over blocks of `block_size` (default N), which must be a
        multiple of the internal block when given."""
        N = x.shape[-1]
        B = self._block
        if block_size is not None and block_size % B:
            raise ValueError(
                f"fdn process_blocks: block_size {block_size} must be a "
                f"multiple of the internal block {B}")
        if B < 16 or N % B:
            return scan_blocks(self.process, state, x,
                               block_size=block_size or N)
        return self.process(state, x)

    def process_scan(self, state, x):
        """Per-sample reference implementation (kept for parity tests);
        the order of operations of fdn_reverb.go:196-259, the pre-delay
        read per sample."""
        consts = feedback.fdn_consts(self, x)
        lines, pre = state["lines"].clone(), state["pre"].clone()
        fstate, lfo = state["filter"], state["lfo_phase"]
        n0 = int(state["step"])
        P = self.pre_len
        ys = []
        for k in range(x.shape[-1]):
            n, xv = n0 + k, x[..., k]
            if self.pre_delay > 0:
                wp = n % P
                pre[..., wp] = xv
                pos = torch.tensor(float(wp), dtype=x.dtype) - self.pre_delay
                fl = torch.floor(pos)
                frac = pos - fl
                i0 = torch.remainder(fl.long(), P)
                inp = (pre[..., i0] * (1 - frac)
                       + pre[..., torch.remainder(i0 + 1, P)] * frac)
            else:
                inp = xv
            fstate, lfo, yk = feedback.fdn_step_plain(self, lines, fstate, lfo,
                                                      n, xv, inp, consts)
            ys.append(yk)
        y = torch.stack(ys, dim=-1) if ys else x.clone()
        return ({"lines": lines, "pre": pre, "filter": fstate, "lfo_phase": lfo,
                 "step": torch.as_tensor(n0 + x.shape[-1], dtype=torch.int32,
                                         device=x.device)}, y)
