"""Freeverb / Schroeder reverb (counterpart of
`algodsp_tpu/effects/reverb/freeverb.py`).

8 parallel feedback combs (damping one-pole in the loop, denormal
squelch at 1e-23) + 4 serial allpasses, legacy 44.1 kHz tunings, fixed
input gain 0.015, wet/dry/room-size/damp controls
(`dsp/effects/reverb/reverb.go:5-200`).

The state is the reference's: 8 comb rings and 4 allpass rings of their
tuned lengths, the combs' damping states and the int32 step. `process`
runs the feedback loop through `ops/feedback.freeverb_feedback`: R2 on
the card (per sample, in place on the rings), the reference's blocked
engine on the CPU (128-sample blocks on the shift-register layout with
the damping as a Toeplitz product, the tail per sample; it squelches
once a block where the per-sample walk squelches each sample, a gap
below 1e-23). `process_scan` is the reference's per-sample walk.
"""

from __future__ import annotations

import numpy as np
import torch

from algodsp_tpu_torch._device import resolve_device
from algodsp_tpu_torch.ops import feedback
from algodsp_tpu_torch.streaming import scan_blocks

COMB_TUNINGS = (1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617)
ALLPASS_TUNINGS = (556, 441, 341, 225)
FIXED_GAIN = 0.015
_BLOCK = feedback.DELAY_BLOCK  # must be <= min(ALLPASS_TUNINGS)


class Freeverb:
    def __init__(self, *, wet: float = 0.22, dry: float = 1.0,
                 room_size: float = 0.72, damp: float = 0.45,
                 input_gain: float = FIXED_GAIN):
        self.input_gain = float(input_gain)
        self.wet = float(wet)
        self.dry = float(dry)
        self.room_size = float(room_size)
        self.damp = float(damp)
        # Freeverb scaling: feedback = roomsize (legacy maps it directly)
        self.comb_feedback = self.room_size
        self.allpass_feedback = 0.5
        # the blocked damping kernels (host float64):
        #   fs[t] = db*out[t] + da*fs[t-1]
        #   fs = out @ T^T + fs0 * p,  T[t,k] = db*da^(t-k) (t>=k),
        #   p[t] = da^(t+1)
        da, db = self.damp, 1.0 - self.damp
        t = np.arange(_BLOCK)
        lag = t[:, None] - t[None, :]
        self._damp_T = np.where(lag >= 0, db * da ** np.maximum(lag, 0), 0.0)
        self._damp_p = da ** (t + 1.0)

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        """The rings, damping states and step, on the CUDA card unless
        `device` says otherwise."""
        device = resolve_device(device)
        shape = tuple(batch_shape)
        zeros = lambda n: torch.zeros(shape + (n,), dtype=dtype, device=device)
        return {"combs": [zeros(n) for n in COMB_TUNINGS],
                "filter_store": zeros(len(COMB_TUNINGS)),
                "allpasses": [zeros(n) for n in ALLPASS_TUNINGS],
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    def process(self, state, x):
        """(state, x:(..., N)) -> (state, y). On the card the state's rings
        are updated in place."""
        return feedback.freeverb_feedback(self, state, x)

    def process_blocks(self, state, x, *, block_size: int | None = None):
        """Streamed multi-block processing (`freeverb.py:153-185`): where N
        is a multiple of the internal 128-sample block, one `process`
        call (the reference's single scan: the same per-block algebra,
        one layout conversion a run); otherwise `process` over blocks of
        `block_size` (default N). `block_size` must be a multiple of 128."""
        n = x.shape[-1]
        if block_size is not None and block_size % _BLOCK:
            raise ValueError(
                f"freeverb process_blocks: block_size {block_size} must "
                f"be a multiple of the internal block {_BLOCK}")
        if n % _BLOCK:
            return scan_blocks(self.process, state, x,
                               block_size=block_size or n)
        return self.process(state, x)

    def process_scan(self, state, x):
        """Per-sample reference implementation (kept for parity tests)."""
        combs, fstore, allp, y = feedback.freeverb_scan_plain(
            self, state["combs"], state["filter_store"], state["allpasses"],
            int(state["step"]), x)
        step = torch.as_tensor(int(state["step"]) + x.shape[-1],
                               dtype=torch.int32, device=x.device)
        return ({"combs": combs, "filter_store": fstore, "allpasses": allp,
                 "step": step}, y)
