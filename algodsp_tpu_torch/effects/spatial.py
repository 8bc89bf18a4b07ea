"""Spatial / stereo effects (counterpart of `algodsp_tpu/effects/spatial.py`).

Capability parity with `dsp/effects/spatial/`: StereoWidener (mid/side
width 0-4 with optional bass-mono crossover, `stereo_widener.go:142-178`),
CrosstalkCanceller (staged delayed + high-shelf-shaped crossfeed
subtraction modeling speaker-to-ear path mismatch,
`crosstalk_canceller.go:204-218`), CrosstalkSimulator (single delayed,
shelved crossfeed with mix, `crosstalk_simulator.go:171-185`; the HRTF
variant takes explicit crossfeed impulse responses, the analog of the
embedded IR set in `crosstalk_simulator_hrtf.go:20-85`).

All are feedforward: integer delays are shifts with carried history, the
shelves and the bass-mono split run through `BiquadChain.process_stream`
(K3 wherever auto dispatch takes it) and the HRTF paths through
`fftconvolve` (K1 on the card for float32 kernels of `FDL_MIN_TAPS`
taps or more).

Stereo convention: x is (..., 2, N) with the channel axis second to last.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from algodsp_tpu_torch._device import resolve_device
from algodsp_tpu_torch.conv import fftconvolve
from algodsp_tpu_torch.filters.biquad import BiquadChain
from algodsp_tpu_torch.filters.design import rbj


def _delayed_with_history(x, state, delay: int):
    """Integer delay with carried history (state length == delay)."""
    if delay == 0:
        return state, x
    ext = torch.cat([state.to(x.dtype), x], dim=-1)
    return ext[..., -delay:], ext[..., :x.shape[-1]]


class StereoWidener:
    def __init__(self, sample_rate: float, *, width: float = 1.5,
                 bass_mono_hz: float = 0.0):
        if not (0.0 <= width <= 4.0):
            raise ValueError(f"stereo widener width must be in [0, 4]: {width}")
        self.width = width
        self.bass_mono_hz = bass_mono_hz
        if bass_mono_hz > 0:
            self.lp = BiquadChain(rbj.lowpass(bass_mono_hz, 0.707, sample_rate))
            self.hp = BiquadChain(rbj.highpass(bass_mono_hz, 0.707, sample_rate))
        else:
            self.lp = self.hp = None

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        """The split's two filter states, on the CUDA card unless `device`
        says otherwise ({} without the bass-mono split)."""
        device = resolve_device(device)
        if self.lp is None:
            return {}
        batch = tuple(batch_shape) + (2,)
        return {"lp": self.lp.init_state(batch, dtype, device),
                "hp": self.hp.init_state(batch, dtype, device)}

    def process(self, state, x):
        """x: (..., 2, N) stereo."""
        left, right = x[..., 0, :], x[..., 1, :]
        if self.lp is None:
            mid = (left + right) * 0.5
            side = (left - right) * 0.5
            out = torch.stack([mid + side * self.width,
                               mid - side * self.width], dim=-2)
            return state, out
        lp_state, bass = self.lp.process_stream(state["lp"], x)
        hp_state, high = self.hp.process_stream(state["hp"], x)
        bass_mono = (bass[..., 0, :] + bass[..., 1, :]) * 0.5
        mid_h = (high[..., 0, :] + high[..., 1, :]) * 0.5
        side_h = (high[..., 0, :] - high[..., 1, :]) * 0.5
        out = torch.stack([bass_mono + mid_h + side_h * self.width,
                           bass_mono + mid_h - side_h * self.width], dim=-2)
        return {"lp": lp_state, "hp": hp_state}, out


class CrosstalkCanceller:
    def __init__(self, sample_rate: float, *, speaker_span_deg: float = 30.0,
                 listening_distance_m: float = 0.6, stages: int = 3,
                 attenuation: float = 0.5, shelf_freq: float = 4000.0,
                 shelf_gain_db: float = -6.0, speed_of_sound: float = 343.0,
                 head_width_m: float = 0.15):
        if not (0.0 <= attenuation < 1.0):
            raise ValueError(f"crosstalk canceller attenuation must be in [0,1): {attenuation}")
        if stages < 1:
            raise ValueError("crosstalk canceller needs >= 1 stage")
        # geometric path difference between near and far ear
        half_span = math.radians(speaker_span_deg / 2)
        d_near = math.hypot(listening_distance_m * math.cos(half_span),
                            listening_distance_m * math.sin(half_span)
                            - head_width_m / 2)
        d_far = math.hypot(listening_distance_m * math.cos(half_span),
                           listening_distance_m * math.sin(half_span)
                           + head_width_m / 2)
        delay_seconds = (d_far - d_near) / speed_of_sound
        self.base_delay = max(int(round(delay_seconds * sample_rate)), 1)
        self.stage_delays = [self.base_delay * (i + 1) for i in range(stages)]
        self.stage_gains = [attenuation ** (i + 1) for i in range(stages)]
        self.shelves = [BiquadChain(rbj.high_shelf(shelf_freq, shelf_gain_db,
                                                   0.707, sample_rate))
                        for _ in range(stages)]
        self.stages = stages

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        """Each stage's delay history and shelf state, on the CUDA card
        unless `device` says otherwise."""
        device = resolve_device(device)
        batch = tuple(batch_shape) + (2,)
        return {"delays": [torch.zeros(batch + (d,), dtype=dtype, device=device)
                           for d in self.stage_delays],
                "shelves": [s.init_state(batch, dtype, device)
                            for s in self.shelves]}

    def process(self, state, x):
        """x: (..., 2, N) -> crosstalk-cancelled stereo."""
        swapped = x.flip(-2)  # (R, L): the opposite channel feed
        cross = torch.zeros_like(x)
        new_delays, new_shelves = [], []
        for i in range(self.stages):
            dstate, delayed = _delayed_with_history(
                swapped, state["delays"][i], self.stage_delays[i])
            sstate, shaped = self.shelves[i].process_stream(
                state["shelves"][i], delayed)
            cross = cross + shaped * self.stage_gains[i]
            new_delays.append(dstate)
            new_shelves.append(sstate)
        return ({"delays": new_delays, "shelves": new_shelves}, x - cross)


class CrosstalkSimulator:
    """Loudspeaker crosstalk / crossfeed simulator.

    Three operating modes, matching the reference pair of types:

      * parametric (default): single delayed, high-shelf-shaped
        crossfeed with mix (`crosstalk_simulator.go:171-185`);
      * `hrtf_irs` = one array: that IR convolves the crossfeed path,
        mixed like the parametric model;
      * `hrtf_irs` = dict with keys left_direct/left_cross/
        right_direct/right_cross (the `HRTFImpulseResponseSet` fields,
        `crosstalk_simulator_hrtf.go:20-24`; e.g. from
        `utils.irlib.hrtf_ir_set`): full 4-path FIR routing with
        `hrtf_mode` "crossfeed_only" (dry direct + convolved crossfeed,
        the reference default) or "complete" (both paths convolved) —
        `ProcessStereo` semantics at `crosstalk_simulator_hrtf.go:121-137`.
    """

    def __init__(self, sample_rate: float, *, delay_seconds: float = 0.0003,
                 shelf_freq: float = 3000.0, shelf_gain_db: float = -8.0,
                 crossfeed_mix: float = 0.35, invert_polarity: bool = False,
                 hrtf_irs=None, hrtf_mode: str = "crossfeed_only"):
        if not (0.0 <= crossfeed_mix <= 1.0):
            raise ValueError(f"crossfeed mix must be in [0,1]: {crossfeed_mix}")
        if hrtf_mode not in ("crossfeed_only", "complete"):
            raise ValueError(
                f"hrtf mode must be 'crossfeed_only' or 'complete': "
                f"{hrtf_mode!r}")
        self.delay = max(int(round(delay_seconds * sample_rate)), 1)
        self.mix = crossfeed_mix
        self.invert = invert_polarity
        self.hrtf_mode = hrtf_mode
        self.shelf = BiquadChain(rbj.high_shelf(shelf_freq, shelf_gain_db,
                                                0.707, sample_rate))
        self.hrtf = None
        self.hrtf_set = None
        if isinstance(hrtf_irs, dict):
            keys = ("left_direct", "left_cross", "right_direct",
                    "right_cross")
            missing = [k for k in keys if k not in hrtf_irs]
            if missing:
                raise ValueError(f"hrtf ir set missing paths: {missing}")
            self.hrtf_set = {k: np.asarray(hrtf_irs[k], np.float64).reshape(-1)
                             for k in keys}
            for k, v in self.hrtf_set.items():
                if v.size == 0:
                    raise ValueError(f"hrtf ir set path {k!r} is empty")
        elif hrtf_irs is not None:
            self.hrtf = np.asarray(hrtf_irs, dtype=np.float64)

    def _hrtf_tail_len(self) -> int:
        """Longest IR tail the 4-path routing can produce."""
        irs = [self.hrtf_set["left_cross"], self.hrtf_set["right_cross"]]
        if self.hrtf_mode == "complete":
            irs += [self.hrtf_set["left_direct"],
                    self.hrtf_set["right_direct"]]
        return max(ir.size for ir in irs) - 1

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        """The overlap tail (HRTF set), nothing (one IR), or the delay
        history and shelf state (parametric); on the CUDA card unless
        `device` says otherwise."""
        device = resolve_device(device)
        batch = tuple(batch_shape) + (2,)
        if self.hrtf_set is not None:
            # streaming overlap tail per output channel — the stateful
            # analog of the reference's firPath history, so block-by-
            # block processing is exact (no dropped convolution tails)
            t = self._hrtf_tail_len()
            return ({"tail": torch.zeros(batch + (t,), dtype=dtype,
                                         device=device)} if t else {})
        if self.hrtf is not None:
            return {}
        return {"delay": torch.zeros(batch + (self.delay,), dtype=dtype,
                                     device=device),
                "shelf": self.shelf.init_state(batch, dtype, device)}

    def _process_hrtf_set(self, state, x):
        """4-path FIR routing (`crosstalk_simulator_hrtf.go:121-137`)
        with carried overlap tails (ProcessStereo's stateful firPath):
        feeding the signal block-by-block gives the same output as one
        whole-signal call."""
        n = x.shape[-1]
        t = self._hrtf_tail_len()
        left, right = x[..., 0, :], x[..., 1, :]

        def conv_full(sig, ir):
            full = fftconvolve(sig, ir)
            pad = n + t - full.shape[-1]
            if pad > 0:
                full = torch.nn.functional.pad(full, (0, pad))
            return full

        full_l = conv_full(right, self.hrtf_set["left_cross"])
        full_r = conv_full(left, self.hrtf_set["right_cross"])
        if self.hrtf_mode == "complete":
            full_l = full_l + conv_full(left, self.hrtf_set["left_direct"])
            full_r = full_r + conv_full(right, self.hrtf_set["right_direct"])
        full = torch.stack([full_l, full_r], dim=-2)  # (..., 2, n + t)
        if t == 0:
            out = full
            new_state = state
        else:
            tail_in = state["tail"].to(x.dtype)
            full = full + torch.nn.functional.pad(tail_in, (0, n))
            out = full[..., :n]
            # the carried tail stays in the STATE's type, whatever x's
            new_state = {"tail": full[..., n:].to(state["tail"].dtype)}
        if self.hrtf_mode != "complete":
            out = out + x
        return new_state, out

    def process(self, state, x):
        if self.hrtf_set is not None:
            return self._process_hrtf_set(state, x)
        swapped = x.flip(-2)
        if self.hrtf is not None:
            n = x.shape[-1]
            cross = fftconvolve(swapped, self.hrtf)[..., :n]
            new_state = state
        else:
            dstate, delayed = _delayed_with_history(swapped, state["delay"],
                                                    self.delay)
            sstate, cross = self.shelf.process_stream(state["shelf"], delayed)
            new_state = {"delay": dstate, "shelf": sstate}
        if self.invert:
            cross = -cross
        out = x * (1.0 - self.mix) + cross * self.mix
        return new_state, out
