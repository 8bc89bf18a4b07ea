"""Channel vocoder (counterpart of `algodsp_tpu/effects/vocoder.py`).

Capability parity with `dsp/effects/vocoder.go`: 32-band ISO 1/3-octave
or 24-band Bark analysis/synthesis constant-peak-gain bandpass banks at
Q = 1/(2^(1/6)-2^(-1/6)) ≈ 4.3185, per-band envelope followers
(attack 0.5 ms / release 2 ms defaults), sidechain carrier, and
input/synth/vocoded level mixing.

Both filter banks run as `_BandedChain`s (every band in one banded
pass); ALL band envelope followers run in a single `envelope_scan`, K4
on the card over C x B rows. As in the reference, every band runs at the
full rate (the Go code's per-band-group decimation, `vocoder.go:400,
581-608`, is a scalar-CPU optimisation; outputs settle to the same
envelopes).
"""

from __future__ import annotations

import enum
import math

import numpy as np
import torch

from algodsp_tpu_torch._device import resolve_device
from algodsp_tpu_torch.filters.bank import _BandedChain
from algodsp_tpu_torch.ops.envscan import envelope_scan

THIRD_OCTAVE_FREQUENCIES = np.array([
    16, 20, 25, 31, 40, 50, 63, 80, 100, 125, 160, 200, 250, 315, 400, 500,
    630, 800, 1000, 1250, 1600, 2000, 2500, 3150, 4000, 5000, 6300, 8000,
    10000, 12500, 16000, 20000], dtype=np.float64)

BARK_FREQUENCIES = np.array([
    100, 200, 300, 400, 510, 630, 770, 920, 1080, 1270, 1480, 1720, 2000,
    2320, 2700, 3150, 3700, 4400, 5300, 6400, 7700, 9500, 12000, 15500],
    dtype=np.float64)

THIRD_OCTAVE_Q = 1.0 / (2.0 ** (1.0 / 6.0) - 2.0 ** (-1.0 / 6.0))


class BandLayout(enum.Enum):
    THIRD_OCTAVE = "third_octave"
    BARK = "bark"


def _cpg_bandpass(freq: float, q: float, sample_rate: float) -> np.ndarray:
    """Constant-peak-gain RBJ bandpass (b0 = alpha variant)."""
    w0 = 2.0 * math.pi * freq / sample_rate
    sw, cw = math.sin(w0), math.cos(w0)
    alpha = sw / (2.0 * q)
    a0 = 1.0 + alpha
    return np.array([alpha / a0, 0.0, -alpha / a0,
                     -2.0 * cw / a0, (1.0 - alpha) / a0])


class Vocoder:
    def __init__(self, sample_rate: float, *,
                 layout: BandLayout = BandLayout.THIRD_OCTAVE,
                 synth_q: float = THIRD_OCTAVE_Q,
                 attack_ms: float = 0.5, release_ms: float = 2.0,
                 input_level: float = 0.0, synth_level: float = 0.0,
                 vocoded_level: float = 1.0):
        if sample_rate <= 0:
            raise ValueError("vocoder: sample rate must be > 0")
        if not (0.01 <= attack_ms <= 100.0) or not (0.01 <= release_ms <= 1000.0):
            raise ValueError("vocoder: attack/release out of range")
        if not (0.1 <= synth_q <= 20.0):
            raise ValueError(f"vocoder: synth Q out of range: {synth_q}")
        freqs = (THIRD_OCTAVE_FREQUENCIES if layout == BandLayout.THIRD_OCTAVE
                 else BARK_FREQUENCIES)
        nyquist = sample_rate / 2
        freqs = freqs[freqs < nyquist * 0.9]
        if freqs.size == 0:
            raise ValueError(f"vocoder: no usable bands at {sample_rate} Hz")
        self.sample_rate = sample_rate
        self.layout = layout
        self.frequencies = freqs
        self.num_bands = freqs.size
        analysis_q = THIRD_OCTAVE_Q
        a_sos = np.stack([_cpg_bandpass(f, analysis_q, sample_rate)[None, :]
                          for f in freqs])  # (B, 1, 5)
        s_sos = np.stack([_cpg_bandpass(f, synth_q, sample_rate)[None, :]
                          for f in freqs])
        self.analysis = _BandedChain(a_sos)
        self.synthesis = _BandedChain(s_sos)
        self.attack_coeff = 1.0 - math.exp(-1.0 / (attack_ms * 1e-3 * sample_rate))
        self.release_coeff = 1.0 - math.exp(-1.0 / (release_ms * 1e-3 * sample_rate))
        self.input_level = input_level
        self.synth_level = synth_level
        self.vocoded_level = vocoded_level

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        """Both banks' states and the band envelopes (..., B), on the CUDA
        card unless `device` says otherwise."""
        device = resolve_device(device)
        batch = tuple(batch_shape)
        return {"analysis": self.analysis.init_state(batch, dtype, device),
                "synthesis": self.synthesis.init_state(batch, dtype, device),
                "env": torch.zeros(batch + (self.num_bands,), dtype=dtype,
                                   device=device)}

    def process(self, state, modulator, carrier):
        """(state, modulator (..., N), carrier (..., N)) -> (state, y)."""
        mod, car = modulator, carrier
        b = self.num_bands
        mod_b = mod[..., None, :].expand(mod.shape[:-1] + (b, mod.shape[-1]))
        car_b = car[..., None, :].expand(car.shape[:-1] + (b, car.shape[-1]))
        a_state, band_sig = self.analysis.process_stream(state["analysis"], mod_b)
        env_f, env = envelope_scan(torch.abs(band_sig), state["env"],
                                   self.attack_coeff, self.release_coeff)
        s_state, synth_bands = self.synthesis.process_stream(
            state["synthesis"], car_b)
        vocoded = torch.sum(env * synth_bands, dim=-2)
        synth_sum = torch.sum(synth_bands, dim=-2)
        y = (self.vocoded_level * vocoded + self.input_level * mod
             + self.synth_level * synth_sum)
        return ({"analysis": a_state, "synthesis": s_state, "env": env_f}, y)
