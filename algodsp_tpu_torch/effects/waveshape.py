"""Waveshaping and lo-fi effects: Distortion, BitCrusher,
TransformerSimulation, HarmonicBass (counterpart of
`algodsp_tpu/effects/waveshape.py`).

Capability parity with `dsp/effects/distortion.go` (15 modes incl.
Chebyshev polynomial harmonic shaping of order 1-16 with parity control
and DC bypass), `bit_crusher.go` (fractional bit depth 1-32 and
sample-hold downsampling 1-256), `transformer_simulation.go`
(pre-emphasis HP + tanh/poly saturation + damping, quality
high = 4x oversampled / lightweight) and `harmonic_bass.go`
(psychoacoustic bass exciter: crossover, quadratic shaper, limiter).

Every transfer curve is elementwise PyTorch; the Chebyshev recurrence
unrolls to a fixed-order polynomial evaluation; the sample-hold is a
running maximum of update indices (`torch.cummax`) and a gather. The
filters are `BiquadChain`s on auto dispatch (the cascade kernel K3, or
the whole-cascade or blocked engine for slow poles), the DC bypass one
explicit-state section (K3 for float32 on the card, the blocked engine
otherwise), and the bass limiter the ported `Limiter` (K4 under its
detector).
"""

from __future__ import annotations

import enum
import math

import numpy as np
import torch

from algodsp_tpu_torch._device import resolve_device
from algodsp_tpu_torch.filters.biquad import BiquadChain
from algodsp_tpu_torch.filters.design import cascades, rbj


class DistortionMode(enum.Enum):
    SOFT_CLIP = "soft_clip"
    HARD_CLIP = "hard_clip"
    TANH = "tanh"
    WAVESHAPER1 = "waveshaper1"
    WAVESHAPER2 = "waveshaper2"
    WAVESHAPER3 = "waveshaper3"
    WAVESHAPER4 = "waveshaper4"
    WAVESHAPER5 = "waveshaper5"
    WAVESHAPER6 = "waveshaper6"
    WAVESHAPER7 = "waveshaper7"
    WAVESHAPER8 = "waveshaper8"
    SATURATE = "saturate"
    SATURATE2 = "saturate2"
    SOFT_SAT = "soft_sat"
    CHEBYSHEV = "chebyshev"


class ChebyshevHarmonicMode(enum.Enum):
    ALL = "all"
    ODD = "odd"
    EVEN = "even"


_DC_BYPASS_POLE = 0.995
# y_n = x_n - x_{n-1} + pole y_{n-1}: the first-order DC blocker
_DC_BYPASS = BiquadChain([1.0, -1.0, 0.0, -_DC_BYPASS_POLE, 0.0])


def _clamp_unit(x):
    return torch.clamp(x, -1.0, 1.0)


def _cube(x):
    return x * x * x


def _soft_clip(x):
    return torch.where(torch.abs(x) < 1, 1.5 * (x - _cube(x) / 3.0),
                       torch.sign(x))


class Distortion:
    """Multi-mode waveshaper (`distortion.go:537-744`)."""

    def __init__(self, *, mode: DistortionMode = DistortionMode.SOFT_CLIP,
                 drive: float = 1.0, shape: float = 0.5, bias: float = 0.0,
                 clip_level: float = 1.0, output_level: float = 1.0,
                 mix: float = 1.0, chebyshev_order: int = 2,
                 chebyshev_mode: ChebyshevHarmonicMode = ChebyshevHarmonicMode.ALL,
                 chebyshev_weights=None, chebyshev_gain: float = 1.0,
                 chebyshev_invert: bool = False, chebyshev_dc_bypass: bool = True):
        if not (0.01 <= drive <= 20.0):
            raise ValueError(f"distortion drive must be in [0.01, 20]: {drive}")
        if not (-1.0 <= bias <= 1.0):
            raise ValueError(f"distortion bias must be in [-1, 1]: {bias}")
        if not (1 <= chebyshev_order <= 16):
            raise ValueError(f"chebyshev order must be in [1, 16]: {chebyshev_order}")
        if chebyshev_mode == ChebyshevHarmonicMode.ODD and chebyshev_order % 2 == 0:
            raise ValueError("chebyshev odd harmonic mode requires odd order")
        if chebyshev_mode == ChebyshevHarmonicMode.EVEN and chebyshev_order % 2 == 1:
            raise ValueError("chebyshev even harmonic mode requires even order")
        self.mode = mode
        self.drive = drive
        self.shape = shape
        self.bias = bias
        self.clip_level = clip_level
        self.output_level = output_level
        self.mix = mix
        self.chebyshev_order = chebyshev_order
        self.chebyshev_weights = (np.zeros(chebyshev_order)
                                  if chebyshev_weights is None
                                  else np.asarray(chebyshev_weights, np.float64))
        self.chebyshev_gain = chebyshev_gain
        self.chebyshev_invert = chebyshev_invert
        self.chebyshev_dc_bypass = chebyshev_dc_bypass

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        device = resolve_device(device)
        zeros = lambda: torch.zeros(tuple(batch_shape), dtype=dtype, device=device)
        return {"dc_in": zeros(), "dc_out": zeros()}

    def _shape(self, x):
        m, s = self.mode, self.shape
        if m == DistortionMode.SOFT_CLIP:
            return _soft_clip(x)
        if m == DistortionMode.HARD_CLIP:
            return torch.clamp(x, -self.clip_level, self.clip_level) / self.clip_level
        if m == DistortionMode.TANH:
            return torch.tanh(x)
        if m == DistortionMode.WAVESHAPER1:
            return _clamp_unit(x / (1 + s * torch.abs(x)))
        if m == DistortionMode.WAVESHAPER2:
            return _clamp_unit((1 + s) * x / (1 + s * torch.abs(x)))
        if m == DistortionMode.WAVESHAPER3:
            return _clamp_unit(x - s * _cube(x) / 3.0)
        if m == DistortionMode.WAVESHAPER4:
            return _clamp_unit(3 * x / (2 + torch.abs(2 * x)))
        if m == DistortionMode.WAVESHAPER5:
            scale = 1 + 4 * s
            return _clamp_unit(torch.atan(x * scale) / math.atan(scale))
        if m == DistortionMode.WAVESHAPER6:
            return _clamp_unit((1 + s) * x / (1 + s * x * x))
        if m == DistortionMode.WAVESHAPER7:
            return torch.tanh(x * (1 + 6 * s))
        if m == DistortionMode.WAVESHAPER8:
            a = 1 + 6 * s
            return _clamp_unit(torch.sign(x) * (1 - torch.exp(-torch.abs(x) * a)))
        if m == DistortionMode.SATURATE:
            return _clamp_unit(x / (1 + torch.abs(x)))
        if m == DistortionMode.SATURATE2:
            return _soft_clip(x * (1 + 2 * s))
        if m == DistortionMode.SOFT_SAT:
            return _clamp_unit((2 / math.pi) * torch.atan((math.pi / 2) * x))
        if m == DistortionMode.CHEBYSHEV:
            return self._chebyshev(x)
        raise ValueError(f"unknown distortion mode {m}")

    def _chebyshev(self, x):
        """T_n recurrence with optional per-harmonic weights
        (`distortion.go:684-728`), the weights in x's type."""
        x = torch.clamp(x, -1.0, 1.0)
        weights = [float(v) for v in self.chebyshev_weights]
        has_weights = any(v != 0 for v in weights)
        t0 = torch.ones_like(x)
        t1 = x
        acc = weights[0] * t1 if has_weights else None
        tn = t1
        for n in range(2, self.chebyshev_order + 1):
            tn = 2 * x * t1 - t0
            if has_weights:
                acc = acc + weights[n - 1] * tn
            t0, t1 = t1, tn
        out = (acc if has_weights else tn) * self.chebyshev_gain
        if self.chebyshev_invert:
            out = -out
        return _clamp_unit(out)

    def process(self, state, x):
        wet = self._shape((x + self.bias) * self.drive) * self.output_level
        new_state = dict(state)
        if self.mode == DistortionMode.CHEBYSHEV and self.chebyshev_dc_bypass:
            st = torch.stack([state["dc_in"], torch.zeros_like(state["dc_in"]),
                              state["dc_out"], torch.zeros_like(state["dc_out"])],
                             dim=-1)[..., None, :].to(x.dtype)
            st, wet = _DC_BYPASS.process_stream(st, wet)
            new_state["dc_in"] = st[..., 0, 0]
            new_state["dc_out"] = st[..., 0, 2]
        wet = torch.where(torch.isfinite(wet), wet, torch.zeros_like(wet))
        return new_state, x * (1 - self.mix) + wet * self.mix


class BitCrusher:
    """Bit-depth quantizer + sample-hold downsampler
    (`bit_crusher.go:191-230`)."""

    def __init__(self, sample_rate: float, *, bit_depth: float = 8.0,
                 downsample: int = 4, mix: float = 1.0):
        if not (1.0 <= bit_depth <= 32.0):
            raise ValueError(f"bit depth must be in [1, 32]: {bit_depth}")
        if not (1 <= downsample <= 256):
            raise ValueError(f"downsample must be in [1, 256]: {downsample}")
        self.sample_rate = sample_rate
        self.bit_depth = bit_depth
        self.downsample = downsample
        self.mix = mix
        self.quant_levels = 2.0 ** (bit_depth - 1.0)

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        device = resolve_device(device)
        return {"hold": torch.zeros(tuple(batch_shape), dtype=dtype, device=device),
                "counter": torch.zeros((), dtype=torch.int32, device=device)}

    def _quantize(self, x):
        # half to even, as jnp.round
        return torch.round(x * self.quant_levels) / self.quant_levels

    def process(self, state, x):
        n = x.shape[-1]
        ds = self.downsample
        if ds == 1:
            wet = self._quantize(x)
            return ({"hold": wet[..., -1], "counter": state["counter"]},
                    x * (1 - self.mix) + wet * self.mix)
        # the counter increments, then wraps at ds; an update fires where
        # it reaches ds (`bit_crusher.go:193-198`): the held value is the
        # quantized sample at the most recent update, by a running maximum
        # of update indices
        k = torch.arange(n, device=x.device)
        counters = torch.remainder(state["counter"].to(torch.int64) + 1 + k, ds)
        last = torch.cummax(torch.where(counters == 0, k, torch.full_like(k, -1)),
                            dim=0).values
        q = self._quantize(x)
        held = torch.where(last >= 0, q[..., torch.clamp(last, min=0)],
                           state["hold"].to(x.dtype)[..., None])
        return ({"hold": held[..., -1], "counter": counters[-1].to(torch.int32)},
                x * (1 - self.mix) + held * self.mix)


class TransformerQuality(enum.Enum):
    HIGH = "high"
    LIGHTWEIGHT = "lightweight"


def _poly_saturate(x):
    """Odd polynomial tanh approximation (`transformer_simulation.go:488-501`)."""
    one = torch.ones_like(x)
    return torch.where(x > 3, one,
                       torch.where(x < -3, -one,
                                   torch.clamp(x * (27 + x * x) / (27 + 9 * x * x),
                                               -1.0, 1.0)))


class TransformerSimulation:
    """Transformer core saturation (`transformer_simulation.go:333-430`):
    pre-emphasis HP -> saturate (4x oversampled exact tanh in high
    quality, polynomial in lightweight) -> damping LP -> mix."""

    def __init__(self, sample_rate: float, *,
                 quality: TransformerQuality = TransformerQuality.HIGH,
                 drive: float = 1.5, mix: float = 1.0, output_level: float = 1.0,
                 highpass_hz: float = 20.0, damping_hz: float = 18000.0,
                 oversampling: int = 4):
        if sample_rate <= 0:
            raise ValueError("transformer: sample rate must be > 0")
        self.sample_rate = sample_rate
        self.quality = quality
        self.drive = drive
        self.mix = mix
        self.output_level = output_level
        self.oversampling = oversampling if quality == TransformerQuality.HIGH else 1
        # the pre-emphasis is a slow pole (25 Hz by the registry's
        # default): in float32 the whole-cascade engine's error grows with
        # the carries between its blocks, and 256-sample blocks (the
        # reference's bulk block) halve them: 106 dB against float64 where
        # 128 gives 103 on a 512-sample call
        self.pre_hp = BiquadChain(rbj.highpass(highpass_hz, 0.707, sample_rate),
                                  block_size=256)
        self.damp = BiquadChain(
            rbj.lowpass(min(damping_hz, 0.45 * sample_rate), 0.707, sample_rate))
        if self.oversampling > 1:
            os_sr = sample_rate * self.oversampling
            # anti-alias filters at the oversampled rate
            self.up_aa = BiquadChain(
                cascades.butterworth_lp(0.45 * sample_rate, 4, os_sr))
            self.down_aa = BiquadChain(
                cascades.butterworth_lp(0.45 * sample_rate, 4, os_sr))
            self.damp_os = BiquadChain(
                rbj.lowpass(min(damping_hz, 0.45 * sample_rate), 0.707, os_sr))

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        device = resolve_device(device)
        st = {"hp": self.pre_hp.init_state(batch_shape, dtype, device),
              "damp": self.damp.init_state(batch_shape, dtype, device)}
        if self.oversampling > 1:
            st["up_aa"] = self.up_aa.init_state(batch_shape, dtype, device)
            st["down_aa"] = self.down_aa.init_state(batch_shape, dtype, device)
            st["damp_os"] = self.damp_os.init_state(batch_shape, dtype, device)
        return st

    def process(self, state, x):
        new_state = dict(state)
        new_state["hp"], pre = self.pre_hp.process_stream(state["hp"], x)
        if self.oversampling > 1:
            os = self.oversampling
            # zero-stuff upsample scaled by the factor
            # (transformer_simulation.go:404-409)
            up = x.new_zeros(x.shape[:-1] + (x.shape[-1] * os,))
            up[..., ::os] = pre * os
            new_state["up_aa"], u = self.up_aa.process_stream(state["up_aa"], up)
            u = torch.tanh(u * self.drive)
            new_state["damp_os"], u = self.damp_os.process_stream(state["damp_os"], u)
            new_state["down_aa"], u = self.down_aa.process_stream(state["down_aa"], u)
            wet = u[..., os - 1::os]
        else:
            wet = _poly_saturate(pre * self.drive)
            new_state["damp"], wet = self.damp.process_stream(state["damp"], wet)
        wet = wet * self.output_level
        wet = torch.where(torch.isfinite(wet), wet, torch.zeros_like(wet))
        return new_state, x * (1 - self.mix) + wet * self.mix


class HarmonicBass:
    """Psychoacoustic bass exciter (`harmonic_bass.go:262-300`):
    crossover split, quadratic shaper on the low band, HP + limiter on
    the harmonics, recombination."""

    def __init__(self, sample_rate: float, *, frequency: float = 120.0,
                 decay: float = 0.2, response_ms: float = 20.0,
                 input_level: float = 1.0, high_frequency_gain: float = 1.0,
                 original_bass_gain: float = 1.0, harmonic_bass_gain: float = 0.0):
        from algodsp_tpu_torch.effects.dynamics import Limiter
        if sample_rate <= 0 or not math.isfinite(sample_rate):
            raise ValueError(f"harmonic bass sample rate must be positive: {sample_rate}")
        self.sample_rate = sample_rate
        self.frequency = frequency
        self.decay = decay
        self.input_level = input_level
        self.high_frequency_gain = high_frequency_gain
        self.original_bass_gain = original_bass_gain
        self.harmonic_bass_gain = harmonic_bass_gain
        self.lp = BiquadChain(cascades.butterworth_lp(frequency, 4, sample_rate))
        self.hp = BiquadChain(cascades.butterworth_hp(frequency, 4, sample_rate))
        self.harm_hp = BiquadChain(rbj.highpass(frequency / 2, 0.707, sample_rate))
        self.limiter = Limiter(sample_rate, threshold_db=0.0,
                               release_ms=response_ms)

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        device = resolve_device(device)
        return {"lp": self.lp.init_state(batch_shape, dtype, device),
                "hp": self.hp.init_state(batch_shape, dtype, device),
                "hhp": self.harm_hp.init_state(batch_shape, dtype, device),
                "lim": self.limiter.init_state(batch_shape, dtype, device)}

    def process(self, state, x):
        x = x * self.input_level
        new_state = dict(state)
        new_state["lp"], low = self.lp.process_stream(state["lp"], x)
        new_state["hp"], high = self.hp.process_stream(state["hp"], x)
        shaped = self.decay + low * (1 + low * (-2.0 * self.decay))
        new_state["hhp"], shaped = self.harm_hp.process_stream(state["hhp"], shaped)
        new_state["lim"], shaped = self.limiter.process(state["lim"], 4.0 * shaped)
        shaped = torch.clamp(0.5 * shaped, -1.0, 1.0)
        y = (self.original_bass_gain * low + self.harmonic_bass_gain * shaped
             + self.high_frequency_gain * high)
        return new_state, y
