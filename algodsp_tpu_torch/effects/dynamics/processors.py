"""Dynamics processors built on the shared core (counterpart of
`algodsp_tpu/effects/dynamics/processors.py`).

Capability parity with `dsp/effects/dynamics/`: Compressor
(`compressor.go`, feed-forward or feedback), Limiter (100:1, 0.1 ms,
hard knee, `limiter.go`), Expander (`expander.go`), Gate with hold timer
(`gate.go`), LookaheadLimiter (delayed program path + early detector,
`lookahead_limiter.go:23-36,185-210`), DeEsser (band detector + split
or wideband gain, `deesser.go`), TransientShaper (attack/sustain split,
`transient_shaper.go:139-188`) and MultibandCompressor (crossover tree
+ per-band compressors, `multiband.go:27-160`).

Every processor is a composition of the port's kernels and elementwise
work: the detectors run the envelope kernel (K4) and the sidechain and
band filters the cascade kernel (K3) or the blocked engine, the feedback
topology runs D1 (`ops/dynfb.py`). The gate's hold timer and the
transient shaper's gain need no kernel of their own (see their
classes). Processors are functional: `process(state, x, ...) ->
(state, y)`, vectorized over leading dims; metrics are returned per
block (`block_metrics`).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from algodsp_tpu_torch._device import resolve_device
from algodsp_tpu_torch.effects.dynamics.core import (
    DetectorMode, DynamicsConfig, DynamicsCore, Topology,
    downward_expansion_gain)
from algodsp_tpu_torch.filters.biquad import BiquadChain
from algodsp_tpu_torch.filters.crossover import Crossover, MultiBand
from algodsp_tpu_torch.filters.design.rbj import bandpass, highpass
from algodsp_tpu_torch.ops.envscan import envelope_scan


@dataclasses.dataclass(frozen=True)
class BlockMetrics:
    """Per-block metering (`compressor.go:31-35`)."""
    input_peak: float
    output_peak: float
    gain_reduction: float


def block_metrics(x, y, gain) -> BlockMetrics:
    """Input and output peak and the smallest gain of one block."""
    return BlockMetrics(
        input_peak=float(torch.max(torch.abs(x))),
        output_peak=float(torch.max(torch.abs(y))),
        gain_reduction=float(torch.min(gain)))


class Compressor:
    """Soft-knee compressor (`compressor.go:77-120` defaults)."""

    def __init__(self, sample_rate: float, *, threshold_db: float = -20.0,
                 ratio: float = 4.0, knee_db: float = 6.0,
                 attack_ms: float = 10.0, release_ms: float = 100.0,
                 makeup_gain_db: float = 0.0, auto_makeup: bool = False,
                 topology: Topology = Topology.FEEDFORWARD,
                 detector_mode: DetectorMode = DetectorMode.PEAK,
                 feedback_ratio_scale: bool = False,
                 rms_window_ms: float = 30.0,
                 sidechain_low_cut_hz: float = 0.0,
                 sidechain_high_cut_hz: float = 0.0):
        self.core = DynamicsCore(DynamicsConfig(
            sample_rate=sample_rate, topology=topology,
            detector_mode=detector_mode,
            feedback_ratio_scale=feedback_ratio_scale,
            threshold_db=threshold_db, ratio=ratio, knee_db=knee_db,
            attack_ms=attack_ms, release_ms=release_ms,
            rms_window_ms=rms_window_ms, auto_makeup=auto_makeup,
            makeup_gain_db=makeup_gain_db,
            sidechain_low_cut_hz=sidechain_low_cut_hz,
            sidechain_high_cut_hz=sidechain_high_cut_hz))

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        return self.core.init_state(batch_shape, dtype, device)

    def process(self, state, x, sidechain=None, *, with_gain: bool = False):
        state, y, gain = self.core.process(state, x, sidechain)
        if with_gain:
            return state, y, gain
        return state, y

    def calculate_output_level(self, input_magnitude):
        """Steady-state output level (`compressor.go:369`)."""
        mag = torch.abs(torch.as_tensor(input_magnitude))
        return mag * self.core.gain_for_level(mag) * self.core.makeup_gain_lin


class Limiter(Compressor):
    """Peak limiter: 100:1, 0.1 ms attack, hard knee (`limiter.go:11-43`)."""

    def __init__(self, sample_rate: float, *, threshold_db: float = -20.0,
                 release_ms: float = 100.0):
        super().__init__(sample_rate, threshold_db=threshold_db, ratio=100.0,
                         knee_db=0.0, attack_ms=0.1, release_ms=release_ms,
                         makeup_gain_db=0.0, auto_makeup=False)


class _ExpansionBase:
    """Shared machinery for downward expanders and gates."""

    def __init__(self, sample_rate: float, threshold_db: float, ratio: float,
                 knee_db: float, attack_ms: float, release_ms: float,
                 range_db: float, detector_mode: DetectorMode,
                 rms_window_ms: float):
        self.core = DynamicsCore(DynamicsConfig(
            sample_rate=sample_rate, threshold_db=threshold_db, ratio=ratio,
            knee_db=knee_db, attack_ms=attack_ms, release_ms=release_ms,
            detector_mode=detector_mode, rms_window_ms=rms_window_ms))
        self.range_db = range_db
        self.range_lin = 10.0 ** (range_db / 20.0)

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        return self.core.init_state(batch_shape, dtype, device)

    def _gain(self, level):
        c = self.core
        return downward_expansion_gain(
            level, c.threshold_log2, c.cfg.knee_db, c.knee_width_log2,
            c.inv_knee_width_log2, c.cfg.ratio, self.range_lin)


class Expander(_ExpansionBase):
    """Downward expander (`expander.go:66-120` defaults)."""

    def __init__(self, sample_rate: float, *, threshold_db: float = -40.0,
                 ratio: float = 2.0, knee_db: float = 6.0,
                 attack_ms: float = 5.0, release_ms: float = 50.0,
                 range_db: float = -60.0,
                 detector_mode: DetectorMode = DetectorMode.PEAK,
                 rms_window_ms: float = 30.0):
        super().__init__(sample_rate, threshold_db, ratio, knee_db,
                         attack_ms, release_ms, range_db, detector_mode,
                         rms_window_ms)

    def process(self, state, x, sidechain=None, *, with_gain: bool = False):
        sc = x if sidechain is None else sidechain
        state, level = self.core.detector(state, sc)
        gain = self._gain(level)
        y = x * gain
        if with_gain:
            return state, y, gain
        return state, y


def gate_hold(gain, hold0, hold_samples: int):
    """The gate's hold timer (`gate.go:360-367`) over a gain trajectory
    (..., T) with the carried counter hold0 (...,) int32.

    The reference walks it per sample: while g >= 1 the counter resets
    to H = hold_samples; otherwise unity gain is held while the counter
    is positive, and it counts down to 0. In closed form, with m_n the
    last index <= n where g >= 1 (one `torch.cummax`), sample n is held
    iff not g_n >= 1 (a NaN gain counts as below) and either
    H - (n - 1 - m_n) > 0 where such an m exists, or h0 - n > 0 where
    none does; the counter after T samples is max(H - (T - 1 - m), 0)
    with m the last reset, or max(h0 - T, 0) without one. Exact: only
    integer arithmetic and comparisons of the gain the reference makes.
    Returns (gated gain, counter (...,) int32)."""
    t = gain.shape[-1]
    if t == 0:
        return gain, hold0
    reset = gain >= 1.0
    idx = torch.arange(t, device=gain.device)
    last = torch.cummax(torch.where(reset, idx, -1), dim=-1).values
    h0 = hold0.to(torch.int64)[..., None]
    held = ~reset & torch.where(last >= 0, hold_samples - (idx - 1 - last) > 0,
                                h0 - idx > 0)
    gated = torch.where(held, torch.ones_like(gain), gain)
    m = last[..., -1]
    hold = torch.where(m >= 0, hold_samples - (t - 1 - m),
                       h0[..., 0] - t).clamp(min=0)
    return gated, hold.to(torch.int32)


class Gate(_ExpansionBase):
    """Soft-knee noise gate with hold (`gate.go:83-376`)."""

    def __init__(self, sample_rate: float, *, threshold_db: float = -40.0,
                 ratio: float = 10.0, knee_db: float = 6.0,
                 attack_ms: float = 0.1, hold_ms: float = 50.0,
                 release_ms: float = 100.0, range_db: float = -80.0,
                 detector_mode: DetectorMode = DetectorMode.PEAK,
                 rms_window_ms: float = 30.0):
        super().__init__(sample_rate, threshold_db, ratio, knee_db,
                         attack_ms, release_ms, range_db, detector_mode,
                         rms_window_ms)
        self.hold_samples = int(hold_ms * 1e-3 * sample_rate)

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        st = super().init_state(batch_shape, dtype, device)
        st["hold"] = torch.zeros(tuple(batch_shape), dtype=torch.int32,
                                 device=st["envelope"].device)
        return st

    def process(self, state, x, sidechain=None, *, with_gain: bool = False):
        sc = x if sidechain is None else sidechain
        state, level = self.core.detector(state, sc)
        gain, hold = gate_hold(self._gain(level), state["hold"],
                               self.hold_samples)
        state = dict(state)
        state["hold"] = hold
        y = x * gain
        if with_gain:
            return state, y, gain
        return state, y


class LookaheadLimiter:
    """Limiter with lookahead delay on the program path
    (`lookahead_limiter.go:23-36,185-210`): the detector runs
    lookahead_ms ahead of the delayed signal."""

    def __init__(self, sample_rate: float, *, lookahead_ms: float = 5.0,
                 threshold_db: float = -1.0, release_ms: float = 50.0):
        if lookahead_ms <= 0:
            raise ValueError("lookahead must be > 0 ms")
        self.delay = max(int(round(lookahead_ms * 1e-3 * sample_rate)), 1)
        self.comp = Limiter(sample_rate, threshold_db=threshold_db,
                            release_ms=release_ms)

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        core = self.comp.init_state(batch_shape, dtype, device)
        return {"core": core,
                "delay": torch.zeros(tuple(batch_shape) + (self.delay,),
                                     dtype=dtype,
                                     device=core["envelope"].device)}

    def process(self, state, x, sidechain=None):
        sc = x if sidechain is None else sidechain
        cstate, _, gain = self.comp.core.process(state["core"], sc)
        ext = torch.cat([state["delay"].to(x.dtype), x], dim=-1)
        n = x.shape[-1]
        y = ext[..., :n] * gain
        return {"core": cstate, "delay": ext[..., n:]}, y


class DeEsser:
    """Sibilance reducer (`deesser.go`): a band-limited detector drives a
    compressor whose gain is applied to the high band (split mode) or
    the whole signal (wideband)."""

    def __init__(self, sample_rate: float, *, freq_hz: float = 6000.0,
                 q: float = 1.5, threshold_db: float = -20.0,
                 ratio: float = 4.0, knee_db: float = 3.0,
                 attack_ms: float = 0.5, release_ms: float = 20.0,
                 range_db: float = -24.0, split_band: bool = True,
                 detect_bandpass: bool = True, listen: bool = False):
        self.split_band = split_band
        self.listen = listen
        self.range_lin = 10.0 ** (range_db / 20.0)
        design = bandpass if detect_bandpass else highpass
        self.detector_filter = BiquadChain(design(freq_hz, q, sample_rate))
        self.crossover = (Crossover(freq_hz, 4, sample_rate)
                          if split_band else None)
        self.core = DynamicsCore(DynamicsConfig(
            sample_rate=sample_rate, threshold_db=threshold_db, ratio=ratio,
            knee_db=knee_db, attack_ms=attack_ms, release_ms=release_ms))

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        st = {"core": self.core.init_state(batch_shape, dtype, device),
              "det": self.detector_filter.init_state(batch_shape, dtype,
                                                     device)}
        if self.crossover is not None:
            st["xo"] = self.crossover.init_state(batch_shape, dtype, device)
        return st

    def process(self, state, x):
        dstate, det = self.detector_filter.process_stream(state["det"], x)
        cstate, level = self.core.detector(state["core"], det)
        gain = torch.clamp(self.core.gain_for_level(level),
                           min=self.range_lin)
        new_state = {"core": cstate, "det": dstate}
        if self.crossover is not None:
            xstate, (lo, hi) = self.crossover.process_stream(state["xo"], x)
            new_state["xo"] = xstate
            y = hi * gain if self.listen else lo + hi * gain
        else:
            y = x * gain
        return new_state, y


class TransientShaper:
    """Attack/sustain shaper (`transient_shaper.go:139-188`).

    The reference's per-sample step is the branching one-pole
    env += coeff (s - env), coeff = a if s > env else r, on s = |x|:
    exactly the envelope kernel's recurrence (K4, release multiplier r).
    So the envelope runs on `envelope_scan`, and the step's
    delta = env_n - env_{n-1}, its norm and the gain are elementwise
    over the trajectory shifted by the carried env0."""

    def __init__(self, sample_rate: float, *, attack_amount: float = 0.0,
                 sustain_amount: float = 0.0, attack_ms: float = 1.0,
                 release_ms: float = 100.0):
        for v, name in [(attack_amount, "attack"), (sustain_amount, "sustain")]:
            if not (-1.0 <= v <= 1.0):
                raise ValueError(f"transient shaper {name} amount must be in "
                                 f"[-1,1]: {v}")
        self.attack_amount = attack_amount
        self.sustain_amount = sustain_amount
        self.attack_coeff = self._coeff(attack_ms, sample_rate)
        self.release_coeff = self._coeff(release_ms, sample_rate)

    @staticmethod
    def _coeff(ms: float, sr: float) -> float:
        sec = ms / 1000.0
        if sec <= 0:
            return 1.0
        return 1.0 - math.exp(-1.0 / (sec * sr))

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        return torch.zeros(tuple(batch_shape), dtype=dtype,
                           device=resolve_device(device))

    def process(self, state, x):
        env0 = torch.broadcast_to(state.to(x.dtype), x.shape[:-1])
        env_f, traj = envelope_scan(torch.abs(x), env0, self.attack_coeff,
                                    self.release_coeff)
        prev = torch.cat([env0[..., None], traj[..., :-1]], dim=-1)
        delta = traj - prev
        norm = torch.clamp(torch.abs(delta) / (prev + 1e-9), max=1.0)
        gain = 1.0 + torch.where(delta >= 0, self.attack_amount * norm,
                                 self.sustain_amount * norm)
        return env_f, x * torch.clamp(gain, min=0.0)


@dataclasses.dataclass(frozen=True)
class BandConfig:
    """Per-band compressor settings (`multiband.go:27-42`)."""
    threshold_db: float = -20.0
    ratio: float = 4.0
    knee_db: float = 6.0
    attack_ms: float = 10.0
    release_ms: float = 100.0
    makeup_gain_db: float = 0.0


class MultibandCompressor:
    """Crossover tree + per-band compressors (`multiband.go:92-160`)."""

    def __init__(self, freqs, order: int, sample_rate: float,
                 configs: list[BandConfig] | None = None):
        self.multiband = MultiBand(freqs, order, sample_rate)
        n_bands = self.multiband.num_bands
        if configs is None:
            configs = [BandConfig() for _ in range(n_bands)]
        if len(configs) != n_bands:
            raise ValueError(
                f"multiband: {len(configs)} configs for {n_bands} bands")
        self.bands = [Compressor(sample_rate,
                                 threshold_db=c.threshold_db, ratio=c.ratio,
                                 knee_db=c.knee_db, attack_ms=c.attack_ms,
                                 release_ms=c.release_ms,
                                 makeup_gain_db=c.makeup_gain_db)
                      for c in configs]

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        return {"xo": self.multiband.init_state(batch_shape, dtype, device),
                "bands": [b.init_state(batch_shape, dtype, device)
                          for b in self.bands]}

    def process(self, state, x):
        xo_state, band_signals = self.multiband.process_stream(state["xo"], x)
        new_band_states = []
        y = None
        for comp, bstate, sig in zip(self.bands, state["bands"], band_signals):
            bstate, out = comp.process(bstate, sig)
            new_band_states.append(bstate)
            y = out if y is None else y + out
        return {"xo": xo_state, "bands": new_band_states}, y
