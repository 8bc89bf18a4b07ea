"""Effect registry: node type -> runtime factory (counterpart of
`algodsp_tpu/chain/registry.py`).

Parameters use the reference's names, defaults, clamps and string enums
(`runtime_*.go` Configure methods via `chain/params.py`), so graph JSONs
written for the reference load unmodified. Filter nodes support the
full family x kind designer matrix like the webdemo's FilterDesigner
(`internal/webdemo/eq.go:91-302`), plus the Moog family with
order-derived oversampling.

The port registers every node type of the JAX package's default
registry: the ten filter keys (`filter-moog` included), the dynamics
family (`dyn-compressor`, feed-forward or feedback, `dyn-limiter`,
`dyn-lookahead`, `dyn-gate`, `dyn-expander`, `dyn-deesser`,
`dyn-transient`, `dyn-multiband`), `split-freq` (two output ports: low,
high), `delay` (its integer-lag echo train as an LTI descriptor, so
`Chain.fuse_lti` folds it), the reverbs (`reverb`, switching on `model`,
`reverb-freeverb`, `reverb-fdn`, `reverb-conv`), `delay-simple`,
`widener`, the modulation family (`chorus`, `flanger`, `ringmod`,
`phaser`, `tremolo`), the waveshapers (`bitcrusher`, `distortion`,
`dist-cheb`, `transformer`, `bass`), `vocoder` (its carrier on port 1)
and the one-shot processors `pitch-time`, `pitch-spectral`,
`spectral-freeze` and `granular`, which keep no state and process each
call's signal as a whole (run them through `Chain.process` on whole
signals: `pitch-time` raises on a block shorter than its minimum
length, as the reference does). An unknown type raises KeyError.

Every runtime is a functional `NodeRuntime`: explicit state,
`process(state, x, sidechain) -> (state, y)`, and
`init_state(batch_shape, dtype, device)`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from algodsp_tpu_torch.chain.params import (
    FAMILY_MOOG, build_eq_sos, clamp, get_bool, get_int, get_num, get_str,
    moog_oversampling_from_order, normalize_chebyshev_harmonic_mode,
    normalize_deesser_detector, normalize_deesser_mode,
    normalize_distortion_mode, normalize_dynamics_detector,
    normalize_dynamics_topology, normalize_filter_family,
    normalize_filter_kind, normalize_freeze_phase_mode,
    normalize_transformer_quality)

FILTER_TYPES = ("filter", "filter-lowpass", "filter-highpass",
                "filter-bandpass", "filter-notch", "filter-allpass",
                "filter-peak", "filter-lowshelf", "filter-highshelf",
                "filter-moog")

# Types of the JAX package's default registry that wait for their
# modules: none are left.
NOT_PORTED = ()


@dataclasses.dataclass(frozen=True)
class Context:
    sample_rate: float
    block_size: int = 512


@dataclasses.dataclass
class NodeRuntime:
    init_state: Callable          # (batch_shape, dtype, device) -> state
    process: Callable             # (state, x, sidechain) -> (state, y)
    n_outputs: int = 1            # split-freq has 2 ports
    effect: object = None         # underlying effect object
    lti: object = None            # LTI descriptor for Chain.fuse_lti():
                                  # ("chain", BiquadChain) or
                                  # ("kernel_fn", tol_db -> f64 kernel);
                                  # None = not linear/time-invariant


class Registry:
    def __init__(self):
        self._factories: dict[str, Callable[[Context, dict], NodeRuntime]] = {}

    def register(self, type_name: str,
                 factory: Callable[[Context, dict], NodeRuntime]):
        if type_name in self._factories:
            raise ValueError(f"registry: duplicate type {type_name!r}")
        self._factories[type_name] = factory

    def lookup(self, type_name: str):
        if type_name in self._factories:
            return self._factories[type_name]
        if type_name in NOT_PORTED:
            raise KeyError(f"registry: effect type {type_name!r} is not "
                           "ported yet")
        raise KeyError(f"registry: unknown effect type {type_name!r}")

    def types(self):
        return sorted(self._factories)


def empty_state(batch_shape=(), dtype=torch.float32, device=None):
    """The state of a node that keeps none."""
    return {}


def _stateless(fn) -> NodeRuntime:
    """A one-shot processor fn(x) as a node that keeps no state."""
    return NodeRuntime(init_state=empty_state,
                       process=lambda st, x, sc: (st, fn(x)))


def _stateful(fx, *, sidechain: bool = False) -> NodeRuntime:
    if sidechain:
        def proc(st, x, sc):
            return fx.process(st, x, sc if sc is not None else x)
    else:
        def proc(st, x, sc):
            return fx.process(st, x)
    return NodeRuntime(init_state=fx.init_state, process=proc, effect=fx)


def default_registry() -> Registry:
    """The registry of every node type (`registry_defaults.go:48-300`)."""
    from algodsp_tpu_torch._device import resolve_device
    from algodsp_tpu_torch.effects.dynamics import (
        BandConfig, Compressor, DeEsser, DetectorMode, Expander, Gate,
        Limiter, LookaheadLimiter, MultibandCompressor, Topology,
        TransientShaper)
    from algodsp_tpu_torch.effects.delay_effect import Delay
    from algodsp_tpu_torch.effects.modulation import (Chorus, Flanger, Phaser,
                                                      RingModulator, Tremolo)
    from algodsp_tpu_torch.effects.pitch import (SpectralPitchShifter,
                                                 WSOLAPitchShifter)
    from algodsp_tpu_torch.effects.reverb import (ConvolutionReverb,
                                                  FDNReverb, Freeverb)
    from algodsp_tpu_torch.effects.spectral import (FreezePhaseMode, Granular,
                                                    SpectralFreeze)
    from algodsp_tpu_torch.effects.vocoder import Vocoder
    from algodsp_tpu_torch.effects.waveshape import (
        BitCrusher, Distortion, DistortionMode, HarmonicBass,
        TransformerQuality, TransformerSimulation)
    from algodsp_tpu_torch.filters.biquad import BiquadChain
    from algodsp_tpu_torch.filters.crossover import Crossover
    from algodsp_tpu_torch.filters.moog import MoogFilter, MoogVariant

    r = Registry()

    # -- modulation (runtime_modulation.go) -------------------------------
    r.register("chorus", lambda ctx, p: _stateful(Chorus(
        ctx.sample_rate,
        speed_hz=get_num(p, "speedHz", 0.35, 0.05, 5, aliases=("rateHz",)),
        depth_seconds=get_num(p, "depth", 0.003, 0, 0.01),
        base_delay_seconds=get_num(p, "baseDelay", 0.02, 0.001, 0.1),
        mix=get_num(p, "mix", 0.18, 0, 1),
        stages=get_int(p, "stages", 3, 1, 6))))
    r.register("flanger", lambda ctx, p: _stateful(Flanger(
        ctx.sample_rate,
        rate_hz=get_num(p, "rateHz", 0.25, 0.05, 5),
        base_delay_seconds=get_num(p, "baseDelay", 0.001, 0.0001, 0.01),
        depth_seconds=get_num(p, "depth", 0.0015, 0, 0.0099),
        feedback=get_num(p, "feedback", 0.25, -0.99, 0.99),
        mix=get_num(p, "mix", 0.5, 0, 1))))
    r.register("ringmod", lambda ctx, p: _stateful(RingModulator(
        ctx.sample_rate,
        carrier_hz=get_num(p, "carrierHz", 440, 1, ctx.sample_rate * 0.49,
                           aliases=("freqHz",)),
        mix=get_num(p, "mix", 1, 0, 1))))
    r.register("phaser", lambda ctx, p: _stateful(Phaser(
        ctx.sample_rate,
        min_freq_hz=get_num(p, "minFreqHz", 300, 20, ctx.sample_rate * 0.45),
        max_freq_hz=get_num(p, "maxFreqHz", 1600,
                            get_num(p, "minFreqHz", 300) + 1,
                            ctx.sample_rate * 0.49),
        stages=get_int(p, "stages", 6, 1, 12),
        rate_hz=get_num(p, "rateHz", 0.4, 0.05, 5),
        feedback=get_num(p, "feedback", 0.2, -0.99, 0.99),
        mix=get_num(p, "mix", 0.5, 0, 1))))
    r.register("tremolo", lambda ctx, p: _stateful(Tremolo(
        ctx.sample_rate,
        rate_hz=get_num(p, "rateHz", 4, 0.05, 20),
        depth=get_num(p, "depth", 0.6, 0, 1),
        smoothing_ms=get_num(p, "smoothingMs", 5, 0, 200),
        mix=get_num(p, "mix", 1, 0, 1))))

    # -- waveshaping (runtime_modulation.go:76-205) -----------------------
    r.register("bitcrusher", lambda ctx, p: _stateful(BitCrusher(
        ctx.sample_rate,
        bit_depth=get_num(p, "bitDepth", 8, 1, 32, aliases=("bits",)),
        downsample=get_int(p, "downsample", 4, 1, 256),
        mix=get_num(p, "mix", 1, 0, 1))))
    r.register("distortion", lambda ctx, p: _stateful(Distortion(
        mode=normalize_distortion_mode(get_str(p, "mode")),
        drive=get_num(p, "drive", 1.8, 0.01, 20),
        mix=get_num(p, "mix", 1.0, 0, 1),
        output_level=get_num(p, "output", 1.0, 0, 4),
        clip_level=get_num(p, "clip", 1.0, 0.05, 1),
        shape=get_num(p, "shape", 0.5, 0, 1),
        bias=get_num(p, "bias", 0, -1, 1))))

    def _dist_cheb(ctx, p):
        weights = [get_num(p, f"w{k}", 0.0) for k in range(1, 17)]
        if not any(weights):
            weights = None
        return _stateful(Distortion(
            mode=DistortionMode.CHEBYSHEV,
            drive=get_num(p, "drive", 1.0, 0.01, 20),
            mix=get_num(p, "mix", 1.0, 0, 1),
            output_level=get_num(p, "output", 1.0, 0, 4),
            chebyshev_order=get_int(p, "order", 3, 1, 16),
            chebyshev_mode=normalize_chebyshev_harmonic_mode(
                get_str(p, "harmonic")),
            chebyshev_gain=get_num(p, "gain", 1.0, 0, 4),
            chebyshev_invert=get_bool(p, "invert"),
            chebyshev_dc_bypass=get_bool(p, "dcBypass"),
            chebyshev_weights=weights))
    r.register("dist-cheb", _dist_cheb)
    r.register("transformer", lambda ctx, p: _stateful(TransformerSimulation(
        ctx.sample_rate,
        quality=(TransformerQuality.LIGHTWEIGHT
                 if normalize_transformer_quality(get_str(p, "quality"))
                 == "lightweight" else TransformerQuality.HIGH),
        drive=get_num(p, "drive", 2.0, 0.1, 30),
        mix=get_num(p, "mix", 1.0, 0, 1),
        output_level=get_num(p, "output", 1.0, 0, 4),
        highpass_hz=get_num(p, "highpassHz", 25, 5, ctx.sample_rate * 0.45),
        damping_hz=get_num(p, "dampingHz", 9000, 200, ctx.sample_rate * 0.49),
        oversampling=get_int(p, "oversampling", 4, 1, 8))))
    r.register("bass", lambda ctx, p: _stateful(HarmonicBass(
        ctx.sample_rate,
        frequency=get_num(p, "frequency", 80, 10, 500, aliases=("freqHz",)),
        input_level=get_num(p, "inputGain", 1, 0, 2),
        high_frequency_gain=get_num(p, "highGain", 1, 0, 2),
        original_bass_gain=get_num(p, "original", 1, 0, 2),
        harmonic_bass_gain=get_num(p, "harmonic", 0, 0, 2,
                                   aliases=("gain",)),
        decay=get_num(p, "decay", 0, -1, 1),
        response_ms=get_num(p, "responseMs", 20, 1, 200))))

    # -- spatial / delay --------------------------------------------------
    def _widener(ctx, p):
        # chain blocks are mono: a mono signal has no side component, so
        # M/S widening reduces to identity; kept as a registered node for
        # graph compatibility (registry_defaults.go:104)
        return NodeRuntime(init_state=empty_state,
                           process=lambda st, x, sc: (st, x),
                           lti=("kernel_fn", lambda tol_db: np.ones(1)))
    r.register("widener", _widener)

    def _feedback_delay_kernel(delay: int, fb: float, mix: float):
        """IR of the integer-lag feedback delay:
        (1-mix)*d[0] + mix * sum_{k>=1} fb^(k-1) * d[n - k*delay]."""
        def kernel(tol_db: float) -> np.ndarray:
            if mix == 0.0:
                return np.ones(1)
            if fb == 0.0:
                echoes = 1
            else:
                echoes = 1 + int(np.ceil(tol_db / (-20.0 * np.log10(fb))))
            h = np.zeros(echoes * delay + 1)
            h[0] = 1.0 - mix
            h[np.arange(1, echoes + 1) * delay] = mix * fb ** np.arange(echoes)
            return h
        return kernel

    def _delay(ctx, p):
        fx = Delay(ctx.sample_rate,
                   delay_seconds=get_num(p, "time", 0.25, 0.001, 2),
                   feedback=get_num(p, "feedback", 0.35, 0, 0.99),
                   mix=get_num(p, "mix", 0.25, 0, 1))
        rt = _stateful(fx)
        # constant integer lag (round(time*sr), no mid-stream retarget)
        # makes the feedback loop a pure echo train
        rt.lti = ("kernel_fn", _feedback_delay_kernel(
            fx.delay_samples, fx.feedback, fx.mix))
        return rt
    r.register("delay", _delay)

    def _delay_simple(ctx, p):
        # runtime_modulation.go:332: delayMs 20 (0-500)
        if "delayMs" in p or "time" not in p:
            seconds = get_num(p, "delayMs", 20, 0, 500) * 1e-3
        else:
            seconds = get_num(p, "time", 0.02, 0, 0.5)
        delay = max(int(seconds * ctx.sample_rate), 1)

        def init_state(batch_shape=(), dtype=torch.float32, device=None):
            return torch.zeros(tuple(batch_shape) + (delay,), dtype=dtype,
                               device=resolve_device(device))

        def proc(st, x, sc):
            ext = torch.cat([st.to(x.dtype), x], dim=-1)
            return ext[..., -delay:], ext[..., :x.shape[-1]]

        def _unit_delay_kernel(tol_db, _d=delay):
            h = np.zeros(_d + 1)
            h[_d] = 1.0
            return h
        return NodeRuntime(init_state=init_state, process=proc,
                           lti=("kernel_fn", _unit_delay_kernel))
    r.register("delay-simple", _delay_simple)

    # -- filters (runtime_filter_pitch_reverb.go:42-180) ------------------
    def _filter_factory(node_type):
        def make(ctx, p):
            family = normalize_filter_family(get_str(p, "family"), node_type)
            kind = normalize_filter_kind(node_type, get_str(p, "kind"))
            freq = get_num(p, "freq", 1200, 20, ctx.sample_rate * 0.49,
                           aliases=("freqHz",))
            gain_db = get_num(p, "gain", 0, -24, 24)
            # the [0.2, 8] pre-clamp is reference parity: the Go runtime
            # also clamps q before ClampShape reinterprets it
            # (runtime_filter_pitch_reverb.go:48,131)
            shape = get_num(p, "q", 0.707, 0.2, 8)
            if family == FAMILY_MOOG:
                order = get_int(p, "order", 8, 1, 16)
                fx = MoogFilter(
                    ctx.sample_rate, variant=MoogVariant.HUOVILAINEN,
                    oversampling=moog_oversampling_from_order(order),
                    cutoff_hz=freq, resonance=clamp(shape, 0, 4),
                    drive=clamp(10.0 ** (gain_db / 20.0), 0.1, 24),
                    normalize_output=True)
                return _stateful(fx)
            sos, lin_gain = build_eq_sos(
                family, kind, get_int(p, "order", 2, 0, 24), freq,
                gain_db, shape, ctx.sample_rate)
            chain = BiquadChain(sos, gain=lin_gain)
            return NodeRuntime(
                init_state=chain.init_state,
                process=lambda st, x, sc: chain.process_stream(st, x),
                effect=chain, lti=("chain", chain))
        return make

    for key in FILTER_TYPES:
        r.register(key, _filter_factory(key))

    # -- pitch / spectral (one-shot processors wrapped stateless) ---------
    r.register("pitch-time", lambda ctx, p: _stateless(
        WSOLAPitchShifter(
            ctx.sample_rate,
            pitch_ratio=2.0 ** (get_num(p, "semitones", 0, -24, 24) / 12.0),
            sequence_ms=get_num(p, "sequence", 40, 20, 120),
            overlap_ms=get_num(p, "overlap", 10, 4, 60),
            seek_window_ms=get_num(p, "search", 15, 2, 40)).process))

    def _frame_and_hop(p, default_frame):
        frame = get_int(p, "frameSize", default_frame, 64, 8192)
        if frame & (frame - 1):
            frame = 1 << int(np.ceil(np.log2(frame)))
        hop = max(int(round(frame * get_num(p, "hopRatio", 0.25,
                                            0.01, 0.99))), 1)
        return frame, hop

    def _pitch_spectral(ctx, p):
        frame, hop = _frame_and_hop(p, 1024)
        return _stateless(SpectralPitchShifter(
            ctx.sample_rate,
            pitch_ratio=2.0 ** (get_num(p, "semitones", 0, -24, 24) / 12.0),
            frame_size=frame, analysis_hop=hop).process)
    r.register("pitch-spectral", _pitch_spectral)

    def _freeze(ctx, p):
        frame, hop = _frame_and_hop(p, 2048)
        return _stateless(SpectralFreeze(
            ctx.sample_rate, frame_size=frame, hop_size=hop,
            frozen=get_bool(p, "frozen", 1.0),
            mix=get_num(p, "mix", 1, 0, 1),
            phase_mode=(FreezePhaseMode.HOLD
                        if normalize_freeze_phase_mode(
                            get_str(p, "phaseMode")) == "hold"
                        else FreezePhaseMode.ADVANCE)).process)
    r.register("spectral-freeze", _freeze)

    def _granular(ctx, p):
        pitch = get_num(p, "pitch", 1, 0.25, 4)
        if "pitch" not in p and "semitones" in p:
            pitch = clamp(2.0 ** (get_num(p, "semitones", 0) / 12.0), 0.25, 4)
        return _stateless(Granular(
            ctx.sample_rate,
            grain_seconds=get_num(p, "grainSeconds", 0.08, 0.005, 0.5,
                                  aliases=("grain",)),
            overlap=get_num(p, "overlap", 0.5, 0, 0.95),
            pitch=pitch,
            spray_seconds=get_num(p, "spray", 0.1, 0, 1),
            mix=get_num(p, "mix", 1, 0, 1)).process)
    r.register("granular", _granular)

    # -- reverbs (runtime_filter_pitch_reverb.go:325-380, runtime_misc.go) --
    def _freeverb(ctx, p):
        return _stateful(Freeverb(
            wet=get_num(p, "wet", 0.22, 0, 1.5),
            dry=get_num(p, "dry", 1, 0, 1.5),
            room_size=get_num(p, "roomSize", 0.72, 0, 0.98),
            damp=get_num(p, "damp", 0.45, 0, 0.99),
            input_gain=get_num(p, "gain", 0.015, 0, 0.1)))

    def _fdn(ctx, p):
        return _stateful(FDNReverb(
            ctx.sample_rate,
            wet=get_num(p, "wet", 0.22, 0, 1.5),
            dry=get_num(p, "dry", 1, 0, 1.5),
            rt60_seconds=get_num(p, "rt60", 1.8, 0.2, 8),
            pre_delay_seconds=get_num(p, "preDelay", 0.01, 0, 0.1),
            damp=get_num(p, "damp", 0.45, 0, 0.99),
            mod_depth_seconds=get_num(p, "modDepth", 0.002, 0, 0.01),
            mod_rate_hz=get_num(p, "modRate", 0.1, 0, 1)))

    def _reverb(ctx, p):
        # "reverb" switches on the model string (`runtime:380`)
        if get_str(p, "model").strip().lower() == "fdn":
            return _fdn(ctx, p)
        return _freeverb(ctx, p)
    r.register("reverb", _reverb)
    r.register("reverb-freeverb", _freeverb)
    r.register("reverb-fdn", _fdn)

    def _reverb_conv(ctx, p):
        # IR library lookup by index (`runtime_misc.go:19-40`), with the
        # round-1 synthetic-IR params kept as a fallback
        wet = get_num(p, "wet", 0.35, 0, 1.5)
        if "irSeconds" in p or "seed" in p:
            ir_len = max(int(get_num(p, "irSeconds", 0.5, 0.01, 10)
                             * ctx.sample_rate), 256)
            rng = np.random.default_rng(int(get_num(p, "seed", 7)))
            ir = (rng.standard_normal(ir_len)
                  * np.exp(-np.arange(ir_len) / max(0.1 * ctx.sample_rate, 1.0)))
        else:
            from algodsp_tpu_torch.utils.irlib import builtin_irs
            irs = builtin_irs(ctx.sample_rate)
            names = sorted(irs)
            name = get_str(p, "irName", "", aliases=("ir",))
            if name in irs:
                idx = names.index(name)
            else:
                idx = get_int(p, "irIndex", 0, 0, len(names) - 1)
            _, ir = irs[names[idx]]
            ir = np.asarray(ir, dtype=np.float64)
            if ir.ndim > 1:  # downmix like runtime_misc.go:36-44
                ir = ir.mean(axis=0)
        fx = ConvolutionReverb(ir, min_block_order=9, wet=wet,
                               dry=get_num(p, "dry", 1.0, 0, 1.5))
        rt = _stateful(fx)

        def _conv_kernel(tol_db, _fx=fx):
            h = _fx.wet * np.asarray(_fx.engine.kernel, np.float64)
            if h.size == 0:
                h = np.zeros(1)
            h = h.copy()
            h[0] += _fx.dry
            return h
        rt.lti = ("kernel_fn", _conv_kernel)
        return rt
    r.register("reverb-conv", _reverb_conv)

    # -- dynamics (runtime_dynamics.go) -----------------------------------
    r.register("dyn-compressor", lambda ctx, p: _stateful(Compressor(
        ctx.sample_rate,
        threshold_db=get_num(p, "thresholdDB", -20, -60, 0),
        ratio=get_num(p, "ratio", 4, 1, 100),
        knee_db=get_num(p, "kneeDB", 6, 0, 24),
        attack_ms=get_num(p, "attackMs", 10, 0.1, 1000),
        release_ms=get_num(p, "releaseMs", 100, 1, 5000),
        makeup_gain_db=get_num(p, "makeupGainDB", 0, 0, 24),
        auto_makeup=get_bool(p, "autoMakeup"),
        topology=(Topology.FEEDBACK
                  if normalize_dynamics_topology(get_str(p, "topology"))
                  == "feedback" else Topology.FEEDFORWARD),
        detector_mode=(DetectorMode.RMS
                       if normalize_dynamics_detector(get_str(p, "detector"))
                       == "rms" else DetectorMode.PEAK),
        rms_window_ms=get_num(p, "rmsWindowMs", 30, 1, 1000)),
        sidechain=True))
    r.register("dyn-limiter", lambda ctx, p: _stateful(Limiter(
        ctx.sample_rate,
        threshold_db=get_num(p, "thresholdDB", -0.1, -24, 0),
        release_ms=get_num(p, "releaseMs", 100, 1, 5000)), sidechain=True))
    r.register("dyn-lookahead", lambda ctx, p: _stateful(LookaheadLimiter(
        ctx.sample_rate,
        threshold_db=get_num(p, "thresholdDB", -1, -24, 0),
        release_ms=get_num(p, "releaseMs", 100, 1, 5000),
        lookahead_ms=max(get_num(p, "lookaheadMs", 3, 0, 200), 0.05)),
        sidechain=True))
    r.register("dyn-gate", lambda ctx, p: _stateful(Gate(
        ctx.sample_rate,
        threshold_db=get_num(p, "thresholdDB", -40, -80, 0),
        ratio=get_num(p, "ratio", 10, 1, 100),
        knee_db=get_num(p, "kneeDB", 6, 0, 24),
        attack_ms=get_num(p, "attackMs", 0.1, 0.1, 1000),
        hold_ms=get_num(p, "holdMs", 50, 0, 5000),
        release_ms=get_num(p, "releaseMs", 100, 1, 5000),
        range_db=get_num(p, "rangeDB", -80, -120, 0)), sidechain=True))
    r.register("dyn-expander", lambda ctx, p: _stateful(Expander(
        ctx.sample_rate,
        threshold_db=get_num(p, "thresholdDB", -35, -80, 0),
        ratio=get_num(p, "ratio", 2, 1, 100),
        knee_db=get_num(p, "kneeDB", 6, 0, 24),
        attack_ms=get_num(p, "attackMs", 1, 0.1, 1000),
        release_ms=get_num(p, "releaseMs", 100, 1, 5000),
        range_db=get_num(p, "rangeDB", -60, -120, 0)), sidechain=True))
    r.register("dyn-deesser", lambda ctx, p: _stateful(DeEsser(
        ctx.sample_rate,
        freq_hz=get_num(p, "freqHz", 6000, 1000, ctx.sample_rate * 0.49),
        q=get_num(p, "q", 1.5, 0.1, 10),
        threshold_db=get_num(p, "thresholdDB", -20, -80, 0),
        ratio=get_num(p, "ratio", 4, 1, 100),
        knee_db=get_num(p, "kneeDB", 3, 0, 12),
        attack_ms=get_num(p, "attackMs", 0.5, 0.01, 50),
        release_ms=get_num(p, "releaseMs", 20, 1, 500),
        range_db=get_num(p, "rangeDB", -24, -60, 0),
        split_band=normalize_deesser_mode(get_str(p, "mode")) == "splitband",
        detect_bandpass=normalize_deesser_detector(
            get_str(p, "detector")) == "bandpass",
        listen=get_bool(p, "listen"))))
    r.register("dyn-transient", lambda ctx, p: _stateful(TransientShaper(
        ctx.sample_rate,
        attack_amount=get_num(p, "attack", 0, -1, 1),
        sustain_amount=get_num(p, "sustain", 0, -1, 1),
        attack_ms=get_num(p, "attackMs", 10, 0.1, 200),
        release_ms=get_num(p, "releaseMs", 120, 1, 2000))))

    def _multiband(ctx, p):
        # runtime_dynamics.go:364-437
        bands = get_int(p, "bands", 3, 2, 3)
        order = get_int(p, "order", 4, 2, 24)
        if order % 2:
            order += 1
        c1 = get_num(p, "cross1Hz", 250, 40, ctx.sample_rate * 0.2)
        freqs = [c1]
        if bands == 3:
            freqs.append(get_num(p, "cross2Hz", 3000, c1 + 100,
                                 ctx.sample_rate * 0.45))
        shared = dict(knee_db=get_num(p, "kneeDB", 6, 0, 24),
                      attack_ms=get_num(p, "attackMs", 8, 0.1, 1000),
                      release_ms=get_num(p, "releaseMs", 120, 1, 5000),
                      makeup_gain_db=get_num(p, "makeupGainDB", 0, 0, 24))
        cfg = [BandConfig(
                   threshold_db=get_num(p, "lowThresholdDB", -20, -80, 0),
                   ratio=get_num(p, "lowRatio", 2.5, 1, 20), **shared),
               BandConfig(
                   threshold_db=get_num(p, "midThresholdDB", -18, -80, 0),
                   ratio=get_num(p, "midRatio", 3.0, 1, 20), **shared)]
        if bands == 3:
            cfg.append(BandConfig(
                threshold_db=get_num(p, "highThresholdDB", -14, -80, 0),
                ratio=get_num(p, "highRatio", 4.0, 1, 20), **shared))
        return _stateful(MultibandCompressor(freqs, order, ctx.sample_rate,
                                             configs=cfg))
    r.register("dyn-multiband", _multiband)

    # -- vocoder (sidechain = carrier; runtime_misc.go:80-100) ------------
    r.register("vocoder", lambda ctx, p: _stateful(Vocoder(
        ctx.sample_rate,
        attack_ms=get_num(p, "attackMs", 0.5, 0.01, 100),
        release_ms=get_num(p, "releaseMs", 2.0, 0.01, 1000),
        input_level=get_num(p, "inputLevel", 0, 0, 10),
        synth_level=get_num(p, "synthLevel", 0, 0, 10),
        vocoded_level=get_num(p, "vocoderLevel", 1, 0, 10)), sidechain=True))

    # -- split-freq (2 output ports: lo, hi) ------------------------------
    def _split_freq(ctx, p):
        xo = Crossover(get_num(p, "freqHz", 1000, 20, ctx.sample_rate * 0.49,
                               aliases=("freq",)),
                       get_int(p, "order", 4, 2, 8), ctx.sample_rate)
        return NodeRuntime(init_state=xo.init_state,
                           process=lambda st, x, sc: xo.process_stream(st, x),
                           n_outputs=2, effect=xo)
    r.register("split-freq", _split_freq)

    return r
