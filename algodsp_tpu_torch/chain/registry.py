"""Effect registry: node type -> runtime factory (counterpart of
`algodsp_tpu/chain/registry.py`).

Parameters use the reference's names, defaults, clamps and string enums
(`runtime_*.go` Configure methods via `chain/params.py`), so graph JSONs
written for the reference load unmodified. Filter nodes support the
full family x kind designer matrix like the webdemo's FilterDesigner
(`internal/webdemo/eq.go:91-302`), plus the Moog family with
order-derived oversampling.

The port registers the node types whose modules it has: the ten filter
keys (`filter-moog` included), `dyn-compressor` (feed-forward),
`reverb-conv`, `delay-simple` and `widener`. Every other type of the
JAX package's default registry raises KeyError saying that it is not
ported yet (ROADMAP.md lists them).

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
    moog_oversampling_from_order, normalize_dynamics_detector,
    normalize_dynamics_topology, normalize_filter_family,
    normalize_filter_kind)

FILTER_TYPES = ("filter", "filter-lowpass", "filter-highpass",
                "filter-bandpass", "filter-notch", "filter-allpass",
                "filter-peak", "filter-lowshelf", "filter-highshelf",
                "filter-moog")

# Types of the JAX package's default registry that wait for their
# modules, in the order ROADMAP.md ports them.
NOT_PORTED = (
    "dyn-limiter", "dyn-lookahead", "dyn-gate", "dyn-expander",
    "dyn-deesser", "dyn-transient", "dyn-multiband", "split-freq",
    "delay", "reverb", "reverb-freeverb", "reverb-fdn",
    "chorus", "flanger", "ringmod", "phaser", "tremolo",
    "bitcrusher", "distortion", "dist-cheb", "transformer", "bass",
    "spectral-freeze", "granular", "vocoder", "pitch-time",
    "pitch-spectral")


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


def _stateful(fx, *, sidechain: bool = False) -> NodeRuntime:
    if sidechain:
        def proc(st, x, sc):
            return fx.process(st, x, sc if sc is not None else x)
    else:
        def proc(st, x, sc):
            return fx.process(st, x)
    return NodeRuntime(init_state=fx.init_state, process=proc, effect=fx)


def default_registry() -> Registry:
    """The registry of the node types the port has (the ported part of
    `registry_defaults.go:48-300`)."""
    from algodsp_tpu_torch._device import resolve_device
    from algodsp_tpu_torch.effects.dynamics import (
        Compressor, DetectorMode, Topology)
    from algodsp_tpu_torch.effects.reverb import ConvolutionReverb
    from algodsp_tpu_torch.filters.biquad import BiquadChain
    from algodsp_tpu_torch.filters.moog import MoogFilter, MoogVariant

    r = Registry()

    # -- spatial / delay --------------------------------------------------
    def _widener(ctx, p):
        # chain blocks are mono: a mono signal has no side component, so
        # M/S widening reduces to identity; kept as a registered node for
        # graph compatibility (registry_defaults.go:104)
        return NodeRuntime(init_state=empty_state,
                           process=lambda st, x, sc: (st, x),
                           lti=("kernel_fn", lambda tol_db: np.ones(1)))
    r.register("widener", _widener)

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

    # -- reverbs (runtime_misc.go:19-44) ------------------------------------
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

    return r
