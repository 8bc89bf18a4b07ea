"""Shared dynamics engine: detector + log2-domain soft-knee gain computer
(counterpart of `algodsp_tpu/effects/dynamics/core.py`).

Feed-forward dataflow:

  sidechain prefilter (one-pole sections on the biquad cascade) -> |x|
  -> RMS box filter (cumulative sum) -> envelope scan (the CUDA kernel
  of `ops/envscan.py`) -> gain computer (elementwise log2/exp2) ->
  multiply.

Feedback dataflow, where the detector reads the previous output
sample: one per-sample walk, the CUDA kernel D1 of `ops/dynfb.py`
(`csrc/dynamics.cu`), envelope, gain computer and output together.
"""

from __future__ import annotations

import dataclasses
import enum
import math

import torch

from algodsp_tpu_torch import _build
from algodsp_tpu_torch._device import resolve_device
from algodsp_tpu_torch.ops import dynfb, linrec
from algodsp_tpu_torch.ops.biquad_cascade import biquad_cascade
from algodsp_tpu_torch.ops.envscan import envelope_scan

LOG2_OF_10_DIV_20 = math.log2(10.0) / 20.0
_MIN_FEEDBACK_GAIN = 1e-9


class Topology(enum.Enum):
    FEEDFORWARD = "feedforward"
    FEEDBACK = "feedback"


class DetectorMode(enum.Enum):
    PEAK = "peak"
    RMS = "rms"


@dataclasses.dataclass(frozen=True)
class DynamicsConfig:
    sample_rate: float
    topology: Topology = Topology.FEEDFORWARD
    detector_mode: DetectorMode = DetectorMode.PEAK
    feedback_ratio_scale: bool = False
    threshold_db: float = -20.0
    ratio: float = 4.0
    knee_db: float = 6.0
    attack_ms: float = 10.0
    release_ms: float = 100.0
    rms_window_ms: float = 30.0
    auto_makeup: bool = False
    makeup_gain_db: float = 0.0
    sidechain_low_cut_hz: float = 0.0
    sidechain_high_cut_hz: float = 0.0

    def __post_init__(self):
        if self.sample_rate <= 0 or not math.isfinite(self.sample_rate):
            raise ValueError(f"dynamics: invalid sample rate {self.sample_rate}")
        if self.ratio < 1.0:
            raise ValueError(f"dynamics: ratio must be >= 1: {self.ratio}")
        if self.attack_ms <= 0 or self.release_ms <= 0:
            raise ValueError("dynamics: attack/release must be > 0")
        nyq = self.sample_rate / 2
        for hz, name in [(self.sidechain_low_cut_hz, "low-cut"),
                         (self.sidechain_high_cut_hz, "high-cut")]:
            if hz > 0 and not (1.0 <= hz < nyq):
                raise ValueError(f"dynamics: sidechain {name} out of range: {hz}")


def compression_gain(level, threshold_log2, knee_db, knee_width_log2,
                     inv_knee_width_log2, compression_factor):
    """Log2-domain soft-knee compression gain (`core.go:288-329`).

    Elementwise over level tensors; level <= 0 -> unity.
    """
    one = torch.ones_like(level)
    zero = torch.zeros_like(level)
    safe = torch.where(level > 0, level, one)
    overshoot = torch.log2(safe) - threshold_log2
    if knee_db <= 0:
        gain_log2 = torch.where(overshoot > 0, -overshoot * compression_factor,
                                zero)
    else:
        half = knee_width_log2 * 0.5
        scratch = overshoot + half
        knee_os = scratch * scratch * 0.5 * inv_knee_width_log2
        eff = torch.where(overshoot > half, overshoot,
                          torch.where(overshoot < -half, zero, knee_os))
        gain_log2 = -eff * compression_factor
    return torch.where(level > 0, torch.exp2(gain_log2), one)


def downward_expansion_gain(level, threshold_log2, knee_db, knee_width_log2,
                            inv_knee_width_log2, ratio, range_lin):
    """Downward expansion / gate gain (`expander.go:358-411`)."""
    one = torch.ones_like(level)
    zero = torch.zeros_like(level)
    safe = torch.where(level > 0, level, one)
    undershoot = threshold_log2 - torch.log2(safe)
    factor = ratio - 1.0
    if knee_db <= 0:
        gain_log2 = torch.where(undershoot > 0, -undershoot * factor, zero)
    else:
        half = knee_width_log2 * 0.5
        scratch = undershoot + half
        knee_us = scratch * scratch * 0.5 * inv_knee_width_log2
        eff = torch.where(undershoot > half, undershoot,
                          torch.where(undershoot < -half, zero, knee_us))
        gain_log2 = -eff * factor
    gain = torch.clamp(torch.exp2(gain_log2), min=range_lin)
    return torch.where(level > 0, gain, torch.full_like(level, range_lin))


def dynamics_env_scan(src, env0, attack_coeff, release_coeff, *,
                      unroll: int = 8):
    """The core envelope recurrence (`core.go:339-359`):
    rising: env += (src-env)*attack ; falling: env = src + (env-src)*release.

    The falling branch rewrites to env += (src-env)*(1-release), so it
    runs through the envelope kernel with release' = 1 - release —
    exactly the same recurrence. `unroll` is accepted for the
    reference's signature and ignored: it tunes the unrolling of the
    reference's `lax.scan`, and the envelope kernel has no unroll to tune.
    """
    return envelope_scan(src, env0, attack_coeff, 1.0 - release_coeff)


class DynamicsCore:
    """Functional dynamics engine used by the dynamics processors."""

    def __init__(self, cfg: DynamicsConfig):
        self.cfg = cfg
        sr = cfg.sample_rate
        self.attack_coeff = 1.0 - math.exp(-math.log(2.0) / (cfg.attack_ms * 1e-3 * sr))
        self.release_coeff = math.exp(-math.log(2.0) / (cfg.release_ms * 1e-3 * sr))
        if cfg.feedback_ratio_scale:
            self.fb_attack_coeff = 1.0 - math.exp(
                -math.log(2.0) / (cfg.attack_ms * 1e-3 * sr * cfg.ratio))
            self.fb_release_coeff = math.exp(
                -math.log(2.0) / (cfg.release_ms * 1e-3 * sr * cfg.ratio))
        else:
            self.fb_attack_coeff = self.attack_coeff
            self.fb_release_coeff = self.release_coeff
        self.threshold_log2 = cfg.threshold_db * LOG2_OF_10_DIV_20
        self.knee_width_log2 = cfg.knee_db * LOG2_OF_10_DIV_20
        self.inv_knee_width_log2 = (1.0 / self.knee_width_log2
                                    if cfg.knee_db > 0 else 0.0)
        if cfg.auto_makeup:
            self.makeup_gain_db = -cfg.threshold_db * (1.0 - 1.0 / cfg.ratio)
        else:
            self.makeup_gain_db = cfg.makeup_gain_db
        self.makeup_gain_lin = 10.0 ** (self.makeup_gain_db / 20.0)
        self.rms_window = max(int(round(cfg.rms_window_ms * 1e-3 * sr)), 1)
        # one-pole prefilter coefficients: state += c*(x - state)
        self.lp_coeff = (1.0 - math.exp(-2.0 * math.pi * cfg.sidechain_high_cut_hz / sr)
                         if cfg.sidechain_high_cut_hz > 0 else 0.0)
        self.hp_coeff = (1.0 - math.exp(-2.0 * math.pi * cfg.sidechain_low_cut_hz / sr)
                         if cfg.sidechain_low_cut_hz > 0 else 0.0)

    def init_state(self, batch_shape: tuple[int, ...] = (),
                   dtype=torch.float32, device=None):
        """State dict of (batch_shape) tensors, on the CUDA card unless
        `device` says otherwise."""
        device = resolve_device(device)
        zeros = lambda shape: torch.zeros(shape, dtype=dtype, device=device)
        batch_shape = tuple(batch_shape)
        st = {"envelope": zeros(batch_shape)}
        if self.cfg.detector_mode == DetectorMode.RMS:
            st["rms_hist"] = zeros(batch_shape + (self.rms_window - 1,))
        if self.lp_coeff > 0:
            st["lp"] = zeros(batch_shape)
        if self.hp_coeff > 0:
            st["hp_lp"] = zeros(batch_shape)
        if self.cfg.topology == Topology.FEEDBACK:
            st["prev_gain"] = torch.ones(batch_shape, dtype=dtype,
                                         device=device)
            st["prev_abs"] = zeros(batch_shape)
        return st

    @staticmethod
    def _one_pole_lp(state_val, x, coeff):
        """s_n = (1-c) s_{n-1} + c x_n, as the biquad section
        [c, 0, 0, -(1-c), 0] with carried y_{-1} = state. float32 on the
        card runs the cascade kernel; every other type and device runs
        the blocked engine, as the reference runs `linrec.ar2_apply_scan`
        in any type. So does float32 on the card when a gradient is
        wanted (grad mode on and x or the state requiring grad): the
        kernel's explicit-state call has no backward, and the blocked
        engine is plain PyTorch that autograd differentiates, as
        `jax.grad` does the reference's scan."""
        lead = x.shape[:-1]
        n = x.shape[-1]
        sos = [[coeff, 0.0, 0.0, -(1.0 - coeff), 0.0]]
        st = x.new_zeros(lead + (1, 4))
        st[..., 0, 2] = state_val
        if (x.device.type == "cuda" and x.dtype == torch.float32
                and not _build.wants_grad(x, state_val)):
            y, _ = biquad_cascade(x.reshape(-1, n).contiguous(), sos, 1.0,
                                  st.reshape(-1, 1, 4))
            y = y.reshape(lead + (n,))
        else:
            _, y = linrec.run_sections(x, sos, st, mode="blocked")
        return y[..., -1], y

    def _prefilter(self, state, x):
        """Sidechain detector prefilter (`core.go:600-662`)."""
        new_state = dict(state)
        y = x
        if self.lp_coeff > 0:
            last, y = self._one_pole_lp(state["lp"], y, self.lp_coeff)
            new_state["lp"] = last
        if self.hp_coeff > 0:
            last, lp_out = self._one_pole_lp(state["hp_lp"], y, self.hp_coeff)
            new_state["hp_lp"] = last
            y = y - lp_out
        return new_state, y

    def _rms(self, state, src):
        """Moving RMS over the window: the Go ring buffer
        (`core.go:361-388`) as a box FIR over [history, src^2]."""
        new_state = dict(state)
        if self.cfg.detector_mode != DetectorMode.RMS or self.rms_window <= 1:
            return new_state, src
        sq = src * src
        ext = torch.cat([state["rms_hist"].to(src.dtype), sq], dim=-1)
        w = self.rms_window
        csum = torch.cumsum(ext, dim=-1)
        csum = torch.cat([csum.new_zeros(ext.shape[:-1] + (1,)), csum], dim=-1)
        n = src.shape[-1]
        mean = (csum[..., w:w + n] - csum[..., :n]) / w
        new_state["rms_hist"] = ext[..., -(w - 1):]
        return new_state, torch.sqrt(torch.clamp(mean, min=0.0))

    def _ratio_scaled(self) -> bool:
        return (self.cfg.topology == Topology.FEEDBACK
                and self.cfg.feedback_ratio_scale)

    def _compression_factor(self) -> float:
        if self._ratio_scaled():
            return self.cfg.ratio - 1.0
        return 1.0 - 1.0 / self.cfg.ratio

    def gain_for_level(self, level):
        """Elementwise gain computer (`core.go:288-329`)."""
        cf = self._compression_factor()
        return compression_gain(level, self.threshold_log2, self.cfg.knee_db,
                                self.knee_width_log2, self.inv_knee_width_log2,
                                cf)

    def detector(self, state, sidechain):
        """Feed-forward detector chain: prefilter -> |.| -> RMS -> envelope.

        Returns (new_state, level trajectory)."""
        state, pre = self._prefilter(state, sidechain)
        src = torch.abs(pre)
        state, src = self._rms(state, src)
        a, r = self.attack_coeff, self.release_coeff
        if self._ratio_scaled():
            a, r = self.fb_attack_coeff, self.fb_release_coeff
        env_f, env = dynamics_env_scan(src, state["envelope"], a, r)
        state = dict(state)
        state["envelope"] = env_f
        return state, env

    def process(self, state, x, sidechain=None):
        """(state, x[, sidechain]) -> (state, y, gain).

        Feed-forward: the detector chain, then elementwise work.
        Feedback (`core.go:274-286`): the per-sample walk of D1, which
        reads the previous output and no sidechain, as the reference's
        scan does."""
        if self.cfg.topology == Topology.FEEDBACK:
            return self._process_feedback(state, x)
        sc = x if sidechain is None else sidechain
        state, level = self.detector(state, sc)
        gain = self.gain_for_level(level)
        y = x * gain * self.makeup_gain_lin
        return state, y, gain

    def feedback_params(self) -> dynfb.FeedbackParams:
        """The constants of the feedback walk (`ops/dynfb.py`)."""
        scaled = self._ratio_scaled()
        return dynfb.FeedbackParams(
            attack=self.fb_attack_coeff if scaled else self.attack_coeff,
            release=self.fb_release_coeff if scaled else self.release_coeff,
            threshold_log2=self.threshold_log2, knee_db=self.cfg.knee_db,
            knee_width_log2=self.knee_width_log2,
            inv_knee_width_log2=self.inv_knee_width_log2,
            compression_factor=self._compression_factor(),
            makeup=self.makeup_gain_lin)

    def _process_feedback(self, state, x):
        """Leading dims flatten onto D1's channel axis. The state's
        `prev_gain` is the last gain, floored at 1e-9; T = 0 leaves the
        state as it was."""
        lead, t = x.shape[:-1], x.shape[-1]
        flat = lambda v: torch.broadcast_to(v.to(x.dtype), lead).reshape(-1)
        y, gain, env_f, abs_f = dynfb.dynamics_feedback(
            x.reshape(lead.numel(), t).contiguous(),
            flat(state["envelope"]).contiguous(),
            flat(state["prev_abs"]).contiguous(), self.feedback_params())
        state = dict(state)
        if t:
            state["envelope"] = env_f.reshape(lead)
            state["prev_abs"] = abs_f.reshape(lead)
            state["prev_gain"] = torch.clamp(gain[:, -1],
                                             min=_MIN_FEEDBACK_GAIN).reshape(lead)
        return state, y.reshape(lead + (t,)), gain.reshape(lead + (t,))
