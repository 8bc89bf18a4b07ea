"""Modulation effects (counterpart of
`algodsp_tpu/effects/modulation/modulation.py`).

Capability parity with `dsp/effects/modulation/`: Chorus (multi-voice
modulated delay, `chorus.go:136-165`), Flanger (modulated delay with
feedback, `flanger.go:259-282`), Phaser (allpass cascade + LFO +
feedback, `phaser.go:268-285,365-378`), Tremolo (LFO amplitude with
smoothing, `tremolo.go:201-294`), RingModulator
(`ring_modulator.go:143-153`), AutoWah (envelope-driven bandpass,
`auto_wah.go:315-334,455-482`) and FrequencyShifter (Bode SSB via the
polyphase Hilbert transformer, `frequency_shifter.go:78-210`).

The LFO trajectories are closed-form in the sample index and computed
up front in the input's type, as the reference computes them; the phase
state is one scalar shared by every channel. Then:
  * the Chorus reads its voices from the history-extended timeline by
    one gather (`delayline.walking_read`);
  * the Tremolo's smoothing one-pole is one explicit-state section
    (the cascade kernel K3 for float32 on the card, the blocked engine
    otherwise), the RingModulator and FrequencyShifter are elementwise
    work (the shifter's Hilbert pair on K3);
  * the Flanger's feedback loop is the CUDA kernel M1
    (`ops/feedback.flanger_feedback`);
  * the AutoWah's envelope is K4 and its time-varying DF2T the affine
    scan M3 (`ops/linrec.affine2_scan`);
  * the Phaser's cascade, reduced to an (S+1)-dimensional affine
    recurrence, is the scan M2 (`ops/linrec.affine_scan_nd`).
On the CPU every kernel runs its plain version.
"""

from __future__ import annotations

import math

import torch

from algodsp_tpu_torch._device import resolve_device
from algodsp_tpu_torch.delayline import DelayLine, fractional_read, walking_read
from algodsp_tpu_torch.effects.dynamics.core import DynamicsCore
from algodsp_tpu_torch.filters.hilbert import HilbertTransformer
from algodsp_tpu_torch.interp import Mode
from algodsp_tpu_torch.ops import feedback, linrec
from algodsp_tpu_torch.ops.envscan import envelope_scan

TWO_PI = 2.0 * math.pi


def _zero_phase(dtype, device):
    return torch.zeros((), dtype=dtype, device=resolve_device(device))


def _lfo_phases(state_phase, n, rate_hz, sample_rate, x):
    """Phase trajectory for n samples starting at state_phase; only the
    final phase is reduced mod 2 pi."""
    inc = TWO_PI * rate_hz / sample_rate
    idx = torch.arange(n, dtype=x.dtype, device=x.device)
    phases = state_phase + idx * inc
    final = torch.remainder(state_phase + n * inc, TWO_PI)
    return phases, final


def _lfo_unit(phases):
    return 0.5 * (1.0 + torch.sin(phases))


class Chorus:
    """Multi-voice chorus (`chorus.go:136-165`). Feedback-free: the voices
    read the history-extended timeline by one gather."""

    def __init__(self, sample_rate: float, *, speed_hz: float = 0.8,
                 depth_seconds: float = 0.004, base_delay_seconds: float = 0.02,
                 mix: float = 0.5, stages: int = 3):
        if sample_rate <= 0:
            raise ValueError("chorus: sample rate must be > 0")
        if stages < 1:
            raise ValueError("chorus: stages must be >= 1")
        self.sample_rate = sample_rate
        self.speed_hz = speed_hz
        self.depth = depth_seconds
        self.base_delay = base_delay_seconds
        self.mix = mix
        self.stages = stages
        max_delay = int(math.ceil((base_delay_seconds + depth_seconds)
                                  * sample_rate)) + 4
        self.delayline = DelayLine(max_delay, mode=Mode.HERMITE)

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        """History and LFO phase, on the CUDA card unless `device` says
        otherwise."""
        return {"buf": self.delayline.init_state(batch_shape, dtype, device),
                "phase": _zero_phase(dtype, device)}

    def process(self, state, x):
        n = x.shape[-1]
        phases, phase_f = _lfo_phases(state["phase"], n, self.speed_hz,
                                      self.sample_rate, x)
        base = self.base_delay * self.sample_rate
        depth = self.depth * self.sample_rate
        h = state["buf"].shape[-1]
        ext = torch.cat([state["buf"].to(x.dtype), x], dim=-1)
        drift = depth * TWO_PI * self.speed_hz / self.sample_rate
        off = torch.tensor([TWO_PI * i / self.stages for i in range(self.stages)],
                           dtype=x.dtype, device=x.device)
        delay = base + depth * _lfo_unit(phases + off[:, None])    # (stages, n)
        pos = h + torch.arange(n, dtype=x.dtype, device=x.device) - delay
        # every voice's taps in one gather: (..., stages, n)
        if base >= 4.0:                    # the Hermite stencil fits
            voices = walking_read(ext[..., None, :], pos, drift, Mode.HERMITE)
        else:
            voices = fractional_read(ext[..., None, :], pos, Mode.HERMITE)
        wet = voices[..., 0, :]
        for i in range(1, self.stages):
            wet = wet + voices[..., i, :]
        wet = wet / self.stages
        return ({"buf": ext[..., ext.shape[-1] - h:], "phase": phase_f},
                x * (1.0 - self.mix) + wet * self.mix)


class Tremolo:
    """LFO amplitude modulation with smoothing (`tremolo.go:201-294`).
    The smoothing one-pole's input trajectory is known, so it runs as one
    explicit-state section."""

    def __init__(self, sample_rate: float, *, rate_hz: float = 5.0,
                 depth: float = 0.5, mix: float = 1.0,
                 smoothing_ms: float = 0.0):
        if sample_rate <= 0:
            raise ValueError("tremolo: sample rate must be > 0")
        if not (0.0 <= depth <= 1.0):
            raise ValueError(f"tremolo depth must be in [0,1]: {depth}")
        self.sample_rate = sample_rate
        self.rate_hz = rate_hz
        self.depth = depth
        self.mix = mix
        if smoothing_ms <= 0:
            self.smoothing_coeff = 1.0
        else:
            tau = smoothing_ms / 1000.0
            self.smoothing_coeff = min(max(
                1.0 - math.exp(-1.0 / (tau * sample_rate)), 0.0), 1.0)

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        device = resolve_device(device)
        return {"phase": _zero_phase(dtype, device),
                "mod": torch.zeros(tuple(batch_shape), dtype=dtype, device=device)}

    def process(self, state, x):
        phases, phase_f = _lfo_phases(state["phase"], x.shape[-1], self.rate_hz,
                                      self.sample_rate, x)
        target = (1.0 - self.depth) + self.depth * _lfo_unit(phases)
        target = torch.broadcast_to(target, x.shape)
        if self.smoothing_coeff >= 1.0:
            mod = target
            mod_f = mod[..., -1]
        else:
            # s_n = (1 - c) s_{n-1} + c target_n from s_{-1} = mod
            mod_f, mod = DynamicsCore._one_pole_lp(
                state["mod"].to(x.dtype), target, self.smoothing_coeff)
        wet = x * mod
        return ({"phase": phase_f, "mod": mod_f},
                x * (1.0 - self.mix) + wet * self.mix)


class RingModulator:
    """Carrier multiplication (`ring_modulator.go:143-153`)."""

    def __init__(self, sample_rate: float, *, carrier_hz: float = 440.0,
                 mix: float = 1.0):
        if sample_rate <= 0:
            raise ValueError("ring modulator: sample rate must be > 0")
        self.sample_rate = sample_rate
        self.carrier_hz = carrier_hz
        self.mix = mix

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        return {"phase": _zero_phase(dtype, device)}

    def process(self, state, x):
        phases, phase_f = _lfo_phases(state["phase"], x.shape[-1],
                                      self.carrier_hz, self.sample_rate, x)
        wet = x * torch.sin(phases)
        return {"phase": phase_f}, x * (1.0 - self.mix) + wet * self.mix


class Flanger:
    """Modulated delay with feedback (`flanger.go:259-282`).

    The modulated lag never drops below base_delay (the LFO term is >=
    0), and its trajectory is closed-form and independent of the input;
    the loop runs through `ops/feedback.flanger_feedback` (M1 on the
    card, in place on the ring). The reference's form stays: whole
    `_block` blocks of B <= base_delay*sr - 2 samples on the linearised
    ring, then the per-sample scan for the tail, and the per-sample form
    for the whole call where base_delay is too short to block (under ~0.4
    ms at 48 kHz)."""

    def __init__(self, sample_rate: float, *, rate_hz: float = 0.25,
                 depth_seconds: float = 0.002, base_delay_seconds: float = 0.002,
                 feedback: float = 0.5, mix: float = 0.5):
        if sample_rate <= 0:
            raise ValueError("flanger: sample rate must be > 0")
        if not (-0.99 <= feedback <= 0.99):
            raise ValueError(f"flanger feedback must be in [-0.99, 0.99]: {feedback}")
        self.sample_rate = sample_rate
        self.rate_hz = rate_hz
        self.depth = depth_seconds
        self.base_delay = base_delay_seconds
        self.feedback = feedback
        self.mix = mix
        self.buf_len = int(math.ceil((base_delay_seconds + depth_seconds)
                                     * sample_rate)) + 4
        inc = TWO_PI * rate_hz / sample_rate
        min_d = max(base_delay_seconds * sample_rate, 1.0)
        B = int(min(128, math.floor(min_d) - 2))
        drift = depth_seconds * sample_rate * inc   # max |d lag/dt|
        while B > 16 and drift * B > 8.0:
            B //= 2
        self._block = B

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        """Ring, LFO phase and the int32 write counter, on the CUDA card
        unless `device` says otherwise."""
        device = resolve_device(device)
        return {"buf": torch.zeros(tuple(batch_shape) + (self.buf_len,),
                                   dtype=dtype, device=device),
                "phase": _zero_phase(dtype, device),
                "write": torch.zeros((), dtype=torch.int32, device=device)}

    def lags(self, phase0, n: int, x):
        """Closed-form modulated-lag trajectory (n,) in x's type and on its
        device (the reference's `_lags`: the phase reduced at every
        sample)."""
        inc = TWO_PI * self.rate_hz / self.sample_rate
        phases = torch.remainder(
            phase0 + inc * torch.arange(n, dtype=x.dtype, device=x.device),
            TWO_PI)
        return torch.clamp((self.base_delay + self.depth * _lfo_unit(phases))
                           * self.sample_rate, min=1.0)

    def process(self, state, x):
        """(state, x (..., N)) -> (state, y). On the card the state's ring
        is updated in place."""
        N = x.shape[-1]
        d = self.lags(state["phase"].to(x.dtype), N, x)
        inc = TWO_PI * self.rate_hz / self.sample_rate
        new_phase = torch.remainder(state["phase"] + inc * N, TWO_PI)
        buf, w, y = feedback.flanger_feedback(self, state["buf"], state["write"],
                                              x, d)
        return {"buf": buf, "phase": new_phase, "write": w}, y


class Phaser:
    """Allpass-cascade phaser with feedback (`phaser.go:268-285`).

    The S-stage allpass cascade and its feedback path are linear in the
    state and the input; only the allpass coefficient varies per sample,
    LFO-driven. One sample in, the stored state is redundant (x1_i' =
    y1_{i-1}', fb' = y1_{S-1}'), so each later sample is an (S+1)-dim
    affine map of u = [v_0..v_S], built in closed form and solved by the
    affine scan M2 (`ops/linrec.affine_scan_nd`); sample 0 is evaluated
    from the full user state, which keeps an inconsistent initial state
    exact. `process_scan` keeps the per-sample reference loop."""

    def __init__(self, sample_rate: float, *, rate_hz: float = 0.5,
                 min_freq_hz: float = 300.0, max_freq_hz: float = 1600.0,
                 stages: int = 4, feedback: float = 0.5, mix: float = 0.5):
        if sample_rate <= 0:
            raise ValueError("phaser: sample rate must be > 0")
        if not (1 <= stages <= 12):
            raise ValueError(f"phaser stages must be in [1, 12]: {stages}")
        if not (-0.99 <= feedback <= 0.99):
            raise ValueError(f"phaser feedback must be in [-0.99, 0.99]: {feedback}")
        self.sample_rate = sample_rate
        self.rate_hz = rate_hz
        self.min_freq = min_freq_hz
        self.max_freq = max_freq_hz
        self.stages = stages
        self.feedback = feedback
        self.mix = mix

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        device = resolve_device(device)
        zeros = lambda *shape: torch.zeros(tuple(batch_shape) + shape,
                                           dtype=dtype, device=device)
        return {"x1": zeros(self.stages), "y1": zeros(self.stages),
                "fb": zeros(), "phase": _zero_phase(dtype, device)}

    def _coeff(self, phases):
        freq = torch.clamp(self.min_freq + (self.max_freq - self.min_freq)
                           * _lfo_unit(phases), 1.0, 0.45 * self.sample_rate)
        g = torch.tan(math.pi * freq / self.sample_rate)
        return (g - 1.0) / (g + 1.0)

    def allpass_coeffs(self, phase0, n: int, x):
        """Per-sample first-order allpass coefficient trajectory (n,)."""
        inc = TWO_PI * self.rate_hz / self.sample_rate
        return self._coeff(torch.remainder(
            phase0 + inc * torch.arange(n, dtype=x.dtype, device=x.device),
            TWO_PI))

    def process(self, state, x):
        N = x.shape[-1]
        S = self.stages
        a = self.allpass_coeffs(state["phase"].to(x.dtype), N, x)   # (N,)
        inc = TWO_PI * self.rate_hz / self.sample_rate
        new_phase = torch.remainder(state["phase"] + inc * N, TWO_PI)

        # sample 0 from the full (possibly inconsistent) user state
        x0 = x[..., 0]
        a0 = a[0]
        v = x0 + state["fb"] * self.feedback
        vs = [v]
        for i in range(S):
            v = a0 * v + state["x1"][..., i] - a0 * state["y1"][..., i]
            vs.append(v)
        u0 = torch.stack(vs, dim=-1)                               # (..., S+1)
        y0 = x0 * (1.0 - self.mix) + vs[-1] * self.mix

        if N == 1:
            final = u0
            y_out = y0[..., None]
        else:
            # samples 1..N-1: v_0 = x + feedback u_S,
            # v_{i+1} = a v_i + u_i - a u_{i+1}; alpha_i holds the
            # coefficients of v_i over [u, x]
            dr = S + 1
            a1 = a[1:]                                             # (N-1,)
            alpha = torch.zeros((N - 1, dr + 1), dtype=x.dtype, device=x.device)
            alpha[:, dr] = 1.0
            alpha[:, S] = self.feedback
            alphas = [alpha]
            for i in range(S):
                nxt = a1[:, None] * alphas[-1]
                nxt[:, i] += 1.0
                nxt[:, i + 1] -= a1
                alphas.append(nxt)
            M = torch.stack(alphas, dim=1)                         # (N-1, dr, dr+1)
            A, b = M[..., :dr], M[..., dr]
            w = b * x[..., 1:, None]                               # (..., N-1, dr)
            after, final = linrec.affine_scan_nd(A, w, u0)
            y_out = torch.cat([y0[..., None], x[..., 1:] * (1.0 - self.mix)
                               + after[..., :, S] * self.mix], dim=-1)
        return ({"x1": final[..., :S], "y1": final[..., 1:],
                 "fb": final[..., S], "phase": new_phase}, y_out)

    def process_scan(self, state, x):
        """Per-sample reference loop (`phaser.go:268-285` order)."""
        inc = TWO_PI * self.rate_hz / self.sample_rate
        x1, y1, fb = state["x1"], state["y1"], state["fb"]
        phase = state["phase"].to(x.dtype)
        ys = []
        for k in range(x.shape[-1]):
            xv = x[..., k]
            a = self._coeff(phase)
            v = xv + fb * self.feedback
            new_x1, new_y1 = [], []
            for i in range(self.stages):
                yv = a * v + x1[..., i] - a * y1[..., i]
                new_x1.append(v)
                new_y1.append(yv)
                v = yv
            x1 = torch.stack(new_x1, dim=-1)
            y1 = torch.stack(new_y1, dim=-1)
            fb = v
            phase = torch.remainder(phase + inc, TWO_PI)
            ys.append(xv * (1.0 - self.mix) + v * self.mix)
        y = torch.stack(ys, dim=-1) if ys else x.clone()
        return {"x1": x1, "y1": y1, "fb": fb, "phase": phase}, y


class AutoWah:
    """Envelope-driven bandpass wah (`auto_wah.go:315-334,455-482`).

    The envelope runs on the branching envelope kernel (K4); the
    time-varying RBJ bandpass coefficients follow from it elementwise,
    and the filter runs as the time-varying affine scan M3
    (`ops/linrec.affine2_scan`)."""

    def __init__(self, sample_rate: float, *, min_freq_hz: float = 350.0,
                 max_freq_hz: float = 2500.0, q: float = 2.0,
                 sensitivity: float = 5.0, attack_ms: float = 5.0,
                 release_ms: float = 70.0, mix: float = 1.0):
        if sample_rate <= 0:
            raise ValueError("auto-wah: sample rate must be > 0")
        self.sample_rate = sample_rate
        self.min_freq = min_freq_hz
        self.max_freq = max_freq_hz
        self.q = q
        self.sensitivity = sensitivity
        self.mix = mix
        self.attack_coeff = 1.0 - math.exp(-1.0 / (attack_ms * 1e-3 * sample_rate))
        self.release_coeff = 1.0 - math.exp(-1.0 / (release_ms * 1e-3 * sample_rate))

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        device = resolve_device(device)
        zeros = lambda: torch.zeros(tuple(batch_shape), dtype=dtype, device=device)
        return {"env": zeros(), "z1": zeros(), "z2": zeros()}

    def process(self, state, x):
        env_f, env = envelope_scan(torch.abs(x), state["env"].to(x.dtype),
                                   self.attack_coeff, self.release_coeff)
        env_norm = torch.clamp(env * self.sensitivity, max=1.0)
        freq = torch.clamp(self.min_freq + env_norm * (self.max_freq - self.min_freq),
                           1.0, 0.49 * self.sample_rate)
        w0 = TWO_PI * freq / self.sample_rate
        sw, cw = torch.sin(w0), torch.cos(w0)
        alpha = sw / (2.0 * self.q)
        inv_a0 = 1.0 / (1.0 + alpha)
        b0 = alpha * inv_a0
        b2 = -alpha * inv_a0
        a1 = -2.0 * cw * inv_a0
        a2 = (1.0 - alpha) * inv_a0
        # DF2T with per-sample coefficients: with out = b0 x + z1 (b1 = 0),
        #   z1' = -a1 z1 + z2 - a1 b0 x
        #   z2' = -a2 z1      + (b2 - a2 b0) x
        A = torch.stack([-a1, torch.ones_like(a1), -a2, torch.zeros_like(a1)],
                        dim=-1)                                 # (..., N, 4)
        w = torch.stack([-a1 * b0 * x, (b2 - a2 * b0) * x], dim=-1)
        s0 = torch.stack([state["z1"], state["z2"]], dim=-1).to(x.dtype)
        entry, final = linrec.affine2_scan(A, w, s0)
        wet = b0 * x + entry[..., 0]
        y = x * (1.0 - self.mix) + wet * self.mix
        return {"env": env_f, "z1": final[..., 0], "z2": final[..., 1]}, y


class FrequencyShifter:
    """Bode-style SSB frequency shifter (`frequency_shifter.go:78-210`):
    the analytic signal from the Hilbert transformer (its two allpass
    chains on K3), multiplied by a quadrature carrier. Returns
    (upshift, downshift)."""

    def __init__(self, sample_rate: float, *, shift_hz: float = 100.0,
                 number_of_coeffs: int = 8, transition: float = 0.1):
        if sample_rate <= 0:
            raise ValueError("frequency shifter: sample rate must be > 0")
        self.sample_rate = sample_rate
        self.shift_hz = shift_hz
        self.hilbert = HilbertTransformer(number_of_coeffs, transition)

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        return {"phase": _zero_phase(dtype, device)}

    def process(self, state, x):
        a, b = self.hilbert.process(x)
        phases, phase_f = _lfo_phases(state["phase"], x.shape[-1],
                                      abs(self.shift_hz), self.sample_rate, x)
        c, s = torch.cos(phases), torch.sin(phases)
        up = a * c - b * s
        down = a * c + b * s
        if self.shift_hz < 0:
            up, down = down, up
        return {"phase": phase_f}, (up, down)
