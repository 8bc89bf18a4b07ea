"""Nonlinear Moog ladder filter, 6 variants (counterpart of
`algodsp_tpu/filters/moog.py`).

Classic (exact tanh), ClassicLightweight (rational tanh),
ImprovedClassic(+Lightweight) (stage coefficient scaled by 2*Vt),
Huovilainen (cutoff/resonance polynomial compensation, half-sample
feedback, optional oversampling) and ZDF (Zavalishin TPT with
fixed-iteration Newton-Raphson). Coefficients are derived on the host
as in the reference (`moog.go:800-853`).

The ladder is a per-sample nonlinear feedback recurrence. On the card
every call runs one of the two CUDA kernels of `ops/moog.py` (K5 for the
classic family and Huovilainen, K6 for ZDF) over all of its samples;
CPU tensors run their plain per-sample versions. `process` is
differentiable in x and in the dict state (`MoogLadderFn`, `MoogZDFFn`:
the reference's custom VJP; its backward runs the adjoint kernels on the
card), also across blocks with the state carried between them.
"""

from __future__ import annotations

import enum
import math

import torch

from algodsp_tpu_torch._device import resolve_device
from algodsp_tpu_torch.ops import moog as moog_ops

STATE_LIMIT = moog_ops.STATE_LIMIT


class MoogVariant(enum.Enum):
    CLASSIC = "classic"
    CLASSIC_LIGHTWEIGHT = "classic_lightweight"
    IMPROVED_CLASSIC = "improved_classic"
    IMPROVED_CLASSIC_LIGHTWEIGHT = "improved_classic_lightweight"
    HUOVILAINEN = "huovilainen"
    ZDF = "zdf"


_IMPROVED = (MoogVariant.IMPROVED_CLASSIC,
             MoogVariant.IMPROVED_CLASSIC_LIGHTWEIGHT)
_LIGHTWEIGHT = (MoogVariant.CLASSIC_LIGHTWEIGHT,
                MoogVariant.IMPROVED_CLASSIC_LIGHTWEIGHT)


class MoogFilter:
    def __init__(self, sample_rate: float, *,
                 variant: MoogVariant = MoogVariant.CLASSIC,
                 cutoff_hz: float = 1000.0, resonance: float = 0.8,
                 drive: float = 1.0, input_gain: float = 1.0,
                 output_gain: float = 1.0, thermal_voltage: float = 5.0,
                 oversampling: int = 1, newton_iters: int = 4,
                 normalize_output: bool = False):
        if sample_rate <= 0:
            raise ValueError("moog: sample rate must be > 0")
        if not (1.0 <= cutoff_hz < sample_rate / 2):
            raise ValueError(f"moog: cutoff must be in [1, Nyquist): {cutoff_hz}")
        if not (0.0 <= resonance <= 4.0):
            raise ValueError(f"moog: resonance must be in [0, 4]: {resonance}")
        if not (0.1 <= drive <= 24.0):
            raise ValueError(f"moog: drive must be in [0.1, 24]: {drive}")
        if not (1 <= newton_iters <= 8):
            raise ValueError(f"moog: newton iters must be in [1, 8]: {newton_iters}")
        if oversampling < 1:
            raise ValueError("moog: oversampling must be >= 1")
        self.sample_rate = sample_rate
        self.variant = variant
        self.cutoff_hz = cutoff_hz
        self.resonance = resonance
        self.drive = drive
        self.input_gain = input_gain
        self.output_gain = output_gain
        self.thermal_voltage = thermal_voltage
        self.oversampling = oversampling
        self.newton_iters = newton_iters
        self.normalize_output = normalize_output
        self._rebuild()

    def _rebuild(self):
        """Coefficient derivation (`moog.go:800-853`)."""
        eff_sr = self.sample_rate * self.oversampling
        fc = self.cutoff_hz / eff_sr
        vt = self.thermal_voltage
        self.drive_scale = 0.5 * self.drive / vt
        self.feedback = self.resonance
        self.coefficient = 2 * vt * (1 - math.exp(-2 * math.pi * fc))
        if self.variant == MoogVariant.HUOVILAINEN:
            fcr = max(1.8730 * fc ** 3 + 0.4955 * fc * fc - 0.6490 * fc + 0.9988, 0.0)
            self.coefficient = 2 * vt * (1 - math.exp(-2 * math.pi * fcr * fc))
            comp = max(-3.9364 * fc * fc + 1.8409 * fc + 0.9968, 0.0)
            self.feedback = self.resonance * comp
        elif self.variant == MoogVariant.ZDF:
            self.zdf_g = math.tan(math.pi * fc)
            self.zdf_gk = self.zdf_g / (1 + self.zdf_g)
        legacy = 10.0 ** (self.resonance / 20.0)
        norm = 1.0 / (1 + 0.5 * self.resonance) if self.normalize_output else 1.0
        self.output_scale = self.output_gain * legacy * legacy * norm

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        """Zero state, on the CUDA card unless `device` says otherwise."""
        device = resolve_device(device)
        batch_shape = tuple(batch_shape)
        zeros = lambda shape: torch.zeros(shape, dtype=dtype, device=device)
        return {"stage": zeros(batch_shape + (4,)),
                "tanh_last": zeros(batch_shape + (3,)),
                "prev_out": zeros(batch_shape)}

    def kernel_params(self) -> list[float]:
        """The five kernel parameters (`moog.py:215-222`); the improved
        variants get coefficient * 2 Vt here, on the host."""
        if self.variant == MoogVariant.ZDF:
            return [self.zdf_gk, self.drive_scale, self.feedback,
                    self.input_gain, self.output_scale]
        coef = self.coefficient * (2 * self.thermal_voltage
                                   if self.variant in _IMPROVED else 1.0)
        return [coef, self.drive_scale, self.feedback, self.input_gain,
                self.output_scale]

    def _run(self, state, x_run, os: int = 1):
        """The ladder over x_run (..., T) at oversampling `os` from the
        dict state. The state rows are stacked and broadcast onto the
        channel axis differentiably, so the gradient of state8 reaches the
        dict (summed over a broadcast)."""
        lead, t = x_run.shape[:-1], x_run.shape[-1]
        xf = x_run.reshape(-1, t).contiguous()
        c = xf.shape[0]
        rows = [state["stage"][..., i] for i in range(4)]
        rows += [state["tanh_last"][..., i] for i in range(3)]
        rows.append(state["prev_out"])
        st8 = torch.stack([torch.broadcast_to(r.to(x_run.dtype), lead)
                           .reshape(c) for r in rows]).contiguous()
        if self.variant == MoogVariant.ZDF:
            st8, y = moog_ops.moog_zdf(xf, st8, self.kernel_params(),
                                       newton_iters=self.newton_iters, os=os)
        else:
            st8, y = moog_ops.moog_ladder(
                xf, st8, self.kernel_params(),
                fast_tanh=self.variant in _LIGHTWEIGHT,
                huovilainen=self.variant == MoogVariant.HUOVILAINEN, os=os)
        new = {"stage": st8[:4].T.reshape(lead + (4,)),
               "tanh_last": st8[4:7].T.reshape(lead + (3,)),
               "prev_out": st8[7].reshape(lead)}
        return new, y.reshape(lead + (t,))

    def process(self, state, x):
        """(state, x:(..., N)) -> (state, y). Oversampling processes each
        sample `os` times with the input applied on the first tick and
        the last tick's output kept (zero-stuff + decimate semantics),
        inside the kernel (or its plain version): x is read and y written
        at the base rate. Differentiable in x and state."""
        if x.shape[-1] == 0:
            return state, x
        return self._run(state, x, self.oversampling)
