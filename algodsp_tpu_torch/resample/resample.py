"""Polyphase FIR rational resampler (counterpart of
`algodsp_tpu/resample/resample.py`).

Capability parity with `dsp/resample/`: Kaiser-windowed sinc prototype
split into `up` phases (`resample_design.go:9-70`), quality profiles
Fast/Balanced/Best (`resample.go:28-54`), continued-fraction ratio
approximation with max denominator (`resample.go:190`,
`resample_design.go:71-110`), streaming `process` with history carry
(`resample.go:249-292`).

The reference walks output samples one by one, selecting a polyphase
branch per sample. Since phase p_m = (m*down) mod up cycles with period
`up`, each phase's outputs form a stride-`down` correlation of the
input: the resampler is one strided correlation with an (up, W) kernel
bank (phases as output features), followed by a phase interleave.
Output m: y[m] = sum_k phases[p][k] * x[i_m - k] with
i_m = floor(m*down/up), the Go loop's sample map. The design is the
reference's host float64 code. The correlation is a strided view of the
input (`Tensor.unfold`, a window of W samples every `down`) times the
transposed bank, one product run in full float32 under
`linrec.full_float32()`: no cuDNN convolution, whose float32 path
follows `torch.backends.cudnn.allow_tf32` (True by default).
"""

from __future__ import annotations

import dataclasses
import enum
import math

import numpy as np
import torch

from algodsp_tpu_torch._device import resolve_device
from algodsp_tpu_torch.ops.linrec import full_float32


class Quality(enum.Enum):
    FAST = "fast"
    BALANCED = "balanced"
    BEST = "best"


@dataclasses.dataclass(frozen=True)
class QualityProfile:
    taps_per_phase: int
    cutoff_scale: float
    kaiser_beta: float
    nominal_stopband_db: float


def quality_profile(q: Quality) -> QualityProfile:
    """Default profiles (`resample.go:36-46`)."""
    if q == Quality.FAST:
        return QualityProfile(16, 0.88, 5.0, 55.0)
    if q == Quality.BEST:
        return QualityProfile(64, 0.96, 9.0, 90.0)
    return QualityProfile(32, 0.92, 7.5, 75.0)


def _i0(x: np.ndarray) -> np.ndarray:
    """Power-series modified Bessel I0 (`resample_design.go:151-166`)."""
    x = np.asarray(x, dtype=np.float64)
    total = np.ones_like(x)
    term = np.ones_like(x)
    x2 = (x * x) / 4.0
    for k in range(1, 64):
        term = term * x2 / (k * k)
        total = total + term
        if np.all(term < 1e-16 * total):
            break
    return total


def _design_polyphase(up: int, down: int, taps_per_phase: int,
                      cutoff_scale: float, beta: float):
    """Kaiser-sinc prototype split into phases (`resample_design.go:9-70`).

    Returns (taps, phase_bank (up, max_phase_len))."""
    n_taps = taps_per_phase * up
    fc = (0.5 / max(up, down)) * cutoff_scale
    if fc <= 0 or fc >= 0.5:
        raise ValueError(f"resample: invalid cutoff {fc}")
    n = np.arange(n_taps, dtype=np.float64)
    center = 0.5 * (n_taps - 1)
    t = n - center
    arg = 2.0 * fc * t
    sinc = np.where(np.abs(arg) < 1e-12, 1.0,
                    np.sin(np.pi * np.where(np.abs(arg) < 1e-12, 1.0, arg))
                    / (np.pi * np.where(np.abs(arg) < 1e-12, 1.0, arg)))
    if n_taps > 1 and beta != 0:
        w = 2.0 * n / (n_taps - 1) - 1.0
        window = _i0(beta * np.sqrt(np.maximum(0.0, 1 - w * w))) / _i0(np.array(beta))
    else:
        window = np.ones(n_taps)
    taps = 2.0 * fc * sinc * window
    s = taps.sum()
    if s == 0:
        raise ValueError("resample: designed zero-sum filter")
    taps *= up / s

    max_len = -(-n_taps // up)
    bank = np.zeros((up, max_len))
    for p in range(up):
        ph = taps[p::up]
        bank[p, :ph.size] = ph
    return taps, bank


def approximate_ratio(v: float, max_den: int = 4096) -> tuple[int, int]:
    """Continued-fraction rationalization (`resample_design.go:71-110`)."""
    if max_den <= 0:
        max_den = 4096
    if v <= 0 or not math.isfinite(v):
        return 1, 1
    a0 = math.floor(v)
    p0, q0 = 1.0, 0.0
    p1, q1 = a0, 1.0
    x = v
    while True:
        frac = x - math.floor(x)
        if frac == 0:
            break
        x = 1.0 / frac
        a = math.floor(x)
        p2 = a * p1 + p0
        q2 = a * q1 + q0
        if q2 > max_den:
            break
        p0, q0 = p1, q1
        p1, q1 = p2, q2
    num, den = int(round(p1)), int(round(q1))
    if den <= 0:
        return 1, 1
    g = math.gcd(num, den)
    return num // g, den // g


class Resampler:
    """Rational up/down resampler with streaming state."""

    def __init__(self, up: int, down: int, *, quality: Quality = Quality.BALANCED,
                 taps_per_phase: int | None = None,
                 cutoff_scale: float | None = None,
                 kaiser_beta: float | None = None):
        if up <= 0 or down <= 0:
            raise ValueError("resample: invalid ratio")
        g = math.gcd(up, down)
        self.up = up // g
        self.down = down // g
        prof = quality_profile(quality)
        self.profile = prof
        tp = taps_per_phase or prof.taps_per_phase
        cs = cutoff_scale or prof.cutoff_scale
        kb = prof.kaiser_beta if kaiser_beta is None else kaiser_beta
        self.taps, self._bank = _design_polyphase(self.up, self.down, tp, cs, kb)
        self.max_phase_len = self._bank.shape[1]
        # correlation bank: for output slot r of a group of `up` outputs
        # (global output m = j*up + r), phase (r*down) mod up at input
        # offset floor(r*down/up) from the group base j*down; its row
        # holds the reversed taps at that offset inside a common window
        # of width L + down - 1
        L = self.max_phase_len
        W = L + self.down - 1
        kbank = np.zeros((self.up, W))
        for r in range(self.up):
            p = (r * self.down) % self.up
            d_r = (r * self.down) // self.up
            # y = sum_k h[k] x[i - k] -> correlation with reversed taps
            kbank[r, d_r:d_r + L] = self._bank[p, ::-1]
        self._kbank = kbank
        self._W = W
        self._kbank_t: dict = {}   # (dtype, device) -> (W, up) tensor

    def _kbank_on(self, dtype: torch.dtype, device: torch.device):
        """The correlation bank transposed, (W, up), of `dtype` on
        `device`, made once per type and device."""
        key = (dtype, device)
        if key not in self._kbank_t:
            self._kbank_t[key] = torch.as_tensor(
                np.ascontiguousarray(self._kbank.T), dtype=dtype, device=device)
        return self._kbank_t[key]

    @classmethod
    def for_rates(cls, in_rate: float, out_rate: float, *, max_den: int = 4096,
                  **kwargs) -> "Resampler":
        """Rationalize out_rate/in_rate (`resample.go:190-208`)."""
        if in_rate <= 0 or out_rate <= 0 or not math.isfinite(in_rate) \
                or not math.isfinite(out_rate):
            raise ValueError("resample: invalid rate")
        up, down = approximate_ratio(out_rate / in_rate, max_den)
        return cls(up, down, **kwargs)

    def output_len(self, input_len: int) -> int:
        """ceil(N*up/down): outputs produced from N fresh samples at
        stream start (`resample.go:281-299` PredictOutputLen)."""
        return -(-input_len * self.up // self.down)

    def process(self, x):
        """One-shot resample of (..., N) -> (..., ceil(N*up/down))."""
        n_out = self.output_len(x.shape[-1])
        groups = -(-n_out // self.up)  # correlation outputs needed
        hist = x.new_zeros(x.shape[:-1] + (self.max_phase_len - 1,))
        y = self._run_ext(torch.cat([hist, x], dim=-1), hist.shape[-1], groups)
        return y[..., :n_out]

    def init_state(self, batch_shape: tuple[int, ...] = (), dtype=torch.float32,
                   device=None):
        """History = last max_phase_len-1 inputs (`resample.go:135-152`),
        on the CUDA card unless `device` says otherwise."""
        return torch.zeros(tuple(batch_shape) + (self.max_phase_len - 1,),
                           dtype=dtype, device=resolve_device(device))

    def process_stream(self, state, x):
        """Streaming blocks; len(x) must be a multiple of `down` so the
        polyphase cycle completes each call. Returns (state, y) with
        len(y) = len(x)*up/down."""
        n = x.shape[-1]
        if n % self.down:
            raise ValueError(
                f"resample: streaming block {n} must be a multiple of down={self.down}")
        n_out = n * self.up // self.down
        groups = n_out // self.up
        ext = torch.cat([state.to(x.dtype), x], dim=-1)
        hist = self.max_phase_len - 1
        y = self._run_ext(ext, hist, groups)
        new_state = ext[..., ext.shape[-1] - hist:]
        return new_state, y[..., :n_out]

    def _run_ext(self, ext, hist: int, groups: int):
        """Strided correlation over the history-extended input: group j,
        slot p is y[j*up+p] = sum_k bank[p,k] x[j*down + d_p - k]."""
        W = self._W
        # output j uses the ext window starting at hist + j*down - (L-1):
        # pad left so index 0 of the window aligns, pad right for the tail
        L = self.max_phase_len
        n_ext = ext.shape[-1]
        left = L - 1 - hist
        need = (groups - 1) * self.down + W - (n_ext + max(left, 0))
        xp = ext
        if left > 0:
            xp = torch.cat([ext.new_zeros(ext.shape[:-1] + (left,)), xp], dim=-1)
        elif left < 0:
            xp = xp[..., -left:]
        if need > 0:
            xp = torch.cat([xp, xp.new_zeros(xp.shape[:-1] + (need,))], dim=-1)
        frames = xp.unfold(-1, W, self.down)[..., :groups, :]   # (..., groups, W)
        with full_float32():
            y = torch.matmul(frames, self._kbank_on(ext.dtype, ext.device))
        return y.reshape(ext.shape[:-1] + (groups * self.up,))


def resample(x, up: int, down: int, **kwargs):
    """One-shot helper (`resample.go:230-240`)."""
    return Resampler(up, down, **kwargs).process(x)


def upsample_2x(x, **kwargs):
    return Resampler(2, 1, **kwargs).process(x)


def downsample_2x(x, **kwargs):
    return Resampler(1, 2, **kwargs).process(x)
