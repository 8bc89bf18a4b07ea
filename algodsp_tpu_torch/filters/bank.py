"""Octave / fractional-octave filter banks (counterpart of
`algodsp_tpu/filters/bank.py`).

Capability parity with `dsp/filter/bank/`: IEC 61260 base-10 center
frequencies f_m = 1000*G^(k/N), G = 10^(3/10), band edges
f_c*G^(+-1/2N) (`bank.go:84-124`), per-band Butterworth bandpass
(LP at the upper edge cascaded with HP at the lower edge), custom
center lists (`bank.go:128-160`), and the band-level analyzer
(`analyzer.go:136-346`).

All bands process in parallel as a *banded* biquad cascade: where the
length is a multiple of the block, one banded whole-cascade Toeplitz
pass (`ops/cascade.cascade_apply_blocked_banded`), else one banded
per-section pass each (`ops/linrec.ar2_apply_blocked_banded`), with the
band axis batched. The analyzer comes in two flavors:
`OctaveAnalyzer` (all bands at the native rate, one-pole attack/release
envelopes through the port's `envelope_scan`, the CUDA kernel
`csrc/envelope.cu` on the card) and `MultirateOctaveAnalyzer`
(reference parity with `analyzer.go:136-346`: per-band-group polyphase
decimation by powers of two, Butterworth envelope smoothing at the
reduced rate).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from algodsp_tpu_torch._device import resolve_device
from algodsp_tpu_torch.filters.design.cascades import butterworth_hp, butterworth_lp
from algodsp_tpu_torch.ops import cascade as cascmod
from algodsp_tpu_torch.ops import linrec
from algodsp_tpu_torch.ops.envscan import envelope_scan

OCTAVE_RATIO = 10.0 ** 0.3  # G per IEC 61260


def octave_band_specs(fraction: int, sample_rate: float,
                      lower_hz: float = 20.0, upper_hz: float = 20000.0):
    """[(center, low_edge, high_edge)] for IEC 61260 bands in range."""
    if fraction <= 0:
        fraction = 1
    nyquist = sample_rate / 2
    upper_hz = min(upper_hz, nyquist * 0.95)
    specs = []
    half = OCTAVE_RATIO ** (1.0 / (2 * fraction))
    # f_m = 1000 * G^(k/N), N = fraction bands per octave (bank.go:84-88)
    for k in range(-200, 200):
        fc = 1000.0 * OCTAVE_RATIO ** (k / fraction)
        lo, hi = fc / half, fc * half
        if fc < lower_hz or fc > upper_hz or hi >= nyquist:
            continue
        specs.append((fc, lo, hi))
    specs.sort()
    return specs


def _broadcast_bands(x, n_bands: int):
    """(..., N) -> (..., B, N) as a view."""
    return x[..., None, :].expand(x.shape[:-1] + (n_bands, x.shape[-1]))


class _BandedChain:
    """Serial cascade of S sections applied per band: sos (B, S, 5)."""

    def __init__(self, sos: np.ndarray, block_size: int = linrec.DEFAULT_BLOCK):
        self.sos = np.asarray(sos, dtype=np.float64)
        if self.sos.ndim != 3 or self.sos.shape[2] != 5:
            raise ValueError(f"banded sos must be (B, S, 5), got {self.sos.shape}")
        self.block_size = block_size
        self.n_bands, self.n_sections = self.sos.shape[:2]
        self._kernels = [linrec.ar2_kernels(self.sos[:, s, 3], self.sos[:, s, 4],
                                            block_size)
                         for s in range(self.n_sections)]
        self._fir_cols = {}

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        """Zero state (..., B, S, 4), on the CUDA card unless `device`
        says otherwise."""
        return torch.zeros(tuple(batch_shape) + (self.n_bands, self.n_sections, 4),
                           dtype=dtype, device=resolve_device(device))

    def process_stream(self, state, xb):
        """xb: (..., B, N) banded input; state (..., B, S, 4).

        Where N is a multiple of the block, every band's whole cascade
        runs in ONE banded Toeplitz pass per block
        (`ops/cascade.cascade_apply_blocked_banded`), replacing S
        sequential banded stages. Other lengths take the per-section
        path, which carries the exact state at the true last samples.
        """
        if xb.shape[-1] % self.block_size:
            return self._process_stream_sections(state, xb)
        s0 = cascmod.chain_state_to_compact(state.to(xb.dtype))
        y, s_fin = cascmod.cascade_apply_blocked_banded(
            xb, self.sos, block=self.block_size, s0=s0, return_state=True)
        return cascmod.compact_state_to_chain(s_fin, self.n_sections), y

    def _fir_columns(self, dtype, device):
        """Each section's (b0, b1, b2) as (B, 1) columns of `dtype` on
        `device`, made once per (type, device)."""
        key = (dtype, device)
        if key not in self._fir_cols:
            t = torch.as_tensor(self.sos[..., :3], dtype=dtype, device=device)
            self._fir_cols[key] = [tuple(t[:, s, i, None] for i in range(3))
                                   for s in range(self.n_sections)]
        return self._fir_cols[key]

    def _process_stream_sections(self, state, xb):
        """Per-section path (the pre-fused formulation): exact tail states
        and the dispatch tests' oracle."""
        n = xb.shape[-1]
        pad = (-n) % self.block_size
        x = xb
        if pad:
            x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
        state = state.to(x.dtype)
        cols = self._fir_columns(x.dtype, x.device)
        new_states = []
        for s in range(self.n_sections):
            st = state[..., s, :]
            x_in = x
            f = linrec.fir3(x, *cols[s], st[..., 0], st[..., 1])
            y = linrec.ar2_apply_blocked_banded(f, self._kernels[s],
                                                st[..., 2], st[..., 3])
            if n >= 2:
                ns = torch.stack([x_in[..., n - 1], x_in[..., n - 2],
                                  y[..., n - 1], y[..., n - 2]], dim=-1)
            else:
                ns = torch.stack([x_in[..., n - 1], st[..., 0],
                                  y[..., n - 1], st[..., 2]], dim=-1)
            new_states.append(ns)
            x = y
        y_out = x[..., :n] if pad else x
        return torch.stack(new_states, dim=-2), y_out

    def process(self, xb):
        state = self.init_state(xb.shape[:-2], xb.dtype, xb.device)
        _, y = self.process_stream(state, xb)
        return y


class Bank:
    """Parallel bandpass filter bank: input (..., N) -> bands (..., B, N)."""

    def __init__(self, specs, order: int, sample_rate: float,
                 block_size: int = linrec.DEFAULT_BLOCK):
        if order <= 0 or order % 2:
            raise ValueError(f"bank order must be positive even: {order}")
        self.sample_rate = sample_rate
        self.order = order
        self.centers = np.array([s[0] for s in specs])
        self.low_edges = np.array([s[1] for s in specs])
        self.high_edges = np.array([s[2] for s in specs])
        if len(specs) == 0:
            raise ValueError("bank: no bands in range")
        rows = []
        for fc, lo, hi in specs:
            lp = butterworth_lp(hi, order, sample_rate)
            hp = butterworth_hp(lo, order, sample_rate)
            rows.append(np.concatenate([lp, hp]))
        self.chain = _BandedChain(np.stack(rows), block_size)

    @classmethod
    def octave(cls, fraction: int, sample_rate: float, *, order: int = 4,
               lower_hz: float = 20.0, upper_hz: float = 20000.0, **kw):
        """IEC 61260 octave/fractional-octave bank (`bank.go:90-124`)."""
        specs = octave_band_specs(fraction, sample_rate, lower_hz, upper_hz)
        return cls(specs, order, sample_rate, **kw)

    @classmethod
    def custom(cls, centers, bandwidth_octaves: float, sample_rate: float,
               *, order: int = 4, **kw):
        """Custom centers with bandwidth in octaves (`bank.go:128-160`)."""
        if bandwidth_octaves <= 0:
            bandwidth_octaves = 1.0
        half = 2.0 ** (bandwidth_octaves / 2)
        nyq = sample_rate / 2
        specs = [(fc, fc / half, fc * half) for fc in centers
                 if 0 < fc / half and fc * half < nyq]
        return cls(specs, order, sample_rate, **kw)

    @property
    def num_bands(self) -> int:
        return self.chain.n_bands

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        return self.chain.init_state(batch_shape, dtype, device)

    def process(self, x):
        """(..., N) -> (..., B, N) band outputs."""
        return self.chain.process(_broadcast_bands(x, self.num_bands))

    def process_stream(self, state, x):
        return self.chain.process_stream(state, _broadcast_bands(x, self.num_bands))


class OctaveAnalyzer:
    """Band-level analyzer (`analyzer.go:136-346`): filter bank +
    per-band envelope followers; levels in dB per band.

    Runs all bands at the native rate; the envelopes of every channel
    and band run as rows of one `envelope_scan` call (the CUDA kernel on
    the card)."""

    def __init__(self, fraction: int, sample_rate: float, *, order: int = 4,
                 attack_ms: float = 5.0, release_ms: float = 50.0,
                 lower_hz: float = 20.0, upper_hz: float = 20000.0):
        self.bank = Bank.octave(fraction, sample_rate, order=order,
                                lower_hz=lower_hz, upper_hz=upper_hz)
        self.attack_coeff = 1.0 - math.exp(-1.0 / (attack_ms * 1e-3 * sample_rate))
        self.release_coeff = 1.0 - math.exp(-1.0 / (release_ms * 1e-3 * sample_rate))

    @property
    def centers(self):
        return self.bank.centers

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        """Zero state, on the CUDA card unless `device` says otherwise."""
        device = resolve_device(device)
        return {"bank": self.bank.init_state(batch_shape, dtype, device),
                "env": torch.zeros(tuple(batch_shape) + (self.bank.num_bands,),
                                   dtype=dtype, device=device)}

    def process(self, state, x):
        """Returns (state, band_signals (..., B, N), levels_db (..., B))."""
        bstate, bands = self.bank.process_stream(state["bank"], x)
        env_f, _ = envelope_scan(torch.abs(bands), state["env"],
                                 self.attack_coeff, self.release_coeff)
        levels_db = 20.0 * torch.log10(torch.clamp(env_f, min=1e-10))
        return {"bank": bstate, "env": env_f}, bands, levels_db


# ---------------------------------------------------------------------------
# Multirate analyzer (reference parity: `dsp/filter/bank/analyzer.go`)
# ---------------------------------------------------------------------------

def choose_downsample(sample_rate: float, high_hz: float,
                      max_downsample: int) -> tuple[int, int]:
    """Per-band decimation factor (`analyzer.go:360-377`): double while
    ds*high < sample_rate/8 and ds stays within max_downsample.
    Returns (factor, exponent)."""
    if max_downsample < 1 or high_hz <= 0 or sample_rate <= 0:
        return 1, 0
    ds, pow_ = 1, 0
    limit = sample_rate / 8.0
    while ds * 2 <= max_downsample and ds * high_hz < limit:
        ds *= 2
        pow_ += 1
    return ds, pow_


def clamp_envelope_hz(freq_hz: float, sample_rate: float) -> float:
    """Envelope cutoff clamp (`analyzer.go:380-396`)."""
    if sample_rate <= 0:
        return 1.0
    nyquist = sample_rate / 2.0
    if freq_hz <= 0:
        return min(1.0, nyquist * 0.1)
    return min(freq_hz, nyquist * 0.45)


@dataclasses.dataclass(frozen=True)
class BandInfo:
    """Analyzer band metadata (`analyzer.go:228-253` BandInfo)."""
    center_hz: float
    low_hz: float
    high_hz: float
    sample_rate: float
    downsample: int


class MultirateOctaveAnalyzer:
    """Fractional-octave band-level analyzer with per-group decimation.

    Reference parity with `bank/analyzer.go:136-346`: each band is
    downsampled by the largest power of two keeping its upper edge below
    (sample_rate/ds)/8 (`chooseDownsample`), bandpass-filtered by
    Butterworth LP+HP cascades designed at the band rate, rectified, and
    smoothed by a Butterworth lowpass "envelope" filter whose
    coefficients are designed at sample_rate/exponent, the reference's
    legacy quirk (`analyzer.go:183-190`: envRate divides by the
    *exponent*, not the factor). `process` returns the per-band envelope
    value at the last decimated sample ("peaks", linear), like
    `Analyzer.ProcessBlock` (`analyzer.go:306-346`).

    Bands sharing a decimation factor form a *group*: each group
    decimates the input once through the polyphase resampler and runs
    its bands as one banded cascade at the reduced rate.
    `process(state, x) -> (state, peaks)`; N must be a multiple of the
    largest decimation factor.
    """

    def __init__(self, fraction: int, sample_rate: float, *,
                 order: int = 10, envelope_hz: float = 100.0,
                 envelope_order: int = 4, lower_hz: float = 20.0,
                 upper_hz: float = 20000.0, max_downsample: int = 64,
                 resample_quality=None, resample: bool = True):
        from algodsp_tpu_torch.resample import Quality, Resampler
        if sample_rate <= 0 or not math.isfinite(sample_rate):
            raise ValueError(f"bank: invalid sample rate {sample_rate}")
        if order <= 0 or order % 2:
            raise ValueError(f"bank: analyzer order must be positive even: {order}")
        if envelope_order <= 0 or envelope_order % 2:
            raise ValueError(
                f"bank: envelope order must be positive even: {envelope_order}")
        specs = octave_band_specs(fraction, sample_rate, lower_hz, upper_hz)
        if not specs:
            raise ValueError(
                f"bank: no bands in range {lower_hz}-{upper_hz} Hz")
        self.sample_rate = sample_rate
        self.fraction = fraction
        quality = resample_quality or Quality.BALANCED

        # group bands by decimation factor (contiguous in ascending-center
        # order since ds is non-increasing in the upper band edge)
        self.band_info: list[BandInfo] = []
        groups: dict[int, list[tuple[float, float, float, int]]] = {}
        for fc, lo, hi in specs:
            ds, pw = (choose_downsample(sample_rate, hi, max_downsample)
                      if resample else (1, 0))
            groups.setdefault(ds, []).append((fc, lo, hi, pw))
            self.band_info.append(BandInfo(fc, lo, hi, sample_rate / ds, ds))

        self._groups = []
        for ds in sorted(groups):
            rows_bp, rows_env = [], []
            for fc, lo, hi, pw in groups[ds]:
                band_rate = sample_rate / ds
                lp = butterworth_lp(hi, order, band_rate)
                hp = butterworth_hp(lo, order, band_rate)
                rows_bp.append(np.concatenate([lp, hp]))
                env_rate = sample_rate / pw if pw > 0 else sample_rate
                env_hz = clamp_envelope_hz(envelope_hz, env_rate)
                rows_env.append(butterworth_lp(env_hz, envelope_order, env_rate))
            self._groups.append({
                "ds": ds,
                "resampler": (Resampler(1, ds, quality=quality)
                              if ds > 1 else None),
                "bandpass": _BandedChain(np.stack(rows_bp)),
                "envelope": _BandedChain(np.stack(rows_env)),
            })
        self.max_ds = max(g["ds"] for g in self._groups)
        # output ordering: groups sorted by ds ascending = bands sorted by
        # DESCENDING center within the spec order; build the permutation
        # back to ascending-center order.
        order_idx = []
        for ds in sorted(groups):
            for spec in groups[ds]:
                order_idx.append(specs.index(spec[:3]))
        self._perm = np.argsort(np.asarray(order_idx))
        self._perm_on = {}

    @property
    def num_bands(self) -> int:
        return len(self.band_info)

    @property
    def centers(self):
        return np.array([b.center_hz for b in self.band_info])

    def bands(self) -> list[BandInfo]:
        """Per-band metadata (`analyzer.go:239-253`)."""
        return list(self.band_info)

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        """Zero state, on the CUDA card unless `device` says otherwise."""
        device = resolve_device(device)
        gs = []
        for g in self._groups:
            gs.append({
                "resamp": (g["resampler"].init_state(batch_shape, dtype, device)
                           if g["resampler"] is not None
                           else torch.zeros(tuple(batch_shape) + (0,),
                                            dtype=dtype, device=device)),
                "bank": g["bandpass"].init_state(batch_shape, dtype, device),
                "env": g["envelope"].init_state(batch_shape, dtype, device),
            })
        return tuple(gs)

    def process(self, state, x):
        """(state, x (..., N)) -> (state, peaks (..., B)) with peaks the
        linear envelope value at each band's last decimated sample
        (`analyzer.go:306-346`). N must be a multiple of the largest
        decimation factor."""
        n = x.shape[-1]
        if n % self.max_ds:
            raise ValueError(
                f"analyzer: block length {n} must be a multiple of the "
                f"largest decimation factor {self.max_ds}")
        new_states, peaks = [], []
        for g, st in zip(self._groups, state):
            if g["resampler"] is not None:
                rs_state, xg = g["resampler"].process_stream(st["resamp"], x)
            else:
                rs_state, xg = st["resamp"], x
            xb = _broadcast_bands(xg, g["bandpass"].n_bands)
            bk_state, bands = g["bandpass"].process_stream(st["bank"], xb)
            env_state, env = g["envelope"].process_stream(st["env"],
                                                          torch.abs(bands))
            peaks.append(env[..., -1])
            new_states.append({"resamp": rs_state, "bank": bk_state,
                               "env": env_state})
        if x.device not in self._perm_on:
            self._perm_on[x.device] = torch.as_tensor(self._perm, device=x.device)
        return (tuple(new_states),
                torch.cat(peaks, dim=-1)[..., self._perm_on[x.device]])

    def analyze(self, x):
        """One-shot: zero state, returns peaks only."""
        _, peaks = self.process(
            self.init_state(x.shape[:-1], x.dtype, x.device), x)
        return peaks
