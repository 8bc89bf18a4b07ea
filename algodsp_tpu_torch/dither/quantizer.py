"""Bit-depth quantizer with dither and error-feedback noise shaping
(counterpart of `algodsp_tpu/dither/quantizer.py`).

Capability parity with `dsp/dither/`: dither PDFs
None/Rect/TPDF/Gaussian/FastGaussian (`dither.go:8-27`,
`quantizer.go:137-170`), FIR error-feedback shaper (`shaper_fir.go`),
published FIR presets (E-weighted, F-weighted, Sony SBM, sharp-rolloff
families, `presets.go:84-186`), scaling/limiting conventions
(bitMul = 2^(bits-1) - 0.5, floor quantization, `quantizer.go:87-120`).

The dither for a whole call is drawn up front from a `torch.Generator`
on the input's device (equal in its statistics to the reference's
`jax.random` draws, not sample for sample); the state carries the
generator's position (`Generator.get_state()`, a CPU byte tensor), so
every call draws new noise. A caller may pass the noise instead, as the
golden `native.quantize` takes it; the generator then stays where it
was. The error-feedback loop is the only sequential piece: Q1
(`ops/dither.py`, `csrc/dither.cu`), its state the error history (FIR)
or the shelf's (d0, d1, last error) (IIR).
"""

from __future__ import annotations

import enum
import math

import numpy as np
import torch

from algodsp_tpu_torch._device import resolve_device
from algodsp_tpu_torch.ops.dither import ShaperParams, error_feedback


class DitherType(enum.Enum):
    NONE = "none"
    RECTANGULAR = "rectangular"
    TRIANGULAR = "triangular"
    GAUSSIAN = "gaussian"
    FAST_GAUSSIAN = "fast_gaussian"


class Preset(enum.Enum):
    NONE = "none"
    EFB = "efb"
    SC2 = "2sc"
    MEC2 = "2mec"
    MEC3 = "3mec"
    MEC9 = "9mec"
    IEC5 = "5iec"
    IEC9 = "9iec"
    FC3 = "3fc"
    FC9 = "9fc"
    SBM = "sbm"
    SBM_REDUCED = "sbm_reduced"
    SHARP_14K = "sharp14k"
    SHARP_15K = "sharp15k"
    SHARP_16K = "sharp16k"
    EXPERIMENTAL = "experimental"


# Published noise-shaping coefficient sets (presets.go:84-186;
# E-/F-weighted sets from Wannamaker/Lipshitz, SBM from Sony).
_PRESETS: dict[Preset, list[float]] = {
    Preset.NONE: [],
    Preset.EFB: [1.0],
    Preset.SC2: [1.0, -0.5],
    Preset.MEC2: [1.537, -0.8367],
    Preset.MEC3: [1.652, -1.049, 0.1382],
    Preset.MEC9: [1.662, -1.263, 0.4827, -0.2913, 0.1268,
                  -0.1124, 0.03252, -0.01265, -0.03524],
    Preset.IEC5: [2.033, -2.165, 1.959, -1.590, 0.6149],
    Preset.IEC9: [2.847, -4.685, 6.214, -7.184, 6.639,
                  -5.032, 3.263, -1.632, 0.4191],
    Preset.FC3: [1.623, -0.982, 0.109],
    Preset.FC9: [2.412, -3.370, 3.937, -4.174, 3.353,
                 -2.205, 1.281, -0.569, 0.0847],
    Preset.SBM: [1.47933, -1.59032, 1.64436, -1.36613, 0.926704,
                 -0.557931, 0.26786, -0.106726, 0.028516, 0.00123066,
                 -0.00616555, 0.003067],
    Preset.SBM_REDUCED: [1.47933, -1.59032, 1.64436, -1.36613, 0.926704,
                         -0.557931, 0.26786, -0.106726, 0.028516, 0.00123066],
    Preset.SHARP_14K: [1.62019206878484, -2.26551157411517, 2.50884415683988,
                       -2.25007947643775, 1.62160867255441, -0.899114621685913,
                       0.35350816625238],
    Preset.SHARP_15K: [1.34860378444905, -1.80123976889643, 2.04804746376671,
                       -1.93234174830592, 1.59264693241396, -1.04979311664936,
                       0.599422666305319, -0.213194268754789],
    Preset.SHARP_16K: [1.07618924753262, -1.41232919229157, 1.61374140100329,
                       -1.5996973679788, 1.42711666927426, -1.09986023030973,
                       0.750589080482029, -0.418709259968069, 0.185132272731155],
    Preset.EXPERIMENTAL: [1.2194769820734, -1.77912468394129, 2.18256539389233,
                          -2.33622087251503, 2.2010985277411, -1.81964871362306,
                          1.29830681491534, -0.767889385169331, 0.320990893363264],
}

_SHARP_BY_RATE = {
    40000.0: [0.919387305668676, -1.04843437730544, 1.04843048925451,
              -0.868972788711174, 0.60853001063849, -0.3449209471469,
              0.147484332561636, -0.0370652871194614],
    48000.0: [1.4247141061364, -1.5437678148854, 1.0967969510044,
              -0.32075758107035, -0.32074811729292, 0.525494723539046,
              -0.38058984415197, 0.14824460513256],
    64000.0: [2.49725554745212, -3.23587161287721, 2.31844946822861,
              -0.54326047010533, -0.54325301319653, 0.543289788745007,
              -0.142132484905, -0.0202120370327948],
    96000.0: [3.14014081409305, -3.76888037179035, 1.26107138314221,
              1.26088059917107, -0.807698715053922, -0.80767075968406,
              1.0101984930848, -0.322351688402064],
}


def preset_coefficients(p: Preset) -> np.ndarray:
    return np.asarray(_PRESETS[p], dtype=np.float64)


def sharp_preset_for_sample_rate(sample_rate: float) -> np.ndarray:
    """Rate-adaptive sharp 15 kHz set (`presets.go:183-205`)."""
    if sample_rate < 44100.0:
        return np.asarray(_SHARP_BY_RATE[40000.0])
    if sample_rate < 48000.0:
        return preset_coefficients(Preset.SHARP_15K)
    if sample_rate < 64000.0:
        return np.asarray(_SHARP_BY_RATE[48000.0])
    if sample_rate < 96000.0:
        return np.asarray(_SHARP_BY_RATE[64000.0])
    return np.asarray(_SHARP_BY_RATE[96000.0])


class Quantizer:
    """Dithering bit-depth reducer (`quantizer.go:31-132`)."""

    def __init__(self, sample_rate: float, *, bit_depth: int = 16,
                 dither_type: DitherType = DitherType.TRIANGULAR,
                 dither_amplitude: float = 1.0, limit: bool = True,
                 shaper_coeffs=None, preset: Preset = Preset.FC9,
                 iir_shelf_freq: float | None = None,
                 seed: int = 1):
        if sample_rate <= 0 or not math.isfinite(sample_rate):
            raise ValueError(f"dither: sample rate must be > 0: {sample_rate}")
        if not (1 <= bit_depth <= 32):
            raise ValueError(f"dither: bit depth must be in [1, 32]: {bit_depth}")
        self.sample_rate = sample_rate
        self.bit_depth = bit_depth
        self.dither_type = dither_type
        self.dither_amplitude = dither_amplitude
        self.limit = limit
        self.seed = seed
        # IIR shelf error-feedback shaper (`shaper_iir.go:20-57`): a
        # -5 dB Butterworth low-shelf biquad on the PREVIOUS error.
        # Precedence mirrors the Go options: explicit coefficients >
        # shelf > preset.
        self.iir_shelf_sos: np.ndarray | None = None
        if iir_shelf_freq is not None and shaper_coeffs is None:
            if not (0.0 < iir_shelf_freq < sample_rate / 2.0) \
                    or not math.isfinite(iir_shelf_freq):
                # >= Nyquist would silently design an all-zero shelf
                # (rbj convention) and disable the shaping the caller
                # asked for — reject it instead
                raise ValueError(
                    f"dither: IIR shelf frequency must be in (0, Nyquist "
                    f"= {sample_rate / 2.0}): {iir_shelf_freq}")
            from algodsp_tpu_torch.filters.design.rbj import low_shelf
            self.iir_shelf_sos = np.asarray(
                low_shelf(iir_shelf_freq, -5.0, 1.0 / math.sqrt(2.0),
                          sample_rate), np.float64).reshape(-1)
            shaper_coeffs = []
        if shaper_coeffs is None:
            shaper_coeffs = preset_coefficients(preset)
        self.shaper_coeffs = np.asarray(shaper_coeffs, dtype=np.float64).reshape(-1)
        self.bit_mul = 2.0 ** (bit_depth - 1) - 0.5
        self.bit_div = 1.0 / self.bit_mul
        self.limit_lo = -int(round(self.bit_mul + 0.5))
        self.limit_hi = int(round(self.bit_mul - 0.5))
        self.shaper = ShaperParams(
            coeffs=tuple(float(c) for c in self.shaper_coeffs),
            shelf=(None if self.iir_shelf_sos is None
                   else tuple(float(c) for c in self.iir_shelf_sos)),
            limit=bool(limit), lo=float(self.limit_lo), hi=float(self.limit_hi))

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        """The error history (..., max(order, 1)), the generator's position
        ("key", seeded with `seed`) and, with the IIR shelf, its (..., 3)
        state; on the CUDA card unless `device` says otherwise."""
        device = resolve_device(device)
        order = self.shaper_coeffs.size
        gen = torch.Generator(device=device)
        gen.manual_seed(int(self.seed))
        st = {"err": torch.zeros(tuple(batch_shape) + (max(order, 1),),
                                 dtype=dtype, device=device),
              "key": gen.get_state()}
        if self.iir_shelf_sos is not None:
            st["iir"] = torch.zeros(tuple(batch_shape) + (3,), dtype=dtype,
                                    device=device)
        return st

    def _noise(self, gen, shape, dtype, device):
        t = self.dither_type
        amp = self.dither_amplitude
        u = lambda: torch.rand(shape, generator=gen, dtype=dtype, device=device)
        if t == DitherType.NONE:
            return torch.zeros(shape, dtype=dtype, device=device)
        if t == DitherType.RECTANGULAR:
            return amp * (2.0 * u() - 1.0)
        if t == DitherType.TRIANGULAR:
            return amp * (u() - u())
        if t == DitherType.GAUSSIAN:
            return amp * torch.randn(shape, generator=gen, dtype=dtype,
                                     device=device)
        # fast gaussian: sum of 3 uniforms - 1.5 (quantizer.go:158-170 analog)
        return amp * (u() + u() + u() - 1.5)

    def process(self, state, x, noise=None):
        """(state, x in [-1,1]) -> (state, quantized float).

        Float output is `(code + 0.5) * bit_div` (`quantizer.go:118-120`).
        `noise` (x's shape) replaces the generator's draw where given."""
        state, q = self._process_codes(state, x, noise)
        return state, (q + 0.5) * torch.tensor(self.bit_div, dtype=q.dtype,
                                               device=q.device)

    def process_integer(self, state, x, noise=None):
        """(state, x in [-1,1]) -> (state, int32 codes in the bit-depth
        range) — `Quantizer.ProcessInteger` (`quantizer.go:95-114`)."""
        state, q = self._process_codes(state, x, noise)
        return state, q.to(torch.int32)

    def _process_codes(self, state, x, noise):
        key = state["key"]
        if noise is None:
            gen = torch.Generator(device=x.device)
            gen.set_state(key)
            noise = self._noise(gen, x.shape, x.dtype, x.device)
            key = gen.get_state()
        else:
            noise = torch.as_tensor(noise, dtype=x.dtype, device=x.device)
            if noise.shape != x.shape:
                raise ValueError(f"dither: noise must have x's shape "
                                 f"{tuple(x.shape)}, got {tuple(noise.shape)}")
        scaled = self.bit_mul * x
        new_state = dict(state)
        new_state["key"] = key
        if self.iir_shelf_sos is not None:
            q, new_state["iir"] = error_feedback(
                scaled, noise, state["iir"].to(x.dtype), self.shaper)
            return new_state, q
        if self.shaper_coeffs.size == 0:
            q = torch.floor(scaled + noise)
            if self.limit:
                q = torch.clamp(q, self.limit_lo, self.limit_hi)
            return new_state, q
        q, new_state["err"] = error_feedback(scaled, noise,
                                             state["err"].to(x.dtype), self.shaper)
        return new_state, q
