"""IEC 61672 A/B/C/Z frequency weighting filters.

Capability parity with `dsp/filter/weighting/weighting.go:64-226`:
weighting curves built from the standard analog pole positions
(f1=20.598997, f2=107.65265, f3=158.48932, f4=737.86223,
f5=12194.217 Hz) via bilinear transform, normalized to 0 dB at 1 kHz.

Returns a `BiquadChain` of this port.
"""

from __future__ import annotations

import enum
import math

import numpy as np

from algodsp_tpu_torch.filters.biquad import BiquadChain, sos_response

F1 = 20.598997
F2 = 107.65265
F3 = 158.48932
F4 = 737.86223
F5 = 12194.217


class WeightingType(enum.Enum):
    A = "A"
    B = "B"
    C = "C"
    Z = "Z"


def _lp_first_order(f: float, sr: float) -> np.ndarray:
    k = math.tan(math.pi * f / sr)
    d = 1.0 + k
    return np.array([k / d, k / d, 0.0, (k - 1.0) / d, 0.0])


def _hp_first_order(f: float, sr: float) -> np.ndarray:
    k = math.tan(math.pi * f / sr)
    d = 1.0 + k
    return np.array([1.0 / d, -1.0 / d, 0.0, (k - 1.0) / d, 0.0])


def _hp_second_order(f: float, sr: float) -> np.ndarray:
    k = math.tan(math.pi * f / sr)
    k2 = k * k
    d = 1.0 + 2.0 * k + k2
    return np.array([1.0 / d, -2.0 / d, 1.0 / d,
                     2.0 * (k2 - 1.0) / d, (1.0 - 2.0 * k + k2) / d])


def weighting_sos(wtype: WeightingType, sample_rate: float) -> np.ndarray:
    """SOS rows for the weighting cascade (before 1 kHz normalization)."""
    if sample_rate <= 0:
        raise ValueError("weighting: sample rate must be positive")
    if wtype == WeightingType.A:
        rows = [_hp_second_order(F1, sample_rate),
                _lp_first_order(F5, sample_rate),
                _lp_first_order(F5, sample_rate),
                _hp_first_order(F2, sample_rate),
                _hp_first_order(F4, sample_rate)]
    elif wtype == WeightingType.B:
        rows = [_hp_second_order(F1, sample_rate),
                _lp_first_order(F5, sample_rate),
                _lp_first_order(F5, sample_rate),
                _hp_first_order(F3, sample_rate)]
    elif wtype == WeightingType.C:
        rows = [_hp_second_order(F1, sample_rate),
                _lp_first_order(F5, sample_rate),
                _lp_first_order(F5, sample_rate)]
    elif wtype == WeightingType.Z:
        rows = [np.array([1.0, 0.0, 0.0, 0.0, 0.0])]
    else:
        raise ValueError(f"unknown weighting type: {wtype}")
    return np.stack(rows)


def weighting_chain(wtype: WeightingType, sample_rate: float,
                    **chain_kwargs) -> BiquadChain:
    """Build the weighting filter, 0 dB at 1 kHz (`weighting.go:64-86`)."""
    sos = weighting_sos(wtype, sample_rate)
    h = sos_response(sos, 1000.0, sample_rate)
    gain = 1.0 / float(np.abs(h[0])) if wtype != WeightingType.Z else 1.0
    return BiquadChain(sos, gain=gain, **chain_kwargs)
