"""Numeric helpers: clamping, dB conversions, denormal flushing
(counterpart of `algodsp_tpu/core/numeric.py`).

Behavior parity with the Go reference `dsp/core/numeric.go:8-101`
(Clamp, NearlyEqual, FlushDenormals, DBToLinear/LinearToDB,
DBPowerToLinear/LinearPowerToDB). Every function works elementwise on a
tensor of any shape, on its device and in its dtype; a float NumPy
array becomes a host tensor of its own type, a Python number a float64
one.
"""

from __future__ import annotations

import numpy as np
import torch

_DEFAULT_EPSILON = 1e-12
_DENORMAL_EPSILON = 1e-30


def _tensor(v) -> torch.Tensor:
    """A tensor as it is, a float NumPy array in its own type, anything
    else (numbers, lists, integer arrays) as float64."""
    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, np.ndarray) and v.dtype.kind == "f":
        return torch.as_tensor(v)
    return torch.as_tensor(v, dtype=torch.float64)


def clamp(value, min_value, max_value):
    """Limit value to the inclusive range [min_value, max_value].

    Like the reference (`numeric.go:8-24`), a reversed range is swapped
    rather than rejected.
    """
    value = _tensor(value)
    lo = torch.as_tensor(min_value, dtype=value.dtype, device=value.device)
    hi = torch.as_tensor(max_value, dtype=value.dtype, device=value.device)
    return torch.clamp(value, torch.minimum(lo, hi), torch.maximum(lo, hi))


def nearly_equal(a, b, eps: float = 0.0):
    """Absolute-or-relative equality within eps (`numeric.go:27-44`)."""
    eps = eps if eps > 0 else _DEFAULT_EPSILON
    a, b = _tensor(a), _tensor(b)
    diff = torch.abs(a - b)
    largest = torch.maximum(torch.abs(a), torch.abs(b))
    rel_ok = torch.where(largest == 0, diff <= eps,
                         diff / torch.where(largest == 0,
                                            torch.ones_like(largest),
                                            largest) <= eps)
    return torch.logical_or(diff <= eps, rel_ok)


def flush_denormals(x):
    """Zero out magnitudes below 1e-30 (`numeric.go:48-56`): exact
    behavioral parity in float64 paths and a feedback-loop squelch."""
    x = _tensor(x)
    return torch.where(torch.abs(x) < _DENORMAL_EPSILON, torch.zeros_like(x), x)


def db_to_linear(db):
    """dB -> linear amplitude, 20*log10 convention (`numeric.go:59-61`)."""
    db = _tensor(db)
    return torch.pow(torch.tensor(10.0, dtype=db.dtype, device=db.device),
                     db / 20.0)


def _to_db(v, scale: float):
    v = _tensor(v)
    out = scale * torch.log10(torch.where(v > 0, v, torch.ones_like(v)))
    out = torch.where(v == 0, torch.full_like(v, -torch.inf), out)
    return torch.where(v < 0, torch.full_like(v, torch.nan), out)


def linear_to_db(linear):
    """Linear amplitude -> dB. -inf for 0, NaN for negatives (`numeric.go:64-76`)."""
    return _to_db(linear, 20.0)


def db_power_to_linear(db):
    """dB -> linear power, 10*log10 convention (`numeric.go:79-81`)."""
    db = _tensor(db)
    return torch.pow(torch.tensor(10.0, dtype=db.dtype, device=db.device),
                     db / 10.0)


def linear_power_to_db(power):
    """Linear power -> dB. -inf for 0, NaN for negatives (`numeric.go:84-96`)."""
    return _to_db(power, 10.0)


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (host-side helper for FFT sizing)."""
    if n <= 1:
        return 1
    return 1 << (int(n - 1).bit_length())


def best_float():
    """The widest float type to default to for float64-preferring state
    (meters, oracles). The reference returns float64 only where JAX's x64
    mode is on; PyTorch always has float64, so this is torch.float64."""
    return torch.float64
