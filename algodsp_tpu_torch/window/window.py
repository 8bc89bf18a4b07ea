"""Window function generation, 46 window types (counterpart of
`algodsp_tpu/window/window.py`).

Capability parity with the Go reference `dsp/window/window.go` +
`tables.go`: 24 fixed cosine-sum families (Hann ... Albrecht 2-11 term),
parametric Kaiser/Tukey/Gauss/Lanczos/Triangle/Welch/Cosine/FreeCosine,
with periodic-vs-symmetric sampling (`window.go:404-415`), slope taper
(left/right/symmetric, `window.go:326-335`), DC removal, inversion, and
the Bartlett triangle variant (`window.go:448-458`).

Coefficient *generation* is host-side NumPy float64, the same code as
the reference's (including its Abramowitz-Stegun Bessel-I0 polynomial,
`window.go:471-484`), cached per parameter set. `window_tensor` makes
the coefficients a tensor once per (parameters, dtype, device);
*application* (`apply`) is one elementwise multiply on the input's
device, broadcasting over leading channel/batch dims.
"""

from __future__ import annotations

import enum
from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

from algodsp_tpu_torch._device import resolve_device


class WindowType(enum.Enum):
    RECTANGULAR = "rectangular"
    HANN = "hann"
    HAMMING = "hamming"
    BLACKMAN = "blackman"
    BLACKMAN_HARRIS_4TERM = "blackman_harris_4term"
    FLAT_TOP = "flat_top"
    KAISER = "kaiser"
    TUKEY = "tukey"
    TRIANGLE = "triangle"
    COSINE = "cosine"
    WELCH = "welch"
    LANCZOS = "lanczos"
    GAUSS = "gauss"
    EXACT_BLACKMAN = "exact_blackman"
    BLACKMAN_HARRIS_3TERM = "blackman_harris_3term"
    BLACKMAN_NUTTALL = "blackman_nuttall"
    NUTTALL_CTD = "nuttall_ctd"
    NUTTALL_CFD = "nuttall_cfd"
    LAWREY_5TERM = "lawrey_5term"
    LAWREY_6TERM = "lawrey_6term"
    BURGESS_OPTIMIZED_59DB = "burgess_optimized_59db"
    BURGESS_OPTIMIZED_71DB = "burgess_optimized_71db"
    ALBRECHT_2TERM = "albrecht_2term"
    ALBRECHT_3TERM = "albrecht_3term"
    ALBRECHT_4TERM = "albrecht_4term"
    ALBRECHT_5TERM = "albrecht_5term"
    ALBRECHT_6TERM = "albrecht_6term"
    ALBRECHT_7TERM = "albrecht_7term"
    ALBRECHT_8TERM = "albrecht_8term"
    ALBRECHT_9TERM = "albrecht_9term"
    ALBRECHT_10TERM = "albrecht_10term"
    ALBRECHT_11TERM = "albrecht_11term"
    FREE_COSINE = "free_cosine"


class Slope(enum.Enum):
    SYMMETRIC = "symmetric"
    LEFT = "left"
    RIGHT = "right"


# Published cosine-sum coefficient tables (values as in the literature;
# reference mirror: dsp/window/tables.go:3-28).
_COSINE_COEFFS: dict[WindowType, tuple[float, ...]] = {
    WindowType.HANN: (0.5, -0.5),
    WindowType.HAMMING: (0.54, -0.46),
    WindowType.BLACKMAN: (0.42, -0.5, 0.08),
    WindowType.BLACKMAN_HARRIS_4TERM: (0.35875, -0.48829, 0.14128, -0.01168),
    WindowType.FLAT_TOP: (0.21557895, -0.41663158, 0.277263158, -0.083578947, 0.006947368),
    WindowType.EXACT_BLACKMAN: (0.42659, -0.49656, 0.076849),
    WindowType.BLACKMAN_HARRIS_3TERM: (0.42323, -0.49755, 0.07922),
    WindowType.BLACKMAN_NUTTALL: (0.3635819, -0.4891775, 0.1365995, -0.0106411),
    WindowType.NUTTALL_CTD: (0.355768, -0.487396, 0.144232, -0.012604),
    WindowType.NUTTALL_CFD: (0.338946, -0.481973, 0.161054, -0.018027),
    WindowType.LAWREY_5TERM: (0.323215218, -0.471492057, 0.17553428, -0.02849699, 0.001261357),
    WindowType.LAWREY_6TERM: (0.29309794, -0.45394848, 0.20226297, -0.04801175, 0.00559536, -0.00019845),
    WindowType.BURGESS_OPTIMIZED_59DB: (0.392478, -0.47901, 0.1284),
    WindowType.BURGESS_OPTIMIZED_71DB: (0.4243801, -0.4973406, 0.0782793),
    WindowType.ALBRECHT_2TERM: (0.5, -0.5),
    WindowType.ALBRECHT_3TERM: (0.4243801, -0.4973406, 0.0782793),
    WindowType.ALBRECHT_4TERM: (0.3635819, -0.4891775, 0.1365995, -0.0106411),
    WindowType.ALBRECHT_5TERM: (0.323215218, -0.471492057, 0.17553428, -0.02849699, 0.001261357),
    WindowType.ALBRECHT_6TERM: (0.29309794, -0.45394848, 0.20226297, -0.04801175, 0.00559536, -0.00019845),
    WindowType.ALBRECHT_7TERM: (
        0.271220360, -0.433444612, 0.21800412, -0.065785343, 0.01164061, -0.00130752, 0.00006771),
    WindowType.ALBRECHT_8TERM: (
        0.2533178, -0.412242, 0.225257, -0.078915, 0.018104, -0.002758, 0.000254, -0.000009),
    WindowType.ALBRECHT_9TERM: (
        0.238289, -0.391879, 0.227211, -0.087655, 0.024601, -0.004791, 0.000654, -0.000059, 0.000002),
    WindowType.ALBRECHT_10TERM: (
        0.225585, -0.373067, 0.224900, -0.092907, 0.030477, -0.007189, 0.001238, -0.000149,
        0.000012, -0.0000005),
    WindowType.ALBRECHT_11TERM: (
        0.214736, -0.356168, 0.219839, -0.095537, 0.035363, -0.009749, 0.002004, -0.000311,
        0.000033, -0.000002, 0.00000008),
}


def bessel_i0(x):
    """Modified Bessel function I0, Abramowitz & Stegun 9.8.1/9.8.2 polynomial.

    Same approximation family the reference uses (`window.go:471-484`)
    so Kaiser windows match to ~1e-7 relative.
    """
    x = np.asarray(x, dtype=np.float64)
    ax = np.abs(x)
    # Small branch
    y_s = (x / 3.75) ** 2
    small = 1.0 + y_s * (3.5156229 + y_s * (3.0899424 + y_s * (
        1.2067492 + y_s * (0.2659732 + y_s * (0.0360768 + y_s * 0.0045813)))))
    # Large branch
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        y_l = 3.75 / np.where(ax > 0, ax, 1.0)
        large = (np.exp(ax) / np.sqrt(np.where(ax > 0, ax, 1.0))) * (
            0.39894228 + y_l * (0.01328592 + y_l * (0.00225319 + y_l * (
                -0.00157565 + y_l * (0.00916281 + y_l * (-0.02057706 + y_l * (
                    0.02635537 + y_l * (-0.01647633 + y_l * 0.00392377))))))))
    return np.where(ax < 3.75, small, large)


def _sinc(x):
    px = np.pi * np.asarray(x, dtype=np.float64)
    return np.where(x == 0, 1.0, np.sin(np.where(px == 0, 1.0, px)) / np.where(px == 0, 1.0, px))


def _cosine_sum(x, coeffs: Sequence[float]):
    phase = 2.0 * np.pi * x
    out = np.zeros_like(x)
    for k, c in enumerate(coeffs):
        out += c * np.cos(k * phase)
    return out


def _eval_window(wtype: WindowType, x: np.ndarray, alpha: float, bartlett: bool,
                 custom_coeffs: tuple[float, ...] | None) -> np.ndarray:
    coeffs = _COSINE_COEFFS.get(wtype)
    if coeffs is not None:
        return _cosine_sum(x, coeffs)
    if wtype == WindowType.RECTANGULAR:
        return np.ones_like(x)
    if wtype == WindowType.KAISER:
        if alpha <= 0:
            return np.ones_like(x)
        r = 2.0 * x - 1.0
        term = np.sqrt(np.maximum(0.0, 1.0 - r * r))
        return bessel_i0(alpha * term) / bessel_i0(alpha)
    if wtype == WindowType.TUKEY:
        if alpha <= 0:
            return np.ones_like(x)
        if alpha >= 1:
            return _cosine_sum(x, _COSINE_COEFFS[WindowType.HANN])
        a = alpha / 2.0
        left = 0.5 * (1.0 + np.cos(np.pi * (2.0 * x / alpha - 1.0)))
        right = 0.5 * (1.0 + np.cos(np.pi * (2.0 * x / alpha - 2.0 / alpha + 1.0)))
        return np.where(x < a, left, np.where(x <= 1.0 - a, 1.0, right))
    if wtype == WindowType.TRIANGLE:
        if bartlett:
            return 1.0 - np.abs(2.0 * x - 1.0)
        return np.where(x <= 0.5, 2.0 * x, 2.0 * (1.0 - x))
    if wtype == WindowType.COSINE:
        return np.sin(np.pi * x)
    if wtype == WindowType.WELCH:
        d = x - 0.5
        return 1.0 - 4.0 * d * d
    if wtype == WindowType.LANCZOS:
        return _sinc((2.0 * x - 1.0) * alpha)
    if wtype == WindowType.GAUSS:
        v = (2.0 * x - 1.0) * alpha
        return np.exp(-np.log(2.0) * v * v)
    if wtype == WindowType.FREE_COSINE:
        if not custom_coeffs:
            return np.ones_like(x)
        return _cosine_sum(x, custom_coeffs)
    return np.ones_like(x)


@lru_cache(maxsize=256)
def _generate_cached(wtype: WindowType, length: int, alpha: float, periodic: bool,
                     slope: Slope, dc_removal: bool, invert: bool, bartlett: bool,
                     custom_coeffs: tuple[float, ...] | None) -> np.ndarray:
    if length <= 0:
        return np.zeros((0,), dtype=np.float64)
    if length == 1:
        x = np.zeros((1,), dtype=np.float64)
    else:
        den = float(length) if periodic else float(length - 1)
        x = np.arange(length, dtype=np.float64) / den

    # Slope taper: left keeps the right half at 1, right keeps the left half
    # at 1 (window.go:326-335).
    xe = np.clip(x, 0.0, 1.0)
    out = _eval_window(wtype, xe, alpha, bartlett, custom_coeffs)
    if slope == Slope.LEFT:
        out = np.where(x >= 0.5, 1.0, out)
    elif slope == Slope.RIGHT:
        out = np.where(x <= 0.5, 1.0, out)

    if invert:
        out = 1.0 - out
    if dc_removal:
        out = out - out.mean()
    out.setflags(write=False)
    return out


def generate(wtype: WindowType, length: int, *, alpha: float = 1.0,
             periodic: bool = False, slope: Slope = Slope.SYMMETRIC,
             dc_removal: bool = False, invert: bool = False,
             bartlett: bool = False,
             custom_coeffs: Sequence[float] | None = None,
             dtype=None) -> np.ndarray:
    """Generate window coefficients (host-side float64 NumPy).

    Mirrors `window.Generate` (`dsp/window/window.go:140-162`). Results
    are cached per parameter set; pass a NumPy `dtype` to get a
    converted copy, or use `window_tensor` for a tensor on a device.
    """
    out = _generate_cached(*_key(wtype, length, alpha, periodic, slope,
                                 dc_removal, invert, bartlett, custom_coeffs))
    if dtype is not None:
        return out.astype(dtype)
    return out


def _key(wtype: WindowType, length: int, alpha: float, periodic: bool,
         slope: Slope, dc_removal: bool, invert: bool, bartlett: bool,
         custom_coeffs):
    if alpha < 0:
        alpha = 1.0
    cc = tuple(custom_coeffs) if custom_coeffs is not None else None
    return (wtype, int(length), float(alpha), bool(periodic), slope,
            bool(dc_removal), bool(invert), bool(bartlett), cc)


@lru_cache(maxsize=256)
def _tensor_cached(key, dtype: torch.dtype, device: torch.device):
    return torch.tensor(_generate_cached(*key), dtype=dtype, device=device)


def window_tensor(wtype: WindowType, length: int, dtype=torch.float32,
                  device=None, *, alpha: float = 1.0, periodic: bool = False,
                  slope: Slope = Slope.SYMMETRIC, dc_removal: bool = False,
                  invert: bool = False, bartlett: bool = False,
                  custom_coeffs: Sequence[float] | None = None) -> torch.Tensor:
    """The window of `generate` as a tensor of `dtype` on `device` (the
    CUDA card when None), made once per parameter set, type and device
    and then reused. Treat it as read-only: every caller gets the same
    tensor."""
    key = _key(wtype, length, alpha, periodic, slope, dc_removal, invert,
               bartlett, custom_coeffs)
    return _tensor_cached(key, dtype, resolve_device(device))


def apply(x, wtype: WindowType, **kwargs):
    """Multiply the last axis of x by the window, on x's device and in
    its type (`window.go:165-176`), pure and broadcasting over leading
    channel/batch dims."""
    return x * window_tensor(wtype, x.shape[-1], x.dtype, x.device, **kwargs)


def apply_coefficients(x, coeffs):
    """Multiply samples by precomputed coefficients (`window.go:261-270`)."""
    coeffs = torch.as_tensor(coeffs, dtype=x.dtype, device=x.device)
    if x.shape[-1] != coeffs.shape[-1]:
        raise ValueError(f"length mismatch: {x.shape[-1]} != {coeffs.shape[-1]}")
    return x * coeffs


def equivalent_noise_bandwidth(coeffs) -> float:
    """ENBW in bins: N * sum(w^2) / sum(w)^2 (`window.go:240-258`)."""
    if isinstance(coeffs, torch.Tensor):
        coeffs = coeffs.detach().to("cpu", torch.float64).numpy()
    c = np.asarray(coeffs, dtype=np.float64)
    if c.size == 0:
        raise ValueError("empty coefficients")
    s = c.sum()
    if s == 0:
        raise ValueError("zero coherent gain")
    return float(c.size * (c * c).sum() / (s * s))
