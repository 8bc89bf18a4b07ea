"""Static window metadata (ENBW, sidelobe, coherent gain); counterpart of
`algodsp_tpu/window/metadata.py`, host-side.

Parity with `dsp/window/metadata.go:5-139`. Types without published
metadata (Lawrey/Burgess/Albrecht families) return an empty Metadata,
matching `window.Info` (`window.go:179-185`); use `window.analyze` for
numeric properties of any window.
"""

from __future__ import annotations

import dataclasses
import math

from algodsp_tpu_torch.window.window import WindowType


@dataclasses.dataclass(frozen=True)
class Metadata:
    name: str = ""
    enbw: float = 0.0
    highest_sidelobe: float = 0.0
    coherent_gain: float = 0.0
    coherent_gain_squared: float = 0.0


_TWO_OVER_PI = 2.0 / math.pi

_METADATA: dict[WindowType, Metadata] = {
    WindowType.RECTANGULAR: Metadata("Rectangular", 1.000, -13.3, 1.0, 1.0),
    WindowType.HANN: Metadata("Hann", 1.500, -31.5, 0.5, 0.25),
    WindowType.HAMMING: Metadata("Hamming", 1.363, -42.7, 0.54, 0.2916),
    WindowType.BLACKMAN: Metadata("Blackman", 1.727, -58.1, 0.42, 0.1764),
    WindowType.BLACKMAN_HARRIS_4TERM: Metadata(
        "Blackman-Harris 4T", 2.004, -92.0, 0.35875, 0.1287015625),
    WindowType.FLAT_TOP: Metadata(
        "FlatTop", 3.770, -93.0, 0.21557895, 0.046474285619102495),
    WindowType.KAISER: Metadata("Kaiser", 1.7218, -63.24, 0.420698, 0.176986807204),
    WindowType.TUKEY: Metadata("Tukey", 1.2225, -15.12, 0.749817, 0.562225535489),
    WindowType.TRIANGLE: Metadata("Triangle", 1.333, -26.5, 0.5, 0.25),
    WindowType.COSINE: Metadata(
        "Cosine", 1.233, -23.0, _TWO_OVER_PI, _TWO_OVER_PI * _TWO_OVER_PI),
    WindowType.WELCH: Metadata("Welch", 1.200, -21.3, 2.0 / 3.0, 4.0 / 9.0),
    WindowType.LANCZOS: Metadata("Lanczos", 1.2994, -26.41, 0.589346, 0.347328712516),
    WindowType.GAUSS: Metadata("Gauss", 1.6719, -54.70, 0.424305, 0.180034732025),
    WindowType.EXACT_BLACKMAN: Metadata(
        "Exact Blackman", 1.693, -68.2, 0.42659, 0.1819780281),
    WindowType.BLACKMAN_HARRIS_3TERM: Metadata(
        "Blackman-Harris 3T", 1.708, -70.9, 0.42323, 0.1791236329),
    WindowType.BLACKMAN_NUTTALL: Metadata(
        "Blackman-Nuttall", 1.976, -98.2, 0.3635819, 0.13219279958161),
    WindowType.NUTTALL_CTD: Metadata(
        "Nuttall CTD", 1.976, -98.1, 0.355768, 0.126570879824),
    WindowType.NUTTALL_CFD: Metadata(
        "Nuttall CFD", 2.021, -93.3, 0.338946, 0.114885391716),
    WindowType.FREE_COSINE: Metadata(
        "Free Cosine", math.nan, math.nan, math.nan, math.nan),
}


def info(wtype: WindowType) -> Metadata:
    """Return static metadata for a window type (`window.go:179-185`)."""
    return _METADATA.get(wtype, Metadata())
