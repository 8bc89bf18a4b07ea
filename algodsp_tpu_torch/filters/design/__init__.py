"""Host-side float64 filter designers (copies of `algodsp_tpu.filters.design`).

Only the RBJ and LP/HP cascade designers are ported; the elliptic, band,
shelving and Orfanidis designers are queued in ROADMAP.md.
"""

from algodsp_tpu_torch.filters.design.rbj import (
    bilinear_transform,
    lowpass,
    highpass,
    bandpass,
    notch,
    allpass,
    peak,
    low_shelf,
    high_shelf,
    DEFAULT_Q,
)
from algodsp_tpu_torch.filters.design.cascades import (
    butterworth_lp,
    butterworth_hp,
    chebyshev1_lp,
    chebyshev1_hp,
    chebyshev2_lp,
    chebyshev2_hp,
    bessel_lp,
    bessel_hp,
    linkwitz_riley_lp,
    linkwitz_riley_hp,
    linkwitz_riley_hp_inverted,
    linkwitz_riley_needs_hp_invert,
)

__all__ = [
    "DEFAULT_Q",
    "allpass",
    "bandpass",
    "bessel_hp",
    "bessel_lp",
    "bilinear_transform",
    "butterworth_hp",
    "butterworth_lp",
    "chebyshev1_hp",
    "chebyshev1_lp",
    "chebyshev2_hp",
    "chebyshev2_lp",
    "high_shelf",
    "highpass",
    "linkwitz_riley_hp",
    "linkwitz_riley_hp_inverted",
    "linkwitz_riley_lp",
    "linkwitz_riley_needs_hp_invert",
    "low_shelf",
    "lowpass",
    "notch",
    "peak",
]
