"""Effect-chain parameter normalization.

Capability parity with `dsp/effectchain/params.go` + `normalize.go` and
the webdemo EQ designer (`internal/webdemo/eq.go:91-302`): NaN/Inf-safe
numeric extraction with reference clamps, string-enum normalization
(filter family/kind, distortion mode, dynamics topology/detector,
de-esser mode, spectral-freeze phase mode, transformer quality), and
the full family×kind EQ-chain design (Butterworth/Chebyshev/Bessel/
elliptic cascades, band-EQ, shelving — with the reference's shape-mode
reinterpretation of `q` as ripple-dB or bandwidth where applicable).

Graph JSONs written for the reference load unmodified: its param names
are primary; this framework's round-1 names stay as aliases.

Counterpart of `algodsp_tpu/chain/params.py`, identical to it except
that the distortion-mode and Chebyshev-harmonic normalizers wait with
their node types (ROADMAP.md).
"""

from __future__ import annotations

import math

import numpy as np

FAMILY_RBJ = "rbj"
FAMILY_BUTTERWORTH = "butterworth"
FAMILY_BESSEL = "bessel"
FAMILY_CHEBYSHEV1 = "chebyshev1"
FAMILY_CHEBYSHEV2 = "chebyshev2"
FAMILY_ELLIPTIC = "elliptic"
FAMILY_MOOG = "moog"
FAMILIES = (FAMILY_RBJ, FAMILY_BUTTERWORTH, FAMILY_BESSEL,
            FAMILY_CHEBYSHEV1, FAMILY_CHEBYSHEV2, FAMILY_ELLIPTIC,
            FAMILY_MOOG)

KINDS = ("highpass", "lowpass", "bandpass", "notch", "allpass", "peak",
         "highshelf", "lowshelf")

EQ_DEFAULT_ORDER = 2            # webdemo/engine.go:24
EQ_ELLIPTIC_STOPBAND_DB = 40.0  # webdemo/eq.go:14


def clamp(v: float, lo: float, hi: float) -> float:
    return lo if v < lo else hi if v > hi else v


def get_num(p: dict, key: str, default: float, lo: float | None = None,
            hi: float | None = None, aliases: tuple[str, ...] = ()) -> float:
    """NaN/Inf/type-safe numeric param with optional clamp
    (`params.go:14-26` GetNum + the runtimes' core.Clamp calls)."""
    v = None
    for k in (key, *aliases):
        if k in p:
            v = p[k]
            break
    try:
        v = float(v)
    except (TypeError, ValueError):
        v = float(default)
    if math.isnan(v) or math.isinf(v):
        v = float(default)
    if lo is not None:
        v = max(v, lo)
    if hi is not None:
        v = min(v, hi)
    return v


def get_int(p: dict, key: str, default: float, lo: int, hi: int,
            aliases: tuple[str, ...] = ()) -> int:
    """round + min/max clamp, the runtimes' int param idiom."""
    return int(clamp(round(get_num(p, key, default, aliases=aliases)), lo, hi))


def get_str(p: dict, key: str, default: str = "",
            aliases: tuple[str, ...] = ()) -> str:
    for k in (key, *aliases):
        v = p.get(k)
        if isinstance(v, str):
            return v
    return default


def get_bool(p: dict, key: str, default: float = 0.0,
             aliases: tuple[str, ...] = ()) -> bool:
    """Reference truthiness: numeric >= 0.5 (`runtime_dynamics.go:307`);
    also accepts JSON booleans."""
    for k in (key, *aliases):
        if k in p:
            v = p[k]
            if isinstance(v, bool):
                return v
            break
    return get_num(p, key, default, aliases=aliases) >= 0.5


# -- string-enum normalization (`normalize.go`) -----------------------------

def normalize_filter_family(raw: str, node_type: str) -> str:
    """`normalize.go:24-41`."""
    if node_type == "filter-moog":
        return FAMILY_MOOG
    family = raw.strip().lower()
    if family in FAMILIES:
        return family
    return FAMILY_RBJ


def normalize_eq_kind(kind: str) -> str:
    """`normalize.go:74-88` normalizeEQTypeForChain."""
    k = kind.strip().lower()
    if k in ("bandeq", "band-eq", "bandeqpeak", "bell", "bandbell"):
        k = "peak"
    return k if k in KINDS else "peak"


def normalize_filter_kind(node_type: str, raw: str) -> str:
    """`normalize.go:43-71`."""
    if node_type == "filter-moog":
        return "lowpass"
    if raw.strip():
        return normalize_eq_kind(raw)
    return {
        "filter-highpass": "highpass",
        "filter-bandpass": "bandpass",
        "filter-notch": "notch",
        "filter-allpass": "allpass",
        "filter-peak": "peak",
        "filter-lowshelf": "lowshelf",
        "filter-highshelf": "highshelf",
    }.get(node_type, "lowpass")


def moog_oversampling_from_order(order: int) -> int:
    """`normalize.go:90-101`."""
    if order >= 12:
        return 8
    if order >= 8:
        return 4
    if order >= 4:
        return 2
    return 1


def normalize_dynamics_topology(raw: str) -> str:
    """`normalize.go:186-194`: 'feedback' else 'feedforward'."""
    return "feedback" if raw.strip().lower() == "feedback" else "feedforward"


def normalize_dynamics_detector(raw: str) -> str:
    """`normalize.go:197-204`: 'rms' else 'peak'."""
    return "rms" if raw.strip().lower() == "rms" else "peak"


def normalize_deesser_mode(raw: str) -> str:
    """`normalize.go:207-214`: 'wideband' else 'splitband'."""
    return "wideband" if raw.strip().lower() == "wideband" else "splitband"


def normalize_deesser_detector(raw: str) -> str:
    """`normalize.go:217-226`: 'highpass' else 'bandpass'."""
    return "highpass" if raw.strip().lower() == "highpass" else "bandpass"


def normalize_freeze_phase_mode(raw: str) -> str:
    """`normalize.go:175-183`: 'hold' else 'advance'."""
    return "hold" if raw.strip().lower() == "hold" else "advance"


def normalize_transformer_quality(raw: str) -> str:
    """`normalize.go:163-172`: 'lightweight' else 'high'."""
    return "lightweight" if raw.strip().lower() == "lightweight" else "high"


# -- EQ chain design (`webdemo/eq.go:91-302`) ------------------------------

def _supports_family(kind: str, family: str) -> bool:
    if family == FAMILY_RBJ:
        return True
    if family == FAMILY_BESSEL:
        return kind in ("highpass", "lowpass")
    if family in (FAMILY_BUTTERWORTH, FAMILY_CHEBYSHEV1, FAMILY_CHEBYSHEV2):
        return kind in ("highpass", "lowpass", "peak", "lowshelf", "highshelf")
    if family == FAMILY_ELLIPTIC:
        return kind in ("highpass", "lowpass", "peak")
    return False


def normalize_family_for_kind(kind: str, family: str) -> str:
    return family if _supports_family(kind, family) else FAMILY_RBJ


def normalize_eq_order(kind: str, family: str, order: int) -> int:
    """`eq.go:354-379`."""
    if family == FAMILY_RBJ or not _supports_family(kind, family):
        return 1
    if family == FAMILY_BESSEL and kind not in ("highpass", "lowpass"):
        return 1
    if order <= 0:
        order = EQ_DEFAULT_ORDER
    max_order = 10 if family == FAMILY_BESSEL else 12
    if kind == "peak":
        order = int(clamp(order, 4, max_order))
        if order % 2:
            order += 1
        return order
    return int(clamp(order, 1, max_order))


def _shape_mode(kind: str, family: str) -> str:
    """`eq.go:252-266`."""
    if kind == "peak" and family != FAMILY_RBJ:
        return "bandwidth"
    if family in (FAMILY_CHEBYSHEV1, FAMILY_CHEBYSHEV2) and \
            kind in ("highpass", "lowpass", "highshelf", "lowshelf"):
        return "ripple"
    if family == FAMILY_ELLIPTIC and kind in ("highpass", "lowpass"):
        return "ripple"
    return "q"


def _max_peak_bandwidth(freq: float, sample_rate: float) -> float:
    nyq = sample_rate * 0.5
    return max(2 * min(max(freq, 1.0), max(nyq - freq, 1.0)), 1.0)


def clamp_eq_shape(kind: str, family: str, freq: float, sample_rate: float,
                   value: float) -> float:
    """`eq.go:279-293`."""
    mode = _shape_mode(kind, family)
    if mode == "bandwidth":
        return clamp(value, 1.0, _max_peak_bandwidth(freq, sample_rate))
    if mode == "ripple":
        hi = 24.0 if family == FAMILY_CHEBYSHEV2 else 12.0
        return clamp(value, 0.05, hi)
    return clamp(value, 0.2, 8.0)


def _peak_bandwidth_hz(kind, family, freq, sample_rate, shape) -> float:
    if _shape_mode(kind, family) == "bandwidth":
        return clamp(shape, 1.0, _max_peak_bandwidth(freq, sample_rate))
    return clamp(freq / max(shape, 1e-6), 1.0,
                 _max_peak_bandwidth(freq, sample_rate))


def _rbj_q_from_shape(kind, family, freq, shape) -> float:
    if _shape_mode(kind, family) == "bandwidth":
        return clamp(freq / max(shape, 1e-6), 0.2, 8.0)
    return clamp(shape, 0.2, 8.0)


def build_eq_sos(family: str, kind: str, order: int, freq: float,
                 gain_db: float, q: float,
                 sample_rate: float) -> tuple[np.ndarray, float]:
    """(sos (S,5), linear gain) mirror of `buildEQChain` (eq.go:91-211):
    cascade designers per family/kind, RBJ fallback; `q` reinterpreted
    as Chebyshev ripple / band bandwidth per shape mode."""
    from algodsp_tpu_torch.filters.design import rbj, cascades, band, shelving
    from algodsp_tpu_torch.filters.design.elliptic import elliptic_lp, elliptic_hp

    family = normalize_family_for_kind(kind, family if family in FAMILIES
                                       else FAMILY_RBJ)
    order = normalize_eq_order(kind, family, order)
    q = clamp_eq_shape(kind, family, freq, sample_rate, q)
    embedded = (kind in ("peak", "lowshelf", "highshelf")
                or (kind == "bandpass" and family != FAMILY_RBJ))
    lin_gain = 1.0 if embedded else 10.0 ** (gain_db / 20.0)
    ripple = clamp(q, 0.05, 24.0)

    def _done(sos):
        if sos is None or len(np.atleast_2d(sos)) == 0:
            return None
        return np.atleast_2d(np.asarray(sos, dtype=np.float64)), lin_gain

    out = None
    if family == FAMILY_BUTTERWORTH:
        if kind == "highpass":
            out = _done(cascades.butterworth_hp(freq, order, sample_rate))
        elif kind == "lowpass":
            out = _done(cascades.butterworth_lp(freq, order, sample_rate))
        elif kind == "peak":
            bw = _peak_bandwidth_hz(kind, family, freq, sample_rate, q)
            out = _done(band.butterworth_band(sample_rate, freq, bw,
                                              gain_db, order))
        elif kind == "highshelf":
            out = _done(shelving.butterworth_high_shelf(sample_rate, freq,
                                                        gain_db, order))
        elif kind == "lowshelf":
            out = _done(shelving.butterworth_low_shelf(sample_rate, freq,
                                                       gain_db, order))
    elif family == FAMILY_CHEBYSHEV1:
        if kind == "highpass":
            out = _done(cascades.chebyshev1_hp(freq, order, ripple, sample_rate))
        elif kind == "lowpass":
            out = _done(cascades.chebyshev1_lp(freq, order, ripple, sample_rate))
        elif kind == "peak":
            bw = _peak_bandwidth_hz(kind, family, freq, sample_rate, q)
            out = _done(band.chebyshev1_band(sample_rate, freq, bw,
                                             gain_db, order))
        elif kind == "highshelf":
            out = _done(shelving.chebyshev1_high_shelf(sample_rate, freq,
                                                       gain_db, ripple, order))
        elif kind == "lowshelf":
            out = _done(shelving.chebyshev1_low_shelf(sample_rate, freq,
                                                      gain_db, ripple, order))
    elif family == FAMILY_CHEBYSHEV2:
        if kind == "highpass":
            out = _done(cascades.chebyshev2_hp(freq, order, ripple, sample_rate))
        elif kind == "lowpass":
            out = _done(cascades.chebyshev2_lp(freq, order, ripple, sample_rate))
        elif kind == "peak":
            bw = _peak_bandwidth_hz(kind, family, freq, sample_rate, q)
            out = _done(band.chebyshev2_band(sample_rate, freq, bw,
                                             gain_db, order))
        elif kind == "highshelf":
            out = _done(shelving.chebyshev2_high_shelf(sample_rate, freq,
                                                       gain_db, ripple, order))
        elif kind == "lowshelf":
            out = _done(shelving.chebyshev2_low_shelf(sample_rate, freq,
                                                      gain_db, ripple, order))
    elif family == FAMILY_BESSEL:
        if kind == "highpass":
            out = _done(cascades.bessel_hp(freq, order, sample_rate))
        elif kind == "lowpass":
            out = _done(cascades.bessel_lp(freq, order, sample_rate))
    elif family == FAMILY_ELLIPTIC:
        if kind == "highpass":
            out = _done(elliptic_hp(freq, order, ripple,
                                    EQ_ELLIPTIC_STOPBAND_DB, sample_rate))
        elif kind == "lowpass":
            out = _done(elliptic_lp(freq, order, ripple,
                                    EQ_ELLIPTIC_STOPBAND_DB, sample_rate))
        elif kind == "peak":
            bw = _peak_bandwidth_hz(kind, family, freq, sample_rate, q)
            out = _done(band.elliptic_band(sample_rate, freq, bw,
                                           gain_db, order))
    if out is not None:
        return out

    # RBJ fallback (eq.go:196-211)
    if kind == "highpass":
        sos = rbj.highpass(freq, q, sample_rate)
    elif kind == "bandpass":
        sos = rbj.bandpass(freq, q, sample_rate)
    elif kind == "notch":
        sos = rbj.notch(freq, q, sample_rate)
    elif kind == "allpass":
        sos = rbj.allpass(freq, q, sample_rate)
    elif kind == "peak":
        sos = rbj.peak(freq, gain_db,
                       _rbj_q_from_shape(kind, family, freq, q), sample_rate)
    elif kind == "highshelf":
        sos = rbj.high_shelf(freq, gain_db, q, sample_rate)
    elif kind == "lowshelf":
        sos = rbj.low_shelf(freq, gain_db, q, sample_rate)
    else:
        sos = rbj.lowpass(freq, q, sample_rate)
    sos = np.atleast_2d(np.asarray(sos, dtype=np.float64))
    if not np.any(sos):
        sos = np.array([[1.0, 0.0, 0.0, 0.0, 0.0]])
    return sos, lin_gain
