"""The port's EQ designers (elliptic, band, shelving, Orfanidis) and the
chain's `build_eq_sos` against the JAX package's: float64 SOS must be
bit-identical (they are copies, so any difference is a copying fault),
and a parameter set that one side refuses the other must refuse with
the same error type name and message, over a small grid."""

import numpy as np
import pytest

from algodsp_tpu.chain import params as jp
from algodsp_tpu.filters import design as jd
from algodsp_tpu_torch.chain import params as tp
from algodsp_tpu_torch.filters import design as td

SR = 48000.0


def _outcome(fn, *args, **kw):
    try:
        out = fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 - compared by name and text
        return ("raise", type(e).__name__, str(e))
    if isinstance(out, tuple):
        return tuple(None if o is None else np.asarray(o).tobytes()
                     for o in out)
    return None if out is None else np.asarray(out).tobytes()


def _same(name_j, name_t, *args, **kw):
    assert _outcome(name_j, *args, **kw) == _outcome(name_t, *args, **kw), \
        (name_t, args, kw)


@pytest.mark.parametrize("name", ["elliptic_lp", "elliptic_hp"])
def test_elliptic_bit_identical(name):
    for order in (0, 1, 2, 3, 4, 7, 10):
        for f in (60.0, 2000.0, 15000.0, 0.0, 24000.0):
            for ripple in (0.1, 0.5, 3.0):
                for stop in (40.0, 80.0):
                    _same(getattr(jd, name), getattr(td, name),
                          f, order, ripple, stop, SR)


@pytest.mark.parametrize("name", ["butterworth_band", "chebyshev1_band",
                                  "chebyshev2_band", "elliptic_band"])
def test_band_bit_identical(name):
    for order in (2, 4, 6, 8, 5):
        for f0, bw in ((1000.0, 200.0), (3000.0, 8.0), (60.0, 40.0),
                       (20000.0, 6000.0), (30000.0, 100.0)):
            for gain in (-12.0, 0.0, 6.0):
                _same(getattr(jd, name), getattr(td, name),
                      SR, f0, bw, gain, order)


@pytest.mark.parametrize("name", ["butterworth_low_shelf",
                                  "butterworth_high_shelf"])
def test_butterworth_shelf_bit_identical(name):
    for order in (0, 1, 2, 3, 6):
        for f in (100.0, 3000.0, 30000.0):
            for gain in (-9.0, 0.0, 4.0):
                _same(getattr(jd, name), getattr(td, name),
                      SR, f, gain, order)


@pytest.mark.parametrize("name", ["chebyshev1_low_shelf",
                                  "chebyshev1_high_shelf",
                                  "chebyshev2_low_shelf",
                                  "chebyshev2_high_shelf"])
def test_chebyshev_shelf_bit_identical(name):
    for order in (1, 2, 4, 5):
        for f in (100.0, 3000.0):
            for gain in (-9.0, 6.0, 12.0):
                for ripple in (0.0, 0.5, 3.0, 8.0):
                    _same(getattr(jd, name), getattr(td, name),
                          SR, f, gain, ripple, order)


def test_orfanidis_bit_identical():
    for f in (50.0, 1000.0, 12000.0):
        for gain in (-12.0, 6.0, 0.0):
            for q in (0.5, 2.0):
                for kw in ({"dc_gain_db": 0.0}, {"nyquist_gain_db": -1.0},
                           {"band_edge_gain_db": 3.0},
                           {"dc_gain_db": 1.0, "nyquist_gain_db": 0.5}):
                    _same(jd.peak_orfanidis, td.peak_orfanidis,
                          f, gain, q, SR, **kw)
                    _same(jd.peak, td.peak, f, gain, q, SR, **kw)
                _same(jd.peak_cascade, td.peak_cascade, SR, f, q, gain, 3)
    for args in ((1.0, 1.0, 2.0, 1.4, 0.5, 0.2), (1.0, 0.9, 0.5, 0.7, 2.0, 0.4),
                 (-1.0, 1.0, 2.0, 1.4, 0.5, 0.2), (1.0, 1.0, 2.0, 1.4, 4.0, 0.2)):
        _same(jd.peak_raw, td.peak_raw, *args)


@pytest.mark.parametrize("family", jp.FAMILIES)
def test_build_eq_sos_every_kind_bit_identical(family):
    # an unknown family falls back to RBJ; it rides with the RBJ case
    for kind in jp.KINDS + (("bell", "unknown-kind") if family == "rbj" else ()):
        for order in (0, 2, 4, 7):
            for f, gain, q in ((1000.0, 6.0, 0.707), (80.0, -9.0, 4.0),
                               (15000.0, 3.0, 0.2)):
                for fam in (family, "unknown") if family == "rbj" else (family,):
                    _same(jp.build_eq_sos, tp.build_eq_sos,
                          fam, kind, order, f, gain, q, SR)
