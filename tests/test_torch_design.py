"""The port's filter designers against the JAX package's: float64 SOS
must be bit-identical (the designers are copies, so any difference is a
copying fault), over a small grid of valid and invalid parameters.

Families are grouped into few test functions on purpose: pytest-xdist
with `--dist loadfile` hands whole files to its workers in order of
their test counts, and a file with fewer tests than
tests/test_parallel.py (by far the longest file) leaves that file's
place in the queue, and so the suite's wall time, unchanged."""

import tests.torch_port_setup  # noqa: F401  (first: one PyTorch thread)

import numpy as np
import pytest

from algodsp_tpu.filters import design as jd
from algodsp_tpu.filters import weighting as jw
from algodsp_tpu_torch.filters import design as td
from algodsp_tpu_torch.filters import weighting as tw

SR = 48000.0
FREQS = (20.0, 1000.0, 12000.0, 23999.0, 0.0, 30000.0)


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", ["lowpass", "highpass", "bandpass", "notch",
                                  "allpass", "peak", "low_shelf", "high_shelf"])
def test_rbj_bit_identical(name):
    with_gain = name in ("peak", "low_shelf", "high_shelf")
    for f in FREQS:
        for q in (0.5, 0.7071, 4.0, 0.0, -1.0):
            for g in ((-12.0, 0.0, 6.0) if with_gain else (None,)):
                args = (f, g, q, SR) if with_gain else (f, q, SR)
                assert _same(getattr(jd, name)(*args),
                             getattr(td, name)(*args)), args


def test_bilinear_lr_flag_and_orfanidis_boundary():
    for s in ([1.0, 2.0, 3.0], [0.0, 1.0, 1e4], [1e-3, 0.5, 7.0]):
        for sr in (SR, 44100.0, 0.0):
            assert _same(jd.bilinear_transform(s, sr), td.bilinear_transform(s, sr))
    for order in range(0, 12):
        assert (jd.linkwitz_riley_needs_hp_invert(order)
                == td.linkwitz_riley_needs_hp_invert(order))
    assert _same(jd.peak(1000.0, 6.0, 1.0, SR, dc_gain_db=0.0),
                 td.peak(1000.0, 6.0, 1.0, SR, dc_gain_db=0.0))


@pytest.mark.parametrize("name", ["butterworth_lp", "butterworth_hp",
                                  "bessel_lp", "bessel_hp",
                                  "linkwitz_riley_lp", "linkwitz_riley_hp",
                                  "linkwitz_riley_hp_inverted"])
def test_cascade_bit_identical(name):
    for order in range(0, 12):
        for f in (60.0, 2000.0, 15000.0, 0.0, 24000.0):
            assert _same(getattr(jd, name)(f, order, SR),
                         getattr(td, name)(f, order, SR)), (order, f)


def test_chebyshev_bit_identical():
    for name in ("chebyshev1_lp", "chebyshev1_hp", "chebyshev2_lp", "chebyshev2_hp"):
        for order in range(0, 11):
            for f in (60.0, 2000.0, 15000.0, 24000.0):
                for ripple in (0.5, 1.0, 3.0, 0.0, 40.0):
                    assert _same(getattr(jd, name)(f, order, ripple, SR),
                                 getattr(td, name)(f, order, ripple, SR)), \
                        (name, order, f, ripple)


def test_weighting_bit_identical():
    for kind in ("A", "B", "C", "Z"):
        for sr in (44100.0, SR, 96000.0):
            js = jw.weighting_sos(jw.WeightingType[kind], sr)
            ts = tw.weighting_sos(tw.WeightingType[kind], sr)
            assert np.array_equal(js, ts)
            jc = jw.weighting_chain(jw.WeightingType[kind], sr)
            tc = tw.weighting_chain(tw.WeightingType[kind], sr)
            assert jc.gain == tc.gain
            assert np.array_equal(jc.runtime_sos, tc.runtime_sos)
