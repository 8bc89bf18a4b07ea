"""The rest of the port's conv package against the JAX package on the CPU:
`direct`, `direct_circular`, `convolve` (both sides of FFT_THRESHOLD),
`OverlapSave` / `OverlapAdd` one-shot and streamed, the one-shot
conveniences, the correlate family and `deconvolve` by its three methods,
`inverse_filter` and `snr`; and the cuDNN pin `direct` runs under.

Tolerances: float64 >= 200 dB (or 1e-12), as tests/test_conv.py holds the
JAX package to NumPy in float64; float32 against JAX float64 no more than
6 dB below JAX float32's own SNR (the reference's float32 class;
tests/test_conv.py has no float32 bar), except `direct` with a kernel of 256 taps or more: there
the CPU's `conv1d` sums its m products in float32 in order where XLA
sums in a tree (127-130 dB against XLA's 138-140 at 300-1500 taps), so
the bar is the float32 dot-product bound, -20 log10(2^-24 sqrt(m)) dB.
Peak indices and lags exact.
"""

import tests.torch_port_setup  # noqa: F401  (first: one PyTorch thread)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algodsp_tpu import conv as J
from algodsp_tpu_torch import conv as T
from algodsp_tpu_torch.ops.linrec import full_float32_conv
from tests.conftest import snr_db

rng = np.random.default_rng(20)
X = rng.standard_normal((3, 700))


def _jax(jfn, args, dtype):
    """JAX's output, its arguments in `dtype`."""
    return np.asarray(jfn(*[jnp.asarray(a.astype(dtype)) if isinstance(a, np.ndarray)
                            else a for a in args]))


def _port(tfn, args, dtype):
    """The port's output, its arguments in `dtype`."""
    t = tfn(*[torch.as_tensor(a.astype(dtype)) if isinstance(a, np.ndarray) else a
              for a in args])
    return t.numpy() if torch.is_tensor(t) else t


def _holds(jfn, tfn, *args, long_taps=0):
    """JAX's float64 output, computed once, against the port's in float64
    (>= 200 dB) and float32 (the bar of the module docstring; JAX's
    float32 output only where the bar reads it)."""
    j64 = _jax(jfn, args, "float64")
    t64 = _port(tfn, args, "float64")
    assert t64.shape == j64.shape and t64.dtype == np.float64
    assert snr_db(j64, t64) >= 200
    t32 = _port(tfn, args, "float32")
    assert t32.dtype == np.float32
    bar = (-20.0 * np.log10(2.0 ** -24 * np.sqrt(long_taps)) if long_taps >= 256
           else snr_db(j64, _jax(jfn, args, "float32")) - 6.0)
    assert snr_db(j64, t32) >= bar


@pytest.mark.parametrize("m", [7, 31, 32, 45])
def test_direct_and_convolve_match_jax(m):
    """Both sides of FFT_THRESHOLD: convolve picks direct below 32 taps."""
    h = rng.standard_normal(m)
    for mode in ("full", "same", "valid"):
        _holds(lambda a, b: J.direct(a, b, mode), lambda a, b: T.direct(a, b, mode),
               X, h)
        _holds(lambda a, b: J.convolve(a, b, mode),
               lambda a, b: T.convolve(a, b, mode), X, h)
    assert T.FFT_THRESHOLD == J.FFT_THRESHOLD == 32


def test_direct_circular_matches_jax():
    for m in (5, 700, 1500):                  # shorter, as long, wraps twice
        _holds(J.direct_circular, T.direct_circular, X, rng.standard_normal(m),
               long_taps=m)
    with pytest.raises(ValueError, match="empty"):
        T.direct(torch.zeros(3, 0), np.ones(3))


def test_overlap_save_one_shot_and_streamed():
    h = rng.standard_normal(100)
    _holds(lambda a: J.OverlapSave(h).process(a),
           lambda a: T.OverlapSave(h).process(a), X)
    _holds(lambda a: J.OverlapSave(h, 512).process(a),
           lambda a: T.OverlapSave(h, 512).process(a), X)
    cuts = [0, 1, 90, 333, 700]                 # ragged blocks, state carried
    js, ts = J.OverlapSave(h, 256), T.OverlapSave(h, 256)
    sj, st = js.init_state((3,), jnp.float64), ts.init_state((3,), torch.float64, "cpu")
    yj, yt = [], []
    for a, b in zip(cuts[:-1], cuts[1:]):
        sj, y1 = js.process_stream(sj, jnp.asarray(X[:, a:b]))
        st, y2 = ts.process_stream(st, torch.as_tensor(X[:, a:b]))
        yj.append(np.asarray(y1))
        yt.append(y2.numpy())
    assert snr_db(np.concatenate(yj, -1), np.concatenate(yt, -1)) >= 200
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-12)


def test_overlap_add_one_shot_and_streamed():
    x = X[:, :640]
    for m in (20, 100, 300):                    # tails under, over one block
        h = rng.standard_normal(m)
        _holds(lambda a: J.OverlapAdd(h, 64).process(a),
               lambda a: T.OverlapAdd(h, 64).process(a), x)
    h = rng.standard_normal(150)
    ja, ta = J.OverlapAdd(h, 64), T.OverlapAdd(h, 64)
    sj, st = ja.init_state((3,), jnp.float64), ta.init_state((3,), torch.float64, "cpu")
    yj, yt = [], []
    for a, b in ((0, 64), (64, 320), (320, 640)):
        sj, y1 = ja.process_stream(sj, jnp.asarray(x[:, a:b]))
        st, y2 = ta.process_stream(st, torch.as_tensor(x[:, a:b]))
        yj.append(np.asarray(y1))
        yt.append(y2.numpy())
    assert snr_db(np.concatenate(yj, -1), np.concatenate(yt, -1)) >= 200
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-12)
    with pytest.raises(ValueError, match="multiple of block"):
        ta.process_stream(st, torch.zeros(3, 65, dtype=torch.float64))
    with pytest.raises(ValueError, match="power of two"):
        T.OverlapSave(h, 100)
    with pytest.raises(ValueError, match="block size"):
        T.OverlapAdd(h, 0)


def test_overlap_conveniences_and_spectrum_cache():
    h = rng.standard_normal(77)
    _holds(lambda a: J.overlap_add_convolve(a, h), lambda a: T.overlap_add_convolve(a, h), X)
    _holds(lambda a: J.overlap_save_convolve(a, h), lambda a: T.overlap_save_convolve(a, h), X)
    _holds(lambda a: J.overlap_save_convolve(a, h, 1024),
           lambda a: T.overlap_save_convolve(a, h, 1024), X)
    from algodsp_tpu_torch.conv import overlap
    cached = overlap._ols_cached(np.asarray(h, np.float64).tobytes(), None)
    assert cached is overlap._ols_cached(np.asarray(h, np.float64).tobytes(), None)
    T.overlap_save_convolve(torch.as_tensor(X), h)
    spec = cached._kfft_on[(torch.device("cpu"), torch.complex128)]
    T.overlap_save_convolve(torch.as_tensor(X), torch.as_tensor(h))
    assert cached._kfft_on[(torch.device("cpu"), torch.complex128)] is spec


def test_correlate_family_matches_jax():
    for m in (9, 40):                           # direct and FFT
        b = rng.standard_normal(m)
        for name in ("correlate", "correlate_direct", "correlate_fft",
                     "correlate_normalized"):
            _holds(getattr(J, name), getattr(T, name), X, b)
    _holds(J.auto_correlate, T.auto_correlate, X)
    _holds(J.auto_correlate_normalized, T.auto_correlate_normalized, X)
    ac = T.auto_correlate_normalized(torch.as_tensor(X)).numpy()
    np.testing.assert_allclose(ac[:, 699], 1.0, atol=1e-12)


def test_find_peak_and_lags_exact():
    tmpl = rng.standard_normal(64)
    lags = np.array([30, 200, 512])
    x = X.copy() * 0.1
    for c, lag in enumerate(lags):
        x[c, lag:lag + 64] += tmpl
    corr_t = T.correlate(torch.as_tensor(x), tmpl)
    corr_j = J.correlate(jnp.asarray(x), tmpl)
    idx_t, val_t = T.find_peak(corr_t)
    idx_j, val_j = J.find_peak(corr_j)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(val_t.numpy(), np.asarray(val_j), rtol=1e-12)
    lag_t = T.lag_from_index(idx_t, 64)
    assert torch.is_tensor(lag_t)
    np.testing.assert_array_equal(lag_t.numpy(), lags)
    assert T.lag_from_index(100, 64) == J.lag_from_index(100, 64) == 37
    assert T.index_from_lag(37, 64) == J.index_from_lag(37, 64) == 100
    assert type(T.lag_from_index(100, 64)) is int


@pytest.mark.parametrize("method", ["naive", "regularized", "wiener"])
def test_deconvolve_matches_jax(method):
    h = 0.8 ** np.arange(24)
    y = np.stack([np.convolve(r, h) for r in X[:, :500]])
    jopt = J.DeconvOptions(method=J.DeconvMethod(method))
    topt = T.DeconvOptions(method=T.DeconvMethod(method))
    _holds(lambda a: J.deconvolve(a, h, jopt), lambda a: T.deconvolve(a, h, topt), y)
    if method == "wiener":
        # the population variance of the whole signal, as jnp.var
        for kw in (dict(signal_variance=0.5), dict(noise_variance=0.1),
                   dict(signal_variance=2.0, noise_variance=0.01)):
            _holds(lambda a: J.deconvolve(a, h, J.DeconvOptions(J.DeconvMethod.WIENER, **kw)),
                   lambda a: T.deconvolve(a, h, T.DeconvOptions(T.DeconvMethod.WIENER, **kw)),
                   y)
        assert float(torch.var(torch.as_tensor(y), correction=0)) == pytest.approx(
            float(jnp.var(jnp.asarray(y))), rel=1e-14)


def test_deconvolve_errors_inverse_filter_and_snr():
    with pytest.raises(T.DivisionByZeroError, match="near-zero"):
        T.deconvolve(torch.as_tensor(X[0]), np.array([1.0, 1.0]),
                     T.DeconvOptions(method=T.DeconvMethod.NAIVE))
    with pytest.raises(ValueError, match="empty"):
        T.deconvolve(torch.zeros(0), np.ones(3))
    h = np.array([1.0, 0.5, 0.25])
    for length, eps in ((64, 1e-6), (100, 1e-3), (33, 0.0)):
        np.testing.assert_allclose(T.inverse_filter(h, length, eps),
                                   J.inverse_filter(h, length, eps), atol=1e-12)
    with pytest.raises(ValueError, match="empty"):
        T.inverse_filter(np.zeros(0), 8)
    a, b = X[0], X[0] + 1e-3 * X[1]
    assert T.snr(torch.as_tensor(a), torch.as_tensor(b)) == J.snr(a, b)
    assert T.snr(a, a) == np.inf and T.snr(np.zeros(4), np.ones(4)) == -np.inf


def test_full_float32_conv_pin_restores_the_callers_settings():
    """The cuDNN TF32 pin `direct` runs under: inside it float32
    convolutions are off TF32; after it, also after an exception, the
    caller's settings read back as they were."""
    cudnn = torch.backends.cudnn
    saved = cudnn.allow_tf32
    try:
        for flag in (True, False):
            cudnn.allow_tf32 = flag
            with full_float32_conv():
                assert cudnn.allow_tf32 is False
            assert cudnn.allow_tf32 is flag
            with pytest.raises(RuntimeError, match="inside"):
                with full_float32_conv():
                    raise RuntimeError("inside")
            assert cudnn.allow_tf32 is flag
            y = T.direct(torch.as_tensor(X, dtype=torch.float32), np.ones(5))
            assert y.dtype == torch.float32 and cudnn.allow_tf32 is flag
    finally:
        cudnn.allow_tf32 = saved


def test_exports_match_jax():
    assert set(J.__all__) <= set(T.__all__)
    for name in J.__all__:
        assert hasattr(T, name), name
    assert T.DivisionByZeroError is not None
