"""The port's `filters/hilbert.py` and `resample/resample.py` against the
JAX package on the CPU (its XLA paths, jitted) and against the C++
goldens `native.hilbert` and `native.resample_polyphase`.

Tolerances:
- design (allpass coefficients, attenuation model, polyphase bank,
  correlation bank, ratio approximation): equal, the same host float64
  code;
- float64 >= 200 dB SNR against the JAX float64 output (the same
  recurrences and products in another summation order);
- float32 against the JAX float64 output: no more than 6 dB below the
  JAX float32 output's own SNR (both sum the same float32 products in
  different orders);
- the goldens in float64: > 120 dB (`tests/test_native.py`), streaming
  included; `tests/test_resample_delay.py`'s > 180 dB for the streamed
  resampler against one call;
- the resampler's product under a caller's lowered matmul precision
  (and cuDNN's TF32 switch, which it does not use): bit-equal.
"""

import tests.torch_port_setup  # noqa: F401  (first: one PyTorch thread)

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algodsp_tpu import native
from algodsp_tpu.filters import hilbert as jhil
from algodsp_tpu import resample as jres
from algodsp_tpu_torch.filters import hilbert
from algodsp_tpu_torch import resample
from algodsp_tpu_torch.ops.biquad_cascade import MAX_SECTIONS
from tests.conftest import snr_db
from tests.torch_port_setup import ref_jit

needs_native = pytest.mark.skipif(not native.available(),
                                  reason="native library not built")


def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def test_hilbert_design_equals_jax():
    for p in (hilbert.Preset.FAST, hilbert.Preset.BALANCED,
              hilbert.Preset.LOW_FREQUENCY):
        assert hilbert.preset_config(p) == jhil.preset_config(p)
        n, tr = hilbert.preset_config(p)
        np.testing.assert_array_equal(hilbert.design_coefficients(n, tr),
                                      jhil.design_coefficients(n, tr))
        assert hilbert.attenuation_from_order_tbw(n, tr) == \
            jhil.attenuation_from_order_tbw(n, tr)
        ht = hilbert.HilbertTransformer.from_preset(p)
        np.testing.assert_array_equal(ht.coeffs,
                                      jhil.HilbertTransformer.from_preset(p).coeffs)
    with pytest.raises(ValueError):
        hilbert.preset_config("nope")
    with pytest.raises(ValueError):
        hilbert.design_coefficients(0, 0.1)
    with pytest.raises(ValueError):
        hilbert.design_coefficients(4, 0.5)
    with pytest.raises(ValueError):
        hilbert.HilbertTransformer(coefficients=[0.5, 1.0])
    with pytest.raises(ValueError):
        hilbert.HilbertTransformer(coefficients=[0.5])


def test_hilbert_chains_take_the_cascade_kernel_in_float32():
    """The allpass sections [c, -1, 0, -c, 0] have real poles: no slow
    complex pole, no conditioning split, so auto dispatch runs float32
    chains on the fused cascade kernel (its plain version here) for
    every preset, and float64 ones on the blocked engine."""
    x32, x64 = torch.zeros(2, 256), torch.zeros(2, 256, dtype=torch.float64)
    for p in (hilbert.Preset.FAST, hilbert.Preset.BALANCED,
              hilbert.Preset.LOW_FREQUENCY):
        ht = hilbert.HilbertTransformer.from_preset(p)
        for chain in (ht.chain_a, ht.chain_b):
            assert not chain.has_slow_poles
            assert chain.num_runtime_sections == chain.num_sections <= MAX_SECTIONS
            assert chain._auto_mode(x32) == "kernel"
            assert chain._auto_mode(x64) == "blocked"


@functools.lru_cache(maxsize=None)
def _jax_hilbert(ncoef):
    """The jitted JAX transformer, shared by the cases of one parity."""
    return ref_jit(jhil.HilbertTransformer(ncoef, 0.05).process)


@pytest.mark.parametrize("ncoef,n,dtype", [(7, 2047, "float64"),
                                            (8, 2048, "float64"),
                                            (8, 2048, "float32")],
                         ids=["odd-float64", "even-float64", "even-float32"])
def test_hilbert_matches_jax(ncoef, n, dtype):
    """Both coefficient parities at an odd and an even length, and
    float32 (whose JAX side compiles once more)."""
    th = hilbert.HilbertTransformer(ncoef, 0.05)
    x = _x((2, n), 1)
    run = _jax_hilbert(ncoef)
    a64, b64 = (np.asarray(v) for v in run(jnp.asarray(x)))
    tdt = getattr(torch, dtype)
    a, b = th.process(_t(x, tdt))
    assert a.dtype == tdt and a.shape == b.shape == (2, n)
    if dtype == "float64":
        assert snr_db(a64, a.numpy()) >= 200 and snr_db(b64, b.numpy()) >= 200
        np.testing.assert_allclose(th.envelope(_t(x)).numpy(),
                                   np.sqrt(a64 * a64 + b64 * b64), atol=1e-10)
        return
    a32j, b32j = (np.asarray(v) for v in run(jnp.asarray(x, jnp.float32)))
    for ref, own, got in ((a64, a32j, a), (b64, b32j, b)):
        assert snr_db(ref, got.numpy()) >= snr_db(ref, own) - 6.0


@needs_native
@pytest.mark.parametrize("ncoef", [7, 8], ids=["odd", "even"])
def test_hilbert_matches_golden(ncoef):
    """`tests/test_native.py::test_native_hilbert_matches_polyphase`'s
    bar: the full-rate z^-2 allpass golden (independent of the
    deinterleaved routing), float64."""
    th = hilbert.HilbertTransformer(ncoef, 0.05)
    x = _x(2048, 40)
    _, a_gold, b_gold = native.hilbert(th, x)
    a, b = th.process(_t(x))
    assert snr_db(a_gold, a.numpy()) > 120
    assert snr_db(b_gold, b.numpy()) > 120


def _profile_tuple(p):
    return (p.taps_per_phase, p.cutoff_scale, p.kaiser_beta,
            p.nominal_stopband_db)


def test_resampler_design_and_helpers_equal_jax():
    for q in (resample.Quality.FAST, resample.Quality.BALANCED,
              resample.Quality.BEST):
        assert _profile_tuple(resample.quality_profile(q)) == \
            _profile_tuple(jres.quality_profile(jres.Quality[q.name]))
    for up, down in ((2, 1), (3, 2), (147, 160), (1, 64)):
        t, j = resample.Resampler(up, down), jres.Resampler(up, down)
        np.testing.assert_array_equal(t.taps, j.taps)
        np.testing.assert_array_equal(t._bank, j._bank)
        np.testing.assert_array_equal(t._kbank, j._kbank)
        assert t.output_len(1001) == j.output_len(1001)
    for v in (48000 / 44100, 1.5, 0.0, np.pi, float("inf")):
        assert resample.approximate_ratio(v) == jres.approximate_ratio(v)
    r = resample.Resampler.for_rates(44100.0, 48000.0)
    assert (r.up, r.down) == (160, 147)
    with pytest.raises(ValueError):
        resample.Resampler(0, 1)
    with pytest.raises(ValueError):
        resample.Resampler.for_rates(-1.0, 48000.0)


_RATIOS = [(2, 1), (3, 2), (147, 160), (1, 3)]


@pytest.mark.parametrize("up,down", _RATIOS, ids=["2:1", "3:2", "147:160", "1:3"])
def test_resampler_matches_jax(up, down):
    jr, tr = jres.Resampler(up, down), resample.Resampler(up, down)
    x = _x((2, 1000), 26)
    run = ref_jit(jr.process)
    y64 = np.asarray(run(jnp.asarray(x)))
    y = tr.process(_t(x))
    assert y.shape == y64.shape
    assert snr_db(y64, y.numpy()) >= 200
    y32j = np.asarray(run(jnp.asarray(x, jnp.float32)))
    y32 = tr.process(_t(x, torch.float32))
    assert y32.dtype == torch.float32
    assert snr_db(y64, y32.numpy()) >= snr_db(y64, y32j) - 6.0


@needs_native
@pytest.mark.parametrize("up,down", _RATIOS, ids=["2:1", "3:2", "147:160", "1:3"])
def test_resampler_matches_golden(up, down):
    """`tests/test_native.py::test_native_resampler_matches_jax`'s bar
    against the per-output-sample golden, one call."""
    tr = resample.Resampler(up, down, quality=resample.Quality.BALANCED)
    x = _x(1000, 26)
    _, y_gold = native.resample_polyphase(tr, x)
    assert snr_db(y_gold, tr.process(_t(x)).numpy()) > 120


@needs_native
def test_resampler_stream_matches_golden_and_jax():
    """Streamed blocks with the history carried: the golden's own stream
    (> 120 dB), JAX's stream (>= 200 dB) and one call (> 180 dB,
    `tests/test_resample_delay.py`); blocks that are no multiple of
    `down` are refused."""
    tr = resample.Resampler(4, 3, quality=resample.Quality.FAST)
    jr = jres.Resampler(4, 3, quality=jres.Quality.FAST)
    x = _x((2, 1200), 27)
    st, js = tr.init_state((2,), torch.float64, "cpu"), jr.init_state((2,), jnp.float64)
    jstep = ref_jit(jr.process_stream)
    outs, jouts = [], []
    for a, b in ((0, 600), (600, 1200)):
        st, y = tr.process_stream(st, _t(x[:, a:b]))
        js, jy = jstep(js, jnp.asarray(x[:, a:b]))
        outs.append(y.numpy())
        jouts.append(np.asarray(jy))
    y_stream = np.concatenate(outs, -1)
    assert snr_db(np.concatenate(jouts, -1), y_stream) >= 200
    np.testing.assert_allclose(st.numpy(), np.asarray(js), atol=1e-12)
    h, g1 = native.resample_polyphase(tr, x[0, :600], n_out=800)
    _, g2 = native.resample_polyphase(tr, x[0, 600:], hist=h, n_out=800)
    assert snr_db(np.concatenate([g1, g2]), y_stream[0]) > 120
    once = tr.process(_t(x)).numpy()
    assert snr_db(once[:, :y_stream.shape[-1]], y_stream) > 180
    with pytest.raises(ValueError):
        tr.process_stream(st, _t(x[:, :100]))


def test_resample_helpers_match_jax():
    x = _x((2, 501), 28)
    for name in ("upsample_2x", "downsample_2x"):
        np.testing.assert_allclose(
            getattr(resample, name)(_t(x)).numpy(),
            np.asarray(ref_jit(getattr(jres, name))(jnp.asarray(x))), atol=1e-10)
    np.testing.assert_allclose(
        resample.resample(_t(x), 5, 7, quality=resample.Quality.BEST).numpy(),
        np.asarray(ref_jit(functools.partial(jres.resample, up=5, down=7,
                                             quality=jres.Quality.BEST))(
            jnp.asarray(x))), atol=1e-10)


def test_resampler_ignores_a_lowered_precision():
    """The correlation is a strided view times the bank under the
    full-float32 pin, not a cuDNN convolution: the same bits under a
    caller's `torch.set_float32_matmul_precision("medium")` and
    `torch.backends.cudnn.allow_tf32 = True`, the caller's settings
    left as they were."""
    tr = resample.Resampler(1, 64)
    x = _t(_x((4, 8192), 29), torch.float32)
    ref = tr.process(x)
    before = torch.get_float32_matmul_precision()
    cudnn_before = torch.backends.cudnn.allow_tf32
    try:
        torch.set_float32_matmul_precision("medium")
        torch.backends.cudnn.allow_tf32 = True
        got = tr.process(x)
        assert torch.get_float32_matmul_precision() == "medium"
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.set_float32_matmul_precision(before)
        torch.backends.cudnn.allow_tf32 = cudnn_before
    assert torch.equal(ref, got)
