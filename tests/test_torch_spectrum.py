"""The port's `spectrum/` (spectrum, goertzel, stft, mel) against the
JAX package on the CPU (its XLA paths, jitted where the call would
otherwise compile op by op).

Tolerances:
- float64: max abs difference <= 1e-10 (or >= 200 dB SNR for the
  transforms): the same formulas, with FFTs and products summed in
  other orders;
- float32: `tests/test_spectrum.py` and `tests/test_goertzel.py`'s own
  bars where they test float32 (the STFT round trip's 2e-5, the
  streaming STFT's 1e-4); elsewhere no farther from the JAX float64
  output than twice the JAX float32 output's own distance from it
  (plus one float32 ulp of the output's scale);
- Goertzel in float64: `tests/test_goertzel.py`'s rtol 1e-9 against
  the sequential recurrence, streaming rtol 1e-8; in float32 its state
  within the float32 dot-product error bound of the float64 state;
- the pinned products (Goertzel, mel, MFCC) under a caller's
  `torch.set_float32_matmul_precision("medium")`: bit-equal.
"""

import tests.torch_port_setup  # noqa: F401  (first: one PyTorch thread)

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algodsp_tpu import spectrum as jspec
from algodsp_tpu_torch import spectrum
from algodsp_tpu_torch.window import WindowType
from tests.conftest import snr_db
from tests.torch_port_setup import ref_jit

SR = 48000.0


def _t(a, dtype=None):
    a = np.asarray(a)
    return torch.tensor(a) if dtype is None else torch.tensor(a, dtype=dtype)


def _csnr(ref, test):
    """SNR of complex spectra, real and imaginary parts together."""
    ri = lambda a: np.stack([np.real(a), np.imag(a)])
    return snr_db(ri(np.asarray(ref)), ri(np.asarray(test)))


def _f32_bar(j64, j32, got):
    """got (float32) no farther from j64 than twice j32 is, plus an ulp."""
    j64 = np.asarray(j64, np.float64)
    err = np.max(np.abs(np.asarray(got, np.float64) - j64))
    own = np.max(np.abs(np.asarray(j32, np.float64) - j64))
    assert err <= 2 * own + np.finfo(np.float32).eps * np.max(np.abs(j64)), \
        (err, own)


def test_bin_helpers_match_jax():
    rng = np.random.default_rng(1)
    bins = rng.standard_normal((2, 65)) + 1j * rng.standard_normal((2, 65))
    tb = _t(bins)
    for name in ("magnitude", "power", "phase"):
        np.testing.assert_allclose(getattr(spectrum, name)(tb).numpy(),
                                   np.asarray(ref_jit(getattr(jspec, name))(bins)),
                                   atol=1e-12)
    re, im = bins.real, bins.imag
    for name in ("magnitude_from_parts", "power_from_parts"):
        np.testing.assert_allclose(getattr(spectrum, name)(_t(re), _t(im)).numpy(),
                                   np.asarray(getattr(jspec, name)(re, im)),
                                   atol=1e-12)
    ph = np.cumsum(rng.uniform(-3.0, 3.0, (3, 200)), axis=-1)
    wrapped = np.angle(np.exp(1j * ph))
    uw = spectrum.unwrap_phase(_t(wrapped)).numpy()
    np.testing.assert_allclose(uw, np.asarray(ref_jit(jspec.unwrap_phase)(wrapped)),
                               atol=1e-10)
    np.testing.assert_allclose(uw, np.unwrap(wrapped), atol=1e-9)
    np.testing.assert_allclose(
        spectrum.group_delay_seconds(_t(uw), 512, SR).numpy(),
        np.asarray(jspec.group_delay_seconds(uw, 512, SR)), atol=1e-12)
    knots = np.sort(rng.uniform(0.0, 100.0, 40))
    knots[5] = knots[4]                  # a zero-width interval
    vals = rng.standard_normal(40)
    q = rng.uniform(-10.0, 110.0, 300)
    np.testing.assert_allclose(
        spectrum.interpolate_linear(_t(knots), _t(vals), _t(q)).numpy(),
        np.asarray(jspec.interpolate_linear(knots, vals, q)), atol=1e-12)
    freqs = np.linspace(0.0, SR / 2, 257)
    v = rng.uniform(0.0, 1.0, (2, 257))
    np.testing.assert_allclose(
        spectrum.smooth_fractional_octave(_t(freqs), _t(v), 3).numpy(),
        np.asarray(ref_jit(jspec.smooth_fractional_octave, static_argnums=2)(
            freqs, v, 3)), atol=1e-12)
    with pytest.raises(ValueError):
        spectrum.group_delay_from_phase(_t(uw[..., :1]), 512)
    with pytest.raises(ValueError):
        spectrum.smooth_fractional_octave(_t(freqs), _t(v), 0)


def _sequential_goertzel(x, freq, sr):
    coeff = 2.0 * np.cos(2.0 * np.pi * freq / sr)
    s0 = s1 = 0.0
    for v in x:
        s0, s1 = v + coeff * s0 - s1, s0
    return s0 * s0 + s1 * s1 - coeff * s0 * s1


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_goertzel_matches_jax(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 512))
    freqs = [0.0, 440.0, 1000.0, 12345.6, 24000.0]
    j64 = np.asarray(jspec.goertzel_power(jnp.asarray(x), freqs, SR))
    got = spectrum.goertzel_power(_t(x.astype(dtype)), freqs, SR)
    assert got.dtype == getattr(torch, dtype) and got.shape == (3, 5)
    if dtype == "float64":
        np.testing.assert_allclose(got.numpy(), j64, rtol=1e-10)
        for k, f in enumerate(freqs):
            np.testing.assert_allclose(got[0, k].item(),
                                       _sequential_goertzel(x[0], f, SR),
                                       rtol=1e-9)
        np.testing.assert_allclose(
            spectrum.goertzel_power_db(_t(x), freqs, SR).numpy(),
            np.asarray(jspec.goertzel_power_db(jnp.asarray(x), freqs, SR)),
            rtol=1e-10)
        np.testing.assert_allclose(
            spectrum.goertzel_magnitude(_t(x[0]), 1000.0, SR).item(),
            float(jspec.goertzel_magnitude(jnp.asarray(x[0]), 1000.0, SR)),
            rtol=1e-10)
    else:
        # the state (s0, s1) is a float32 dot product of x with the
        # basis: within the summation-order bound (n + 2) u |x| . |basis|
        # of its float64 value on the same float32 x, whatever the order
        # (the power's own cancellation at DC and Nyquist then costs
        # float32 40-60 dB in either package)
        from algodsp_tpu.spectrum.goertzel import _basis_cached
        x32 = x.astype(np.float32).astype(np.float64)
        basis, _ = _basis_cached(tuple(freqs), SR, 512)
        ref = np.einsum("cn,nks->cks", x32, basis)
        bound = (512 + 2) * np.finfo(np.float32).eps / 2 * np.einsum(
            "cn,nks->cks", np.abs(x32), np.abs(basis))
        g = spectrum.Goertzel(freqs, SR)
        st = g.process_block(g.init_state((3,), torch.float32, "cpu"),
                             _t(x, torch.float32))
        assert np.all(np.abs(st.double().numpy() - ref) <= bound)
        assert torch.equal(g.power(st), got)
    with pytest.raises(ValueError):
        spectrum.Goertzel([30000.0], SR)


def test_goertzel_streaming_matches_one_shot():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 1024))
    g = spectrum.Goertzel([440.0, 3000.0], 44100.0)
    jg = jspec.Goertzel([440.0, 3000.0], 44100.0)
    st = g.init_state((2,), torch.float64, "cpu")
    for a, b in ((0, 300), (300, 1024)):
        st = g.process_block(st, _t(x[:, a:b]))
    once = g.process_block(g.init_state((2,), torch.float64, "cpu"), _t(x))
    np.testing.assert_allclose(g.power(st).numpy(), g.power(once).numpy(),
                               rtol=1e-8)
    js = jg.process_block(jg.init_state((2,), jnp.float64), jnp.asarray(x))
    np.testing.assert_allclose(once.numpy(), np.asarray(js), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(g.power_db(once).numpy(),
                               np.asarray(jg.power_db(js)), rtol=1e-10)


_JSTFT = {(f, h): ref_jit(functools.partial(jspec.stft, frame_size=f,
                                            hop_size=h))
          for f, h in ((256, 64), (512, 192))}


@pytest.mark.parametrize("frame,hop", [(256, 64), (512, 192)])
def test_stft_istft_match_jax(frame, hop):
    """Both overlap-add branches: shifted sums (hop divides the frame)
    and the scatter (512 / 192)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3000))
    spec_j = np.asarray(_JSTFT[frame, hop](jnp.asarray(x)))
    spec_t = spectrum.stft(_t(x), frame, hop)
    assert spec_t.shape == spec_j.shape
    assert _csnr(spec_j, spec_t.numpy()) >= 200
    y_j = np.asarray(ref_jit(functools.partial(jspec.istft, hop_size=hop,
                                               length=3000))(jnp.asarray(spec_j)))
    y_t = spectrum.istft(spec_t, hop, length=3000).numpy()
    assert snr_db(y_j, y_t) >= 200
    np.testing.assert_allclose(y_t, x, atol=1e-10)
    # float32: tests/test_spectrum.py's round-trip bar
    y32 = spectrum.istft(spectrum.stft(_t(x, torch.float32), frame, hop), hop,
                         length=3000)
    assert y32.dtype == torch.float32
    assert np.abs(y32.numpy() - x).max() < 2e-5
    with pytest.raises(ValueError):
        spectrum.stft(_t(x), 255, 64)


def test_istft_rectangular_hop_equals_frame_and_center_off():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 1000)).astype(np.float32)
    spec = spectrum.stft(_t(x), 256, 256, window=WindowType.RECTANGULAR)
    y = spectrum.istft(spec, 256, window=WindowType.RECTANGULAR, length=1000)
    assert np.abs(y.numpy() - x).max() < 2e-5
    sj = ref_jit(functools.partial(jspec.stft, frame_size=256, hop_size=128,
                                   center=False))(jnp.asarray(x, jnp.float64))
    st = spectrum.stft(_t(x, torch.float64), 256, 128, center=False)
    assert _csnr(np.asarray(sj), st.numpy()) >= 200
    yj = np.asarray(ref_jit(functools.partial(
        jspec.istft, hop_size=128, center=False, length=1200))(sj))
    yt = spectrum.istft(st, 128, center=False, length=1200).numpy()
    assert snr_db(yj, yt) >= 200 and yt.shape == (3, 1200)


def test_streaming_stft_istft_match_jax():
    """`tests/test_spectrum.py`'s streaming bars: frames against the
    one-shot STFT of the left-padded stream (atol 1e-4 in float32), the
    analysis -> synthesis chain a delayed identity; float64 against the
    JAX streaming classes."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 4096))
    ana, syn = spectrum.StreamingSTFT(512, 128), spectrum.StreamingISTFT(512, 128)
    jana, jsyn = jspec.StreamingSTFT(512, 128), jspec.StreamingISTFT(512, 128)
    j_ana, j_syn = ref_jit(jana.process), ref_jit(jsyn.process)
    for dtype, jdt in ((torch.float64, jnp.float64), (torch.float32, jnp.float32)):
        sa, ss = ana.init_state((2,), dtype, "cpu"), syn.init_state((2,), dtype, "cpu")
        ja, js = jana.init_state((2,), jdt), jsyn.init_state((2,), jdt)
        frames, outs, jouts = [], [], []
        for b in range(8):
            blk = x[:, b * 512:(b + 1) * 512]
            sa, fr = ana.process(sa, _t(blk, dtype))
            ss, y = syn.process(ss, fr)
            ja, jfr = j_ana(ja, jnp.asarray(blk, jdt))
            js, jy = j_syn(js, jfr)
            frames.append(fr)
            outs.append(y.double().numpy())
            jouts.append(np.asarray(jy, np.float64))
        got = np.concatenate(outs, -1)
        lag = 512 - 128
        tol = 1e-10 if dtype == torch.float64 else 2e-5
        np.testing.assert_allclose(got[:, lag:], x[:, :-lag], atol=tol)
        if dtype == torch.float64:
            assert snr_db(np.concatenate(jouts, -1), got) >= 200
        padded = np.concatenate([np.zeros((2, lag)), x], -1)
        ref = np.asarray(ref_jit(functools.partial(
            jspec.stft, frame_size=512, hop_size=128, center=False))(
                jnp.asarray(padded, jdt)))
        fr_all = torch.cat(frames, dim=-2).numpy()
        np.testing.assert_allclose(fr_all, ref[:, :fr_all.shape[-2]], atol=1e-4)
    with pytest.raises(ValueError):
        spectrum.StreamingISTFT(512, 512)
    with pytest.raises(ValueError):
        ana.process(ana.init_state((2,), torch.float64, "cpu"), _t(x[:, :100]))


def test_spectrogram_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 4000))
    x[1] = 0.0
    ref = np.asarray(ref_jit(functools.partial(
        jspec.spectrogram, frame_size=512, hop_size=128))(jnp.asarray(x)))
    got = spectrum.spectrogram(_t(x), 512, 128).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-9)
    assert got[1].max() == -200.0


def test_mel_filterbank_spectrogram_mfcc_match_jax():
    from algodsp_tpu.spectrum import mel as jmel
    from algodsp_tpu_torch.spectrum import mel
    for htk in (False, True):
        np.testing.assert_array_equal(
            mel.mel_filterbank(40, 1024, SR, fmin=30.0, htk=htk),
            jmel.mel_filterbank(40, 1024, SR, fmin=30.0, htk=htk))
        f = np.array([0.0, 440.0, 1000.0, 8000.0])
        np.testing.assert_array_equal(mel.hz_to_mel(f, htk=htk),
                                      jmel.hz_to_mel(f, htk=htk))
    np.testing.assert_array_equal(mel.dct_matrix(13, 40), jmel.dct_matrix(13, 40))
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 6000))
    kw = dict(n_mels=32, frame_size=1024, hop_size=256)
    jmelspec = ref_jit(lambda v, log: jspec.mel_spectrogram(v, SR, log=log, **kw),
                       static_argnums=1)
    j64 = np.asarray(jmelspec(jnp.asarray(x), True))
    got = spectrum.mel_spectrogram(_t(x), SR, **kw)
    np.testing.assert_allclose(got.numpy(), j64, atol=1e-9)
    lin = spectrum.mel_spectrogram(_t(x), SR, log=False, **kw).numpy()
    assert snr_db(np.asarray(jmelspec(jnp.asarray(x), False)), lin) >= 200
    j32 = np.asarray(jmelspec(jnp.asarray(x, jnp.float32), True))
    got32 = spectrum.mel_spectrogram(_t(x, torch.float32), SR, **kw)
    assert got32.dtype == torch.float32
    _f32_bar(j64, j32, got32.numpy())
    np.testing.assert_allclose(
        spectrum.mfcc(_t(x), SR, n_mfcc=13, **kw).numpy(),
        np.asarray(ref_jit(lambda v: jspec.mfcc(v, SR, n_mfcc=13, **kw))(
            jnp.asarray(x))), atol=1e-9)
    with pytest.raises(ValueError):
        spectrum.mfcc(_t(x), SR, n_mfcc=40, n_mels=32)


def test_pinned_products_ignore_a_lowered_precision():
    """Goertzel, mel and MFCC give the same bits under a caller's
    `torch.set_float32_matmul_precision("medium")` (bfloat16 products in
    oneDNN where the CPU has them; TF32 on the card), and leave the
    caller's setting as it was."""
    rng = np.random.default_rng(9)
    x = _t(rng.standard_normal((4, 8192)), torch.float32)
    freqs = np.linspace(100.0, 9000.0, 30)
    run = lambda: (spectrum.goertzel_power(x, freqs, SR),
                   spectrum.mel_spectrogram(x, SR, n_mels=64),
                   spectrum.mfcc(x, SR))
    ref = run()
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        got = run()
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(before)
    for a, b in zip(ref, got):
        assert torch.equal(a, b)
