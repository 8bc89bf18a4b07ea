"""The port's waveshapers against the JAX package on the CPU
(`effects/waveshape.py`: Distortion in every mode with the Chebyshev
recurrence and its DC bypass, BitCrusher, TransformerSimulation,
HarmonicBass; the port through the plain versions of K3/K4 and the
blocked and whole-cascade engines, JAX through its XLA paths, jitted),
and each against its C++ golden of `native/`.

Tolerances: float64 >= 200 dB with states within 1e-10; float32
against JAX float64, no more than 6 dB below JAX float32's own SNR
against JAX float64 (the reference's float32 class: the transformer's
25 Hz pre-emphasis and the bass exciter's 80 Hz crossover are slow
poles); the bit crusher's outputs against JAX's in the same type by
the quantisation steps that differ, counted (none); the goldens at tests/test_native.py's bars (> 140 dB for the
transfer curves, > 120 dB for the Chebyshev streaming and the
transformer, > 110 dB for the bass exciter, atol 1e-12 for the bit
crusher).
"""

import tests.torch_port_setup  # noqa: F401  (first: one PyTorch thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algodsp_tpu import native
from algodsp_tpu.effects import waveshape as jws
from algodsp_tpu_torch.effects import waveshape as tws
from tests.conftest import snr_db
from tests.torch_port_setup import ref_jit

SR = 48000.0
C = 2
CUTS = (0, 640, 1280)


def _x(n, seed=0, scale=0.7):
    return scale * np.random.default_rng(seed).standard_normal((C, n))


def _leaves(st):
    if isinstance(st, dict):
        return [v for k in sorted(st) for v in _leaves(st[k])]
    return [np.asarray(st.numpy() if torch.is_tensor(st) else st)]


def _stream(fx, proc, x, dtype, lib):
    st = (fx.init_state((C,), jnp.dtype(dtype)) if lib == "jax"
          else fx.init_state((C,), getattr(torch, dtype), "cpu"))
    ys = []
    for a, b in zip(CUTS[:-1], CUTS[1:]):
        xb = x[..., a:b].astype(dtype)
        st, y = proc(st, jnp.asarray(xb) if lib == "jax" else torch.as_tensor(xb))
        ys.append(np.asarray(y) if lib == "jax" else y.numpy())
    return st, np.concatenate(ys, axis=-1)


def _both(fj, ft, x, dtype):
    sj, yj = _stream(fj, ref_jit(fj.process), x, dtype, "jax")
    st, yt = _stream(ft, ft.process, x, dtype, "torch")
    return sj, yj, st, yt


def _check(fj, ft, x, f32=True):
    """float64 >= 200 dB and states within 1e-10; float32 within 6 dB of
    JAX float32's class against JAX float64."""
    sj, yj, st, yt = _both(fj, ft, x, "float64")
    assert yt.dtype == np.float64 and snr_db(yj, yt) >= 200
    for a, b in zip(_leaves(sj), _leaves(st)):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-10)
    if f32:
        _, yj32, _, yt32 = _both(fj, ft, x, "float32")
        assert yt32.dtype == np.float32
        assert snr_db(yj, yt32) >= snr_db(yj, yj32) - 6.0


MODES = [m.value for m in tws.DistortionMode if m != tws.DistortionMode.CHEBYSHEV]


@pytest.mark.parametrize("group", [MODES[:5], MODES[5:10], MODES[10:]],
                         ids=["modes_a", "modes_b", "modes_c"])
def test_distortion_modes_match_jax(group):
    """Every transfer curve, with drive, shape, bias, clip and levels, one
    call a mode (elementwise: JAX runs eagerly)."""
    x = _x(1024, 1)
    for mode in group:
        kw = dict(drive=3.0, shape=0.6, bias=0.1, clip_level=0.7,
                  output_level=0.9, mix=0.8)
        fj = jws.Distortion(mode=jws.DistortionMode(mode), **kw)
        ft = tws.Distortion(mode=tws.DistortionMode(mode), **kw)
        ref = None
        for dtype in ("float64", "float32"):
            _, yj = fj.process(fj.init_state((C,), jnp.dtype(dtype)),
                               jnp.asarray(x.astype(dtype)))
            _, yt = ft.process(ft.init_state((C,), getattr(torch, dtype), "cpu"),
                               torch.as_tensor(x.astype(dtype)))
            yj, yt = np.asarray(yj), yt.numpy()
            assert yt.dtype == np.dtype(dtype)
            if ref is None:
                ref = yj
                assert snr_db(ref, yt) >= 200, mode
            else:
                assert snr_db(ref, yt) >= snr_db(ref, yj) - 6.0, mode


@pytest.mark.parametrize("cheb", [
    dict(chebyshev_order=3, chebyshev_dc_bypass=True),
    dict(chebyshev_order=5, chebyshev_weights=[0.5, 0.0, 0.3, 0.0, 0.2],
         chebyshev_gain=0.8, chebyshev_invert=True, chebyshev_dc_bypass=True),
    dict(chebyshev_order=4, chebyshev_mode="even", chebyshev_dc_bypass=False)],
    ids=["order3_dc", "weights_inverted_dc", "even_no_dc"])
def test_chebyshev_matches_jax(cheb):
    """The recurrence, its weights, gain and inversion, and the DC bypass
    with dc_in and dc_out carried across calls. With weights the JAX
    package computes in float64 whatever the input (its NumPy float64
    weights promote), so float32 is held where there are none."""
    cheb = dict(cheb)
    mode = cheb.pop("chebyshev_mode", "all")
    fj = jws.Distortion(mode=jws.DistortionMode.CHEBYSHEV, drive=1.2,
                        chebyshev_mode=jws.ChebyshevHarmonicMode(mode), **cheb)
    ft = tws.Distortion(mode=tws.DistortionMode.CHEBYSHEV, drive=1.2,
                        chebyshev_mode=tws.ChebyshevHarmonicMode(mode), **cheb)
    _check(fj, ft, _x(CUTS[-1], 2), f32="chebyshev_weights" not in cheb)


@pytest.mark.parametrize("downsample", [1, 5])
def test_bitcrusher_matches_jax(downsample):
    """Quantise and sample-hold, the hold and the counter carried. The
    quantised values are compared by the steps that differ (a one-ulp
    difference of the product would flip round-half-to-even, an error of
    a whole step), counted in both types: none here; float64 >= 200 dB
    (the dry/wet mix rounds in another order)."""
    kw = dict(bit_depth=8.3, downsample=downsample, mix=0.75)
    fj, ft = jws.BitCrusher(SR, **kw), tws.BitCrusher(SR, **kw)
    x = _x(CUTS[-1], 3)
    step = 0.75 / ft.quant_levels
    for dtype in ("float64", "float32"):
        sj, yj, st, yt = _both(fj, ft, x, dtype)
        assert yt.dtype == np.dtype(dtype)
        flips = np.abs(yt.astype(np.float64) - yj) > 0.5 * step
        assert int(flips.sum()) == 0
        assert int(st["counter"]) == int(sj["counter"])
        np.testing.assert_allclose(st["hold"].numpy(), np.asarray(sj["hold"]),
                                   rtol=0, atol=1e-6)
        if dtype == "float64":
            assert snr_db(yj, yt) >= 200


@pytest.mark.parametrize("quality", ["high", "lightweight"])
def test_transformer_matches_jax(quality):
    """The 25 Hz pre-emphasis (a slow pole), the zero-stuffed 4x path
    through three chains, or the polynomial path, in 640-sample calls."""
    kw = dict(drive=2.0, mix=0.8, highpass_hz=25.0, damping_hz=9000.0)
    fj = jws.TransformerSimulation(SR, quality=jws.TransformerQuality(quality), **kw)
    ft = tws.TransformerSimulation(SR, quality=tws.TransformerQuality(quality), **kw)
    _check(fj, ft, _x(CUTS[-1], 4))


def test_harmonic_bass_matches_jax():
    """The 80 Hz 4th-order crossover pair (slow poles), the shaper, its
    high-pass and the Limiter (K4's plain version under its detector)."""
    kw = dict(frequency=80.0, harmonic_bass_gain=0.8, original_bass_gain=0.9,
              decay=0.3, response_ms=20.0)
    _check(jws.HarmonicBass(SR, **kw), tws.HarmonicBass(SR, **kw), _x(CUTS[-1], 5))


@pytest.mark.skipif(not native.available(), reason="native library not built")
def test_distortion_matches_golden():
    """Eight transfer curves (> 140 dB) and the weighted Chebyshev mode
    streamed in two calls (> 120 dB) against the C++ golden."""
    rng = np.random.default_rng(120)
    x = rng.standard_normal(4096) * 0.7
    for mode in ("soft_clip", "hard_clip", "tanh", "waveshaper1", "waveshaper5",
                 "waveshaper8", "saturate2", "soft_sat"):
        kw = dict(drive=3.0, shape=0.6, bias=0.1, mix=0.8, output_level=0.9)
        _, g = native.distortion(jws.Distortion(mode=jws.DistortionMode(mode), **kw), x)
        ft = tws.Distortion(mode=tws.DistortionMode(mode), **kw)
        _, y = ft.process(ft.init_state((), torch.float64, "cpu"), torch.as_tensor(x))
        assert snr_db(g, y.numpy()) > 140, mode
    kw = dict(drive=1.2, chebyshev_order=5, chebyshev_weights=[0.5, 0.0, 0.3, 0.0, 0.2],
              chebyshev_gain=0.8, mix=1.0)
    fj = jws.Distortion(mode=jws.DistortionMode.CHEBYSHEV, **kw)
    ft = tws.Distortion(mode=tws.DistortionMode.CHEBYSHEV, **kw)
    g, z1 = native.distortion(fj, x[:2048])
    _, z2 = native.distortion(fj, x[2048:], state=g)
    st, y1 = ft.process(ft.init_state((), torch.float64, "cpu"), torch.as_tensor(x[:2048]))
    _, y2 = ft.process(st, torch.as_tensor(x[2048:]))
    assert snr_db(np.concatenate([z1, z2]), torch.cat([y1, y2]).numpy()) > 120


def _golden_stream(gold, fj, ft, x, split):
    g, z1 = gold(fj, x[:split])
    _, z2 = gold(fj, x[split:], state=g)
    st, y1 = ft.process(ft.init_state((), torch.float64, "cpu"), torch.as_tensor(x[:split]))
    _, y2 = ft.process(st, torch.as_tensor(x[split:]))
    return np.concatenate([z1, z2]), torch.cat([y1, y2]).numpy()


@pytest.mark.skipif(not native.available(), reason="native library not built")
def test_bitcrusher_transformer_bass_match_golden():
    """The bit crusher (atol 1e-12), the transformer in both qualities
    (> 120 dB) and the bass exciter (> 110 dB) streamed in two calls."""
    rng = np.random.default_rng(103)
    x = rng.standard_normal(2051) * 0.8
    kw = dict(bit_depth=8.3, downsample=5, mix=0.75)
    z, y = _golden_stream(native.bitcrusher, jws.BitCrusher(SR, **kw),
                          tws.BitCrusher(SR, **kw), x, 1024)
    np.testing.assert_allclose(y, z, atol=1e-12)
    x = rng.standard_normal(4096) * 0.7
    for q in ("high", "lightweight"):
        kw = dict(drive=2.0, mix=0.8)
        z, y = _golden_stream(
            native.transformer,
            jws.TransformerSimulation(SR, quality=jws.TransformerQuality(q), **kw),
            tws.TransformerSimulation(SR, quality=tws.TransformerQuality(q), **kw),
            x, 2048)
        assert snr_db(z, y) > 120, q
    t = np.arange(8192) / SR
    x = 0.6 * np.sin(2 * np.pi * 60.0 * t) + 0.2 * rng.standard_normal(8192)
    kw = dict(frequency=120.0, harmonic_bass_gain=0.8, original_bass_gain=0.9,
              high_frequency_gain=1.0)
    z, y = _golden_stream(native.harmonic_bass, jws.HarmonicBass(SR, **kw),
                          tws.HarmonicBass(SR, **kw), x, 4096)
    assert snr_db(z, y) > 110
