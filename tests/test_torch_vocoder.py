"""The port's channel vocoder against the JAX package on the CPU (the port
through the banded engines and K4's plain version, JAX jitted): both
band layouts streamed in ragged blocks in float64 and float32, streamed
against one call, the band tables and designs, and the C++ goldens.

Tolerances: float64 >= 200 dB with states within 1e-12; float32 against
JAX float64 >= 100 dB, or no more than 6 dB below JAX float32's own SNR
where that is lower (the 16-40 Hz third-octave bands at Q 4.32 are slow
poles: the reference's float32 class); the goldens at
tests/test_native.py's 120 dB; streamed against one call >= 200 dB
(float64; ragged blocks take the banded engine's per-section path).
"""

import tests.torch_port_setup  # noqa: F401  (first: one PyTorch thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algodsp_tpu import native
from algodsp_tpu.effects import vocoder as jv
from algodsp_tpu_torch.effects import vocoder as tv
from tests.conftest import snr_db
from tests.torch_port_setup import meets_float32_bar, ref_jit

SR = 48000.0
CUTS = (0, 1024, 1500, 3072)
LEVELS = dict(input_level=0.1, synth_level=0.05, vocoded_level=1.0)


def _signals(seed=70, c=2):
    rng = np.random.default_rng(seed)
    n = CUTS[-1]
    env = np.repeat(rng.uniform(0.05, 1.0, (c, n // 256)), 256, axis=1)
    return 0.5 * rng.standard_normal((c, n)) * env, 0.5 * rng.standard_normal((c, n))


def _stream(fx, mod, car, dtype, lib, cuts=CUTS):
    if lib == "jax":
        st, proc, arr = (fx.init_state(mod.shape[:-1], jnp.dtype(dtype)),
                         ref_jit(fx.process), jnp.asarray)
    else:
        st, proc, arr = (fx.init_state(mod.shape[:-1], getattr(torch, dtype), "cpu"),
                         fx.process, torch.as_tensor)
    ys = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        st, y = proc(st, arr(mod[..., a:b].astype(dtype)),
                     arr(car[..., a:b].astype(dtype)))
        ys.append(np.asarray(y) if lib == "jax" else y.numpy())
    return st, np.concatenate(ys, axis=-1)


@pytest.mark.parametrize("layout", ["THIRD_OCTAVE", "BARK"])
def test_vocoder_matches_jax(layout):
    fj = jv.Vocoder(SR, layout=getattr(jv.BandLayout, layout), **LEVELS)
    ft = tv.Vocoder(SR, layout=getattr(tv.BandLayout, layout), **LEVELS)
    mod, car = _signals()
    sj, yj = _stream(fj, mod, car, "float64", "jax")
    st, yt = _stream(ft, mod, car, "float64", "torch")
    assert yt.dtype == np.float64 and snr_db(yj, yt) >= 200
    for key in ("analysis", "synthesis", "env"):
        np.testing.assert_allclose(st[key].numpy(), np.asarray(sj[key]),
                                   rtol=0, atol=1e-12)
    _, yt32 = _stream(ft, mod, car, "float32", "torch")
    assert yt32.dtype == np.float32
    assert meets_float32_bar(
        snr_db(yj, yt32), lambda: snr_db(yj, _stream(fj, mod, car, "float32", "jax")[1]))
    _, y1 = _stream(ft, mod, car, "float64", "torch", cuts=(0, CUTS[-1]))
    assert snr_db(y1, yt) >= 200


def test_bands_and_errors_match_jax():
    np.testing.assert_array_equal(tv.THIRD_OCTAVE_FREQUENCIES,
                                  jv.THIRD_OCTAVE_FREQUENCIES)
    np.testing.assert_array_equal(tv.BARK_FREQUENCIES, jv.BARK_FREQUENCIES)
    assert tv.THIRD_OCTAVE_Q == jv.THIRD_OCTAVE_Q
    for sr, layout in ((48000.0, "THIRD_OCTAVE"), (16000.0, "BARK"),
                       (22050.0, "THIRD_OCTAVE")):
        fj = jv.Vocoder(sr, layout=getattr(jv.BandLayout, layout), synth_q=2.0)
        ft = tv.Vocoder(sr, layout=getattr(tv.BandLayout, layout), synth_q=2.0)
        np.testing.assert_array_equal(ft.frequencies, fj.frequencies)
        np.testing.assert_array_equal(ft.analysis.sos, fj.analysis.sos)
        np.testing.assert_array_equal(ft.synthesis.sos, fj.synthesis.sos)
        assert (ft.attack_coeff, ft.release_coeff) == (fj.attack_coeff,
                                                       fj.release_coeff)
    for kw in (dict(attack_ms=0.001), dict(release_ms=2000.0), dict(synth_q=30.0)):
        with pytest.raises(ValueError):
            jv.Vocoder(SR, **kw)
        with pytest.raises(ValueError):
            tv.Vocoder(SR, **kw)
    with pytest.raises(ValueError):
        tv.Vocoder(0.0)


@pytest.mark.parametrize("layout", ["THIRD_OCTAVE", "BARK"])
def test_vocoder_matches_native(layout):
    """tests/test_native.py's case: mono, one call, and streamed in two
    calls against the golden's state carry."""
    rng = np.random.default_rng(70)
    n = 8192
    mod = rng.standard_normal(n) * 0.5
    car = rng.standard_normal(n) * 0.5
    voc = tv.Vocoder(SR, layout=getattr(tv.BandLayout, layout), **LEVELS)
    st = voc.init_state((), torch.float64, "cpu")
    _, y = voc.process(st, torch.as_tensor(mod), torch.as_tensor(car))
    _, gold = native.vocoder(voc, mod, car)
    assert snr_db(gold, y.numpy()) > 120
    st, y1 = voc.process(st, torch.as_tensor(mod[:1500]), torch.as_tensor(car[:1500]))
    _, y2 = voc.process(st, torch.as_tensor(mod[1500:]), torch.as_tensor(car[1500:]))
    assert snr_db(gold, torch.cat([y1, y2]).numpy()) > 120
