"""The port against the shared C++ goldens of `native/` (the independent
float64 oracle that `tests/test_native.py` holds the JAX package to), on
the CPU in float64: `BiquadChain` on each engine, `FIRFilter`,
`envelope_scan`, `MoogFilter` in every variant with oversampling, the
feed-forward `Compressor`, `Freeverb`, `FDNReverb` and the feedback
`Delay`.

The native wrappers take the JAX package's objects (they read its
derived constants and test its enums by identity), so each case builds
the JAX object from the same parameters, passes it to the golden, and
asserts that the port's object derived the same constants.

Bars are those of tests/test_native.py: > 200 dB for the biquad,
atol 1e-12 for the FIR and the envelope, > 120 dB for Moog, dynamics,
the reverbs and the delay.
"""

import tests.torch_port_setup  # noqa: F401  (first: one PyTorch thread)

import dataclasses

import numpy as np
import pytest
import torch

from algodsp_tpu import native
from algodsp_tpu.effects.dynamics import Compressor as JCompressor
from algodsp_tpu.effects.dynamics.core import DetectorMode as JMode
from algodsp_tpu.filters.moog import MoogFilter as JMoog
from algodsp_tpu.filters.moog import MoogVariant as JVariant
from algodsp_tpu_torch import convert
from algodsp_tpu_torch.filters.biquad import BiquadChain
from algodsp_tpu_torch.filters.design import butterworth_lp
from algodsp_tpu_torch.filters.design.rbj import highpass
from algodsp_tpu_torch.filters.fir import FIRFilter
from algodsp_tpu_torch.filters.moog import MoogFilter, MoogVariant
from algodsp_tpu_torch.ops.envscan import envelope_scan
from tests.conftest import snr_db

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library not built")

SR = 48000.0


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


@pytest.mark.parametrize("mode", ["blocked", "cascade", "scan"])
def test_biquad_chain_matches_golden(mode):
    """One call, and the same input streamed in three blocks with the
    state carried, against one golden DF2T call."""
    sos = np.vstack([butterworth_lp(2000.0, 6, SR), highpass(80.0, 0.9, SR)])
    x = np.random.default_rng(1).standard_normal(1024)
    _, y_gold = native.biquad_df2t(sos, np.zeros((sos.shape[0], 2)), x,
                                   gain=0.8)
    chain = BiquadChain(sos, gain=0.8)
    y = chain.process(_t(x), mode=mode).numpy()
    assert snr_db(y_gold, y) > 200
    st = chain.init_state((), dtype=torch.float64, device="cpu")
    parts = []
    for a, b in ((0, 256), (256, 640), (640, 1024)):
        st, yp = chain.process_stream(st, _t(x[a:b]), mode=mode)
        parts.append(yp.numpy())
    assert snr_db(y_gold, np.concatenate(parts)) > 200


def test_fir_matches_golden():
    rng = np.random.default_rng(3)
    taps = rng.standard_normal(17)
    x = rng.standard_normal(256)
    fir = FIRFilter(taps)
    _, y_gold = native.fir(taps, np.zeros(16), x)
    np.testing.assert_allclose(fir.process(_t(x)).numpy(), y_gold, atol=1e-12)
    hist, y1 = native.fir(taps, np.zeros(16), x[:100])
    st = fir.init_state((), dtype=torch.float64, device="cpu")
    st, z1 = fir.process_stream(st, _t(x[:100]))
    np.testing.assert_allclose(z1.numpy(), y1, atol=1e-12)
    np.testing.assert_allclose(st.numpy(), hist, atol=1e-12)
    _, y2 = native.fir(taps, hist, x[100:])
    _, z2 = fir.process_stream(st, _t(x[100:]))
    np.testing.assert_allclose(z2.numpy(), y2, atol=1e-12)


def test_envelope_matches_golden():
    x = np.random.default_rng(4).standard_normal(512)
    env_f, traj = native.envelope(x, 0.3, 0.05, env0=0.2)
    t_f, t_traj = envelope_scan(torch.abs(_t(x)), 0.2, 0.3, 0.05)
    np.testing.assert_allclose(t_traj.numpy(), traj, atol=1e-12)
    assert abs(float(t_f) - env_f) < 1e-12


MOOG_CASES = [("classic", 1, 1), ("classic_lightweight", 2, 1),
              ("improved_classic", 4, 1),
              ("improved_classic_lightweight", 1, 1), ("huovilainen", 4, 1),
              ("zdf", 2, 3)]


@pytest.mark.parametrize("variant,os_,newton", MOOG_CASES,
                         ids=[c[0] for c in MOOG_CASES])
def test_moog_matches_golden(variant, os_, newton):
    """Every variant with oversampling, streamed over two blocks with the
    eight-value state carried on both sides."""
    kw = dict(cutoff_hz=1800.0, resonance=2.4, drive=2.0, oversampling=os_,
              newton_iters=newton)
    jf = JMoog(SR, variant=JVariant(variant), **kw)
    tf = MoogFilter(SR, variant=MoogVariant(variant), **kw)
    for name in ("coefficient", "drive_scale", "feedback", "input_gain",
                 "output_scale", "thermal_voltage", "oversampling",
                 "newton_iters"):
        assert getattr(tf, name) == getattr(jf, name), name
    if variant == "zdf":
        assert tf.zdf_gk == jf.zdf_gk
    x = np.random.default_rng(20).standard_normal(512) * 0.5
    st8, y1 = native.moog(jf, np.zeros(8), x[:200])
    _, y2 = native.moog(jf, st8, x[200:])
    st = tf.init_state((), dtype=torch.float64, device="cpu")
    st, z1 = tf.process(st, _t(x[:200]))
    t8 = torch.cat([st["stage"], st["tanh_last"], st["prev_out"][None]])
    assert snr_db(st8, t8.numpy()) > 120
    _, z2 = tf.process(st, _t(x[200:]))
    assert snr_db(np.concatenate([y1, y2]),
                  np.concatenate([z1.numpy(), z2.numpy()])) > 120


@pytest.mark.parametrize("config", ["peak_makeup", "rms_prefilters"])
def test_feedforward_compressor_matches_golden(config):
    kw = dict(threshold_db=-16.0, ratio=4.0, knee_db=6.0, attack_ms=2.0,
              release_ms=60.0, makeup_gain_db=1.5)
    if config == "rms_prefilters":
        kw.update(detector_mode=JMode.RMS, rms_window_ms=5.0,
                  sidechain_low_cut_hz=80.0, sidechain_high_cut_hz=8000.0)
    jc = JCompressor(SR, **kw)
    tc = convert.compressor_from_config(dataclasses.asdict(jc.core.cfg))
    for name in ("attack_coeff", "release_coeff", "threshold_log2",
                 "knee_width_log2", "inv_knee_width_log2", "makeup_gain_lin",
                 "rms_window", "lp_coeff", "hp_coeff"):
        assert getattr(tc.core, name) == getattr(jc.core, name), name
    rng = np.random.default_rng(30)
    x = rng.standard_normal(2048) * np.concatenate(
        [np.full(1024, 0.8), np.full(1024, 0.05)])
    _, y_gold, g_gold = native.dynamics_feedforward(jc.core, x)
    _, y, g = tc.process(tc.init_state((), dtype=torch.float64, device="cpu"),
                         _t(x), with_gain=True)
    assert snr_db(y_gold, y.numpy()) > 120
    assert snr_db(g_gold, g.numpy()) > 120


def test_freeverb_matches_golden():
    """Streamed in ragged calls (blocked engine and per-sample tails), the
    rings and damping states carried on both sides."""
    from algodsp_tpu.effects.reverb import Freeverb as JFreeverb
    from algodsp_tpu_torch.effects.reverb import Freeverb
    kw = dict(wet=0.3, dry=0.7, room_size=0.8, damp=0.4)
    jf, tf = JFreeverb(**kw), Freeverb(**kw)
    for name in ("input_gain", "comb_feedback", "allpass_feedback", "damp",
                 "wet", "dry"):
        assert getattr(tf, name) == getattr(jf, name), name
    x = np.random.default_rng(31).standard_normal(1200) * 0.5
    g_st, g_n, y1 = native.freeverb(jf, x[:461])
    _, _, y2 = native.freeverb(jf, x[461:], state=g_st, step=g_n)
    st = tf.init_state((), dtype=torch.float64, device="cpu")
    st, z1 = tf.process(st, _t(x[:461]))
    assert int(st["step"]) == g_n
    assert snr_db(g_st[0], torch.cat(st["combs"]).numpy()) > 120
    assert snr_db(g_st[2], torch.cat(st["allpasses"]).numpy()) > 120
    _, z2 = tf.process(st, _t(x[461:]))
    assert snr_db(np.concatenate([y1, y2]),
                  np.concatenate([z1.numpy(), z2.numpy()])) > 120


def test_fdn_matches_golden():
    """Blocks of the reference's `_block` and a per-sample tail, the
    lines, pre-delay, damping and LFO phase carried."""
    from algodsp_tpu.effects.reverb import FDNReverb as JFDN
    from algodsp_tpu_torch.effects.reverb import FDNReverb
    kw = dict(wet=0.4, dry=0.6, rt60_seconds=1.2, damp=0.25,
              mod_depth_seconds=0.001, mod_rate_hz=0.3)
    jr, tr = JFDN(SR, **kw), FDNReverb(SR, **kw)
    for name in ("line_len", "pre_len", "pre_delay", "mod_depth", "gain",
                 "_block"):
        assert getattr(tr, name) == getattr(jr, name), name
    np.testing.assert_array_equal(tr.feedback_gains, jr.feedback_gains)
    x = np.random.default_rng(32).standard_normal(3000) * 0.5
    g_st, g_n, y1 = native.fdn(jr, x[:1300])
    _, _, y2 = native.fdn(jr, x[1300:], state=g_st, step=g_n)
    st = tr.init_state((), dtype=torch.float64, device="cpu")
    st, z1 = tr.process(st, _t(x[:1300]))
    assert snr_db(g_st[0], st["lines"].numpy()) > 120
    assert abs(float(st["lfo_phase"]) - g_st[3]) < 1e-9
    _, z2 = tr.process(st, _t(x[1300:]))
    assert snr_db(np.concatenate([y1, y2]),
                  np.concatenate([z1.numpy(), z2.numpy()])) > 120


def test_delay_effect_matches_golden():
    """The smoothed lag retargeted mid-stream (`delay.go:140-166`)."""
    from algodsp_tpu.effects.delay_effect import Delay as JDelay
    from algodsp_tpu_torch.effects.delay_effect import Delay
    kw = dict(delay_seconds=0.02, feedback=0.5, mix=0.5, smooth_ms=5.0)
    jd, td = JDelay(SR, **kw), Delay(SR, **kw)
    for name in ("delay_samples", "buf_len", "smooth_coeff", "feedback", "mix"):
        assert getattr(td, name) == getattr(jd, name), name
    x = np.random.default_rng(123).standard_normal(4096)
    tgt = 0.03 * SR
    g, z1 = native.delay_effect(jd, x[:2048])
    g, z2 = native.delay_effect(jd, x[2048:], state=g, target=tgt)
    st = td.init_state((), dtype=torch.float64, device="cpu")
    st, y1 = td.process(st, _t(x[:2048]))
    st, y2 = td.process(st, _t(x[2048:]), target_delay_samples=tgt)
    assert abs(float(st["current"]) - g[-1]) < 1e-9
    assert snr_db(np.concatenate([z1, z2]),
                  np.concatenate([y1.numpy(), y2.numpy()])) > 120
