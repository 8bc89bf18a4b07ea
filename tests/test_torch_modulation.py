"""The port's modulation effects against the JAX package on the CPU
(`effects/modulation/`: Chorus, Tremolo, RingModulator, Flanger, Phaser,
AutoWah, FrequencyShifter; the port through the plain versions of M1-M3
and of K3/K4, JAX through its XLA paths, jitted), the plain affine
scans against the reference's, autograd through the plain versions
against `jax.grad`, and each effect against its C++ golden of
`native/`.

Tolerances: float64 >= 200 dB with states within 1e-10 (the affine
scans compose in another order than JAX's associative scan); float32
against JAX float64, no more than 6 dB below JAX float32's own SNR
against JAX float64 (the reference's float32 class: the LFO phases
accumulate in float32 as in the reference); gradients in float64 >= 200
dB; the goldens at tests/test_native.py's bars (> 120 dB).
"""

import tests.torch_port_setup  # noqa: F401  (first: one PyTorch thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algodsp_tpu import native
from algodsp_tpu.effects import modulation as jmod
from algodsp_tpu.ops import linrec as jlinrec
from algodsp_tpu_torch.effects import modulation as tmod
from algodsp_tpu_torch.ops import linrec
from tests.conftest import snr_db
from tests.torch_port_setup import ref_jit

SR = 48000.0
C = 2
CUTS = (0, 350, 700)                 # two calls, no multiple of any block


def _x(n, seed=0, dtype="float64", scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal((C, n))).astype(dtype)


def _leaves(st):
    if isinstance(st, dict):
        return [v for k in sorted(st) for v in _leaves(st[k])]
    if isinstance(st, (tuple, list)):
        return [v for s in st for v in _leaves(s)]
    return [np.asarray(st.detach().numpy() if torch.is_tensor(st) else st)]


def _stream(fx, proc, x, dtype, lib):
    st = (fx.init_state((C,), jnp.dtype(dtype)) if lib == "jax"
          else fx.init_state((C,), getattr(torch, dtype), "cpu"))
    ys = []
    for a, b in zip(CUTS[:-1], CUTS[1:]):
        xb = jnp.asarray(x[..., a:b]) if lib == "jax" else torch.as_tensor(x[..., a:b])
        st, y = proc(st, xb)
        ys.append(np.asarray(y) if lib == "jax" else y.numpy())
    return st, np.concatenate(ys, axis=-1)


def _check(name, kw, seed=0, scale=0.5):
    """Both packages streamed in CUTS: float64 >= 200 dB and states within
    1e-10 (integers equal); float32 within 6 dB of JAX float32's class."""
    fj, ft = getattr(jmod, name)(SR, **kw), getattr(tmod, name)(SR, **kw)
    jp = ref_jit(fj.process)
    x = _x(CUTS[-1], seed, scale=scale)
    sj, yj = _stream(fj, jp, x, "float64", "jax")
    st, yt = _stream(ft, ft.process, x, "float64", "torch")
    assert yt.dtype == np.float64 and snr_db(yj, yt) >= 200
    for a, b in zip(_leaves(sj), _leaves(st)):
        if np.issubdtype(a.dtype, np.integer):
            assert int(a) == int(b)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-10)
    x32 = x.astype(np.float32)
    _, yj32 = _stream(fj, jp, x32, "float32", "jax")
    _, yt32 = _stream(ft, ft.process, x32, "float32", "torch")
    assert yt32.dtype == np.float32
    assert snr_db(yj, yt32) >= snr_db(yj, yj32) - 6.0


@pytest.mark.parametrize("base", [0.02, 0.00005], ids=["walking", "gather"])
def test_chorus_matches_jax(base):
    """The walking read where the base delay reaches 4 samples, the
    fractional gather under it."""
    _check("Chorus", dict(base_delay_seconds=base, speed_hz=1.3, mix=0.6))


@pytest.mark.parametrize("smoothing", [5.0, 0.0], ids=["smoothed", "raw"])
def test_tremolo_matches_jax(smoothing):
    _check("Tremolo", dict(rate_hz=6.0, depth=0.7, mix=0.9,
                           smoothing_ms=smoothing))


def test_ring_modulator_matches_jax():
    _check("RingModulator", dict(carrier_hz=317.0, mix=0.7))


@pytest.mark.parametrize("base", [0.001, 0.0001], ids=["blocked", "per_sample"])
def test_flanger_matches_jax(base):
    """The blocked form with its per-sample tail (1 ms: 46-sample
    blocks) and the per-sample form (0.1 ms), the ring and the int32
    counter carried."""
    _check("Flanger", dict(base_delay_seconds=base, depth_seconds=0.0015,
                           rate_hz=0.7, feedback=0.6, mix=0.5))


def test_phaser_matches_jax():
    _check("Phaser", dict(stages=6, rate_hz=0.9, feedback=0.5, mix=0.6))


def test_phaser_arbitrary_initial_state():
    """Sample 0 from a full state that the reduced scan's redundancy does
    not hold, then N - 1 samples on the scan, against the per-sample loop
    and against JAX (as tests/test_modulation.py's case); N = 1 takes
    its own branch."""
    kw = dict(rate_hz=0.9, stages=4, feedback=0.55, mix=0.6)
    ph, jph = tmod.Phaser(SR, **kw), jmod.Phaser(SR, **kw)
    rng = np.random.default_rng(23)
    st = {"x1": rng.standard_normal((3, 4)), "y1": rng.standard_normal((3, 4)),
          "fb": rng.standard_normal(3), "phase": np.float64(1.1)}
    x = rng.standard_normal((3, 257))
    to_t = lambda d: {k: torch.as_tensor(v) for k, v in d.items()}
    _, y_j = ref_jit(jph.process)({k: jnp.asarray(v) for k, v in st.items()},
                                  jnp.asarray(x))
    for n in (257, 1):
        s1, y1 = ph.process(to_t(st), torch.as_tensor(x[:, :n]))
        s2, y2 = ph.process_scan(to_t(st), torch.as_tensor(x[:, :n]))
        assert snr_db(y2.numpy(), y1.numpy()) > 200
        for k in ("x1", "y1", "fb"):
            np.testing.assert_allclose(s1[k].numpy(), s2[k].numpy(), atol=1e-10)
    s1, y1 = ph.process(to_t(st), torch.as_tensor(x))
    assert snr_db(np.asarray(y_j), y1.numpy()) > 200


def test_autowah_matches_jax():
    _check("AutoWah", dict(sensitivity=8.0, q=3.0, mix=0.9), scale=0.8)


def test_frequency_shifter_matches_jax():
    """Up and down shift by +100 Hz, the carrier phase carried; -100 Hz
    swaps the two outputs (the reference's carrier runs at |shift|)."""
    x = _x(CUTS[-1], 4)
    fj = jmod.FrequencyShifter(SR, shift_hz=100.0)
    jp = ref_jit(lambda s, v: (lambda o: (o[0], jnp.stack(o[1])))(fj.process(s, v)))
    for dtype in ("float64", "float32"):
        _, yj = _stream(fj, jp, x.astype(dtype), dtype, "jax")
        if dtype == "float64":
            ref = yj
        for shift, order in ((100.0, [0, 1]), (-100.0, [1, 0])):
            ft = tmod.FrequencyShifter(SR, shift_hz=shift)
            _, yt = _stream(ft, lambda s, v: (lambda o: (o[0], torch.stack(o[1])))(
                ft.process(s, v)), x.astype(dtype), dtype, "torch")
            yt = yt[order]
            if dtype == "float64":
                assert snr_db(ref, yt) >= 200
            else:
                assert snr_db(ref, yt) >= snr_db(ref, yj) - 6.0


def test_plain_affine_scans_match_jax():
    """affine2_scan and affine_scan_nd (d = 7) from random states, float64
    >= 200 dB and float32 against JAX float64 within 6 dB of JAX
    float32's class."""
    rng = np.random.default_rng(9)
    n = 300
    A2 = 0.5 * rng.standard_normal((C, n, 4))
    w2 = rng.standard_normal((C, n, 2))
    s2 = rng.standard_normal((C, 2))
    And = 0.35 * rng.standard_normal((n, 7, 7))
    wnd = rng.standard_normal((C, n, 7))
    snd = rng.standard_normal((C, 7))
    cases = [(jlinrec.affine2_scan, linrec.affine2_scan, (A2, w2, s2)),
             (jlinrec.affine_scan_nd, linrec.affine_scan_nd, (And, wnd, snd))]
    for jf, tf, args in cases:
        jf = ref_jit(jf)
        ref = [np.asarray(v) for v in jf(*map(jnp.asarray, args))]
        got = tf(*map(torch.as_tensor, args))
        for r, g in zip(ref, got):
            assert snr_db(r, g.numpy()) >= 200
        a32 = [a.astype(np.float32) for a in args]
        j32 = [np.asarray(v) for v in jf(*map(jnp.asarray, a32))]
        t32 = tf(*map(torch.as_tensor, a32))
        for r, j, g in zip(ref, j32, t32):
            assert g.dtype == torch.float32
            assert snr_db(r, g.numpy()) >= snr_db(r, j) - 6.0


def test_gradients_match_jax():
    """Autograd through the plain versions of M1, M2 and M3 (the
    Flanger, the Phaser, the AutoWah) against jax.grad through the
    reference's scans, in x, float64."""
    x = _x(200, 11)
    wt = np.random.default_rng(12).standard_normal((C, 200))
    for name, kw in (("Flanger", dict(feedback=0.6)), ("Phaser", {}),
                     ("AutoWah", dict(mix=0.8))):
        fj, ft = getattr(jmod, name)(SR, **kw), getattr(tmod, name)(SR, **kw)

        def j_loss(v):
            _, y = fj.process(fj.init_state((C,), jnp.float64), v)
            return jnp.sum(y * wt)

        g_ref = np.asarray(ref_jit(jax.grad(j_loss))(jnp.asarray(x)))
        xt = torch.as_tensor(x).requires_grad_()
        _, y = ft.process(ft.init_state((C,), torch.float64, "cpu"), xt)
        torch.sum(y * torch.as_tensor(wt)).backward()
        assert snr_db(g_ref, xt.grad.numpy()) >= 200, name


def _golden(name, kw, x, split):
    """The golden streamed in two calls against the port in float64."""
    fj = getattr(jmod, name)(SR, **kw)
    ft = getattr(tmod, name)(SR, **kw)
    gold = getattr(native, {"Chorus": "chorus", "Flanger": "flanger",
                            "Phaser": "phaser", "AutoWah": "autowah",
                            "Tremolo": "tremolo", "RingModulator": "ringmod"}[name])
    g, y1 = gold(fj, x[:split])
    _, y2 = gold(fj, x[split:], state=g)
    st = ft.init_state((), torch.float64, "cpu")
    st, z1 = ft.process(st, torch.as_tensor(x[:split]))
    _, z2 = ft.process(st, torch.as_tensor(x[split:]))
    return np.concatenate([y1, y2]), np.concatenate([z1.numpy(), z2.numpy()])


GOLDEN = {
    "Chorus": dict(speed_hz=1.1, depth_seconds=0.003, base_delay_seconds=0.015,
                   mix=0.6, stages=3),
    "Flanger": dict(rate_hz=0.8, depth_seconds=0.0015, base_delay_seconds=0.003,
                    feedback=0.4, mix=0.6),
    "Phaser": dict(stages=4, rate_hz=1.2, feedback=0.6, mix=0.7),
    "AutoWah": dict(sensitivity=8.0, q=3.0, mix=0.9),
    "Tremolo": dict(rate_hz=6.5, depth=0.8, mix=0.9, smoothing_ms=3.0),
    "RingModulator": dict(carrier_hz=317.0, mix=0.7),
}


@pytest.mark.skipif(not native.available(), reason="native library not built")
@pytest.mark.parametrize("name", list(GOLDEN) + ["FrequencyShifter"])
def test_matches_golden(name):
    """Each effect against its C++ golden (the independent float64 oracle
    of tests/test_native.py), streamed in two calls where the golden
    carries state."""
    rng = np.random.default_rng(95)
    x = rng.standard_normal(4096) * np.concatenate([np.full(2048, 0.6),
                                                    np.full(2048, 0.05)])
    if name == "FrequencyShifter":
        for shift in (150.0, -90.0):
            fj = jmod.FrequencyShifter(SR, shift_hz=shift)
            _, up, down = native.freqshift(fj, x)
            ft = tmod.FrequencyShifter(SR, shift_hz=shift)
            _, (u, d) = ft.process(ft.init_state((), torch.float64, "cpu"),
                                   torch.as_tensor(x))
            assert snr_db(up, u.numpy()) > 120 and snr_db(down, d.numpy()) > 120
        return
    y_gold, y = _golden(name, GOLDEN[name], x, 2048 if name != "Phaser" else 1300)
    assert snr_db(y_gold, y) > 120
