"""The port's `diff.py` against the JAX package's `algodsp_tpu.diff` on the
CPU, float64 (x64 is on in conftest): the designers' coefficients and
their gradients in the design parameters, the response of a tensor SOS
stack, the DF2T runtime and the FIR runtime (values and gradients), and
a short EQ fit with `torch.optim.Adam`.

Tolerances: the same maths in float64 agrees to rtol 1e-10 (values and
gradients; the designers' coefficients to 1e-12); runtimes to >= 200 dB.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from algodsp_tpu import diff as jdiff
from algodsp_tpu.filters import biquad as jbiquad, design as jd
from algodsp_tpu_torch import diff
from tests.conftest import snr_db

SR = 48000.0
KINDS = ["lowpass", "highpass", "bandpass", "notch", "allpass", "peak",
         "low_shelf", "high_shelf"]
GAIN_KINDS = {"peak", "low_shelf", "high_shelf"}


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float64, requires_grad=grad)


@pytest.mark.parametrize("kind", KINDS)
def test_designer_matches_jax(kind):
    """Coefficients and the gradient of a weighted sum of them in every
    design parameter, for scalar and for vector parameters."""
    w = np.array([0.3, -1.1, 0.7, 2.0, -0.4])
    params = ([np.float64(3140.0), np.float64(-4.5), np.float64(1.3)]
              if kind in GAIN_KINDS else [np.float64(3140.0), np.float64(1.3)])
    j_fn, t_fn = getattr(jdiff, kind), getattr(diff, kind)
    j_loss = lambda *p: jnp.sum(j_fn(*p, SR) * w)
    argnums = tuple(range(len(params)))
    want = np.asarray(j_fn(*params, SR))
    g_want = jax.jit(jax.grad(j_loss, argnums=argnums))(*params)
    ps = [_t(p, grad=True) for p in params]
    got = t_fn(*ps, SR)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-12,
                               atol=1e-12)
    (got * _t(w)).sum().backward()
    for p, g in zip(ps, g_want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), rtol=1e-10)
    vec = [np.array([500.0, 3140.0, 9000.0])] + [
        np.full(3, float(p)) for p in params[1:]]
    np.testing.assert_allclose(t_fn(*(_t(v) for v in vec), SR).numpy(),
                               np.asarray(j_fn(*vec, SR)), rtol=1e-12,
                               atol=1e-12)


def test_designer_types_and_host_parity(monkeypatch):
    """Python numbers alone design in float64 on the device asked for
    (the card unless device="cpu": without one they raise) and match the
    host designer; float32 tensors design in float32 on their own
    device, and a device that disagrees with them raises; constrain
    keeps value and gradient finite for raw of any magnitude, as JAX's
    does."""
    got = diff.peak(1200.0, -6.0, 2.0, SR, device="cpu")
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        diff.peak(1200.0, -6.0, 2.0, SR)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        diff.sos_response(np.asarray(got), np.array([100.0]), SR)
    with pytest.raises(ValueError, match="given for tensors"):
        diff.lowpass(torch.tensor(1000.0), 0.7, SR, device="meta")
    np.testing.assert_allclose(got.numpy(), jd.peak(1200.0, -6.0, 2.0, SR),
                               rtol=1e-12, atol=1e-12)
    f32 = diff.lowpass(torch.tensor(1000.0), torch.tensor(0.7), SR)
    assert f32.dtype == torch.float32
    raw = _t([-1e4, -3.0, 0.0, 2.5, 1e4], grad=True)
    c = diff.constrain(raw, 40.0, 800.0)
    c.sum().backward()
    want = jdiff.constrain(jnp.asarray(raw.detach().numpy()), 40.0, 800.0)
    g_want = jax.grad(lambda r: jnp.sum(jdiff.constrain(r, 40.0, 800.0)))(
        jnp.asarray(raw.detach().numpy()))
    np.testing.assert_allclose(c.detach().numpy(), np.asarray(want), rtol=1e-12)
    np.testing.assert_allclose(raw.grad.numpy(), np.asarray(g_want), rtol=1e-10,
                               atol=1e-300)
    assert bool(torch.isfinite(raw.grad).all())


def test_sos_response_and_magnitude_match_jax():
    """sos_response against JAX and the host response; sos_magnitude_db
    and its gradient in the coefficients against JAX."""
    sos = np.stack([jd.low_shelf(150.0, 3.0, 0.8, SR), jd.peak(1200.0, -6.0, 2.0, SR),
                    jd.high_shelf(8000.0, 4.5, 0.7, SR)])
    freqs = np.geomspace(30.0, 20000.0, 64)
    h = diff.sos_response(_t(sos), freqs, SR)
    np.testing.assert_allclose(h.numpy(), np.asarray(jdiff.sos_response(sos, freqs, SR)),
                               rtol=1e-10)
    np.testing.assert_allclose(h.numpy(), jbiquad.sos_response(sos, freqs, SR),
                               rtol=1e-10)
    w = np.linspace(-1.0, 1.0, 64)
    st = _t(sos, grad=True)
    m = diff.sos_magnitude_db(st, freqs, SR)
    (m * _t(w)).sum().backward()
    j_m = jdiff.sos_magnitude_db(sos, freqs, SR)
    g = jax.jit(jax.grad(lambda s: jnp.sum(
        jdiff.sos_magnitude_db(s, freqs, SR) * w)))(jnp.asarray(sos))
    np.testing.assert_allclose(m.detach().numpy(), np.asarray(j_m), rtol=1e-10)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(g), rtol=1e-10)


def test_sos_filter_matches_jax(rng):
    """DF2T runtime over tensor coefficients: y and the new state from a
    nonzero state, and the gradients in sos, x and the state, against
    JAX's lax.scan; two halves with the state carried equal one call."""
    sos = np.stack([jd.peak(900.0, 5.0, 1.4, SR), jd.lowpass(6000.0, 0.7, SR)])
    x = rng.standard_normal((2, 300))
    st0 = 0.1 * rng.standard_normal((2, 2, 2))
    wy, ws = rng.standard_normal((2, 300)), rng.standard_normal((2, 2, 2))

    def j_loss(s, x, st):
        y, new = jdiff.sos_filter(s, x, st)
        return jnp.sum(y * wy) + jnp.sum(new * ws)

    y_j, st_j = jax.jit(jdiff.sos_filter)(sos, x, st0)
    g_j = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2)))(sos, x, st0)
    args = [_t(a, grad=True) for a in (sos, x, st0)]
    y, st = diff.sos_filter(*args)
    assert snr_db(np.asarray(y_j), y.detach().numpy()) >= 200
    assert snr_db(np.asarray(st_j), st.detach().numpy()) >= 200
    (torch.sum(y * _t(wy)) + torch.sum(st * _t(ws))).backward()
    for a, g in zip(args, g_j):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), rtol=1e-10,
                                   atol=1e-12)
    y1, s1 = diff.sos_filter(_t(sos), _t(x[:, :120]), _t(st0))
    y2, s2 = diff.sos_filter(_t(sos), _t(x[:, 120:]), s1)
    np.testing.assert_allclose(torch.cat([y1, y2], -1).numpy(),
                               y.detach().numpy(), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(s2.numpy(), st.detach().numpy(), rtol=1e-12,
                               atol=1e-14)


def test_fir_filter_matches_jax(rng):
    """Causal FIR over tensor taps: values against JAX and np.convolve,
    gradients in taps and x against JAX."""
    taps = rng.standard_normal(16)
    x = rng.standard_normal((2, 64))
    w = rng.standard_normal((2, 64))
    tt, xt = _t(taps, grad=True), _t(x, grad=True)
    y = diff.fir_filter(tt, xt)
    want = np.stack([np.convolve(x[i], taps)[:64] for i in range(2)])
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(jdiff.fir_filter(taps, x)),
                               rtol=1e-10, atol=1e-12)
    (y * _t(w)).sum().backward()
    g_t, g_x = jax.jit(jax.grad(lambda t, v: jnp.sum(
        jdiff.fir_filter(t, v) * w), argnums=(0, 1)))(jnp.asarray(taps),
                                                      jnp.asarray(x))
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(g_t), rtol=1e-10)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), rtol=1e-10)


def test_short_eq_fit():
    """A 2-band EQ (peak + high shelf) recovered from its response by
    Adam through the port's designers: the first gradient equals JAX's,
    and 300 steps bring the response within 0.5 dB."""
    freqs = np.geomspace(40.0, 18000.0, 64)
    target = diff.sos_magnitude_db(torch.stack([
        diff.peak(800.0, 5.0, 1.4, SR, device="cpu"),
        diff.high_shelf(6000.0, -4.0, 0.9, SR, device="cpu")]), freqs, SR)

    def build(m, raw):
        return m.stack([
            m.peak(m.constrain(raw[0], 100.0, 4000.0), 12.0 * _tanh(raw[1]),
                   m.constrain(raw[2], 0.3, 6.0), SR),
            m.high_shelf(m.constrain(raw[3], 2000.0, 16000.0),
                         12.0 * _tanh(raw[4]), m.constrain(raw[5], 0.3, 6.0),
                         SR)])

    class _T:
        stack, peak, high_shelf, constrain = (torch.stack, diff.peak,
                                              diff.high_shelf, diff.constrain)

    class _J:
        stack, peak, high_shelf, constrain = (jnp.stack, jdiff.peak,
                                              jdiff.high_shelf, jdiff.constrain)

    def loss(m, mag, raw, tgt):
        return ((mag(build(m, raw), freqs, SR) - tgt) ** 2).mean()

    raw = torch.zeros(6, dtype=torch.float64, requires_grad=True)
    g_j = jax.jit(jax.grad(lambda r: loss(_J, jdiff.sos_magnitude_db, r,
                                          jnp.asarray(target.numpy()))))(
        jnp.zeros(6))
    l0 = loss(_T, diff.sos_magnitude_db, raw, target)
    (g0,) = torch.autograd.grad(l0, raw)
    np.testing.assert_allclose(g0.numpy(), np.asarray(g_j), rtol=1e-10,
                               atol=1e-12 * float(torch.max(torch.abs(g0))))
    opt = torch.optim.Adam([raw], lr=0.05)
    for _ in range(300):
        opt.zero_grad()
        loss(_T, diff.sos_magnitude_db, raw, target).backward()
        opt.step()
    with torch.no_grad():
        err = torch.max(torch.abs(diff.sos_magnitude_db(
            build(_T, raw), freqs, SR) - target))
    assert float(err) < 0.5, float(err)


def _tanh(v):
    return torch.tanh(v) if torch.is_tensor(v) else jnp.tanh(v)
