"""The port's dither quantizer against the JAX package on the CPU (the
port through Q1's plain version, JAX jitted), fed JAX's own noise draws
(as tests/test_native.py's `_engine_noise` gets them): the codes with no
shaper, the FIR presets and the IIR shelf, streamed against one call;
the C++ golden; the generator's draws and their statistics; the zero
gradient against `jax.grad`; the presets and the designer; and a NumPy
model of Q1's walk (tiles of 32 samples staged for a warp of 32
channels, one channel a thread) against the plain version.

Bars: float64 codes exactly equal to JAX's (as the golden holds them);
float32 codes differ from JAX's float32 codes in no more places than
JAX's float32 codes differ from its float64 codes on the same input (a
one-ulp difference in `shaped` flips a floor and the error feedback
carries it on); the golden's codes exactly equal; the Q1 model bit for
bit.
"""

import tests.torch_port_setup  # noqa: F401  (first: one PyTorch thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algodsp_tpu import native
from algodsp_tpu.dither import designer as jdesigner
from algodsp_tpu.dither import quantizer as jq
from algodsp_tpu_torch import dither as tdither
from algodsp_tpu_torch.dither import quantizer as tq
from algodsp_tpu_torch.ops import dither as q1
from tests.torch_port_setup import ref_jit

SR = 48000.0
C, N = 3, 2048


def _pair(kind, **kw):
    """(JAX, port) quantizers of one configuration."""
    def make(m):
        base = dict(bit_depth=16, seed=7, **kw)
        if kind == "none":
            return m.Quantizer(SR, preset=m.Preset.NONE, **base)
        if kind == "iir":
            return m.Quantizer(SR, iir_shelf_freq=8000.0, **base)
        return m.Quantizer(SR, preset=getattr(m.Preset, kind), **base)
    return make(jq), make(tq)


def _engine_noise(qz, shape, dtype):
    """The noise JAX's first call draws (tests/test_native.py:645-652)."""
    st = qz.init_state((), jnp.float64)
    _, sub = jax.random.split(st["key"])
    return np.asarray(qz._noise(sub, shape, jnp.dtype(dtype)))


def _x(seed=108):
    rng = np.random.default_rng(seed)
    return np.clip(rng.standard_normal((C, N)) * 0.3, -1.0, 1.0)


def _codes(qj, qt, x, dtype):
    nz = _engine_noise(qj, x.shape, dtype)
    sj, cj = ref_jit(qj.process_integer)(qj.init_state((C,), jnp.dtype(dtype)),
                                         jnp.asarray(x.astype(dtype)))
    st = qt.init_state((C,), getattr(torch, dtype), "cpu")
    s2, ct = qt.process_integer(st, torch.as_tensor(x.astype(dtype)),
                                noise=torch.tensor(nz))
    return np.asarray(cj), ct.numpy(), sj, s2


@pytest.mark.parametrize("kind", ["none", "FC9", "SBM", "MEC3", "iir"])
def test_codes_match_jax(kind):
    qj, qt = _pair(kind)
    x = _x()
    j64, t64, sj, st = _codes(qj, qt, x, "float64")
    assert t64.dtype == np.int32
    np.testing.assert_array_equal(t64, j64)
    # the error states within a few ulps of `shaped` (~3e4, ulp 3.6e-12):
    # the FIR's sum over k runs in another order in XLA's einsum
    for key in ("err", "iir"):
        if key in sj:
            np.testing.assert_allclose(st[key].numpy(), np.asarray(sj[key]),
                                       rtol=0, atol=1e-10)
    j32, t32, _, _ = _codes(qj, qt, x, "float32")
    assert int(np.sum(t32 != j32)) <= int(np.sum(j32 != j64)), kind


@pytest.mark.parametrize("kind", ["none", "FC9", "iir"])
def test_codes_match_native(kind):
    """tests/test_native.py's case at 12 bits: the codes on the same noise
    exactly equal."""
    shaper = ({"iir_shelf_freq": 8000.0} if kind == "iir" else
              {"preset": tq.Preset.NONE if kind == "none" else tq.Preset.FC9})
    qt = tq.Quantizer(SR, bit_depth=12, seed=7, **shaper)
    x = _x(109)[0]
    nz = np.random.default_rng(5).uniform(-1, 1, x.shape)
    _, q = qt.process_integer(qt.init_state((), torch.float64, "cpu"),
                              torch.as_tensor(x), noise=torch.as_tensor(nz))
    _, gold = native.quantize(qt, x, nz)
    np.testing.assert_array_equal(gold, q.numpy().astype(np.float64))


@pytest.mark.parametrize("kind", ["FC9", "iir"])
def test_streamed_equals_one_call(kind):
    """Codes and state, given the same noise, block by block and in one
    call; `process` returns (code + 0.5) * bit_div as JAX's does."""
    _, qt = _pair(kind)
    x = torch.as_tensor(_x(3))
    nz = torch.as_tensor(np.random.default_rng(4).uniform(-1, 1, x.shape))
    s_all, q_all = qt.process_integer(qt.init_state((C,), torch.float64, "cpu"),
                                      x, noise=nz)
    st, parts = qt.init_state((C,), torch.float64, "cpu"), []
    for a, b in ((0, 700), (700, 701), (701, N)):
        st, q = qt.process_integer(st, x[:, a:b], noise=nz[:, a:b])
        parts.append(q)
    assert torch.equal(torch.cat(parts, -1), q_all)
    for key in s_all:
        if key != "key":
            assert torch.equal(st[key], s_all[key])
    qj, _ = _pair(kind)
    _, yj = qj.process(qj.init_state((), jnp.float64), jnp.asarray(x[0].numpy()))
    _, yt = qt.process(qt.init_state((), torch.float64, "cpu"), x[0],
                       noise=torch.tensor(_engine_noise(qj, (N,), "float64")))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))


@pytest.mark.parametrize("dither", list(tq.DitherType), ids=lambda d: d.value)
def test_generator_draws_and_statistics(dither):
    """The generator moves on every call (two calls draw different noise,
    a fresh state repeats the first), and the draws have JAX's
    statistics: mean, variance and range within sampling error."""
    qt = tq.Quantizer(SR, bit_depth=8, preset=tq.Preset.NONE, limit=False,
                      dither_type=dither, dither_amplitude=0.8)
    qj = jq.Quantizer(SR, bit_depth=8, preset=jq.Preset.NONE, limit=False,
                      dither_type=jq.DitherType(dither.value), dither_amplitude=0.8)
    x = torch.zeros(4, 1 << 14, dtype=torch.float64)
    st0 = qt.init_state((4,), torch.float64, "cpu")
    st1, a = qt.process(st0, x)
    _, b = qt.process(st1, x)
    _, a_again = qt.process(qt.init_state((4,), torch.float64, "cpu"), x)
    assert torch.equal(a, a_again)
    assert (dither == tq.DitherType.NONE) == torch.equal(a, b)
    mine = qt._noise(torch.Generator().manual_seed(3), (1 << 16,), torch.float64,
                     "cpu").numpy()
    ref = _engine_noise(qj, (1 << 16,), "float64")
    assert abs(mine.mean() - ref.mean()) < 0.02
    assert abs(mine.var() - ref.var()) < 0.02 * max(ref.var(), 1e-3)
    if dither not in (tq.DitherType.GAUSSIAN,):
        assert mine.min() >= -0.8 * 3 and mine.max() <= 0.8 * 3
        assert abs(mine.max() - ref.max()) < 0.05 and abs(mine.min() - ref.min()) < 0.05


def test_zero_gradient_matches_jax():
    """floor makes the output's gradient zero in JAX; the port's
    ErrorFeedbackFn returns that zero (FIR, IIR and no shaper)."""
    for kind in ("FC9", "iir", "none"):
        qj, qt = _pair(kind)
        x = _x(8)[0] * 0.5
        nz = _engine_noise(qj, x.shape, "float64")
        w = np.random.default_rng(9).standard_normal(x.shape)
        gj = np.asarray(jax.grad(lambda v: jnp.sum(qj.process(
            qj.init_state((), jnp.float64), v)[1] * w))(jnp.asarray(x)))
        xt = torch.tensor(x, requires_grad=True)
        _, y = qt.process(qt.init_state((), torch.float64, "cpu"), xt,
                          noise=torch.tensor(nz))
        (y * torch.as_tensor(w)).sum().backward()
        assert not np.any(gj) and xt.grad is not None
        np.testing.assert_array_equal(xt.grad.numpy(), gj)


def test_presets_designer_and_errors_match_jax():
    for p in tq.Preset:
        np.testing.assert_array_equal(tq.preset_coefficients(p),
                                      jq.preset_coefficients(jq.Preset(p.value)))
    for rate in (32000.0, 44100.0, 48000.0, 88200.0, 96000.0, 192000.0):
        np.testing.assert_array_equal(tq.sharp_preset_for_sample_rate(rate),
                                      jq.sharp_preset_for_sample_rate(rate))
    seen_t, seen_j = [], []
    got = tdither.design_shaper(SR, 5, iterations=30, population=16, seed=3,
                                progress=lambda i, c: seen_t.append(c))
    want = jdesigner.design_shaper(SR, 5, iterations=30, population=16, seed=3,
                                   progress=lambda i, c: seen_j.append(c))
    np.testing.assert_array_equal(got, want)
    assert seen_t == seen_j
    f = np.linspace(10, 20000, 50)
    np.testing.assert_array_equal(tdither.ath_weight_db(f), jdesigner.ath_weight_db(f))
    for kw in (dict(bit_depth=0), dict(bit_depth=33), dict(iir_shelf_freq=24000.0)):
        with pytest.raises(ValueError):
            tq.Quantizer(SR, **kw)
        with pytest.raises(ValueError):
            jq.Quantizer(SR, **kw)
    qt, qj = tq.Quantizer(SR, bit_depth=24), jq.Quantizer(SR, bit_depth=24)
    for key in ("bit_mul", "bit_div", "limit_lo", "limit_hi"):
        assert getattr(qt, key) == getattr(qj, key)
    with pytest.raises(ValueError, match="noise"):
        qt.process(qt.init_state((), torch.float64, "cpu"),
                   torch.zeros(8, dtype=torch.float64), noise=torch.zeros(9))


# -- a NumPy model of Q1's walk ---------------------------------------------------

def _q1_model(scaled, noise, state, p: q1.ShaperParams, warp=32, tile=32):
    """csrc/dither.cu step by step: blocks of 32 channels, time in tiles of
    32 staged for the warp, each thread walking its channel's tile in
    order; the same products and sums, rounded one by one in the type."""
    dt = scaled.dtype.type
    c_all, n = scaled.shape
    q = np.zeros_like(scaled)
    out_state = np.zeros_like(state)
    cs = np.asarray(p.coeffs, scaled.dtype)
    b0, b1, b2, a1, a2 = (np.asarray(p.shelf or (0,) * 5, scaled.dtype))
    lo, hi = dt(p.lo), dt(p.hi)
    for c0 in range(0, c_all, warp):
        for c in range(c0, min(c0 + warp, c_all)):
            h = list(state[c])
            for t0 in range(0, n, tile):
                xs = scaled[c, t0:t0 + tile]
                ns = noise[c, t0:t0 + tile]
                for j in range(xs.shape[0]):
                    if p.shelf is not None:
                        e = h[2]
                        fo = b0 * e + h[0]
                        d0 = b1 * e - a1 * fo + h[1]
                        d1 = b2 * e - a2 * fo
                        shaped = xs[j] - fo
                    else:
                        acc = cs[0] * h[0]
                        for k in range(1, len(cs)):
                            acc = acc + cs[k] * h[k]
                        shaped = xs[j] - acc
                    v = np.floor(shaped + ns[j])
                    if p.limit:
                        v = lo if v < lo else v
                        v = hi if v > hi else v
                    if p.shelf is not None:
                        h = [d0, d1, v - shaped]
                    else:
                        h = [v - shaped] + h[:-1]
                    q[c, t0 + j] = v
            out_state[c] = h
    return q, out_state


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_q1_walk_model_matches_plain(dtype):
    """33 channels (a second block of one channel), 70 samples (a ragged
    last tile), the FIR at order 12, the IIR shelf, and a NaN (kept by
    the clip) with an overflow the clip limits, bit for bit."""
    rng = np.random.default_rng(30)
    x = (rng.standard_normal((33, 70)) * 3e4).astype(dtype)
    x[5, 10] = np.nan
    x[6, 20] = 1e9
    nz = rng.uniform(-1, 1, x.shape).astype(dtype)
    for kind in ("SBM", "iir"):
        _, qt = _pair(kind)
        p = qt.shaper
        s0 = (rng.standard_normal((33, p.state_width())) * 0.3).astype(dtype)
        q, s = q1.error_feedback(torch.as_tensor(x), torch.as_tensor(nz),
                                 torch.as_tensor(s0), p)
        qm, sm = _q1_model(x, nz, s0, p)
        np.testing.assert_array_equal(q.numpy(), qm, err_msg=kind)
        np.testing.assert_array_equal(s.numpy(), sm, err_msg=kind)
        assert np.isnan(q.numpy()[5, 10]) and q.numpy()[6, 20] == p.hi
