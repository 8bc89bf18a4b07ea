"""The port's `interp.py` and `delayline.py` against the JAX package on the
CPU, and the LFO phase arithmetic of the modulation effects
(`torch.remainder` for `jnp.mod`) bit for bit.

Tolerances: the interpolation kernels and reads in float64 >= 200 dB
(or equal where both evaluate the same expression); float32 against
JAX float64 no more than 6 dB below JAX float32's own SNR against it;
the phase trajectories and their reductions bit-equal in float32.
"""

import tests.torch_port_setup  # noqa: F401  (first: one PyTorch thread)

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algodsp_tpu import delayline as jdl
from algodsp_tpu import interp as jinterp
from algodsp_tpu.effects.modulation import modulation as jmod
from algodsp_tpu_torch import delayline as tdl
from algodsp_tpu_torch import interp as tinterp
from algodsp_tpu_torch.effects.modulation import modulation as tmod
from tests.conftest import snr_db
from tests.torch_port_setup import ref_jit

SR = 48000.0
MODES = list(tinterp.Mode)


def _pair(ref64, port64, ref32, port32):
    """float64 >= 200 dB; float32 within 6 dB of JAX float32's class."""
    ref64 = np.asarray(ref64)
    assert snr_db(ref64, port64.numpy()) >= 200
    assert port32.dtype == torch.float32
    assert snr_db(ref64, port32.numpy()) >= snr_db(ref64, np.asarray(ref32)) - 6.0


def test_interp_kernels_match_jax():
    rng = np.random.default_rng(0)
    t = rng.uniform(0, 1, 64)
    pts = rng.standard_normal((4, 64))
    for name in ("hermite4", "lagrange4"):
        jf, tf = ref_jit(getattr(jinterp, name)), getattr(tinterp, name)
        args = (t, *pts)
        _pair(jf(*map(jnp.asarray, args)), tf(*map(torch.as_tensor, args)),
              jf(*(jnp.asarray(a, jnp.float32) for a in args)),
              tf(*(torch.as_tensor(a, dtype=torch.float32) for a in args)))
    np.testing.assert_array_equal(
        tinterp.linear2(torch.as_tensor(t), torch.as_tensor(pts[0]),
                        torch.as_tensor(pts[1])).numpy(),
        np.asarray(jinterp.linear2(t, pts[0], pts[1])))
    six = rng.standard_normal((64, 6))
    sixteen = rng.standard_normal((64, 16))
    assert snr_db(np.asarray(ref_jit(jinterp.lanczos6)(t, six)),
                  tinterp.lanczos6(torch.as_tensor(t), torch.as_tensor(six)).numpy()) >= 200
    assert snr_db(np.asarray(ref_jit(jinterp.sinc_interp, static_argnums=2)(
                      t, sixteen, 8)),
                  tinterp.sinc_interp(torch.as_tensor(t), torch.as_tensor(sixteen),
                                      8).numpy()) >= 200
    # t = 0 lands on the sinc's removable singularity
    assert float(tinterp.lanczos6(torch.tensor(0.0, dtype=torch.float64),
                                  torch.as_tensor(six[0]))) == pytest.approx(six[0, 2])
    out, st = tinterp.allpass_tick(torch.as_tensor(t), torch.as_tensor(pts[0]),
                                   torch.as_tensor(pts[1]), torch.as_tensor(pts[2]))
    j_out, _ = ref_jit(jinterp.allpass_tick)(t, pts[0], pts[1], pts[2])
    assert snr_db(np.asarray(j_out), out.numpy()) >= 200 and st is out
    for mode in MODES:
        assert tinterp.points_needed(mode, 6) == jinterp.points_needed(
            jinterp.Mode(mode.value), 6)
    for order in (1, 3, 5):
        a = tinterp.LagrangeInterpolator(order).interpolate(torch.as_tensor(pts.T), 0.3)
        b = jinterp.LagrangeInterpolator(order).interpolate(pts.T, 0.3)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-14)


@pytest.mark.parametrize("mode", MODES, ids=[m.value for m in MODES])
def test_fractional_read_matches_jax(mode):
    """Positions inside the timeline, before its start and past its end
    (reads there are 0), batched (2, 3) rows read at per-row positions."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 200))
    pos = rng.uniform(-12.0, 212.0, (2, 3, 150))
    read = ref_jit(functools.partial(jdl.fractional_read,
                                     mode=jinterp.Mode(mode.value)))
    ref64 = read(jnp.asarray(x), jnp.asarray(pos))
    ref32 = read(jnp.asarray(x, jnp.float32), jnp.asarray(pos, jnp.float32))
    _pair(ref64, tdl.fractional_read(torch.as_tensor(x), torch.as_tensor(pos), mode),
          ref32, tdl.fractional_read(torch.as_tensor(x, dtype=torch.float32),
                                     torch.as_tensor(pos, dtype=torch.float32), mode))


@pytest.mark.parametrize("mode", [tinterp.Mode.LINEAR, tinterp.Mode.HERMITE,
                                  tinterp.Mode.LAGRANGE3, tinterp.Mode.LANCZOS3],
                         ids=["linear", "hermite", "lagrange3", "lanczos3"])
def test_walking_read_matches_jax(mode):
    """A chorus-like walk (c + t + a slow LFO wobble) shared by a batch of
    rows: the direct gather with the reference's polynomial weights
    against its in-window shifts; Lanczos takes `fractional_read`."""
    rng = np.random.default_rng(2)
    n = 700
    x = rng.standard_normal((3, n + 900))
    depth, rate = 150.0, 2.0
    pos = 900 - 800.0 + np.arange(n) - depth * 0.5 * (1 + np.sin(2 * np.pi * rate
                                                                 * np.arange(n) / SR))
    drift = depth * np.pi * rate / SR
    read = ref_jit(functools.partial(jdl.walking_read, drift=drift,
                                     mode=jinterp.Mode(mode.value)))
    ref64 = read(jnp.asarray(x), jnp.asarray(pos))
    ref32 = read(jnp.asarray(x, jnp.float32), jnp.asarray(pos, jnp.float32))
    _pair(ref64, tdl.walking_read(torch.as_tensor(x), torch.as_tensor(pos), drift, mode),
          ref32, tdl.walking_read(torch.as_tensor(x, dtype=torch.float32),
                                  torch.as_tensor(pos, dtype=torch.float32), drift, mode))


def test_delayed_and_delay_line_match_jax():
    """`delayed` with a scalar and a per-sample delay, and `DelayLine`
    streamed in three calls with its history carried."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 600))
    d = 20.0 + 15.0 * np.sin(np.arange(600) / 40.0)
    jdelayed = ref_jit(functools.partial(jdl.delayed, mode=jinterp.Mode.HERMITE))
    for delay in (7.25, d):
        np.testing.assert_allclose(
            tdl.delayed(torch.as_tensor(x), torch.as_tensor(delay),
                        tinterp.Mode.HERMITE).numpy(),
            np.asarray(jdelayed(jnp.asarray(x), jnp.asarray(delay))),
            rtol=0, atol=1e-12)
    for mode in (tinterp.Mode.LINEAR, tinterp.Mode.SINC):
        jl = jdl.DelayLine(40, jinterp.Mode(mode.value), sinc_half_width=4)
        tl = tdl.DelayLine(40, mode, sinc_half_width=4)
        sj = jl.init_state((2,), jnp.float64)
        st = tl.init_state((2,), torch.float64, "cpu")
        assert tuple(st.shape) == sj.shape
        jp = ref_jit(jl.process)
        for a, b in ((0, 200), (200, 400), (400, 600)):
            sj, yj = jp(sj, jnp.asarray(x[:, a:b]), jnp.asarray(d[a:b]))
            st, yt = tl.process(st, torch.as_tensor(x[:, a:b]), torch.as_tensor(d[a:b]))
            assert snr_db(np.asarray(yj), yt.numpy()) >= 200
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    with pytest.raises(ValueError, match="max_delay"):
        tdl.DelayLine(0)


def test_phase_arithmetic_bit_equal_to_jax_in_float32():
    """`torch.remainder` and `jnp.mod` of float32 phases bit for bit (the
    divisor's sign, negative and huge phases, exact multiples), and the
    effects' phase trajectories before their sine: the Flanger's and the
    Phaser's reduced at every sample, the Chorus's final phase."""
    rng = np.random.default_rng(4)
    v = np.concatenate([rng.uniform(-1e4, 1e4, 4000), rng.uniform(-7, 7, 4000),
                        [0.0, -0.0, 2 * np.pi, -2 * np.pi, 1e9, -3e7]]).astype(np.float32)
    two_pi = 2 * np.pi
    np.testing.assert_array_equal(torch.remainder(torch.as_tensor(v), two_pi).numpy(),
                                  np.asarray(jnp.mod(jnp.asarray(v), two_pi)))
    inc = two_pi * 0.25 / SR
    for phase0 in (0.0, 5.9, 1234.5):
        p32 = np.float32(phase0)
        jt = jnp.mod(jnp.asarray(p32) + inc * jnp.arange(5000, dtype=jnp.float32), two_pi)
        tt = torch.remainder(torch.tensor(p32) + inc * torch.arange(5000,
                                                                    dtype=torch.float32),
                             two_pi)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    x = torch.zeros(1, 777)
    _, jfinal = jmod._lfo_phases(jnp.asarray(np.float32(6.1)), 777, 0.35, SR,
                                 jnp.float32)
    jph, _ = jmod._lfo_phases(jnp.asarray(np.float32(6.1)), 777, 0.35, SR, jnp.float32)
    tph, tfinal = tmod._lfo_phases(torch.tensor(np.float32(6.1)), 777, 0.35, SR, x)
    np.testing.assert_array_equal(tph.numpy(), np.asarray(jph))
    assert tfinal.item() == float(jfinal)
