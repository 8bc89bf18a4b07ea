"""The port's Moog ladder (`algodsp_tpu_torch.filters.moog`, kernels K5 and
K6 through their plain versions on the CPU) against the JAX package's
`MoogFilter._run_scan`, jitted (its Pallas kernels are tied to that
scan by tests/test_pallas.py).

Tolerances:
- float32: atol 1e-5, the bar the JAX package holds its own kernels to
  against the scan (tests/test_pallas.py); the two sides differ only in
  float32 rounding of tanh and of the constant products;
- float64: atol 1e-11; the plain version repeats the scan's arithmetic
  in its order, so only the two tanh implementations separate them;
- the state-clip case (DC of 100, Vt = 20): atol 1e-4, the JAX bar for
  that case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algodsp_tpu.filters.moog import MoogFilter as JMoog, MoogVariant as JV
from algodsp_tpu_torch import convert
from algodsp_tpu_torch.filters.moog import MoogFilter as TMoog, MoogVariant as TV
from algodsp_tpu_torch.ops import moog as moog_ops

SR = 48000.0
C, N = 3, 200          # os 4 makes 800 ladder steps: not a chunk multiple
BARS = {"float32": 1e-5, "float64": 1e-11}


def _pair(variant, **kw):
    return (JMoog(SR, variant=JV(variant), **kw),
            TMoog(SR, variant=TV(variant), **kw))


def _jax_process(mg, state, x):
    """`MoogFilter.process` through the jitted scan, on the CPU."""
    os = mg.oversampling
    if os > 1:
        x = jnp.zeros(x.shape[:-1] + (x.shape[-1] * os,), x.dtype
                      ).at[..., ::os].set(x * os)
    state, y = jax.jit(mg._run_scan)(state, x)
    return state, (y[..., os - 1::os] if os > 1 else y)


def _state(rng):
    return {"stage": 0.2 * rng.standard_normal((C, 4)),
            "tanh_last": 0.2 * rng.standard_normal((C, 3)),
            "prev_out": 0.2 * rng.standard_normal(C)}


def _compare(jm, tm, st0, x, atol):
    for dtype in ("float32", "float64"):
        sj, yj = _jax_process(jm, {k: jnp.asarray(v, dtype)
                                   for k, v in st0.items()},
                              jnp.asarray(x, dtype))
        st, yt = tm.process(convert.state_from_numpy(
            {k: v.astype(dtype) for k, v in st0.items()}, "cpu"),
            torch.tensor(x.astype(dtype)))
        bar = atol or BARS[dtype]
        assert yt.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                                   atol=bar, err_msg=dtype)
        for k in sj:
            np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]),
                                       rtol=0, atol=bar, err_msg=(dtype, k))


@pytest.mark.parametrize("oversampling", [1, 4])
@pytest.mark.parametrize("variant", [v.value for v in JV])
def test_process_matches_jax_scan(variant, oversampling):
    rng = np.random.default_rng([v.value for v in JV].index(variant)
                                + 10 * oversampling)
    jm, tm = _pair(variant, cutoff_hz=1500.0, resonance=2.0, drive=2.0,
                   thermal_voltage=0.8, oversampling=oversampling,
                   newton_iters=3)
    x = 0.5 * rng.standard_normal((C, N))
    _compare(jm, tm, _state(rng), x, None)


def test_state_clip_matches_jax():
    # DC of 100 drives the stage equilibria past the +-32 clip
    rng = np.random.default_rng(4)
    jm, tm = _pair("classic", cutoff_hz=8000.0, resonance=0.5, drive=1.0,
                   thermal_voltage=20.0)
    x = 100.0 + rng.standard_normal((2, 300))
    st0 = {"stage": np.zeros((2, 4)), "tanh_last": np.zeros((2, 3)),
           "prev_out": np.zeros(2)}
    st, _ = tm.process(convert.state_from_numpy(st0, "cpu"),
                       torch.tensor(x))
    assert float(torch.max(torch.abs(st["stage"]))) == moog_ops.STATE_LIMIT
    _compare(jm, tm, {k: v[:2] for k, v in st0.items()}, x, 1e-4)


def test_self_oscillation_float64_matches_jax():
    # resonance 4 self-oscillates: float32 rounding may grow along time,
    # so float64 is held to the scan at the float64 bar (measured: within
    # 3e-16 here), where the tanh implementations alone separate the two
    rng = np.random.default_rng(8)
    for variant in ("classic", "huovilainen", "zdf"):
        jm, tm = _pair(variant, cutoff_hz=2000.0, resonance=4.0,
                       thermal_voltage=0.5)
        x = 0.1 * rng.standard_normal((1, 600))
        st0 = {"stage": np.zeros((1, 4)), "tanh_last": np.zeros((1, 3)),
               "prev_out": np.zeros(1)}
        sj, yj = _jax_process(jm, {k: jnp.asarray(v) for k, v in st0.items()},
                              jnp.asarray(x))
        _, yt = tm.process(convert.state_from_numpy(st0, "cpu"),
                           torch.tensor(x))
        assert np.all(np.isfinite(yt.numpy()))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                                   atol=BARS["float64"], err_msg=variant)


def test_kernel_params_and_coefficients_match_jax():
    for v in JV:
        for kw in ({}, {"oversampling": 4, "resonance": 3.0, "drive": 5.0,
                        "normalize_output": True, "thermal_voltage": 1.3}):
            jm, tm = _pair(v.value, **kw)
            if v == JV.ZDF:
                ref = [jm.zdf_gk, jm.drive_scale, jm.feedback,
                       jm.input_gain, jm.output_scale]
            else:
                improved = v in (JV.IMPROVED_CLASSIC,
                                 JV.IMPROVED_CLASSIC_LIGHTWEIGHT)
                ref = [jm.coefficient * (2 * jm.thermal_voltage
                                         if improved else 1.0),
                       jm.drive_scale, jm.feedback, jm.input_gain,
                       jm.output_scale]
            assert tm.kernel_params() == ref, (v, kw)


def test_validation_errors_match_jax():
    bad = [dict(sample_rate=0.0), dict(cutoff_hz=0.5),
           dict(cutoff_hz=24000.0), dict(resonance=-0.1),
           dict(resonance=4.5), dict(drive=0.05), dict(drive=30.0),
           dict(newton_iters=0), dict(newton_iters=9),
           dict(oversampling=0)]
    for kw in bad:
        kw = dict(kw)
        sr = kw.pop("sample_rate", SR)
        with pytest.raises(ValueError) as ej:
            JMoog(sr, **kw)
        with pytest.raises(ValueError) as et:
            TMoog(sr, **kw)
        assert str(ej.value) == str(et.value), kw


def test_leading_dims_streaming_and_wrappers():
    rng = np.random.default_rng(11)
    tm = TMoog(SR, variant=TV.HUOVILAINEN, cutoff_hz=900.0, resonance=1.5,
               oversampling=2)
    x = torch.tensor(0.3 * rng.standard_normal((2, 3, 160)))
    st0 = tm.init_state((2, 3), torch.float64, "cpu")
    st, y = tm.process(st0, x)
    # leading dims flatten onto the channel axis and come back
    assert y.shape == (2, 3, 160) and st["stage"].shape == (2, 3, 4)
    s1, y1 = tm.process(tm.init_state((), torch.float64, "cpu"), x[1, 2])
    assert torch.equal(y1, y[1, 2])
    # two calls carry the state exactly
    sa, ya = tm.process(st0, x[..., :70])
    sb, yb = tm.process(sa, x[..., 70:])
    assert torch.equal(torch.cat([ya, yb], -1), y)
    for k in st:
        assert torch.equal(sb[k], st[k])
    # the wrappers take their plain versions on the CPU and check shapes
    x2 = x.reshape(6, 160)
    st8 = torch.zeros(8, 6, dtype=torch.float64)
    p = tm.kernel_params()
    assert torch.equal(moog_ops.moog_ladder(x2, st8, p, huovilainen=True)[1],
                       moog_ops.moog_ladder_plain(x2, st8, p, fast_tanh=False,
                                                  huovilainen=True)[1])
    with pytest.raises(ValueError):
        moog_ops.moog_ladder(x2, torch.zeros(8, 5), p)
    with pytest.raises(ValueError):
        moog_ops.moog_zdf(x2, st8, p, newton_iters=9)
    zdf = convert.moog_from_config({"sample_rate": SR, "variant": "zdf",
                                    "newton_iters": 2})
    assert zdf.variant == TV.ZDF and zdf.newton_iters == 2
