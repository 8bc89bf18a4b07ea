"""The port's spatial effects against the JAX package on the CPU (the
port through K3's and K1's plain paths, JAX jitted): StereoWidener with
and without the bass-mono split, CrosstalkCanceller, and
CrosstalkSimulator in all three modes (parametric, one crossfeed IR, the
4-path HRTF set in both routings), each streamed in ragged blocks
against JAX streamed the same way and (where it keeps state) against
one call of itself, in float64 and float32; the carried HRTF tail's
type; and the C++ goldens.

Tolerances: float64 >= 200 dB with states within 1e-12; float32 against
JAX float64 >= 100 dB, or no more than 6 dB below JAX float32's own SNR
where that is lower (the widener's 120 Hz split: slow poles); streamed
against one call >= 250 dB (float64); the goldens at
tests/test_native.py's 120 dB.
"""

import tests.torch_port_setup  # noqa: F401  (first: one PyTorch thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algodsp_tpu import native
from algodsp_tpu.effects import spatial as js
from algodsp_tpu_torch.effects import spatial as ts
from algodsp_tpu_torch.utils.irlib import hrtf_ir_set
from tests.conftest import snr_db
from tests.torch_port_setup import meets_float32_bar, ref_jit

SR = 48000.0
CUTS = (0, 700, 701, 2048)   # ragged blocks, one of a single sample
HRTF = hrtf_ir_set(SR)
ONE_IR = np.random.default_rng(3).standard_normal(300) * np.exp(
    -np.arange(300) / 60.0) * 0.2

CASES = {
    "widener": ("StereoWidener", dict(width=1.8)),
    "widener_bass_mono": ("StereoWidener", dict(width=1.8, bass_mono_hz=120.0)),
    "canceller": ("CrosstalkCanceller", dict(stages=3, attenuation=0.5)),
    "sim_parametric": ("CrosstalkSimulator", dict(crossfeed_mix=0.4,
                                                  invert_polarity=True)),
    "sim_one_ir": ("CrosstalkSimulator", dict(hrtf_irs=ONE_IR)),
    "sim_hrtf_crossfeed": ("CrosstalkSimulator", dict(hrtf_irs=HRTF)),
    "sim_hrtf_complete": ("CrosstalkSimulator", dict(hrtf_irs=HRTF,
                                                     hrtf_mode="complete")),
}


def _x(seed=0):
    return 0.5 * np.random.default_rng(seed).standard_normal((3, 2, CUTS[-1]))


def _leaves(st):
    if isinstance(st, dict):
        return [v for k in sorted(st) for v in _leaves(st[k])]
    if isinstance(st, (list, tuple)):
        return [v for s in st for v in _leaves(s)]
    return [np.asarray(st.numpy() if torch.is_tensor(st) else st)]


def _stream(fx, x, dtype, lib, cuts=CUTS):
    if lib == "jax":
        st, proc = fx.init_state((3,), jnp.dtype(dtype)), ref_jit(fx.process)
    else:
        st, proc = fx.init_state((3,), getattr(torch, dtype), "cpu"), fx.process
    ys = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        xb = x[..., a:b].astype(dtype)
        st, y = proc(st, jnp.asarray(xb) if lib == "jax" else torch.as_tensor(xb))
        ys.append(np.asarray(y) if lib == "jax" else y.numpy())
    return st, np.concatenate(ys, axis=-1)


@pytest.mark.parametrize("case", list(CASES))
def test_spatial_matches_jax(case):
    name, kw = CASES[case]
    fj, ft = getattr(js, name)(SR, **kw), getattr(ts, name)(SR, **kw)
    x = _x()
    sj, yj = _stream(fj, x, "float64", "jax")
    st, yt = _stream(ft, x, "float64", "torch")
    assert yt.dtype == np.float64 and snr_db(yj, yt) >= 200
    for a, b in zip(_leaves(sj), _leaves(st)):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)
    _, yt32 = _stream(ft, x, "float32", "torch")
    assert yt32.dtype == np.float32
    assert meets_float32_bar(snr_db(yj, yt32),
                             lambda: snr_db(yj, _stream(fj, x, "float32", "jax")[1]))
    # streamed in ragged blocks equals one call, except in the one-IR mode,
    # which keeps no state (each call drops its convolution's tail, as the
    # reference's does)
    if case != "sim_one_ir":
        _, y1 = _stream(ft, x, "float64", "torch", cuts=(0, CUTS[-1]))
        assert snr_db(y1, yt) >= 250


def test_hrtf_tail_keeps_the_state_type():
    """A float32 signal through a float64 state: the carried tail stays
    float64 (`spatial.py:235`), and the output follows the signal."""
    cs = ts.CrosstalkSimulator(SR, hrtf_irs=HRTF, hrtf_mode="complete")
    st = cs.init_state((2,), torch.float64, "cpu")
    st, y = cs.process(st, torch.as_tensor(_x()[:2].astype(np.float32)))
    assert st["tail"].dtype == torch.float64 and y.dtype == torch.float32
    assert st["tail"].shape == (2, 2, max(v.size for v in HRTF.values()) - 1)


def test_parameters_and_errors_match_jax():
    for name, kw in CASES.values():
        fj, ft = getattr(js, name)(SR, **kw), getattr(ts, name)(SR, **kw)
        for key in ("width", "base_delay", "stage_delays", "stage_gains",
                    "delay", "mix", "hrtf_mode"):
            if hasattr(fj, key):
                assert getattr(ft, key) == getattr(fj, key), (name, key)
    for name, kw in (("StereoWidener", dict(width=5.0)),
                     ("CrosstalkCanceller", dict(attenuation=1.0)),
                     ("CrosstalkCanceller", dict(stages=0)),
                     ("CrosstalkSimulator", dict(crossfeed_mix=2.0)),
                     ("CrosstalkSimulator", dict(hrtf_mode="full")),
                     ("CrosstalkSimulator", dict(hrtf_irs={"left_cross": [1.0]})),
                     ("CrosstalkSimulator", dict(hrtf_irs=dict(HRTF, left_cross=[])))):
        with pytest.raises(ValueError):
            getattr(js, name)(SR, **kw)
        with pytest.raises(ValueError):
            getattr(ts, name)(SR, **kw)


@pytest.mark.parametrize("case", ["widener", "widener_bass_mono", "canceller",
                                  "sim_parametric"])
def test_streamed_matches_native(case):
    """tests/test_native.py's goldens, streamed in two calls, float64."""
    name, kw = CASES[case]
    fx = getattr(ts, name)(SR, **kw)
    x = np.random.default_rng(109).standard_normal((2, 4096))
    st = fx.init_state((), torch.float64, "cpu")
    st, y1 = fx.process(st, torch.as_tensor(x[:, :2048]))
    st, y2 = fx.process(st, torch.as_tensor(x[:, 2048:]))
    gold = {"StereoWidener": native.widener, "CrosstalkCanceller":
            native.crosstalk_cancel, "CrosstalkSimulator": native.crosstalk_sim}[name]
    g, z1 = gold(fx, x[:, :2048])
    g, z2 = gold(fx, x[:, 2048:], state=g)
    assert snr_db(np.concatenate([z1, z2], axis=-1),
                  torch.cat([y1, y2], dim=-1).numpy()) > 120


@pytest.mark.parametrize("mode", ["crossfeed_only", "complete"])
def test_hrtf_matches_native(mode):
    cs = ts.CrosstalkSimulator(SR, hrtf_irs=HRTF, hrtf_mode=mode)
    x = np.random.default_rng(112).standard_normal((2, 2048))
    _, y = cs.process(cs.init_state((), torch.float64, "cpu"), torch.as_tensor(x))
    assert snr_db(native.crosstalk_hrtf(cs, x), y.numpy()) > 120
