"""The port's biquad runtime (`algodsp_tpu_torch.filters.biquad`,
`ops/linrec.py`, `ops/biquad_cascade.py` plain path) against the JAX
package's `BiquadChain` on the CPU.

Tolerances:
- >= 100 dB against JAX `process(mode="blocked")` in float32: the bar
  the JAX package holds its own Pallas cascade to (tests/test_pallas.py);
- >= 120 dB against the JAX float64 evaluation for chains without slow
  poles (the reference's parity bar);
- for the slow-pole chain, float32 is held to no worse than the JAX
  float32 path is against float64 (less 1 dB), and `exact=True` to
  >= 120 dB against float64.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from algodsp_tpu.filters import BiquadChain as JChain, design as jd
from algodsp_tpu.filters.weighting import WeightingType as JW, weighting_chain as jwc
from algodsp_tpu_torch import convert
from algodsp_tpu_torch.filters import Section
from algodsp_tpu_torch.filters import biquad as tbq
from algodsp_tpu_torch.ops import linrec
from algodsp_tpu_torch.ops.biquad_cascade import biquad_cascade, biquad_cascade_plain
from tests.conftest import snr_db

SR = 48000.0


CHAINS = {
    "butterworth": JChain(jd.butterworth_lp(2000.0, 10, SR)),
    "a_weighting": jwc(JW.A, SR),
    "slow_hp120": JChain(jd.butterworth_hp(120.0, 2, SR), gain=0.8),
}
# one compiled JAX program per chain (eager dispatch compiles every op
# on first use, which costs more than a jit of the whole call)
_JAX_BLOCKED = {name: jax.jit(functools.partial(jc.process, mode="blocked"))
                for name, jc in CHAINS.items()}
_JAX_STREAM = {name: jax.jit(jc.process_stream) for name, jc in CHAINS.items()}


def _chains():
    return CHAINS


def _jax_blocked(name, x, dtype):
    return np.asarray(_JAX_BLOCKED[name](jnp.asarray(x, dtype)))


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _port(jchain):
    return convert.biquad_chain_from_numpy(jchain.sos, jchain.gain)


@pytest.mark.parametrize("name", ["butterworth", "a_weighting", "slow_hp120"])
def test_process_matches_jax_f32(name):
    jc = _chains()[name]
    tc = _port(jc)
    assert np.array_equal(tc.runtime_sos, jc.runtime_sos)
    assert tc.has_slow_poles == jc.has_slow_poles == (name == "slow_hp120")
    x = _x((2, 1000))
    y = tc.process(torch.from_numpy(x)).numpy()
    y_j = _jax_blocked(name, x, jnp.float32)
    assert snr_db(y_j, y) >= 100


@pytest.mark.parametrize("name", ["butterworth", "a_weighting"])
def test_process_matches_jax_f64(name):
    jc = _chains()[name]
    x = _x((2, 1000), seed=1)
    y = _port(jc).process(torch.from_numpy(x)).numpy()
    y64 = _jax_blocked(name, x, jnp.float64)
    assert snr_db(y64, y) >= 120


def test_slow_pole_chain_and_exact():
    jc = _chains()["slow_hp120"]
    tc = _port(jc)
    x = _x((2, 1000), seed=2)
    y64 = _jax_blocked("slow_hp120", x, jnp.float64)
    y_j = _jax_blocked("slow_hp120", x, jnp.float32)
    y = tc.process(torch.from_numpy(x)).numpy()
    assert snr_db(y64, y) >= snr_db(y64, y_j) - 1.0
    y_exact = tc.process(torch.from_numpy(x), exact=True)
    assert y_exact.dtype == torch.float32
    assert snr_db(y64, y_exact.numpy()) >= 120
    with pytest.raises(ValueError):
        tc.process(torch.from_numpy(x), mode="kernel", exact=True)


@pytest.mark.parametrize("name", ["butterworth", "a_weighting", "slow_hp120"])
def test_process_stream_ragged_blocks(name):
    """Blocks that are not multiples of 128 give the JAX streamed output
    and carried state, and for chains without slow poles the one-shot
    result. The slow-pole chain's float32 error moves with block
    alignment and evaluation order (here 96 dB for the port's stream and
    101 dB for the JAX one against float64, while both are exact to
    266 dB in float64), so it is held against the float64 one-shot at
    90 dB, inside the 86-115 dB the reference documents for this class
    (VERDICT.md, "What's weak" 1)."""
    jc = _chains()[name]
    tc = _port(jc)
    x = _x((2, 1000), seed=3)
    st = tc.init_state((2,), device="cpu")
    st_j = jc.init_state((2,))
    ys, ys_j = [], []
    for i in range(4):
        blk = x[:, 250 * i:250 * (i + 1)]
        st, y = tc.process_stream(st, torch.from_numpy(blk))
        st_j, y_j = _JAX_STREAM[name](st_j, jnp.asarray(blk))
        ys.append(y.numpy())
        ys_j.append(np.asarray(y_j))
    y_stream, y_stream_j = np.concatenate(ys, -1), np.concatenate(ys_j, -1)
    if tc.has_slow_poles:
        y64 = _jax_blocked(name, x, jnp.float64)
        assert snr_db(y64, y_stream) >= 90
        assert snr_db(np.asarray(st_j), st.numpy()) >= 90
    else:
        assert snr_db(y_stream_j, y_stream) >= 100
        assert snr_db(np.asarray(st_j), st.numpy()) >= 100
        y_one = tc.process(torch.from_numpy(x)).numpy()
        assert snr_db(y_one, y_stream) >= 100
    # a one-sample block carries x_{n-2} and y_{n-2} from the old state
    st1, y1 = tc.process_stream(st, torch.from_numpy(x[:, :1]))
    assert torch.equal(st1[..., 1], st[..., 0])
    assert torch.equal(st1[..., 3], st[..., 2])


def test_stream_modes_and_state_checks():
    jc = _chains()["butterworth"]
    tc = _port(jc)
    x = torch.from_numpy(_x((2, 250), seed=4))
    st0 = torch.from_numpy(_x((2, tc.num_runtime_sections, 4), seed=5)) * 0.1
    outs = {m: tc.process_stream(st0, x, mode=m) for m in ("kernel", "blocked", "scan")}
    for m in ("kernel", "scan"):
        assert snr_db(outs["blocked"][1].numpy(), outs[m][1].numpy()) >= 100
        assert snr_db(outs["blocked"][0].numpy(), outs[m][0].numpy()) >= 100
    st_j, y_j = _JAX_STREAM["butterworth"](jnp.asarray(st0.numpy()),
                                            jnp.asarray(x.numpy()))
    assert snr_db(np.asarray(y_j), outs["kernel"][1].numpy()) >= 100
    with pytest.raises(ValueError):
        tc.process_stream(torch.zeros(2, tc.num_runtime_sections + 1, 4), x)
    with pytest.raises(ValueError):
        tc.process(x, mode="pallas")


@pytest.mark.parametrize("shape", [(1000,), (2, 3, 1000)])
def test_auto_mode_sends_every_leading_shape_to_the_kernel(shape):
    """Every float32 chain without slow poles takes the kernel path,
    whatever its leading dims: they flatten onto the kernel's channel
    axis and the output and state take the input's shape again. The
    result equals the 2-D call on the flattened input (which the tests
    above hold against JAX)."""
    tc = _port(_chains()["a_weighting"])
    x = torch.from_numpy(_x(shape, seed=10))
    assert tc._auto_mode(x) == "kernel"
    assert tc._auto_mode(x.double()) == "blocked"
    s = tc.num_runtime_sections
    y = tc.process(x)
    y_2d = tc.process(x.reshape(-1, 1000))
    assert y.shape == x.shape and torch.equal(y.reshape(-1, 1000), y_2d)
    st0 = torch.from_numpy(_x(shape[:-1] + (s, 4), seed=11)) * 0.1
    st, y_s = tc.process_stream(st0, x)
    st_2d, y_s2d = tc.process_stream(st0.reshape(-1, s, 4), x.reshape(-1, 1000))
    assert st.shape == shape[:-1] + (s, 4)
    assert torch.equal(st.reshape(-1, s, 4), st_2d)
    assert torch.equal(y_s.reshape(-1, 1000), y_s2d)


def test_biquad_cascade_plain_is_the_blocked_cascade():
    """The kernel's plain version (used for CPU tensors) threads the
    (C, S, 4) state and returns the true carry for N % 128 != 0."""
    jc = _chains()["a_weighting"]
    sos = jc.runtime_sos
    x = _x((2, 250), seed=6)
    st = _x((2, sos.shape[0], 4), seed=7) * 0.1
    y, s_out = biquad_cascade(torch.from_numpy(x), sos, jc.gain, torch.from_numpy(st))
    y_p, s_p = biquad_cascade_plain(torch.from_numpy(x), sos, jc.gain, torch.from_numpy(st))
    assert torch.equal(y, y_p) and torch.equal(s_out, s_p)
    s_j, y_j = _JAX_STREAM["a_weighting"](jnp.asarray(st), jnp.asarray(x))
    assert snr_db(np.asarray(y_j), y.numpy()) >= 100
    assert snr_db(np.asarray(s_j), s_out.numpy()) >= 100


def test_linrec_blocked_matches_scan_and_jax():
    from algodsp_tpu.ops import linrec as jl
    sos = jd.butterworth_hp(60.0, 4, SR)
    k_t = linrec.ar2_kernels(sos[:, 3], sos[:, 4], 128)
    k_j = jl.ar2_kernels(sos[:, 3], sos[:, 4], 128)
    for field in ("L", "G", "p", "q", "S", "Gm", "Pm", "modal"):
        assert np.array_equal(getattr(k_t, field), getattr(k_j, field))
    assert np.array_equal(linrec.condition_sos(sos), jl.condition_sos(sos))
    assert np.array_equal(linrec.residual_flags(sos), jl.residual_flags(sos))
    f = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 512)))
    y1 = torch.tensor([0.3, -0.2], dtype=torch.float64)
    y2 = torch.tensor([0.1, 0.05], dtype=torch.float64)
    for s in range(sos.shape[0]):
        yb = linrec.ar2_apply_blocked(f, k_t, s, y1, y2)
        ys = linrec.ar2_apply_scan(f, sos[s, 3], sos[s, 4], y1, y2)
        assert snr_db(ys.numpy(), yb.numpy()) >= 200


def test_section_response_and_impulse():
    jc = _chains()["a_weighting"]
    tc = _port(jc)
    freqs = np.array([10.0, 100.0, 1000.0, 10000.0])
    assert np.array_equal(tc.response(freqs, SR), jc.response(freqs, SR))
    assert np.array_equal(tc.magnitude_db(freqs, SR), jc.magnitude_db(freqs, SR))
    from algodsp_tpu.filters.biquad import magnitude_squared as jms
    assert np.array_equal(tbq.magnitude_squared(jc.sos, freqs, SR),
                          jms(jc.sos, freqs, SR))
    from algodsp_tpu_torch.conv.ltifold import chain_impulse_response
    for n in (64, 300):
        assert snr_db(chain_impulse_response(tc, n), tc.impulse_response(n)) >= 200
    sec = Section(*jd.lowpass(1000.0, 0.7, SR))
    assert sec.num_sections == 1 and sec.order == 2
    swapped = tc.update_coefficients(jd.butterworth_lp(500.0, 4, SR))
    assert swapped.gain == tc.gain and swapped.num_sections == 2


def _direct_form(x, sos, st):
    """float64 per-sample cascade over x (N,) from state st (S, 4)."""
    st = st.copy()
    y = np.empty_like(x)
    for n in range(x.size):
        v = x[n]
        for s, (b0, b1, b2, a1, a2) in enumerate(sos):
            m = st[s]
            out = b0 * v + b1 * m[0] + b2 * m[1] - a1 * m[2] - a2 * m[3]
            st[s] = [v, m[0], out, m[2]]
            v = out
        y[n] = v
    return y, st


def test_chunk_tables_of_the_cascade_kernel():
    """The host tables the CUDA cascade kernel uses: zero-state chunks plus
    the carried state's response (R) and transitions (A, A_last) rebuild
    the cascade exactly, for a last chunk shorter than T."""
    from algodsp_tpu_torch.ops.biquad_cascade import chunk_tables
    sos = CHAINS["a_weighting"].runtime_sos
    rng = np.random.default_rng(9)
    x = rng.standard_normal(300)
    st0 = rng.standard_normal((sos.shape[0], 4)) * 0.1
    T = 128
    k = -(-x.size // T)
    last = x.size - (k - 1) * T
    R, A, A_last = chunk_tables(sos, T, last)
    y = np.empty_like(x)
    z = st0.reshape(-1)
    for i in range(k):
        seg = x[i * T:(i + 1) * T]
        y_zero, st_zero = _direct_form(seg, sos, np.zeros_like(st0))
        y[i * T:i * T + seg.size] = y_zero + z @ R[:, :seg.size]
        z = (A if i < k - 1 else A_last) @ z + st_zero.reshape(-1)
    y_ref, st_ref = _direct_form(x, sos, st0)
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(z, st_ref.reshape(-1), rtol=0, atol=1e-12)
