"""The port's whole-cascade engine (`algodsp_tpu_torch/ops/cascade.py`),
`BiquadChain.process_cascade`, the `exact=True` dispatch, the host
helpers of `filters/biquad.py`, and the full-float32 pin of the matrix
engines, against the JAX package on the CPU (its XLA paths, jitted).

Tolerances (SNR against the JAX float64 output):
- float64 >= 200 dB: the same float64 kernels in another summation
  order;
- float32 >= 100 dB; for slow poles (a 60 Hz high-pass, whose float32
  blocked evaluation cancels terms of the size of its impulse
  response's peak) the reference's own float32 class: the port's
  float32 output and state are held to the JAX float64 ones no more
  than 6 dB below the JAX float32 ones' SNR against them (the two
  float32 evaluations sum in different orders, and on six seeds their
  SNRs scattered by up to 5 dB either way, the state's 16 values most);
- state round trips, mode selection and pole-zero factoring exactly.
"""

import tests.torch_port_setup  # noqa: F401  (first: one PyTorch thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algodsp_tpu.filters.biquad import BiquadChain as JChain
from algodsp_tpu.filters.biquad import is_stable as j_is_stable
from algodsp_tpu.filters.biquad import poles_zeros as j_poles_zeros
from algodsp_tpu.ops import cascade as jcasc
from algodsp_tpu_torch.filters.biquad import BiquadChain, is_stable, poles_zeros
from algodsp_tpu_torch.filters.design import butterworth_hp, butterworth_lp
from algodsp_tpu_torch.filters.design.cascades import (
    linkwitz_riley_hp, linkwitz_riley_lp)
from algodsp_tpu_torch.filters.design.rbj import highpass, low_shelf, peak
from algodsp_tpu_torch.ops import cascade as tcasc
from algodsp_tpu_torch.ops import linrec
from tests.conftest import snr_db
from tests.torch_port_setup import ref_jit

SR = 48000.0
C, N, B = 2, 1024, 128

CASES = {
    # 8th-order Butterworth low-pass: four sections, no slow poles
    "zero": butterworth_lp(3000.0, 8, SR),
    # the same with an entry state and the final state returned
    "state": butterworth_lp(3000.0, 8, SR),
    # slow complex poles: the compact state carries in the modal basis
    "modal": np.vstack([highpass(60.0, 0.707, SR), highpass(60.0, 0.707, SR),
                        peak(2000.0, 4.0, 1.0, SR)]),
}


def _x(seed=0, dtype=np.float64, n=N):
    return np.random.default_rng(seed).standard_normal((C, n)).astype(dtype)


def _jax_apply(sos, x, s0=None, block=B):
    fn = ref_jit(lambda x_, s_: jcasc.cascade_apply_blocked(
        x_, sos, block=block, s0=s_, return_state=True))
    y, s = fn(jnp.asarray(x), None if s0 is None else jnp.asarray(s0))
    return np.asarray(y), np.asarray(s)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cascade_apply_matches_jax(case, dtype):
    sos = CASES[case]
    d = 2 * sos.shape[0] + 2
    x64 = _x()
    s0 = (0.1 * np.random.default_rng(1).standard_normal((C, d))
          if case == "state" else None)
    y_ref, s_ref = _jax_apply(sos, x64, s0)
    tdt = getattr(torch, dtype)
    x = torch.as_tensor(x64, dtype=tdt)
    if case == "zero":
        y = tcasc.cascade_apply_blocked(x, sos, block=B)
        s = None
    else:
        y, s = tcasc.cascade_apply_blocked(
            x, sos, block=B, return_state=True,
            s0=None if s0 is None else torch.as_tensor(s0, dtype=tdt))
        assert s.dtype == tdt and s.shape == (C, d)
    assert y.dtype == tdt and y.shape == (C, N)
    got = snr_db(y_ref, y.numpy())
    if dtype == "float64":
        assert got >= 200, got
        if s is not None:
            assert snr_db(s_ref, s.numpy()) >= 200
        return
    bar = bar_s = 100.0
    if case == "modal":
        y_j32, s_j32 = _jax_apply(sos, x64.astype(np.float32))
        bar = min(bar, snr_db(y_ref, y_j32) - 6.0)
        bar_s = min(bar_s, snr_db(s_ref, s_j32) - 6.0)
    assert got >= bar, (got, bar)
    if s is not None:
        assert snr_db(s_ref, s.numpy()) >= bar_s


def test_compact_state_round_trip_matches_jax():
    rng = np.random.default_rng(2)
    S = 3
    # a chain state whose section inputs are the previous outputs, as a
    # streaming run leaves it
    y = rng.standard_normal((C, S, 2))
    x12 = rng.standard_normal((C, 2))
    st = np.concatenate([np.concatenate([x12[:, None], y[:, :-1]], axis=1), y],
                        axis=-1)
    compact_t = tcasc.chain_state_to_compact(torch.as_tensor(st))
    compact_j = np.asarray(jcasc.chain_state_to_compact(jnp.asarray(st)))
    np.testing.assert_array_equal(compact_t.numpy(), compact_j)
    back = tcasc.compact_state_to_chain(compact_t, S)
    np.testing.assert_array_equal(back.numpy(), st)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jcasc.compact_state_to_chain(
            jnp.asarray(compact_j), S)))


def test_process_cascade_streams_like_one_call_and_jax():
    sos = CASES["modal"]
    x = _x(3)
    tc, jc = BiquadChain(sos), JChain(sos)
    st = tc.init_state((C,), dtype=torch.float64, device="cpu")
    ys = []
    for part in (x[:, :384], x[:, 384:]):
        st, y = tc.process_stream(st, torch.as_tensor(part), mode="cascade")
        ys.append(y)
    y_stream = torch.cat(ys, dim=-1).numpy()
    y_one = tc.process(torch.as_tensor(x), mode="cascade").numpy()
    assert snr_db(y_one, y_stream) >= 250
    run = ref_jit(lambda x_, s_: jc.process_cascade(x_, state=s_,
                                                    return_state=True))
    y_j, st_j = run(jnp.asarray(x), jnp.zeros((C, jc.num_runtime_sections, 4)))
    assert snr_db(np.asarray(y_j), y_stream) >= 200
    assert snr_db(np.asarray(st_j), st.numpy()) >= 200
    # the blocked engine leaves the same (..., S, 4) state
    st_b, _ = tc.process_stream(
        tc.init_state((C,), dtype=torch.float64, device="cpu"),
        torch.as_tensor(x), mode="blocked")
    assert snr_db(st_b.numpy(), st.numpy()) >= 200


def test_process_cascade_bulk_block_and_gain():
    """One-shot calls of 2^16 samples run at a 256-sample block on the
    sections re-conditioned for it, the input gain folded in."""
    sos = CASES["modal"]
    x = np.random.default_rng(4).standard_normal((1, 1 << 16))
    tc, jc = BiquadChain(sos, gain=0.7), JChain(sos, gain=0.7)
    y = tc.process_cascade(torch.as_tensor(x))
    assert tc._sos_bulk256.shape == linrec.condition_sos(sos, 256).shape
    y_j = ref_jit(jc.process_cascade)(jnp.asarray(x))
    assert snr_db(np.asarray(y_j), y.numpy()) >= 200


def test_exact_dispatch_takes_the_cascade_engine_on_block_multiples(monkeypatch):
    sos = CASES["modal"]
    tc, jc = BiquadChain(sos), JChain(sos)
    taken = []
    orig_cascade, orig_sections = BiquadChain.process_cascade, linrec.run_sections
    monkeypatch.setattr(BiquadChain, "process_cascade", lambda self, *a, **k: (
        taken.append("cascade"), orig_cascade(self, *a, **k))[1])
    monkeypatch.setattr(linrec, "run_sections", lambda *a, **k: (
        taken.append(k.get("mode")), orig_sections(*a, **k))[1])
    for n, engine in ((N, "cascade"), (N - 5, "blocked")):
        x = _x(5, np.float32, n)
        taken.clear()
        y = tc.process(torch.as_tensor(x), exact=True)
        assert taken == [engine] and y.dtype == torch.float32
        y_j = ref_jit(lambda x_: jc.process(x_, exact=True))(jnp.asarray(x))
        y_64 = tc.process(torch.as_tensor(x, dtype=torch.float64), mode="scan")
        assert snr_db(y_64.numpy(), y.numpy()) >= 140
        assert snr_db(np.asarray(y_j), y.numpy()) >= 140
    with pytest.raises(ValueError, match="not a multiple of block"):
        tc.process(torch.as_tensor(_x(5, n=N - 5)), mode="cascade")
    with pytest.raises(ValueError, match="exact=True"):
        tc.process(torch.as_tensor(_x(5)), mode="kernel", exact=True)


def test_auto_dispatch_takes_the_cascade_engine_for_slow_poles_in_float32():
    """Float32 chains with slow poles on block multiples go to the
    whole-cascade engine (measured faster and more accurate than the
    blocked one); other lengths, float64 and chains without slow poles
    keep their engines."""
    tc, fast = BiquadChain(CASES["modal"]), BiquadChain(CASES["zero"])
    x = torch.as_tensor(_x(7, np.float32))
    assert tc._auto_mode(x) == "cascade"
    assert tc._auto_mode(x[:, :N - 5]) == "blocked"
    assert tc._auto_mode(x.double()) == "blocked"
    assert fast._auto_mode(x) == "kernel"
    y_ref, _ = _jax_apply(CASES["modal"], _x(7))
    y_j32, _ = _jax_apply(CASES["modal"], _x(7, np.float32))
    for y in (tc.process(x), tc.process_stream(
            tc.init_state((C,), device="cpu"), x)[1]):
        assert snr_db(y_ref, y.numpy()) >= snr_db(y_ref, y_j32) - 6.0


def test_cascade_engine_no_less_accurate_on_slow_poles():
    """The class auto dispatch sends to the whole-cascade engine: float32
    chains with slow poles on block multiples. On each such chain here
    (high-passes, a shelf, peaks, Linkwitz-Riley and Butterworth
    sections, 40-250 Hz) it is no less accurate against float64 than the
    blocked engine, in one call and streamed in 512-sample blocks."""
    chains = [highpass(60.0, 0.707, SR), low_shelf(80.0, 6.0, 0.7, SR),
              peak(60.0, 6.0, 1.0, SR), linkwitz_riley_hp(250.0, 4, SR),
              linkwitz_riley_lp(250.0, 4, SR), butterworth_hp(40.0, 8, SR)]
    x64 = _x(8, n=8192)
    x = torch.as_tensor(x64, dtype=torch.float32)
    for sos in chains:
        tc = BiquadChain(sos)
        assert tc.has_slow_poles and tc._auto_mode(x) == "cascade"
        ref = tc.process(torch.as_tensor(x64), mode="blocked").numpy()
        got = {}
        for mode in ("blocked", "cascade"):
            st = tc.init_state((C,), device="cpu")
            parts = []
            for a in range(0, x.shape[-1], 512):
                st, y = tc.process_stream(st, x[:, a:a + 512], mode=mode)
                parts.append(y)
            got[mode] = (snr_db(ref, tc.process(x, mode=mode).numpy()),
                         snr_db(ref, torch.cat(parts, dim=-1).numpy()))
        assert all(c >= b for c, b in zip(got["cascade"], got["blocked"])), got


def test_impulse_response_dtype():
    """The impulse response in the type asked for, against the JAX
    package's evaluation of the same impulse (jitted; its
    `impulse_response` runs the engine op by op)."""
    sos = CASES["zero"]
    tc, jc = BiquadChain(sos), JChain(sos)
    for n, mode in ((100, "scan"), (300, "blocked")):
        for t_dt, j_dt in ((torch.float64, jnp.float64),
                           (torch.float32, jnp.float32)):
            h = tc.impulse_response(n, dtype=t_dt)
            imp = jnp.zeros((n,), j_dt).at[0].set(1.0)
            h_j = np.asarray(ref_jit(lambda x_: jc.process(x_, mode=mode))(imp))
            assert h.dtype == h_j.dtype and h.shape == (n,)
            assert snr_db(h_j, h) >= (200 if t_dt == torch.float64 else 120)


def test_poles_zeros_and_is_stable_match_jax():
    rows = [CASES["modal"][0], CASES["zero"][1],
            [1.0, 0.0, 0.0, -1.9, 0.95],       # no zeros (b1 = b2 = 0)
            [0.0, 1.0, 0.5, 0.1, 0.2],          # b0 = 0: one zero
            [0.0, 0.0, 1.0, -2.1, 1.1]]         # unstable
    for row in rows:
        z, p = poles_zeros(row)
        z_j, p_j = j_poles_zeros(row)
        np.testing.assert_array_equal(z, z_j)
        np.testing.assert_array_equal(p, p_j)
    for sos in (CASES["modal"], rows[2:], rows[:3]):
        assert is_stable(sos) == j_is_stable(sos)
    assert is_stable(CASES["modal"]) and not is_stable(rows)


def test_matrix_engines_pin_full_float32():
    """A caller's `torch.set_float32_matmul_precision("medium")` (bfloat16
    matmuls in oneDNN where the CPU has them; TF32 on the card) neither
    reaches the engines' products nor is changed by them."""
    sos = CASES["modal"]
    tc = BiquadChain(sos)
    x = torch.as_tensor(_x(6, np.float32))
    ref = (tc.process(x, mode="blocked"), tc.process(x, mode="cascade"))
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        got = (tc.process(x, mode="blocked"), tc.process(x, mode="cascade"))
        assert torch.get_float32_matmul_precision() == "medium"
        with pytest.raises(ZeroDivisionError):
            with linrec.full_float32():
                1 / 0
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(before)
    for a, b in zip(ref, got):
        assert torch.equal(a, b)
