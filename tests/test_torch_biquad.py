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


def _section_major_model(x, sos, st, seg, length, threads, blocks):
    """numpy model of the CUDA cascade kernel's plan for one channel:
    rounds of `blocks` segments (one block each), the first seeded by the
    (S, 4) direct-form state. Per section, in transposed direct form II:
    a zero-state walk of each chunk; an inclusive scan of the chunks'
    maps c -> G c + w with the table's powers of G (within warps of 32 by
    doubling, each warp's entering state by Horner's rule over the earlier
    warps' totals); in a round of several blocks, each block's
    entering state composed from the earlier blocks' end states and
    added to chunk k through G^k; and a walk of each chunk from its
    entering state."""
    from algodsp_tpu_torch.ops.biquad_cascade import section_tables
    tab = section_tables(sos, length, seg)[:, 5:].reshape(-1, 37, 2, 2)
    pw, gseg = tab[:, :36], tab[:, 36]
    st = st.copy()
    y = np.empty_like(x)
    k_ = np.arange(threads)
    lane, warp = k_ % 32, k_ // 32

    def shift(a, o):
        out = np.zeros_like(a)
        out[o:] = a[:-o]
        return out

    def power(s, m, v):
        """G^m v for chunk counts m (one per row of v)."""
        for j in range(10):
            g = pw[s, (1 << j) - 1 if j <= 5 else 26 + j]
            v = np.where(((m >> j) & 1)[:, None] == 1, v @ g.T, v)
        return v

    def walk(buf, sec, start, end, c, write):
        """Chunks [start, end) of buf through section `sec` from states c,
        all chunks at once: the end states."""
        b0, b1, b2, a1, a2 = sec
        s1, s2 = c[:, 0].copy(), c[:, 1].copy()
        for i in range(length):
            idx = start + i
            on = idx < end
            v = np.where(on, buf[np.minimum(idx, buf.size - 1)], 0.0)
            out = b0 * v + s1
            if write:
                buf[idx[on]] = out[on]
            s1, s2 = (np.where(on, b1 * v - a1 * out + s2, s1),
                      np.where(on, b2 * v - a2 * out, s2))
        return np.stack([s1, s2], axis=1)

    zero = np.zeros((threads, 2))
    for r0 in range(0, x.size, blocks * seg):
        bufs = [x[b:b + seg].copy() for b in range(r0, min(r0 + blocks * seg, x.size), seg)]
        ns = [b.size for b in bufs]
        starts = [np.minimum(k_ * length, n) for n in ns]
        ends = [np.minimum(s + length, n) for s, n in zip(starts, ns)]
        ws = [walk(b, sos[0], s0, e0, zero, False) for b, s0, e0 in zip(bufs, starts, ends)]
        for s, (b0, b1, b2, a1, a2) in enumerate(sos):
            x1, x2, y1, y2 = st[s]
            c = np.array([b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2,
                          b2 * x1 - a2 * y1])
            es, seg_end = [], []
            for b, w in enumerate(ws):
                inc = w
                for o in (1, 2, 4, 8, 16):
                    inc = inc + (lane >= o)[:, None] * (shift(inc, o) @ pw[s, o - 1].T)
                # each warp's entering state: Horner over the earlier
                # warps' totals from the block's (the channel's for block 0)
                p = np.zeros((threads // 32, 2))
                p[0] = c if b == 0 else 0.0
                for j in range(1, threads // 32):
                    p[j] = pw[s, 31] @ p[j - 1] + inc[32 * j - 1]
                p = p[warp]
                g = pw[s, np.maximum(lane - 1, 0)]
                e = np.where((lane == 0)[:, None], p,
                             np.einsum("kij,kj->ki", g, p) + shift(inc, 1))
                lst = (ns[b] - 1) // length
                seg_end.append(pw[s, 0] @ e[lst] + w[lst])
                es.append(e)
            a = np.zeros(2)
            for b in range(1, len(bufs)):
                a = gseg[s] @ a + seg_end[b - 1]
                es[b] = es[b] + power(s, k_, np.tile(a, (threads, 1)))
            buf, n = bufs[-1], ns[-1]
            ins = buf[-2:].copy() if n > 1 else np.array([x1, buf[-1]])
            for b, buf_b in enumerate(bufs):
                walk(buf_b, sos[s], starts[b], ends[b], es[b], True)
            outs = buf[-2:] if n > 1 else np.array([y1, buf[-1]])
            st[s] = [ins[-1], ins[0], outs[-1], outs[0]]
            if s + 1 < len(sos):
                ws = [walk(b, sos[s + 1], s0, e0, zero, False)
                      for b, s0, e0 in zip(bufs, starts, ends)]
        y[r0:r0 + sum(ns)] = np.concatenate(bufs)
    return y, st


def test_section_major_plan_of_the_cascade_kernel():
    """The CUDA cascade kernel's decomposition (section-major chunks in
    transposed direct form II, a two-value state per section composed by
    a scan with powers of G, segments in order seeded by the direct-form
    state or at once in a cluster of blocks) rebuilds the float64
    cascade, for the Butterworth and the A-weighting chain (first-order
    sections), from a state, with N a multiple of neither the chunk nor
    the segment, two warps of chunks, and a last segment of one sample."""
    rng = np.random.default_rng(9)
    for name in ("butterworth", "a_weighting"):
        sos = CHAINS[name].runtime_sos
        for n, seg, blocks in ((700, 290, 1), (581, 290, 1), (700, 294, 3)):
            x = rng.standard_normal(n)
            st0 = rng.standard_normal((sos.shape[0], 4)) * 0.1
            y, st = _section_major_model(x, sos, st0, seg, 7, 64, blocks)
            y_ref, st_ref = _direct_form(x, sos, st0)
            np.testing.assert_allclose(y, y_ref, rtol=0, atol=1e-12)
            np.testing.assert_allclose(st, st_ref, rtol=0, atol=1e-12)


def test_segment_plan_and_tables_of_the_cascade_kernel():
    """`segment_plan` gives odd chunks of at least 3 samples, at most 512
    threads in whole warps covering the segment, segments covering the
    channel in order (one block) or at once (a cluster of at most 8
    blocks where the channels leave SMs idle, whole chunks in all but the
    last, which has at least 2 samples), and a float64 segment within a
    block's 227 KB of shared memory; `section_tables` holds the
    coefficients and the powers of the transposed direct form's state
    transition that the scan reads."""
    from algodsp_tpu_torch.ops.biquad_cascade import section_tables, segment_plan
    for n, c, b_want in ((1, 1, 1), (2, 4, 1), (512, 64, 1), (5006, 3, 1),
                         (24577, 3, 6), (48128, 8, 8), (24577, 70, 1),
                         (1 << 16, 512, 1), (1 << 20, 1, 1)):
        seg, length, threads, blocks = segment_plan(n, c, 132)
        assert blocks == b_want
        assert length % 2 == 1 and length >= 3
        assert threads % 32 == 0 and 32 <= threads <= 512
        assert threads * length >= seg and threads - 32 < -(-seg // length)
        assert threads * 48 >= seg                  # the staging registers
        # float64 segment plus the static float64 arrays, in 227 KB
        assert seg * 8 + 8 * (4 * 64 + 64 + 2 * 153 + 6) <= 232448
        if blocks == 1:
            assert seg <= n and -(-n // seg) * seg < n + seg
        else:
            assert seg % length == 0 and (blocks - 1) * seg + 2 <= n <= blocks * seg
    sos = CHAINS["a_weighting"].runtime_sos
    tab = section_tables(sos, 25, 1000)
    assert tab.shape == (sos.shape[0], 153)
    assert np.array_equal(tab[:, :5], sos)
    one = np.zeros((sos.shape[0], 2, 2))
    one[:, 0, 0], one[:, 0, 1], one[:, 1, 0] = -sos[:, 3], 1.0, -sos[:, 4]
    mats = tab[:, 5:].reshape(-1, 37, 2, 2)
    for m, i in ((25, 0), (50, 1), (25 * 32, 31), (25 * 512, 35), (1000, 36)):
        np.testing.assert_allclose(mats[:, i], np.linalg.matrix_power(one, m),
                                   rtol=1e-12, atol=1e-300)
