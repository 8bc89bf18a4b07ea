"""NumPy models of the CUDA kernels' walks (`csrc/feedback.cu`: R1
Delay and R2 Freeverb per sample, R3 FDN a stretch at a time with its
damping as a scan) against the port's plain versions on the CPU (R3 also
against the jitted JAX FDNReverb), the plain versions' gradients against
`jax.grad` through the JAX package's scans, and the effects' validation
errors.

Tolerances: the models float64 >= 200 dB, float32 >= 100 dB against the
plain versions, whose blocked tiers sum in other orders; gradients in
float64 >= 200 dB.
"""

import tests.torch_port_setup  # noqa: F401  (first: one PyTorch thread)

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algodsp_tpu.effects.delay_effect import Delay as JDelay
from algodsp_tpu.effects.reverb import FDNReverb as JFDN
from algodsp_tpu.effects.reverb import Freeverb as JFreeverb
from algodsp_tpu_torch.effects.delay_effect import Delay
from algodsp_tpu_torch.effects.reverb import FDNReverb, Freeverb
from algodsp_tpu_torch.effects.reverb import freeverb as freeverb_mod
from algodsp_tpu_torch.ops import feedback
from tests.conftest import snr_db
from tests.torch_port_setup import ref_jit

SR = 48000.0
C = 2


def _x(n, seed=0, dtype="float64"):
    return np.random.default_rng(seed).standard_normal((C, n)).astype(dtype)


# -- NumPy models of the kernels' walks ---------------------------------------

def _pymod(a, b):
    r = np.fmod(a, b)
    return r + b if (r != 0 and (r < 0) != (b < 0)) else r


def _r1_model(dl, buf, w_in, x, cur):
    """csrc/feedback.cu::delay_feedback_kernel: the tier picked from cur and
    the cursor, each stretch in its reference form on the physical ring
    through a virtual offset, the linear extension's rotation at the end."""
    T = buf.dtype.type
    L, B = dl.buf_len, 128
    buf = buf.copy()
    n = x.shape[-1]
    y = np.empty_like(x)
    w = w_in % L
    nb, rem = divmod(n, B)
    ok = nb > 0 and bool(np.all((cur >= T(B + 2)) & (cur <= T(L - 2))))
    rot = -1
    if not ok:
        segs, w_final = [(0, w, 0, 0, n)], (w + n) % L
    elif rem == 0 and w % B == 0:
        segs, w_final = [(1, w, 0, 0, n)], (w + n) % L
    else:
        rot = (w + nb * B) % L
        segs, w_final = [(2, w, 0, 0, nb * B)], rem
        if rem:
            segs.append((0, 0, rot, nb * B, n))
    for form, v0, off, k0, k1 in segs:
        for k in range(k0, k1):
            kk, c = k - k0, cur[k]
            if form == 2:
                pos = T(L + kk) - c
                fl = np.floor(pos)
                r0, r1 = (v0 + int(fl)) % L, (v0 + int(fl) + 1) % L
                wr = (v0 + kk) % L
            else:
                v = v0 + kk if form == 0 else (v0 + kk) % L
                pos = _pymod(T(v) - c, T(L))
                fl = np.floor(pos)
                i0 = int(fl)
                i1 = (i0 + 1) % L
                r0, r1 = (min(max(i0, 0), L - 1) + off) % L, (i1 + off) % L
                wr = (v % L + off) % L
            frac = pos - fl
            delayed = buf[:, r0] * (T(1) - frac) + buf[:, r1] * frac
            buf[:, wr] = x[:, k] + delayed * T(dl.feedback)
            y[:, k] = x[:, k] * T(1.0 - dl.mix) + delayed * T(dl.mix)
    if rot > 0:
        buf = np.roll(buf, -rot, axis=1)
    return buf, w_final, y


def _r2_model(fv, combs, fstore, allp, step, x):
    """csrc/feedback.cu::freeverb_kernel: the reference's per-sample walk,
    each comb's damping in order, the comb sum from 0 in comb order."""
    T = x.dtype.type
    combs = [c.copy() for c in combs]
    allp = [a.copy() for a in allp]
    fst = fstore.copy()
    y = np.empty_like(x)
    da, db = T(fv.damp), T(1.0 - fv.damp)
    for k in range(x.shape[-1]):
        n = step + k
        inp = T(fv.input_gain) * x[:, k]
        acc = np.zeros_like(x[:, k])
        for i, c in enumerate(combs):
            out = c[:, n % c.shape[-1]].copy()
            fs = out * db + fst[:, i] * da
            fs = np.where(np.abs(fs) < T(1e-23), T(0), fs)
            fst[:, i] = fs
            c[:, n % c.shape[-1]] = inp + fs * T(fv.comb_feedback)
            acc = acc + out
        for a in allp:
            bo = a[:, n % a.shape[-1]].copy()
            a[:, n % a.shape[-1]] = acc + bo * T(fv.allpass_feedback)
            acc = bo - acc
        y[:, k] = acc * T(fv.wet) + x[:, k] * T(fv.dry)
    return combs, fst, allp, y


def _r3_model(rv, lines, fst, lfo, step, x, inp):
    """csrc/feedback.cu::fdn_kernel: the call in stretches, each whole
    block of the blocked tier (phase from the block's start, linear read
    index), then the per-sample tier in stretches of max(1, `_block`) samples
    (the phase accumulated in order, ring index). A stretch reads all its
    samples, mixes them, scans each line's damping over 32 chunks (each
    walked in order, lane 0's from the line's state, the chunks' maps
    composed as the shuffles compose them) and then writes."""
    T = x.dtype.type
    lines, fst = lines.copy(), fst.copy()
    L, B, n = rv.line_len, rv._block, x.shape[-1]
    nb = n // B if B >= 16 else 0
    y = np.empty_like(x)
    two_pi, dph = T(2 * np.pi), T(2 * np.pi * rv.mod_rate / rv.sample_rate)
    dph_block = T(2 * np.pi * rv.mod_rate / rv.sample_rate * B)
    base, fbg = rv.base_delays.astype(T), rv.feedback_gains.astype(T)
    off = (2 * np.pi * np.arange(8) / 8).astype(T)
    had = rv.hadamard.astype(T)
    da = T(rv.damp)
    pw = np.array([np.float64(da) ** k for k in range(33)]).astype(T)
    state = {"lfo": T(lfo), "fst": fst}

    def stretch(k0, ln, blocked):
        t = np.arange(ln)
        wn = step + k0 + t
        lfo = state["lfo"]
        if blocked:
            ph = np.array([_pymod(lfo + dph * T(u), two_pi) for u in t], T)
            state["lfo"] = _pymod(lfo + dph_block, two_pi)
        else:
            ph = np.empty(ln, T)
            for u in range(ln):
                ph[u] = lfo
                lfo = _pymod(lfo + dph, two_pi)
            state["lfo"] = lfo
        d = np.empty((x.shape[0], 8, ln), T)
        for i in range(8):
            m = T(0.5) * (T(1) + np.sin(ph + off[i]))
            dl = base[i] + T(rv.mod_depth) * m
            pos = ((L + t).astype(T) if blocked else (wn % L).astype(T)) - dl
            fl = np.floor(pos)
            frac = pos - fl
            if blocked:
                r0 = (wn - t + fl.astype(np.int64)) % L
                r1 = (r0 + 1) % L
            else:
                r0 = fl.astype(np.int64) % L
                r1 = (r0 + 1) % L
            d[:, i] = lines[:, i, r0] * (T(1) - frac) + lines[:, i, r1] * frac
        total = d[:, 0].copy()
        for i in range(1, 8):
            total = total + d[:, i]
        y[:, k0:k0 + ln] = x[:, k0:k0 + ln] * T(rv.dry) + (total * T(rv.gain)) * T(rv.wet)
        f = np.empty_like(d)
        for i in range(8):
            f[:, i] = had[i, 0] * d[:, 0]
            for j in range(1, 8):
                f[:, i] = f[:, i] + had[i, j] * d[:, j]
        omd = T(1.0 - rv.damp) if blocked else T(1) - T(rv.damp)
        lc = -(-ln // 32)
        e = np.zeros(f.shape[:2] + (32,), T)
        P = np.ones(32, T)
        for lane in range(32):
            t0, t1 = min(ln, lane * lc), min(ln, lane * lc + lc)
            z = state["fst"] if lane == 0 else np.zeros(f.shape[:2], T)
            for u in range(t0, t1):
                z = f[..., u] * omd + z * da
                f[..., u] = z
            e[..., lane], P[lane] = z, T(0) if lane == 0 else pw[t1 - t0]
        o = 1
        while o < 32:
            e2, P2 = e.copy(), P.copy()
            for lane in range(o, 32):
                e2[..., lane] = P[lane] * e[..., lane - o] + e[..., lane]
                P2[lane] = P[lane] * P[lane - o]
            e, P, o = e2, P2, 2 * o
        for lane in range(1, 32):
            for u in range(min(ln, lane * lc), min(ln, lane * lc + lc)):
                f[..., u] = f[..., u] + pw[u - lane * lc + 1] * e[..., lane - 1]
        state["fst"] = e[..., 31]
        for i in range(8):
            lines[:, i, wn % L] = inp[:, k0:k0 + ln] * T(rv.gain) + f[:, i] * fbg[i]

    for b in range(nb):
        stretch(b * B, B, True)
    S = max(1, rv._block)
    for k0 in range(nb * B, n, S):
        stretch(k0, min(S, n - k0), False)
    return lines, state["fst"], state["lfo"], y


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_numpy_models_of_the_kernels_match_the_plain_versions(dtype):
    bar = 200.0 if dtype == "float64" else 100.0
    rng = np.random.default_rng(10)
    T = getattr(np, dtype)
    tt = lambda a: torch.as_tensor(a)
    # R1: every tier, the rotation, a lag under a chunk
    for kw, w_in, n in ((dict(delay_seconds=0.02), 1024, 512),
                        (dict(delay_seconds=0.02), 777, 1000),
                        (dict(delay_seconds=0.0005), 96000, 300)):
        dl = Delay(SR, **kw)
        buf = (0.3 * rng.standard_normal((C, dl.buf_len))).astype(T)
        x = rng.standard_normal((C, n)).astype(T)
        cur = dl.trajectory(torch.tensor(float(dl.delay_samples), dtype=getattr(
            torch, dtype)), n, dl.delay_samples * 1.5)
        b_m, w_m, y_m = _r1_model(dl, buf, w_in, x, cur.numpy())
        b_p, w_p, y_p = feedback.delay_feedback_plain(
            dl, tt(buf), torch.tensor(w_in, dtype=torch.int32), tt(x), cur)
        assert int(w_p) == w_m
        assert snr_db(y_p.numpy(), y_m) >= bar
        assert snr_db(b_p.numpy(), b_m) >= bar
    # R2: blocks and a tail from a nonzero state
    fv = Freeverb()
    combs = [(0.3 * rng.standard_normal((C, m))).astype(T)
             for m in freeverb_mod.COMB_TUNINGS]
    allp = [(0.3 * rng.standard_normal((C, m))).astype(T)
            for m in freeverb_mod.ALLPASS_TUNINGS]
    fs0 = (0.05 * rng.standard_normal((C, 8))).astype(T)
    x = rng.standard_normal((C, 333)).astype(T)
    c_m, f_m, a_m, y_m = _r2_model(fv, combs, fs0, allp, 1000, x)
    st, y_p = feedback.freeverb_feedback_plain(fv, {
        "combs": [tt(c) for c in combs], "filter_store": tt(fs0),
        "allpasses": [tt(a) for a in allp],
        "step": torch.tensor(1000, dtype=torch.int32)}, tt(x))
    assert snr_db(y_p.numpy(), y_m) >= bar
    assert snr_db(np.concatenate([c.numpy().ravel() for c in st["combs"]]),
                  np.concatenate([c.ravel() for c in c_m])) >= bar
    # R3: two blocks and a tail
    rv = FDNReverb(SR, damp=0.45, mod_rate_hz=0.7)
    lines = (0.3 * rng.standard_normal((C, 8, rv.line_len))).astype(T)
    fst = (0.05 * rng.standard_normal((C, 8))).astype(T)
    x = rng.standard_normal((C, 2200)).astype(T)
    inp = (0.5 * x + 0.1).astype(T)
    l_m, f_m, lfo_m, y_m = _r3_model(rv, lines, fst, 5.9, 77, x, inp)
    l_p, f_p, lfo_p, s_p, y_p = feedback.fdn_feedback_plain(
        rv, tt(lines), tt(fst), torch.tensor(5.9, dtype=getattr(torch, dtype)),
        torch.tensor(77, dtype=torch.int32), tt(x), tt(inp))
    assert float(lfo_p) == float(lfo_m) and int(s_p) == 77 + 2200
    assert snr_db(y_p.numpy(), y_m) >= bar
    assert snr_db(l_p.numpy(), l_m) >= bar


R3_CASES = {"one_block": (SR, 1024), "blocks_and_tail": (SR, 2200),
            "chain_call": (SR, 512), "tiny_delays": (400.0, 100)}


R3_STEP, R3_LFO = 77, 5.9


def _r3_inputs(case):
    """A case's sample rate and random state and input (float64)."""
    sr, n = R3_CASES[case]
    rng = np.random.default_rng(30)
    rv = FDNReverb(sr)
    lines0 = 0.3 * rng.standard_normal((C, 8, rv.line_len))
    fst0 = 0.05 * rng.standard_normal((C, 8))
    return sr, lines0, fst0, rng.standard_normal((C, n))


@functools.lru_cache(maxsize=None)
def _r3_jax():
    """The JAX FDNReverb's output and lines (float64) for every R3 case,
    all from one jit."""
    fdns, states, xs = {}, {}, {}
    for case in R3_CASES:
        sr, lines0, fst0, x0 = _r3_inputs(case)
        fdns[case] = JFDN(sr, damp=0.45, mod_rate_hz=0.7)
        states[case] = {"lines": jnp.asarray(lines0),
                        "pre": jnp.zeros((C, fdns[case].pre_len)),
                        "filter": jnp.asarray(fst0),
                        "lfo_phase": jnp.float64(R3_LFO),
                        "step": jnp.int32(R3_STEP)}
        xs[case] = jnp.asarray(x0)
    out = ref_jit(lambda st, x: {c: fdns[c].process(st[c], x[c]) for c in R3_CASES})(
        states, xs)
    return {c: (np.asarray(out[c][1]), np.asarray(out[c][0]["lines"]))
            for c in R3_CASES}


@pytest.mark.parametrize("case", list(R3_CASES))
def test_r3_stretch_model_matches_plain_and_jax(case):
    """R3's stretch schedule (the NumPy model of csrc/feedback.cu::
    fdn_kernel) from a random state: one whole block, two blocks and a
    152-sample per-sample tail, the chain's 512-sample call in one
    per-sample stretch, and a configuration whose shortest line (14
    samples at 400 Hz) gives no blocked tier and 11-sample stretches. The
    model against the plain version (float64 and float32) and against the
    jitted JAX FDNReverb's output and lines (float64)."""
    sr, lines0, fst0, x0 = _r3_inputs(case)
    rv = FDNReverb(sr, damp=0.45, mod_rate_hz=0.7)
    step, lfo = R3_STEP, R3_LFO
    for dtype in ("float64", "float32"):
        T = getattr(np, dtype)
        td = getattr(torch, dtype)
        lines, fst, x = lines0.astype(T), fst0.astype(T), x0.astype(T)
        _, inp = rv._apply_pre_delay(torch.zeros(C, rv.pre_len, dtype=td),
                                     torch.tensor(step), torch.as_tensor(x))
        l_m, f_m, lfo_m, y_m = _r3_model(rv, lines, fst, lfo, step, x,
                                         inp.numpy())
        l_p, f_p, lfo_p, _, y_p = feedback.fdn_feedback_plain(
            rv, torch.as_tensor(lines), torch.as_tensor(fst),
            torch.tensor(lfo, dtype=td), torch.tensor(step, dtype=torch.int32),
            torch.as_tensor(x), inp)
        bar = 200.0 if dtype == "float64" else 100.0
        assert float(lfo_p) == float(lfo_m), dtype
        for got, want in ((y_m, y_p), (l_m, l_p), (f_m, f_p)):
            assert snr_db(want.numpy(), got) >= bar, dtype
        if dtype == "float64":
            y64, l64 = y_m, l_m
    yj, lj = _r3_jax()[case]
    assert snr_db(yj, y64) >= 200
    assert snr_db(lj, l64) >= 200


GRAD_CASES = {
    "delay": (lambda: Delay(SR, delay_seconds=0.004, feedback=0.6),
              lambda: JDelay(SR, delay_seconds=0.004, feedback=0.6), 600),
    "freeverb": (Freeverb, JFreeverb, 300),
    "fdn": (lambda: FDNReverb(SR), lambda: JFDN(SR), 1100),
}


@pytest.mark.parametrize("effect", list(GRAD_CASES))
def test_cpu_gradient_matches_jax(effect):
    """On the CPU autograd runs through the plain versions, as jax.grad
    runs through the scans: d sum(y * w) / dx for each effect."""
    make_t, make_j, n = GRAD_CASES[effect]
    x = _x(n, 11)
    w = np.random.default_rng(12).standard_normal(x.shape)
    ft, fj = make_t(), make_j()
    xt = torch.tensor(x, requires_grad=True)
    _, y = ft.process(ft.init_state((C,), torch.float64, "cpu"), xt)
    (y * torch.as_tensor(w)).sum().backward()
    st0 = fj.init_state((C,), jnp.float64)
    g = ref_jit(jax.grad(lambda xx: jnp.sum(fj.process(st0, xx)[1] * w)))(
        jnp.asarray(x))
    assert snr_db(np.asarray(g), xt.grad.numpy()) >= 200


def test_validation_errors():
    for kw in (dict(sample_rate=0.0), dict(sample_rate=SR, feedback=1.0),
               dict(sample_rate=SR, mix=1.5), dict(sample_rate=SR, delay_seconds=3.0),
               dict(sample_rate=SR, delay_seconds=0.0)):
        with pytest.raises(ValueError):
            Delay(**kw)
    for kw in (dict(sample_rate=-1.0), dict(sample_rate=float("inf")),
               dict(sample_rate=SR, wet=-0.1), dict(sample_rate=SR, rt60_seconds=0)):
        with pytest.raises(ValueError):
            FDNReverb(**kw)
    x = torch.zeros(2, 1024)
    with pytest.raises(ValueError, match="multiple of the internal block"):
        Freeverb().process_blocks(Freeverb().init_state((2,), device="cpu"), x,
                                  block_size=100)
    rv = FDNReverb(SR)
    with pytest.raises(ValueError, match="multiple of the internal block"):
        rv.process_blocks(rv.init_state((2,), device="cpu"), x, block_size=512)
    dl = Delay(SR)
    assert dl.buf_len == 96128 and dl.buf_len % 128 == 0
    assert (rv.line_len, rv.pre_len, rv._block) == (3439, 484, 1024)
