"""NumPy models of the CUDA kernels' per-sample walks (`csrc/feedback.cu`:
R1 Delay, R2 Freeverb, R3 FDN) against the port's plain versions on the
CPU, the plain versions' gradients against `jax.grad` through the JAX
package's scans, and the effects' validation errors.

Tolerances: the models float64 >= 200 dB, float32 >= 100 dB against the
plain versions, whose blocked tiers sum in other orders; gradients in
float64 >= 200 dB.
"""

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
    """csrc/feedback.cu::fdn_kernel: full blocks in the blocked form (phase
    from the block's start, linear read index), the tail per sample
    (accumulated phase, ring index); the damping walks in order."""
    T = x.dtype.type
    lines, fst = lines.copy(), fst.copy()
    L, B, n = rv.line_len, rv._block, x.shape[-1]
    nb = n // B if B >= 16 else 0
    y = np.empty_like(x)
    two_pi, dph = T(2 * np.pi), T(2 * np.pi * rv.mod_rate / rv.sample_rate)
    base, fbg = rv.base_delays.astype(T), rv.feedback_gains.astype(T)
    off = (2 * np.pi * np.arange(8) / 8).astype(T)
    had = rv.hadamard.astype(T)
    lfo = T(lfo)
    for k in range(n):
        blocked = k < nb * B
        t = k % B
        if blocked:
            if t == 0:
                lfo_b = lfo
                lfo = _pymod(lfo + T(2 * np.pi * rv.mod_rate / rv.sample_rate * B),
                             two_pi)
            ph = _pymod(lfo_b + dph * T(t), two_pi)
        else:
            ph = lfo
            lfo = _pymod(lfo + dph, two_pi)
        wn = step + k
        d = np.empty((x.shape[0], 8), T)
        for i in range(8):
            m = T(0.5) * (T(1) + np.sin(ph + off[i]))
            pos = (T(L + t) if blocked else T(wn % L)) - (base[i] + T(rv.mod_depth) * m)
            fl = np.floor(pos)
            frac = pos - fl
            if blocked:
                r0, r1 = (wn - t + int(fl)) % L, (wn - t + int(fl) + 1) % L
            else:
                r0 = int(fl) % L
                r1 = (r0 + 1) % L
            d[:, i] = lines[:, i, r0] * (T(1) - frac) + lines[:, i, r1] * frac
        total = d[:, 0].copy()
        for i in range(1, 8):
            total = total + d[:, i]
        y[:, k] = x[:, k] * T(rv.dry) + (total * T(rv.gain)) * T(rv.wet)
        omd = T(1.0 - rv.damp) if blocked else T(1) - T(rv.damp)
        for i in range(8):
            f = had[i, 0] * d[:, 0]
            for j in range(1, 8):
                f = f + had[i, j] * d[:, j]
            fst[:, i] = f * omd + fst[:, i] * T(rv.damp)
            lines[:, i, wn % L] = inp[:, k] * T(rv.gain) + fst[:, i] * fbg[i]
    return lines, fst, lfo, y


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


def test_cpu_gradient_matches_jax():
    """On the CPU autograd runs through the plain versions, as jax.grad
    runs through the scans: d sum(y * w) / dx for each effect."""
    for make_t, make_j, n in (
            (lambda: Delay(SR, delay_seconds=0.004, feedback=0.6),
             lambda: JDelay(SR, delay_seconds=0.004, feedback=0.6), 600),
            (Freeverb, JFreeverb, 300),
            (lambda: FDNReverb(SR), lambda: JFDN(SR), 1100)):
        x = _x(n, 11)
        w = np.random.default_rng(12).standard_normal(x.shape)
        ft, fj = make_t(), make_j()
        xt = torch.tensor(x, requires_grad=True)
        _, y = ft.process(ft.init_state((C,), torch.float64, "cpu"), xt)
        (y * torch.as_tensor(w)).sum().backward()
        st0 = fj.init_state((C,), jnp.float64)
        g = jax.jit(jax.grad(lambda xx: jnp.sum(fj.process(st0, xx)[1] * w)))(
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
