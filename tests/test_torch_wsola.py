"""The port's WSOLA pitch shifter against the JAX package on the CPU (the
port through W1's plain version, JAX jitted): the starts the alignment
search picks (JAX's captured from its own `lax.scan`), the output in
float64 and float32, the sequential crossfade where the overlap is
longer than the flat part, the gradient through the segment gather
against `jax.grad`, the C++ goldens, and a NumPy model of W1's walk
(the kernel's thread ownership of offsets, tiles of the reference and
block reduction) against the plain version, with exact ties and NaN.

Tolerances: float64 >= 200 dB and the starts exactly equal; float32
starts equal to JAX's float32 starts on the JAX tests' material
(tests/test_native.py: smoothed noise, correlation peaks well apart)
and the output no more than 6 dB below JAX float32's own SNR against
JAX float64; the goldens at tests/test_native.py's bars (120 dB, 110 on
the grid sweep); the gradient >= 200 dB.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algodsp_tpu import native
from algodsp_tpu.effects.pitch import WSOLAPitchShifter as JWSOLA
from algodsp_tpu_torch.effects.pitch import WSOLAPitchShifter as TWSOLA
from algodsp_tpu_torch.ops import wsola as w1
from tests.conftest import snr_db

SR = 48000.0


def _material(n, seed=50, channels=2):
    """The JAX tests' material: smoothed noise, a second channel rolled."""
    rng = np.random.default_rng(seed)
    x = np.convolve(rng.standard_normal(n), np.ones(8) / 8.0,
                    mode="same").reshape(1, -1)
    rows = [np.roll(x, 100 * i, axis=-1) for i in range(channels)]
    return np.concatenate(rows, axis=0)


def _jax_stretch(monkeypatch, ws, x, rate):
    """JAX's stretch (jitted) and the starts (S, C) its search picked: the
    first `lax.scan` of `_time_stretch` is the search, whose stacked
    output is the starts."""
    seen, orig = [], jax.lax.scan

    def recording(f, init, xs, *args, **kwargs):
        out = orig(f, init, xs, *args, **kwargs)
        seen.append(out[1])
        return out

    def run(v):
        seen.clear()
        y = ws._time_stretch(v, rate)
        return y, seen[0]

    monkeypatch.setattr(jax.lax, "scan", recording)
    y, starts = jax.jit(run)(jnp.asarray(x))
    return np.asarray(y), np.asarray(starts)


@pytest.mark.parametrize("semitones", [3.0, -4.0, 12.0], ids=["up3", "down4", "up12"])
def test_wsola_matches_jax(monkeypatch, semitones):
    kw = dict(pitch_ratio=2.0 ** (semitones / 12.0))
    wj, wt = JWSOLA(SR, **kw), TWSOLA(SR, **kw)
    x = _material(1 << 15)
    rate = 1.0 / wj.pitch_ratio
    for dtype in ("float64", "float32"):
        xd = x.astype(dtype)
        yj, sj = _jax_stretch(monkeypatch, wj, xd, rate)
        st, _ = wt.search(torch.as_tensor(xd), rate)
        np.testing.assert_array_equal(st.numpy(), sj, err_msg=dtype)
        yt = wt._time_stretch(torch.as_tensor(xd), rate)
        assert yt.dtype == getattr(torch, dtype)
        if dtype == "float64":
            assert snr_db(yj, yt.numpy()) >= 200
            y64 = yj
        else:
            assert snr_db(y64, yt.numpy()) >= snr_db(y64, yj) - 6.0
    y_j = np.asarray(jax.jit(wj.process)(jnp.asarray(x)))
    y_t = wt.process(torch.as_tensor(x)).numpy()
    assert y_t.shape == x.shape and snr_db(y_j, y_t) >= 200


def test_crossfade_with_overlap_longer_than_flat():
    """ov > flat: the crossfade re-fades carried samples, sequentially,
    as the reference's Go loop does (here ov 720, flat 240)."""
    kw = dict(pitch_ratio=2.0 ** (5 / 12.0), sequence_ms=20.0,
              overlap_ms=15.0, seek_window_ms=10.0)
    wj, wt = JWSOLA(SR, **kw), TWSOLA(SR, **kw)
    assert wt.overlap > wt.sequence - wt.overlap
    x = _material(12000, seed=3)
    y_j = np.asarray(jax.jit(wj.process)(jnp.asarray(x)))
    assert snr_db(y_j, wt.process(torch.as_tensor(x)).numpy()) >= 200


@pytest.mark.parametrize("semitones", [3.0, -4.0], ids=["up3", "down4"])
def test_wsola_matches_native(semitones):
    ws = TWSOLA(SR, pitch_ratio=2.0 ** (semitones / 12.0))
    x = _material(1 << 15)
    y = ws.process(torch.as_tensor(x)).numpy()
    assert snr_db(native.wsola(ws, x), y) > 120


@pytest.mark.parametrize("n,ratio", [(12000, 1.3), (20000, 0.8), (30000, 0.707)])
def test_wsola_grid_matches_native(n, ratio):
    """The JAX tests' grid sweep: full length, the golden at 110 dB, the
    energy within 3 dB of the input's."""
    ws = TWSOLA(SR, pitch_ratio=ratio)
    rng = np.random.default_rng(int(n + ratio * 1000))
    x = np.convolve(rng.standard_normal(n), np.ones(8) / 8.0,
                    mode="same").reshape(1, -1)
    y = ws.process(torch.as_tensor(x)).numpy()
    assert y.shape == (1, n)
    assert snr_db(native.wsola(ws, x), y) > 110
    assert 0.5 < float(np.sum(y ** 2)) / float(np.sum(x ** 2)) < 2.0


def test_short_input_ratio_one_and_errors_match_jax():
    wj, wt = JWSOLA(SR, pitch_ratio=1.2), TWSOLA(SR, pitch_ratio=1.2)
    with pytest.raises(ValueError) as ej:
        wj.process(jnp.zeros(64))
    with pytest.raises(ValueError) as et:
        wt.process(torch.zeros(64, dtype=torch.float64))
    assert str(et.value) == str(ej.value)
    for kw in (dict(pitch_ratio=5.0), dict(sequence_ms=10.0, overlap_ms=20.0)):
        with pytest.raises(ValueError):
            TWSOLA(SR, **kw)
    x = torch.randn(2, 100, dtype=torch.float64)
    same = TWSOLA(SR)
    assert same.process(x) is x
    same.set_pitch_semitones(7.0)
    assert same.pitch_ratio == JWSOLA(SR, pitch_ratio=2.0 ** (7 / 12)).pitch_ratio


def test_gradient_through_the_gather_matches_jax():
    """d(sum(w * y))/dx: the starts are data-chosen integers, so the
    gradient flows through the segment gather, the crossfade and the
    resampler, in JAX as in the port."""
    ws_j, ws_t = JWSOLA(SR, pitch_ratio=1.25), TWSOLA(SR, pitch_ratio=1.25)
    x = _material(16000, seed=11)
    w = np.random.default_rng(12).standard_normal(x.shape)
    g_j = np.asarray(jax.jit(jax.grad(
        lambda v: jnp.sum(ws_j.process(v) * w)))(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    (ws_t.process(xt) * torch.as_tensor(w)).sum().backward()
    assert np.any(g_j != 0) and snr_db(g_j, xt.grad.numpy()) >= 200


def test_search_checks_its_reads():
    x2 = torch.zeros(2, 100, dtype=torch.float64)
    csq = w1.energy_prefix(x2)
    with pytest.raises(ValueError, match="may read up to"):
        w1.wsola_search(x2, csq, np.array([50]), np.array([False]), 20, 20, 20, 0)
    with pytest.raises(ValueError, match="csq"):
        w1.wsola_search(x2, csq[:, :-1], np.array([0]), np.array([False]), 8,
                        8, 8, 0)
    st = w1.wsola_search(x2, csq, np.array([0, 10]), np.array([False, True]),
                         8, 8, 8, 0)
    # silent regions and boundary segments take seek // 2
    np.testing.assert_array_equal(st.numpy(), [[4, 4], [14, 14]])


# -- a NumPy model of W1's walk ---------------------------------------------------

def _beats(va, ia, vb, ib):
    na, nb = np.isnan(va), np.isnan(vb)
    if na != nb:
        return bool(na)
    if na:
        return ia < ib
    return va > vb or (va == vb and ia < ib)


def _w1_model(x2, csq, region_starts, boundary, ov, seek, flat, tail0,
              threads=256, per=8, tile=128):
    """csrc/wsola.cu step by step: thread t holds offsets kb + t + r *
    threads of each chunk of threads * per, sums its products over the
    reference's tiles in order of j, keeps its best (value, index), then
    the shuffle-down tree of each warp and warp 0's walk over the warps'
    results."""
    dt = x2.dtype.type
    eps = dt(1e-12)
    chunk = threads * per
    starts = np.zeros((len(region_starts), x2.shape[0]), np.int32)
    for c in range(x2.shape[0]):
        x, q = x2[c], csq[c]
        tail = tail0
        for s, a in enumerate(region_starts):
            bv = np.full(threads, -np.inf, x.dtype)
            bi = np.full(threads, np.iinfo(np.int32).max)
            loud = np.zeros(threads, bool)
            for kb in range(0, seek, chunk):
                width = min(chunk, seek - kb)
                kk = np.arange(chunk)
                valid = kk < width
                acc = np.zeros(chunk, x.dtype)
                for j0 in range(0, ov, tile):
                    tj = min(tile, ov - j0)
                    ref = x[tail + j0:tail + j0 + tj]
                    reg = x[a + kb + j0:a + kb + j0 + width + tj - 1]
                    for jj in range(tj):
                        acc[valid] = acc[valid] + reg[kk[valid] + jj] * ref[jj]
                for r in range(per):
                    for t in range(threads):
                        k_local = t + r * threads
                        if k_local >= width:
                            continue
                        k = kb + k_local
                        norm2 = q[a + ov + k] - q[a + k]
                        v = acc[k_local] / np.sqrt(norm2 + eps)
                        if _beats(v, k, bv[t], bi[t]):
                            bv[t], bi[t] = v, k
                        loud[t] |= not (norm2 <= eps)
            warp_best = []
            for w0 in range(0, threads, 32):
                v, i = list(bv[w0:w0 + 32]), list(bi[w0:w0 + 32])
                for off in (16, 8, 4, 2, 1):
                    for lane in range(32 - off):
                        if _beats(v[lane + off], i[lane + off], v[lane], i[lane]):
                            v[lane], i[lane] = v[lane + off], i[lane + off]
                warp_best.append((v[0], i[0]))
            v, i = warp_best[0]
            for wv, wi in warp_best[1:]:
                if _beats(wv, wi, v, i):
                    v, i = wv, wi
            best = seek // 2 if (not loud.any() or boundary[s]) else i
            starts[s, c] = a + best
            tail = a + best + flat
    return starts


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_w1_walk_model_matches_plain(dtype):
    """Two chunks of offsets (seek 2100) and three tiles of the reference
    (ov 300, the last one ragged): the model's starts equal the plain
    version's; then exact ties (a periodic run of small integers, whose
    products and energy sums are exact, so offsets a period apart score
    alike: the lowest index wins) and a NaN (the first NaN score wins)."""
    ov, seek, flat = 300, 2100, 500
    rng = np.random.default_rng(21)
    n = 9000
    cases = []
    smooth = np.stack([np.convolve(rng.standard_normal(n), np.ones(6) / 6,
                                   mode="same") for _ in range(2)])
    cases.append(smooth)
    period = rng.integers(-3, 4, 64).astype(float)
    cases.append(np.tile(period, (2, n // 64 + 1))[:, :n])
    nan = smooth.copy()
    nan[1, 2500] = np.nan
    cases.append(nan)
    region_starts = np.array([0, 1200, 2400, 3600], np.int32)
    boundary = np.array([False, False, False, True])
    for case, x in enumerate(cases):
        x2 = torch.as_tensor(x.astype(dtype))
        csq = w1.energy_prefix(x2)
        plain = w1.wsola_search(x2, csq, region_starts, boundary, ov, seek,
                                flat, 40).numpy()
        model = _w1_model(x2.numpy(), csq.numpy(), region_starts, boundary, ov,
                          seek, flat, 40)
        np.testing.assert_array_equal(model, plain, err_msg=f"case {case}")
        if case == 1:
            # a tie: the lowest of the offsets a period apart
            assert np.all((plain[:3] - region_starts[:3, None]) < 64)
