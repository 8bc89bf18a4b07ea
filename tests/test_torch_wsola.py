"""The port's WSOLA pitch shifter against the JAX package on the CPU (the
port through W1's plain version, JAX jitted): the starts the alignment
search picks (JAX's captured from its own `lax.scan`), the output in
float64 and float32, the sequential crossfade where the overlap is
longer than the flat part, the gradient through the segment gather
against `jax.grad`, the C++ goldens, and a NumPy model of W1's walk
(the offsets split across a cluster's blocks, the two-level argmax)
against the plain version, with exact ties, NaN and silence.

Tolerances: float64 >= 200 dB and the starts exactly equal; float32
starts equal to JAX's float32 starts on the JAX tests' material
(tests/test_native.py: smoothed noise, correlation peaks well apart)
and the output no more than 6 dB below JAX float32's own SNR against
JAX float64; the goldens at tests/test_native.py's bars (120 dB, 110 on
the grid sweep); the gradient >= 200 dB.
"""

import tests.torch_port_setup  # noqa: F401  (first: one PyTorch thread)

import itertools

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
from tests.torch_port_setup import ref_jit

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
    y, starts = ref_jit(run)(jnp.asarray(x))
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
    y_j = np.asarray(ref_jit(wj.process)(jnp.asarray(x)))
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
    y_j = np.asarray(ref_jit(wj.process)(jnp.asarray(x)))
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
    g_j = np.asarray(ref_jit(jax.grad(
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


def test_plan_stages_presets_and_tiles_long_windows():
    """W1's schedule: the music preset and the pitch-time node's defaults
    fit the staged schedule's shared memory at every rate and in both
    types; the node's longest windows (overlap 60 ms, search 40 ms) fall
    to the tiled schedule in float64 from 96 kHz and in float32 at 192
    kHz. Both keep 8 blocks a channel and one pair of offsets a thread."""
    presets = {"music": {}, "node": dict(sequence_ms=40.0, overlap_ms=10.0,
                                         seek_window_ms=15.0),
               "node_longest": dict(sequence_ms=120.0, overlap_ms=60.0,
                                    seek_window_ms=40.0)}
    for rate, (name, kw), itemsize in itertools.product(
            (48000, 96000, 192000), presets.items(), (4, 8)):
        ws = TWSOLA(rate, **kw)
        pb, threads, tiled = w1.plan(ws.seek, ws.overlap, itemsize)
        assert pb == -(-ws.seek // 8)
        assert threads - 32 == min(480, -(-pb // 64) * 32)
        long_one = name == "node_longest" and itemsize * rate >= 8 * 96000
        assert tiled == long_one, (rate, name, itemsize)


# -- a NumPy model of W1's walk ---------------------------------------------------

def _beats(va, ia, vb, ib):
    na, nb = np.isnan(va), np.isnan(vb)
    if na != nb:
        return bool(na)
    if na:
        return ia < ib
    return va > vb or (va == vb and ia < ib)


def _butterfly(pairs):
    """A warp's xor-shuffle reduction of up to 32 (value, index, loud)
    triples (missing lanes hold -inf, INT_MAX, 0): every lane's result."""
    lanes = list(pairs) + [(-np.inf, np.iinfo(np.int32).max, False)] * (32 - len(pairs))
    for off in (16, 8, 4, 2, 1):
        nxt = []
        for lane in range(32):
            (v, i, ld), (ov, oi, old) = lanes[lane], lanes[lane ^ off]
            if _beats(ov, oi, v, i):
                v, i = ov, oi
            nxt.append((v, i, ld or old))
        lanes = nxt
    return lanes[0]


def _w1_model(x2, csq, region_starts, boundary, ov, seek, flat, tail0,
              threads=None):
    """csrc/wsola.cu step by step: block r of a channel's cluster scores
    offsets [r pb, (r + 1) pb), summing thread t (all but the last warp,
    which copies) the groups of GROUP consecutive offsets t, t + threads -
    32, ... of its share, each sum in order of j from the window the last
    start landed in; each summing warp's shuffle reduction of its lanes'
    pairs, pushed into every block's inbox (rank-major), and after the
    cluster barrier each warp's over its inbox. Boundary segments skip it
    all. The tiled schedule gives each thread the same offsets (a pass of
    one pair a thread is the staged schedule's next stride) and carries
    the sums across its tiles in order of j, so this models both."""
    dt = x2.dtype.type
    eps = dt(1e-12)
    pb, planned, _ = w1.plan(seek, ov, x2.itemsize)
    threads = threads or planned
    starts = np.zeros((len(region_starts), x2.shape[0]), np.int32)
    for c in range(x2.shape[0]):
        x, q = x2[c], csq[c]
        win, prev = x[tail0:tail0 + ov], 0
        for s, a in enumerate(region_starts):
            best = seek // 2
            if not boundary[s]:
                ref = win[prev:prev + ov]
                k = np.arange(seek)
                acc = np.zeros(seek, x.dtype)
                for j in range(ov):
                    acc = acc + x[a + k + j] * ref[j]
                norm2 = q[a + ov + k] - q[a + k]
                v = acc / np.sqrt(norm2 + eps)
                published = []
                for r in range(w1.CLUSTER):
                    k_lo, k_hi = min(seek, r * pb), min(seek, r * pb + pb)
                    per_thread = []
                    for t in range(threads - 32):    # the last warp copies
                        bv, bi, loud = -np.inf, np.iinfo(np.int32).max, False
                        for g in range(t, -(-(k_hi - k_lo) // w1.GROUP),
                                       threads - 32):
                            for u in range(w1.GROUP):
                                kk = k_lo + w1.GROUP * g + u
                                if kk >= k_hi:
                                    continue
                                if _beats(v[kk], kk, bv, bi):
                                    bv, bi = v[kk], kk
                                loud |= not (norm2[kk] <= eps)
                        per_thread.append((bv, bi, loud))
                    published += [_butterfly(per_thread[w:w + 32])
                                  for w in range(0, threads - 32, 32)]
                lanes = []      # lane l folds inbox pairs l, l + 32, ... in order
                for lane in range(min(32, len(published))):
                    bv, bi, loud = -np.inf, np.iinfo(np.int32).max, False
                    for pv, pi, pl in published[lane::32]:
                        if _beats(pv, pi, bv, bi):
                            bv, bi = pv, pi
                        loud |= pl
                    lanes.append((bv, bi, loud))
                _, i, loud = _butterfly(lanes)
                if loud:
                    best = i
            starts[s, c] = a + best
            win, prev = x[a + flat:a + flat + seek - 1 + ov], best
    return starts


W1_CASES = {
    # name: (material, dtype, seek, threads)
    "float32": ("smooth", "float32", 333, None),
    "float64": ("smooth", "float64", 333, None),
    "ties": ("ties", "float32", 333, None),
    "nan": ("nan", "float32", 333, None),
    "silent": ("silent", "float32", 333, None),
    "strided": ("smooth", "float64", 2100, 64),
}


@pytest.mark.parametrize("case", list(W1_CASES))
def test_w1_walk_model_matches_plain(case):
    """The model's starts equal the plain version's. seek 333 is no
    multiple of the cluster's 8 blocks (42 offsets a block, 39 in the
    last) nor of a warp; the last segment is a boundary one. Ties: a
    periodic run of small integers, whose products and energy sums are
    exact, so offsets a period apart score alike and the lowest index
    wins. NaN: the first NaN score wins. Silent: a channel of zeros takes
    seek // 2 and a channel silent in one region too. strided: 8 blocks
    of 263 offsets (the last 259), 132 pairs on 32 summing threads: the
    first four take five."""
    material, dtype, seek, threads = W1_CASES[case]
    ov, flat = 120, 300
    n = 1200 + seek + flat + ov
    rng = np.random.default_rng(21)
    x = np.stack([np.convolve(rng.standard_normal(n), np.ones(6) / 6,
                              mode="same") for _ in range(2)])
    if material == "ties":
        period = rng.integers(-3, 4, 64).astype(float)
        x = np.tile(period, (2, n // 64 + 1))[:, :n]
    elif material == "nan":
        x[1, 900] = np.nan
    elif material == "silent":
        x[0] = 0.0
        x[1, 350:1100] = 0.0
    region_starts = np.array([0, 400, 800, 1200], np.int32)
    boundary = np.array([False, False, False, True])
    x2 = torch.as_tensor(x.astype(dtype))
    csq = w1.energy_prefix(x2)
    plain = w1.wsola_search(x2, csq, region_starts, boundary, ov, seek, flat,
                            40).numpy()
    model = _w1_model(x2.numpy(), csq.numpy(), region_starts, boundary, ov,
                      seek, flat, 40, threads)
    np.testing.assert_array_equal(model, plain)
    np.testing.assert_array_equal(plain[3], region_starts[3] + seek // 2)
    if material == "ties":
        # a tie: the lowest of the offsets a period apart
        assert np.all((plain[:3] - region_starts[:3, None]) < 64)
    if material == "silent":
        np.testing.assert_array_equal(plain[:, 0], region_starts + seek // 2)
        assert plain[1, 1] == region_starts[1] + seek // 2
