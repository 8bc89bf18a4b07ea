"""NumPy models of the CUDA kernels' walks for the modulation effects
(`csrc/feedback.cu`: M1, the flanger's feedback loop; `csrc/affine.cu`:
M2, `affine_scan_nd`, and M3, `affine2_scan`) against the port's plain
versions on the CPU, and the wrappers' validation.

Tolerances: M1's model is bit-equal to its plain version in float32 and
float64 (both round every product and sum alike, and each stretch of a
call takes the reference's form); M2's and M3's models follow the
kernels' chunked scans over time (`linrec.m2_plan`, `linrec.m3_plan`:
chunk maps, the carry in the kernels' order, the walk from each chunk's
entering state) where the plain versions compose by doubling, so
float64 >= 200 dB and float32 >= 100 dB, or no more than 6 dB under the
plain version's own float32 reading against float64 where that is lower
(the bars chip_smoke.py holds the kernels to).
"""

import numpy as np
import pytest
import torch

from algodsp_tpu_torch.effects.modulation import AutoWah, Flanger, Phaser
from algodsp_tpu_torch.ops import feedback, linrec
from tests.conftest import snr_db

SR = 48000.0
C = 3
WARP = 32


def _m1_tap(fl, w, k, dv, nb):
    """csrc/feedback.cu::flanger_tap: the fraction and the virtual index of
    the first tap of call sample k (the blocked form for the first nb
    blocks, the per-sample form after)."""
    T = type(dv)
    B, L = fl._block, fl.buf_len
    if k < nb * B:
        t = k % B
        pos = T(L + t) - dv
        fl_ = np.floor(pos)
        return pos - fl_, w + k - t - L + int(fl_)
    pos = T(w + k) - dv
    fl_ = np.floor(pos)
    return pos - fl_, int(fl_)


def _m1_model(fl, buf, w, x, d):
    """csrc/feedback.cu::flanger_kernel for every channel: chunks of 32
    samples where no sample reads a slot that an earlier sample of the
    chunk writes load on every lane, then store; any other chunk walks in
    order. Returns (buf, y, chunks run on the lanes, chunks walked in
    order)."""
    T = x.dtype.type
    L, N = fl.buf_len, x.shape[-1]
    nb = feedback._flanger_blocks(fl, N)
    fb, mix, dry = T(fl.feedback), T(fl.mix), T(1.0 - fl.mix)
    buf = buf.copy()
    y = np.empty_like(x)
    lanes = walked = 0
    for k0 in range(0, N, WARP):
        cnt = min(WARP, N - k0)
        taps = [_m1_tap(fl, w, k, d[k], nb) for k in range(k0, k0 + cnt)]
        first = w + k0
        if all((r - first) % L >= j and (r + 1 - first) % L >= j
               for j, (_, r) in enumerate(taps)):
            lanes += 1
            delayed = [buf[:, r % L] * (T(1) - f) + buf[:, (r + 1) % L] * f
                       for f, r in taps]
            for j, dl in enumerate(delayed):
                k = k0 + j
                buf[:, (w + k) % L] = x[:, k] + dl * fb
                y[:, k] = x[:, k] * dry + dl * mix
        else:
            walked += 1
            for j, (f, r) in enumerate(taps):
                k = k0 + j
                dl = buf[:, r % L] * (T(1) - f) + buf[:, (r + 1) % L] * f
                buf[:, (w + k) % L] = x[:, k] + dl * fb
                y[:, k] = x[:, k] * dry + dl * mix
    return buf, y, lanes, walked


def _compose2(l, e):
    """Maps s -> M s + b of csrc/affine.cu's M3, packed [m00 m01 m10 m11 b0
    b1] on the last axis: l after e."""
    m = lambda x, i: x[..., i]
    return np.stack([m(l, 0) * m(e, 0) + m(l, 1) * m(e, 2),
                     m(l, 0) * m(e, 1) + m(l, 1) * m(e, 3),
                     m(l, 2) * m(e, 0) + m(l, 3) * m(e, 2),
                     m(l, 2) * m(e, 1) + m(l, 3) * m(e, 3),
                     m(l, 0) * m(e, 4) + m(l, 1) * m(e, 5) + m(l, 4),
                     m(l, 2) * m(e, 4) + m(l, 3) * m(e, 5) + m(l, 5)], -1)


def _apply2(m, x):
    return np.stack([m[..., 0] * x[..., 0] + m[..., 1] * x[..., 1] + m[..., 4],
                     m[..., 2] * x[..., 0] + m[..., 3] * x[..., 1] + m[..., 5]], -1)


def _shift_scan(maps, width):
    """Hillis-Steele inclusive scan along axis -2 in groups of `width`
    (a warp's shuffles): at offset o, element i >= o of its group takes
    itself after element i - o."""
    t = maps.copy()
    lane = np.arange(t.shape[-2]) % width
    o = 1
    while o < width:
        up = np.concatenate([t[..., :o, :], t[..., :-o, :]], axis=-2)
        t = np.where((lane >= o)[:, None], _compose2(t, up), t)
        o *= 2
    return t


def _m3_model(A, w, s0, sms=linrec.H100_SMS):
    """csrc/affine.cu::affine2_chunked for every channel, on the schedule
    of `linrec.m3_plan`: each pass, every block of a channel's cluster
    stages a tile; a thread composes its chunk's map from zero state;
    the maps are scanned over the lanes of each warp, then over the warp
    totals; the ranks' tile maps fold in rank order from the pass's
    entering state; each chunk walks again from its entering state. The
    maps and the walk run in float64 for either type, the stored states
    rounded to it."""
    C, n = A.shape[0], A.shape[-2]
    L, nt, B, tile = linrec.m3_plan(n, C, A.itemsize, sms)
    ident = np.array([1, 0, 0, 1, 0, 0], dtype=np.float64)
    steps = np.concatenate([A, w], -1).astype(np.float64)   # (C, n, 6)
    entry = np.empty_like(w)
    s_pass = s0.astype(np.float64)
    for pbase in range(0, n, B * tile):
        tiles = []
        for r in range(B):
            base = pbase + r * tile
            length = max(0, min(tile, n - base))
            m = np.broadcast_to(ident, (C, nt, 6)).copy()
            for i in range(L if length else 0):             # local
                k = np.arange(nt) * L + i
                live = k < length
                st = steps[:, base + np.minimum(k, length - 1)]
                m = np.where(live[:, None], _compose2(st, m), m)
            incl = _shift_scan(m, 32)
            nw = nt // 32
            tot = np.broadcast_to(ident, (C, 32, 6)).copy()
            tot[:, :nw] = incl[:, 31::32]
            tot = _shift_scan(tot, 32)[:, :nw]
            tiles.append((base, length, incl, tot))
        x = s_pass
        s_tile = []
        for _, _, _, tot in tiles:                          # carry
            s_tile.append(x)
            x = _apply2(tot[:, -1], x)
        s_pass = x
        for (base, length, incl, tot), xt in zip(tiles, s_tile):
            x = np.broadcast_to(xt[:, None], (C, nt, 2)).copy()
            warp = np.arange(nt) // 32
            lane = np.arange(nt) % 32
            wprev = np.concatenate([tot[:, :1], tot], 1)[:, warp]
            x = np.where((warp > 0)[:, None], _apply2(wprev, x), x)
            lprev = np.concatenate([incl[:, :1], incl[:, :-1]], 1)
            x = np.where((lane > 0)[:, None], _apply2(lprev, x), x)
            for i in range(L):                              # walk
                k = np.arange(nt) * L + i
                live = k < length
                idx = base + k[live]
                entry[:, idx] = x[:, live]
                x[:, live] = _apply2(steps[:, idx], x[:, live])
            if length and base + length == n:
                fin = x[:, (length - 1) // L].astype(w.dtype)
    return entry, fin


def _m2_model(A, w, s0, sms=linrec.H100_SMS):
    """csrc/affine.cu::affine_nd_chunked for every channel, on the
    schedule of `linrec.m2_plan`: each pass, every block of a cluster
    takes a tile of K chunks; the chunk composites P_k (shared by the
    channels), the zero-state chunk ends, the prefix products Q_k and the
    zero-state chunk entries e0_k carried in order; the ranks' tile maps
    (Q_K, zero-state end) fold in rank order; each chunk walks again from
    e0_k + Q_k s. Sums over j run in order, as the kernel's unrolled
    loops add them."""
    n, d = A.shape[0], A.shape[-1]
    C = w.shape[0]
    _, K, L, _, B = linrec.m2_plan(n, C, d, A.itemsize, sms)
    tile = K * L
    eye = np.eye(d, dtype=A.dtype)

    def mv(M, x, b=None):
        """M x (+ b), summed over j in order; M (..., d, d), x (..., d)."""
        acc = np.zeros_like(x) if b is None else b.copy()
        for j in range(d):
            acc = acc + M[..., :, j] * x[..., j:j + 1]
        return acc

    after = np.empty_like(w)
    fin = None
    s_pass = s0.copy()
    for pbase in range(0, n, B * tile):
        tiles = []
        for r in range(B):
            base = pbase + r * tile
            length = max(0, min(tile, n - base))
            bounds = [(min(k * L, length), min(k * L + L, length)) for k in range(K)]
            P, E = [], []
            for a, b in bounds:                             # local
                Pk, x = eye.copy(), np.zeros((C, d), A.dtype)
                for t in range(base + a, base + b):
                    Pk = mv(A[t], Pk.T).T
                    x = mv(A[t], x, w[:, t])
                P.append(Pk)
                E.append(x)
            Q, x, e0 = [eye], np.zeros((C, d), A.dtype), []
            for k in range(K):                              # carry
                Q.append(mv(P[k], Q[-1].T).T)
                e0.append(x)
                x = mv(P[k], x, E[k])
            tiles.append((base, bounds, Q, e0, x))
        x = s_pass
        s_tile = []
        for _, _, Q, _, bseg in tiles:
            s_tile.append(x)
            x = mv(Q[K], x, bseg)
        s_pass = x
        for (base, bounds, Q, e0, _), xt in zip(tiles, s_tile):
            for k, (a, b) in enumerate(bounds):             # walk
                x = mv(Q[k], xt, e0[k])
                for t in range(base + a, base + b):
                    x = mv(A[t], x, w[:, t])
                    after[:, t] = x
                if b > a and base + b == n:
                    fin = x
    return after, fin


# the flanger's forms: the registry's default base delay (46-sample blocks,
# a per-sample tail a call), a long one (128-sample blocks), and 0.1 ms
# (blocks under 16 samples: the whole call per sample, lags under a chunk)
FLANGERS = {"blocked": dict(base_delay_seconds=0.001, depth_seconds=0.0015,
                            feedback=0.25, mix=0.5),
            "blocked_128": dict(base_delay_seconds=0.004, depth_seconds=0.002,
                                rate_hz=2.0, feedback=-0.6, mix=0.7),
            "per_sample": dict(base_delay_seconds=0.0001, depth_seconds=0.0015,
                               feedback=0.9, mix=0.5)}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("form", list(FLANGERS))
def test_m1_model_bit_equal_to_plain(form, dtype):
    """Two ragged calls from a random ring and a counter past 2^16: the
    model and the plain version agree bit for bit on y, the ring and the
    counter; the default base delay runs every chunk on the lanes, 0.1
    ms walks the chunks whose lags fall under a chunk in order."""
    fl = Flanger(SR, **FLANGERS[form])
    rng = np.random.default_rng(5)
    buf = (0.3 * rng.standard_normal((C, fl.buf_len))).astype(dtype)
    x = rng.standard_normal((C, 700)).astype(dtype)
    # the LFO near its trough: the per-sample form's lag passes under a chunk
    w, phase = 70000, torch.tensor(4.2, dtype=getattr(torch, dtype))
    ys_m, ys_p, counts = [], [], [0, 0]
    buf_p = torch.as_tensor(buf)
    for a, b in ((0, 333), (333, 700)):
        xt = torch.as_tensor(x[:, a:b])
        d = fl.lags(phase, b - a, xt)
        buf, y_m, lanes, walked = _m1_model(fl, buf, w, x[:, a:b], d.numpy())
        buf_p, w_p, y_p = feedback.flanger_feedback_plain(
            fl, buf_p, torch.tensor(w, dtype=torch.int32), xt, d)
        counts[0] += lanes
        counts[1] += walked
        w += b - a
        assert int(w_p) == w
        ys_m.append(y_m)
        ys_p.append(y_p.numpy())
        phase = torch.remainder(phase + 2 * np.pi * fl.rate_hz / SR * (b - a),
                                2 * np.pi)
    np.testing.assert_array_equal(np.concatenate(ys_m, -1),
                                  np.concatenate(ys_p, -1))
    np.testing.assert_array_equal(buf, buf_p.numpy())
    if form == "per_sample":
        assert fl._block < 16 and counts[1] > 0
    else:
        assert counts[1] == 0 and fl._block >= 16


# ragged lengths: one step, under a chunk, a chunk and one either side,
# and lengths over several blocks of a cluster (M3's 36000 in float64
# also takes two passes of its cluster of 8)
M2_LENGTHS = (1, linrec.M2_CHUNK - 1, linrec.M2_CHUNK + 1, 516)
M3_LENGTHS = (1, linrec.M3_CHUNK - 1, linrec.M3_CHUNK + 1, 4000, 36000)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", M2_LENGTHS)
def test_m2_model_matches_plain(n, dtype):
    """The Phaser's reduced recurrence at the registry's 6 stages (d = 7)
    over n steps from a random state; at 516 steps a cluster of 8 blocks
    takes each channel group, the last block a ragged share."""
    ph = Phaser(SR, stages=6, feedback=0.7, rate_hz=3.0)
    rng = np.random.default_rng(6)
    xt = torch.as_tensor(rng.standard_normal((C, 517)).astype(dtype))
    a = ph.allpass_coeffs(torch.tensor(0.3, dtype=xt.dtype), 517, xt)[1:]
    d = 7
    A = torch.zeros((516, d, d), dtype=xt.dtype)
    A[:, 0, 6] = ph.feedback
    for i in range(6):
        A[:, i + 1] = a[:, None] * A[:, i]
        A[:, i + 1, i] += 1.0
        A[:, i + 1, i + 1] -= a
    w = torch.as_tensor(rng.standard_normal((C, 516, d)).astype(dtype))
    s0 = torch.as_tensor(rng.standard_normal((C, d)).astype(dtype))
    A, w = A[:n].contiguous(), w[:, :n].contiguous()
    if n == 516:
        assert linrec.m2_plan(n, C, d, A.element_size())[-1] == 8
    after, fin = linrec.affine_scan_nd_plain(A, w, s0)
    after_m, fin_m = _m2_model(A.numpy(), w.numpy(), s0.numpy())
    bar = 200 if dtype == "float64" else 100
    assert snr_db(after.numpy(), after_m) >= bar
    assert snr_db(fin.numpy(), fin_m) >= bar


@pytest.mark.parametrize("n", M3_LENGTHS)
def test_m3_model_matches_plain(n):
    """The AutoWah's DF2T coefficients at its defaults, from a one-pole
    envelope of a level-stepped input (the wah sweeping its range), over
    n samples from a random state. The chunked scan is no less accurate
    against float64 than the plain version's doubling, within 1 dB (at
    4000 samples 115 dB in float32 against the doubling's 85), so in
    float32 it is held to >= 100 dB or to 6 dB under the plain version's
    own reading."""
    aw = AutoWah(SR)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((C, n)) * np.repeat(
        rng.uniform(0.01, 1.0, (C, -(-n // 500))), 500, axis=1)[:, :n]
    env, e = np.empty_like(x), np.zeros(C)
    for k in range(x.shape[-1]):
        t = np.abs(x[:, k])
        e = e + (t - e) * np.where(t > e, aw.attack_coeff, aw.release_coeff)
        env[:, k] = e
    freq = np.clip(aw.min_freq + np.minimum(env * aw.sensitivity, 1.0)
                   * (aw.max_freq - aw.min_freq), 1.0, 0.49 * SR)
    w0 = 2 * np.pi * freq / SR
    alpha = np.sin(w0) / (2.0 * aw.q)
    inv = 1.0 / (1.0 + alpha)
    b0, a1, a2 = alpha * inv, -2.0 * np.cos(w0) * inv, (1.0 - alpha) * inv
    A = np.stack([-a1, np.ones_like(a1), -a2, np.zeros_like(a1)], -1)
    w = np.stack([-a1 * b0 * x, (-alpha * inv - a2 * b0) * x], -1)
    s0 = 0.1 * rng.standard_normal((C, 2))
    ref = _m3_model(A, w, s0)
    for dtype in ("float64", "float32"):
        args = [a.astype(dtype) for a in (A, w, s0)]
        entry, fin = linrec.affine2_scan_plain(*map(torch.as_tensor, args))
        entry_m, fin_m = _m3_model(*args)
        np.testing.assert_array_equal(entry.numpy()[:, 0], args[2])
        np.testing.assert_array_equal(entry_m[:, 0], args[2])
        plain_class = snr_db(ref[0], entry.numpy())
        bar = 200 if dtype == "float64" else min(100, plain_class - 6.0)
        assert snr_db(entry.numpy(), entry_m) >= bar
        assert snr_db(fin.numpy(), fin_m) >= bar
        assert snr_db(ref[0], entry_m) >= plain_class - 1.0
    if n == 36000:
        _, _, B, tile = linrec.m3_plan(n, C, 8)
        assert B == 8 and B * tile < n


def test_wrappers_validate_and_skip_empty_calls():
    """Empty calls return without a launch; shapes the kernels do not take
    raise on a device that is not the CPU."""
    x = torch.zeros(2, 0)
    fl = Flanger(SR)
    buf = torch.ones(2, fl.buf_len)
    b2, w2, y = feedback.flanger_feedback(fl, buf, torch.tensor(5, dtype=torch.int32),
                                          x, torch.zeros(0))
    assert int(w2) == 5 and y.shape == (2, 0) and torch.equal(b2, buf)
    entry, fin = linrec.affine2_scan(torch.zeros(2, 0, 4), torch.zeros(2, 0, 2),
                                     torch.ones(2))
    assert entry.shape == (2, 0, 2) and torch.equal(fin, torch.ones(2, 2))
    after, fin = linrec.affine_scan_nd(torch.zeros(0, 3, 3), torch.zeros(2, 0, 3),
                                       torch.ones(3))
    assert after.shape == (2, 0, 3) and torch.equal(fin, torch.ones(2, 3))
    meta = lambda *s: torch.empty(s, device="meta")
    with pytest.raises(ValueError):
        linrec.affine2_scan(meta(2, 8, 4), meta(2, 8, 2), meta(2, 2))
    with pytest.raises(ValueError):
        linrec.affine_scan_nd(meta(8, 3, 3), meta(2, 8, 3), meta(2, 3))
    with pytest.raises(ValueError):
        feedback.flanger_feedback(fl, meta(2, fl.buf_len), meta(), meta(2, 8), meta(8))
