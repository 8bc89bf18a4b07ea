"""NumPy models of the CUDA kernels' walks for the modulation effects
(`csrc/feedback.cu`: M1, the flanger's feedback loop; `csrc/affine.cu`:
M2, `affine_scan_nd`, and M3, `affine2_scan`) against the port's plain
versions on the CPU, and the wrappers' validation.

Tolerances: M1's model is bit-equal to its plain version in float32 and
float64 (both round every product and sum alike, and each stretch of a
call takes the reference's form); M2's and M3's models walk in order
where the plain versions compose by doubling, so float64 >= 200 dB and
float32 >= 100 dB, or no more than 6 dB under the plain version's own
float32 reading against float64 where that is lower (the bars
chip_smoke.py holds the kernels to).
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


def _m2_model(A, w, s0):
    """csrc/affine.cu::affine_scan_nd_kernel: lane i forms row i of A_n s
    plus w_n, summed over j in order."""
    n, d = A.shape[0], A.shape[-1]
    after = np.empty_like(w)
    s = s0.copy()
    for k in range(n):
        new = w[:, k, :].copy()
        for j in range(d):
            new = new + A[k, :, j] * s[:, j:j + 1]
        s = new
        after[:, k, :] = s
    return after, s


def _m3_model(A, w, s0):
    """csrc/affine.cu::affine2_scan_kernel: one thread a channel, the
    state before each step recorded."""
    s = s0.copy()
    entry = np.empty_like(w)
    for k in range(A.shape[-2]):
        entry[:, k] = s
        a = A[:, k]
        s = np.stack([a[:, 0] * s[:, 0] + a[:, 1] * s[:, 1] + w[:, k, 0],
                      a[:, 2] * s[:, 0] + a[:, 3] * s[:, 1] + w[:, k, 1]], -1)
    return entry, s


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


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_m2_model_matches_plain(dtype):
    """The Phaser's reduced recurrence at the registry's 6 stages (d = 7)
    over 517 samples from a random state."""
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
    after, fin = linrec.affine_scan_nd_plain(A, w, s0)
    after_m, fin_m = _m2_model(A.numpy(), w.numpy(), s0.numpy())
    bar = 200 if dtype == "float64" else 100
    assert snr_db(after.numpy(), after_m) >= bar
    assert snr_db(fin.numpy(), fin_m) >= bar


def test_m3_model_matches_plain():
    """The AutoWah's DF2T coefficients at its defaults, from a one-pole
    envelope of a level-stepped input (the wah sweeping its range), over
    4000 samples from a random state. The walk in order is no less
    accurate against float64 than the plain version's doubling (here 111
    dB in float32 against the doubling's 85), so in float32 it is held to
    >= 100 dB or to 6 dB under the plain version's own reading."""
    aw = AutoWah(SR)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((C, 4000)) * np.repeat(rng.uniform(0.01, 1.0, (C, 8)),
                                                   500, axis=1)
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
        plain_class = snr_db(ref[0], entry.numpy())
        bar = 200 if dtype == "float64" else min(100, plain_class - 6.0)
        assert snr_db(entry.numpy(), entry_m) >= bar
        assert snr_db(fin.numpy(), fin_m) >= bar
        assert snr_db(ref[0], entry_m) >= plain_class - 1.0


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
