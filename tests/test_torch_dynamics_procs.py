"""The port's dynamics processors beyond the feed-forward compressor: the
feedback topology (D1's plain version on the CPU), Limiter, Expander,
Gate, LookaheadLimiter, DeEsser, TransientShaper and MultibandCompressor,
against the JAX package (its XLA paths, jitted) and the shared C++
goldens of `native/`.

Each processor runs C channels in two equal blocks with the state
carried and is held to:
- JAX float64 at >= 200 dB on y (and the gain where there is one), and
  its states to the same;
- itself in one call at >= 250 dB (blocks change only the RMS
  history's summation);
- JAX's second block when started from JAX's mid-stream state through
  `convert.state_from_numpy` (>= 200 dB);
- channel 0 against its golden over the same two blocks at
  tests/test_native.py's bars: > 120 dB, the expander's y > 100 dB.
The gate's hold counter and held samples equal the reference's exactly.
"""

import tests.torch_port_setup  # noqa: F401  (first: one PyTorch thread)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algodsp_tpu import native
from algodsp_tpu.effects import dynamics as JD
from algodsp_tpu_torch import convert
from algodsp_tpu_torch.effects import dynamics as TD
from algodsp_tpu_torch.effects.dynamics.processors import gate_hold
from algodsp_tpu_torch.ops import dynfb
from tests.conftest import snr_db
from tests.torch_port_setup import ref_jit

SR = 48000.0
C, N = 2, 1024
needs_native = pytest.mark.skipif(not native.available(),
                                  reason="native library not built")


def _x(seed=0, n=N):
    """Noise whose level steps across the thresholds both ways."""
    rng = np.random.default_rng(seed)
    level = np.repeat([0.9, 0.004, 0.5, 0.02, 1.6, 0.001, 0.3, 0.08],
                      -(-n // 8))[:n]
    return rng.standard_normal((C, n)) * level


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(ref, got, bar=200.0):
    """Every leaf of two state trees agrees to `bar` dB (ints exactly)."""
    ref_l, got_l = jax.tree.leaves(_tree_np(ref)), jax.tree.leaves(
        jax.tree.map(lambda t: t.numpy(), got))
    assert len(ref_l) == len(got_l)
    for a, b in zip(ref_l, got_l):
        assert a.shape == b.shape and a.dtype == b.dtype
        if np.issubdtype(a.dtype, np.integer) or not np.any(a):
            np.testing.assert_array_equal(a, b)
        else:
            assert snr_db(a, b) >= bar


def _both(jp, tp, x, *, gain=False, call=None):
    """Run JAX (jitted) and the port over x in two blocks; check the port
    against JAX, against itself in one call and from JAX's mid-stream
    state. Returns (port y, port gain or None, JAX states, port states)."""
    call = call or (lambda p, st, xb: p.process(st, xb, with_gain=True)
                    if gain else p.process(st, xb))
    run = ref_jit(lambda st, xb: call(jp, st, xb))
    half = x.shape[-1] // 2
    st_j = jp.init_state((C,), jnp.float64)
    st_t = tp.init_state((C,), torch.float64, "cpu")
    outs_j, outs_t, states_j, states_t = [], [], [], []
    for part in (x[:, :half], x[:, half:]):
        res_j = run(st_j, jnp.asarray(part))
        res_t = call(tp, st_t, torch.as_tensor(part))
        st_j, st_t = res_j[0], res_t[0]
        outs_j.append([np.asarray(v) for v in res_j[1:]])
        outs_t.append([v.numpy() for v in res_t[1:]])
        states_j.append(st_j)
        states_t.append(st_t)
    for k in range(len(outs_j[0])):
        ref = np.concatenate([o[k] for o in outs_j], axis=-1)
        got = np.concatenate([o[k] for o in outs_t], axis=-1)
        assert snr_db(ref, got) >= 200, k
    for sj, st in zip(states_j, states_t):
        _close(sj, st)
    one = call(tp, tp.init_state((C,), torch.float64, "cpu"),
               torch.as_tensor(x))
    y = np.concatenate([o[0] for o in outs_t], axis=-1)
    assert snr_db(one[1].numpy(), y) >= 250
    mid = convert.state_from_numpy(_tree_np(states_j[0]), device="cpu")
    res = call(tp, mid, torch.as_tensor(x[:, half:]))
    assert snr_db(outs_j[1][0], res[1].numpy()) >= 200
    g = (np.concatenate([o[1] for o in outs_t], axis=-1)
         if len(outs_t[0]) > 1 else None)
    return y, g, states_j, states_t


def _golden_blocks(fn, proc, x0, **kw):
    """Channel 0 through a golden in the same two blocks, its flat state
    carried."""
    half = x0.shape[-1] // 2
    r1 = fn(proc, x0[:half], **kw)
    r2 = fn(proc, x0[half:], state=r1[0], **kw)
    return [np.concatenate([a, b]) for a, b in zip(r1[1:], r2[1:])]


@needs_native
@pytest.mark.parametrize("fb_scale", [False, True],
                         ids=["plain", "ratio-scaled"])
def test_feedback_compressor(fb_scale):
    jc = JD.Compressor(SR, topology=JD.Topology.FEEDBACK,
                       feedback_ratio_scale=fb_scale, threshold_db=-20.0,
                       ratio=4.0, knee_db=6.0, attack_ms=3.0, release_ms=80.0,
                       makeup_gain_db=2.0)
    tc = convert.compressor_from_config(dataclasses.asdict(jc.core.cfg))
    for name in ("attack_coeff", "release_coeff", "fb_attack_coeff",
                 "fb_release_coeff", "makeup_gain_lin"):
        assert getattr(tc.core, name) == getattr(jc.core, name), name
    x = _x(1)
    y, g, _, st = _both(jc, tc, x, gain=True)
    assert set(st[-1]) == {"envelope", "prev_gain", "prev_abs"}
    y_gold, g_gold = _golden_blocks(
        lambda p, xb, state=None: native.dynamics_feedback(p.core, xb, state),
        jc, x[0])
    assert snr_db(y_gold, y[0]) > 120 and snr_db(g_gold, g[0]) > 120
    # float32 against JAX float32 (each rounds its own log2 and exp2)
    x32 = x.astype(np.float32)
    _, y_j, g_j = ref_jit(lambda s, v: jc.process(s, v, with_gain=True))(
        jc.init_state((C,), jnp.float32), jnp.asarray(x32))
    _, y_t, g_t = tc.process(tc.init_state((C,), torch.float32, "cpu"),
                             torch.as_tensor(x32), with_gain=True)
    assert snr_db(np.asarray(y_j), y_t.numpy()) >= 100
    assert snr_db(np.asarray(g_j), g_t.numpy()) >= 100


def test_feedback_plain_version_per_channel():
    """D1's plain version at C = 3, T = 2048, each channel from its own
    state, against the reference's scan; and its gradient through the
    plain loop against jax.grad."""
    core_j = JD.DynamicsCore(JD.DynamicsConfig(
        SR, topology=JD.Topology.FEEDBACK, threshold_db=-24.0, ratio=6.0,
        knee_db=0.0, attack_ms=1.0, release_ms=40.0))
    core_t = TD.DynamicsCore(TD.DynamicsConfig(
        SR, topology=TD.Topology.FEEDBACK, threshold_db=-24.0, ratio=6.0,
        knee_db=0.0, attack_ms=1.0, release_ms=40.0))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 2048)) * np.array([[0.02], [0.4], [1.5]])
    env0, abs0 = np.array([0.0, 0.3, 2.0]), np.array([0.1, 0.0, 1.0])
    st_j = {"envelope": jnp.asarray(env0), "prev_abs": jnp.asarray(abs0),
            "prev_gain": jnp.ones(3)}
    st_j, y_j, g_j = ref_jit(core_j.process)(st_j, jnp.asarray(x))
    y, g, env_f, abs_f = dynfb.dynamics_feedback_plain(
        torch.as_tensor(x), torch.as_tensor(env0), torch.as_tensor(abs0),
        core_t.feedback_params())
    assert snr_db(np.asarray(y_j), y.numpy()) >= 200
    assert snr_db(np.asarray(g_j), g.numpy()) >= 200
    assert snr_db(np.asarray(st_j["envelope"]), env_f.numpy()) >= 200
    assert snr_db(np.asarray(st_j["prev_abs"]), abs_f.numpy()) >= 200

    xs = x[:, :64]

    def loss_j(v):
        _, yv, _ = core_j.process(core_j.init_state((3,), jnp.float64), v)
        return jnp.sum(yv * yv)

    dx_j = ref_jit(jax.grad(loss_j))(jnp.asarray(xs))
    xt = torch.as_tensor(xs).requires_grad_(True)
    _, yt, _ = core_t.process(core_t.init_state((3,), torch.float64, "cpu"), xt)
    (yt * yt).sum().backward()
    assert snr_db(np.asarray(dx_j), xt.grad.numpy()) >= 200


@needs_native
def test_limiter():
    jp, tp = JD.Limiter(SR, threshold_db=-8.0, release_ms=40.0), \
        TD.Limiter(SR, threshold_db=-8.0, release_ms=40.0)
    x = _x(3)
    y, g, _, _ = _both(jp, tp, x, gain=True)
    y_gold, g_gold = _golden_blocks(
        lambda p, xb, state=None: native.dynamics_feedforward(p.core, xb, state),
        jp, x[0])
    assert snr_db(y_gold, y[0]) > 120 and snr_db(g_gold, g[0]) > 120


@needs_native
def test_expander():
    kw = dict(threshold_db=-30.0, ratio=3.0, knee_db=4.0, attack_ms=2.0,
              release_ms=40.0, detector_mode=JD.DetectorMode.RMS,
              rms_window_ms=5.0)
    jp = JD.Expander(SR, **kw)
    tp = TD.Expander(SR, **{**kw, "detector_mode": TD.DetectorMode.RMS})
    x = _x(4)
    y, g, _, _ = _both(jp, tp, x, gain=True)
    y_gold, g_gold = _golden_blocks(
        lambda p, xb, state=None: native.dynamics_expansion(p, xb, state), jp,
        x[0])
    assert snr_db(g_gold, g[0]) > 120
    assert snr_db(y_gold + 1e-30, y[0] + 1e-30) > 100


@needs_native
def test_gate_hold_counter_and_held_samples():
    kw = dict(threshold_db=-30.0, ratio=10.0, knee_db=3.0, attack_ms=0.2,
              hold_ms=4.0, release_ms=30.0, range_db=-60.0)
    jp, tp = JD.Gate(SR, **kw), TD.Gate(SR, **kw)
    x = _x(5)
    y, g, st_j, st_t = _both(jp, tp, x, gain=True)
    for a, b in zip(st_j, st_t):
        assert b["hold"].dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(a["hold"]), b["hold"].numpy())
    # the held samples: unity gain where the expansion gain was below 1
    run = ref_jit(lambda st, v: jp.process(st, v, with_gain=True))
    _, _, g_j = run(jp.init_state((C,), jnp.float64), jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(g_j) == 1.0, g == 1.0)
    st_gold, y_gold, g_gold = native.gate_hold(jp, x[0])
    assert snr_db(y_gold + 1e-30, y[0] + 1e-30) > 120
    np.testing.assert_array_equal(g_gold == 1.0, g[0] == 1.0)


def test_gate_hold_closed_form_equals_the_step():
    """`gate_hold` against the reference's per-sample step, on gains with
    exact ones, NaN, counters carried in above, at and below H, H = 0,
    T = 0 and T = 1."""
    rng = np.random.default_rng(6)

    def step_loop(g, h0, hold):
        out = g.copy()
        h = h0.copy()
        for n in range(g.shape[-1]):
            reset = g[:, n] >= 1.0
            held = ~reset & (h > 0)
            out[:, n] = np.where(held, 1.0, g[:, n])
            h = np.where(reset, hold, np.maximum(h - 1, 0))
        return out, h

    for t in (0, 1, 7, 300):
        g = rng.choice([0.2, 0.9999, 1.0, 1.3, np.nan], size=(5, t),
                       p=[0.5, 0.2, 0.1, 0.15, 0.05])
        h0 = np.array([0, 3, 40, 1, 12], np.int32)
        for hold in (0, 1, 25):
            ref, h_ref = step_loop(g, h0, hold)
            got, h_got = gate_hold(torch.as_tensor(g), torch.as_tensor(h0),
                                   hold)
            np.testing.assert_array_equal(got.numpy(), ref)
            np.testing.assert_array_equal(h_got.numpy(), h_ref)
            assert h_got.dtype == torch.int32


@needs_native
def test_lookahead_limiter():
    kw = dict(lookahead_ms=3.0, threshold_db=-6.0, release_ms=30.0)
    jp, tp = JD.LookaheadLimiter(SR, **kw), TD.LookaheadLimiter(SR, **kw)
    assert tp.delay == jp.delay
    x = _x(7)
    y, _, _, st = _both(jp, tp, x)
    assert set(st[-1]) == {"core", "delay"}
    (y_gold,) = _golden_blocks(
        lambda p, xb, state=None: native.lookahead(p, xb, state=state), jp,
        x[0])
    assert snr_db(y_gold + 1e-30, y[0] + 1e-30) > 120


@needs_native
@pytest.mark.parametrize("split,listen", [(True, False), (True, True),
                                          (False, False)],
                         ids=["split", "listen", "wideband"])
def test_deesser(split, listen):
    kw = dict(freq_hz=6000.0, q=1.5, threshold_db=-30.0, ratio=4.0,
              knee_db=3.0, attack_ms=0.5, release_ms=20.0, range_db=-24.0,
              split_band=split, listen=listen)
    jp, tp = JD.DeEsser(SR, **kw), TD.DeEsser(SR, **kw)
    t = np.arange(N) / SR
    x = (0.3 * np.sin(2 * np.pi * 400.0 * t)
         + 0.4 * np.sin(2 * np.pi * 7200.0 * t) * (t > 0.01)
         + 0.05 * np.random.default_rng(8).standard_normal((C, N)))
    y, _, _, _ = _both(jp, tp, x)
    (y_gold,) = _golden_blocks(
        lambda p, xb, state=None: native.deesser(p, xb, state), jp, x[0])
    assert snr_db(y_gold, y[0]) > 120


@needs_native
def test_transient_shaper():
    kw = dict(attack_amount=0.6, sustain_amount=-0.4, attack_ms=1.0,
              release_ms=80.0)
    jp, tp = JD.TransientShaper(SR, **kw), TD.TransientShaper(SR, **kw)
    x = _x(9)
    y, _, _, _ = _both(jp, tp, x)
    (y_gold,) = _golden_blocks(
        lambda p, xb, state=None: native.transient(p, xb, state), jp, x[0])
    assert snr_db(y_gold, y[0]) > 120


@needs_native
def test_multiband_compressor():
    cfg = [dict(threshold_db=-25.0, ratio=3.0, attack_ms=15.0),
           dict(threshold_db=-18.0, ratio=5.0, knee_db=2.0),
           dict(threshold_db=-30.0, ratio=2.0, makeup_gain_db=1.5)]
    jp = JD.MultibandCompressor([250.0, 3000.0], 4, SR,
                                configs=[JD.BandConfig(**c) for c in cfg])
    tp = TD.MultibandCompressor([250.0, 3000.0], 4, SR,
                                configs=[TD.BandConfig(**c) for c in cfg])
    x = _x(10)
    y, _, _, st = _both(jp, tp, x)
    assert len(st[-1]["xo"]) == 2 and len(st[-1]["bands"]) == 3
    (y_gold,) = _golden_blocks(
        lambda p, xb, state=None: native.multiband(p, xb, state), jp, x[0])
    assert snr_db(y_gold, y[0]) > 120


def test_zero_and_one_sample_blocks():
    """T = 0 returns an empty output and leaves every state as it was;
    T = 1 from a mid-stream state matches JAX."""
    procs = [
        (JD.Compressor(SR, topology=JD.Topology.FEEDBACK),
         TD.Compressor(SR, topology=TD.Topology.FEEDBACK)),
        (JD.Gate(SR, threshold_db=-10.0, hold_ms=1.0),
         TD.Gate(SR, threshold_db=-10.0, hold_ms=1.0)),
        (JD.LookaheadLimiter(SR), TD.LookaheadLimiter(SR)),
        (JD.TransientShaper(SR, attack_amount=0.5),
         TD.TransientShaper(SR, attack_amount=0.5)),
        (JD.Expander(SR), TD.Expander(SR)),
    ]
    x = _x(11, n=8)
    for jp, tp in procs:
        st_t, _ = tp.process(tp.init_state((C,), torch.float64, "cpu"),
                             torch.as_tensor(x[:, :4]))
        st0, y0 = tp.process(st_t, torch.zeros((C, 0), dtype=torch.float64))
        assert y0.shape == (C, 0)
        _close(jax.tree.map(lambda t: t.numpy(), st_t), st0, bar=np.inf)
        st_j = jax.tree.map(lambda t: jnp.asarray(t.numpy()), st_t)
        st1_j, y1_j = ref_jit(jp.process)(st_j, jnp.asarray(x[:, 4:5]))
        st1_t, y1_t = tp.process(st0, torch.as_tensor(x[:, 4:5]))
        assert snr_db(np.asarray(y1_j), y1_t.numpy()) >= 200
        _close(st1_j, st1_t)
