"""The port's compressor and envelope scan against the JAX package on the
CPU (the port's plain paths; the envelope kernel itself is held against
`envelope_scan_plain` on the card by chip_smoke.py).

Tolerance: >= 100 dB SNR against JAX float32 for outputs, gains and the
envelope trajectory — the bar the JAX package holds its own envelope
kernel to (tests/test_pallas.py) — and states equal to float32 roundoff.
"""

import tests.torch_port_setup  # noqa: F401  (first: one PyTorch thread)

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from algodsp_tpu.effects.dynamics import Compressor as JCompressor
from algodsp_tpu.effects.dynamics import compression_gain as j_gain
from algodsp_tpu.effects.dynamics import downward_expansion_gain as j_exp
from algodsp_tpu.effects.dynamics.core import DetectorMode as JMode
from algodsp_tpu.effects.dynamics.core import Topology as JTopology
from algodsp_tpu.ops.envscan import envelope_scan as j_envelope
from algodsp_tpu_torch import convert
from algodsp_tpu_torch.effects.dynamics import (
    Compressor, DetectorMode, Topology, block_metrics, compression_gain,
    downward_expansion_gain)
from algodsp_tpu_torch.ops.envscan import (
    ENV_MAX_SWEEPS, chunk_plan, envelope_scan, envelope_scan_plain)
from tests.conftest import snr_db
from tests.torch_port_setup import ref_jit

SR = 48000.0
C, N = 2, 1024

CONFIGS = {
    "peak": {},
    "rms": {"detector_mode": JMode.RMS, "rms_window_ms": 5.0},
    "sidechain": {"sidechain_low_cut_hz": 80.0, "sidechain_high_cut_hz": 6000.0},
    "hard_knee_makeup": {"knee_db": 0.0, "auto_makeup": True, "ratio": 8.0},
}


def _signal(seed=0):
    rng = np.random.default_rng(seed)
    env = np.linspace(0.05, 2.0, N)
    return (rng.standard_normal((C, N)) * env).astype(np.float32)


def _states_close(st_j, st_t):
    assert set(st_j) == set(st_t)
    for k in st_j:
        np.testing.assert_allclose(np.asarray(st_j[k]), st_t[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_compressor_matches_jax(name):
    jc = JCompressor(SR, **CONFIGS[name])
    tc = convert.compressor_from_config(dataclasses.asdict(jc.core.cfg))
    x = _signal()
    st_j, y_j, g_j = jc.process(jc.init_state((C,)), jnp.asarray(x), with_gain=True)
    st_t, y_t, g_t = tc.process(tc.init_state((C,), device="cpu"),
                                torch.from_numpy(x), with_gain=True)
    assert snr_db(np.asarray(y_j), y_t.numpy()) >= 100
    assert snr_db(np.asarray(g_j), g_t.numpy()) >= 100
    _states_close(st_j, st_t)


def test_compressor_streams_with_state():
    """Two half blocks threading the state equal the JAX stream, sidechain
    prefilters and RMS history included."""
    cfg = {"detector_mode": JMode.RMS, "rms_window_ms": 2.0,
           "sidechain_low_cut_hz": 80.0}
    jc = JCompressor(SR, **cfg)
    tc = convert.compressor_from_config(dataclasses.asdict(jc.core.cfg))
    x = _signal(seed=1)
    st_j = jc.init_state((C,))
    st_t = tc.init_state((C,), device="cpu")
    jp = ref_jit(jc.process)
    for half in (x[:, :N // 2], x[:, N // 2:]):
        st_j, y_j = jp(st_j, jnp.asarray(half))
        st_t, y_t = tc.process(st_t, torch.from_numpy(half))
        assert snr_db(np.asarray(y_j), y_t.numpy()) >= 100
    _states_close(st_j, st_t)
    state = convert.state_from_numpy({k: np.asarray(v) for k, v in st_j.items()},
                                     device="cpu")
    _, y_a = tc.process(state, torch.from_numpy(x))
    _, y_b = jp(st_j, jnp.asarray(x))
    assert snr_db(np.asarray(y_b), y_a.numpy()) >= 100


def test_envelope_plain_per_channel_matches_jax():
    rng = np.random.default_rng(2)
    x = np.abs(rng.standard_normal((3, 700))).astype(np.float32)
    env0 = rng.uniform(0, 1, 3).astype(np.float32)
    att = np.array([0.3, 0.05, 0.8], np.float32)
    rel = np.array([0.01, 0.2, 0.002], np.float32)
    ef_j, tr_j = j_envelope(jnp.asarray(x), jnp.asarray(env0), jnp.asarray(att),
                            jnp.asarray(rel))
    ef_t, tr_t = envelope_scan(torch.from_numpy(x), torch.from_numpy(env0),
                               torch.from_numpy(att), torch.from_numpy(rel))
    assert snr_db(np.asarray(tr_j), tr_t.numpy()) >= 100
    np.testing.assert_allclose(ef_t.numpy(), np.asarray(ef_j), rtol=1e-6)
    # env_final is the state after the last real sample
    assert torch.equal(ef_t, tr_t[:, -1])
    # scalar ballistics broadcast like the per-channel form
    ef_s, tr_s = envelope_scan_plain(torch.from_numpy(x), torch.from_numpy(env0),
                                     torch.tensor(0.3), torch.tensor(0.01))
    _, tr_js = j_envelope(jnp.asarray(x), jnp.asarray(env0), 0.3, 0.01)
    assert snr_db(np.asarray(tr_js), tr_s.numpy()) >= 100


def _hard_envelope_cases(t, rng):
    """Inputs that stress a time-split envelope, one per channel, with
    per-channel (env0, attack, release): a slow release with x hovering
    at the envelope's level, peak hold under chunk maxima that fall
    across the signal, all ties, a long silence then noise, and a NaN."""
    n = np.arange(t)
    hover = 0.5 + 0.05 * np.sin(2 * np.pi * n / 480.0) + 1e-3 * rng.standard_normal(t)
    steps = np.repeat(np.linspace(1.0, 0.05, -(-t // 47)), 47)[:t]
    hold = np.abs(rng.standard_normal(t)) * steps
    silent = np.where(n < t * 5 // 6, 0.0, np.abs(rng.standard_normal(t)))
    nan = np.abs(rng.standard_normal(t))
    nan[t // 2] = np.nan
    x = np.stack([hover, hold, np.full(t, 0.25), silent, nan])
    env0 = np.array([0.5, 0.0, 0.25, 0.0, 0.0])
    att = np.array([0.3, 1.0, 0.1, 0.2, 0.1])
    rel = np.array([1e-5, 0.0, 0.01, 1e-3, 0.01])
    return x, env0, att, rel


def _assert_trajectories_close(ref, test, bar_db=100.0):
    """Same NaN positions, and >= bar_db SNR over the finite samples."""
    ref, test = np.asarray(ref, np.float64), np.asarray(test, np.float64)
    np.testing.assert_array_equal(np.isnan(ref), np.isnan(test))
    fin = ~np.isnan(ref)
    assert snr_db(ref[fin], test[fin]) >= bar_db


def test_envelope_hard_inputs_match_jax():
    """The port's envelope (its plain path on the CPU) against the JAX
    package's `lax.scan` envelope on the inputs that stress the
    kernel's selection fixpoint, float32 and float64."""
    x, env0, att, rel = _hard_envelope_cases(4000, np.random.default_rng(4))
    for dtype in (np.float32, np.float64):
        args = [a.astype(dtype) for a in (x, env0, att, rel)]
        ef_j, tr_j = j_envelope(*map(jnp.asarray, args))
        ef_t, tr_t = envelope_scan(*map(torch.from_numpy, args))
        assert tr_t.dtype == torch.from_numpy(args[0]).dtype
        _assert_trajectories_close(tr_j, tr_t.numpy())
        np.testing.assert_allclose(ef_t.numpy(), np.asarray(ef_j), rtol=1e-6)


def _fixpoint_model(x, env0, att, rel, itemsize):
    """numpy model of csrc/envelope.cu on one channel, with the
    wrapper's own chunk plan: per segment, a seed pass (the true carry
    for chunk 0, zero for the others), then sweeps (exclusive scan of the
    chunks' float64 affine summaries -> carries -> re-run, re-deriving
    the selection) until no selection flips, the cap, or the exact walk.
    The sweeps also stop where every chunk's end state meets the next
    chunk's carry within 4 ulps (flips on exact ties). Returns
    (trajectory, sweeps per segment, exact walks)."""
    dt = np.float32 if itemsize == 4 else np.float64
    x = x.astype(dt)
    a, r = dt(att), dt(rel)
    seg, L, threads = chunk_plan(x.size, itemsize)
    out = np.empty_like(x)
    carry_seg, sweeps, walks = dt(env0), [], 0

    def run(xs, pad, carry):        # xs (chunks, L); pad marks the tail
        env = carry.copy()
        bits = np.zeros(xs.shape, bool)
        A, W = np.ones(len(env)), np.zeros(len(env))
        traj = np.empty_like(xs)
        for i in range(xs.shape[1]):
            v = xs[:, i]
            real = ~pad[:, i]
            up = v > env
            coef = np.where(up, a, r).astype(dt)
            env = np.where(real, (env + coef * (v - env)).astype(dt), env)
            bits[:, i] = up & real
            m = 1.0 - coef.astype(np.float64)
            W = np.where(real, m * W + coef * v.astype(np.float64), W)
            A = np.where(real, A * m, A)
            traj[:, i] = env
        return traj, bits, A, W

    for base in range(0, x.size, seg):
        xs = x[base:base + seg]
        chunks = -(-xs.size // L)
        assert chunks <= threads
        pad = np.arange(chunks * L).reshape(chunks, L) >= xs.size
        xs = np.concatenate([xs, np.zeros(chunks * L - xs.size, dt)]).reshape(chunks, L)
        carry = np.zeros(chunks, dt)
        carry[0] = carry_seg
        n_sweeps, walk = 0, False
        if chunks > 1:
            _, bits, A, W = run(xs, pad, carry)
            while True:
                if n_sweeps == ENV_MAX_SWEEPS:
                    walk = True
                    break
                c = np.float64(carry_seg)
                for j in range(chunks):
                    carry[j] = c
                    c = A[j] * c + W[j]
                n_sweeps += 1
                traj, new_bits, A, W = run(xs, pad, carry)
                flipped = np.any(new_bits != bits)
                bits = new_bits
                # or every chunk's end meets the next carry within 4 ulps
                e, c = traj[:-1, -1], carry[1:]
                meets = ((e == c) | (np.isnan(e) & np.isnan(c))
                         | (np.abs(e - c) <= 4 * np.finfo(dt).eps
                            * np.maximum(np.abs(e), np.abs(c))))
                if not flipped or meets.all():
                    break
        if walk:
            walks += 1
            _, traj = envelope_scan_plain(*map(torch.as_tensor, (
                xs.reshape(-1), carry_seg, a, r)))
            traj = traj.numpy()
        else:
            traj = run(xs, pad, carry)[0].reshape(-1)
        n = min(seg, x.size - base)
        out[base:base + n] = traj[:n]
        carry_seg = out[base + n - 1]
        sweeps.append(n_sweeps)
    return out, sweeps, walks


def test_envelope_fixpoint_model_converges():
    """Rehearsal of the K4 kernel's algorithm before any chip run: the
    numpy model with the wrapper's chunk plan meets the 100 dB bar
    against the sequential float64 scan on the hard inputs, converging
    within the cap, at the flagship length (1024 chunks of 47 samples),
    over two float64 segments, and at short lengths."""
    x, env0, att, rel = _hard_envelope_cases(48128, np.random.default_rng(5))
    _, ref = envelope_scan_plain(torch.from_numpy(x), torch.from_numpy(env0),
                                 torch.from_numpy(att), torch.from_numpy(rel))
    # a prefix of the input has the prefix of the trajectory
    for t, itemsize in ((48128, 4), (30000, 8), (1000, 4), (47, 4)):
        for ch in range(x.shape[0]):
            traj, sweeps, walks = _fixpoint_model(x[ch, :t], env0[ch], att[ch],
                                                  rel[ch], itemsize)
            assert walks == 0 and max(sweeps) <= ENV_MAX_SWEEPS, (t, ch, sweeps)
            _assert_trajectories_close(ref[ch, :t].numpy(), traj)


def test_gain_computers_match_jax():
    level = np.concatenate([[0.0, -1.0], np.logspace(-4, 1, 200)]).astype(np.float32)
    for knee in (0.0, 6.0):
        kw = (np.log2(10) / 20 * -20.0, knee, np.log2(10) / 20 * knee,
              (1.0 / (np.log2(10) / 20 * knee)) if knee else 0.0)
        g_j = np.asarray(j_gain(jnp.asarray(level), *kw, 0.75))
        g_t = compression_gain(torch.from_numpy(level), *kw, 0.75).numpy()
        np.testing.assert_allclose(g_t, g_j, rtol=1e-6)
        e_j = np.asarray(j_exp(jnp.asarray(level), *kw, 2.0, 1e-3))
        e_t = downward_expansion_gain(torch.from_numpy(level), *kw, 2.0, 1e-3).numpy()
        np.testing.assert_allclose(e_t, e_j, rtol=1e-6)


def test_metrics_feedback_and_output_level():
    tc = Compressor(SR)
    x = torch.from_numpy(_signal(seed=3))
    st, y, g = tc.process(tc.init_state((C,), device="cpu"), x, with_gain=True)
    m = block_metrics(x, y, g)
    assert m.input_peak == float(x.abs().max())
    assert m.output_peak <= m.input_peak and 0.0 < m.gain_reduction <= 1.0
    jc = JCompressor(SR)
    mags = np.array([0.01, 0.1, 1.0, 4.0], np.float32)
    np.testing.assert_allclose(tc.calculate_output_level(mags).numpy(),
                               np.asarray(jc.calculate_output_level(mags)), rtol=1e-6)
    # the feedback topology is ported (D1): its state carries the
    # previous gain and output magnitude, and it matches the JAX scan
    fb = Compressor(SR, topology=Topology.FEEDBACK)
    jfb = JCompressor(SR, topology=JTopology.FEEDBACK)
    st_fb = fb.init_state((C,), device="cpu")
    assert set(st_fb) == set(jfb.init_state((C,))) == {
        "envelope", "prev_gain", "prev_abs"}
    _, y_fb = fb.process(st_fb, x)
    _, y_jfb = jfb.process(jfb.init_state((C,)), jnp.asarray(x.numpy()))
    assert snr_db(np.asarray(y_jfb), y_fb.numpy()) >= 100
    assert Compressor(SR, detector_mode=DetectorMode.RMS).core.rms_window == 1440
