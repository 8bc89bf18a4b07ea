"""The port's delay feedback and reverbs against the JAX package on the CPU:
`ops/ring.py`, `Delay`, `Freeverb` and `FDNReverb` (the port through the
plain versions of R1-R3, JAX through its XLA paths, jitted). The NumPy
models of the kernels' walks are in `test_torch_feedback_walks.py`.

Tolerances: float64 >= 200 dB with states within 1e-12; float32 against
JAX float64, no more than 6 dB below JAX float32's own SNR against JAX
float64 (the reference's float32 class).
"""

import tests.torch_port_setup  # noqa: F401  (first: one PyTorch thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algodsp_tpu.effects.delay_effect import Delay as JDelay
from algodsp_tpu.effects.reverb import FDNReverb as JFDN
from algodsp_tpu.effects.reverb import Freeverb as JFreeverb
from algodsp_tpu.ops import ring as jring
from algodsp_tpu_torch.effects.delay_effect import Delay
from algodsp_tpu_torch.effects.reverb import FDNReverb, Freeverb
from algodsp_tpu_torch.ops import ring
from tests.conftest import snr_db
from tests.torch_port_setup import ref_jit

SR = 48000.0
C = 2


def _x(n, seed=0, dtype="float64"):
    return np.random.default_rng(seed).standard_normal((C, n)).astype(dtype)


def _jstate(st):
    return jax.tree_util.tree_map(np.asarray, st)


def _state_err(sj, st):
    """Largest |difference| over a state's float arrays; the integers equal."""
    errs = []
    for k, a in sj.items():
        b = st[k]
        pairs = zip(a, b) if isinstance(a, list) else [(a, b)]
        for u, v in pairs:
            u, v = np.asarray(u), v.detach().numpy()
            if np.issubdtype(u.dtype, np.integer):
                assert int(u) == int(v), k
            else:
                errs.append(float(np.max(np.abs(u - v))))
    return max(errs)


def _stream(proc, st, x, cuts, lib):
    ys = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        st, y = proc(st, x[..., a:b])
        ys.append(np.asarray(y) if lib == "jax" else y.numpy())
    return st, np.concatenate(ys, axis=-1)


def _run_both(make_j, make_t, x, cuts, dtype, jproc=None, tproc=None):
    """Stream x through both packages in the same ragged calls."""
    fj, ft = make_j(), make_t()
    jp = ref_jit(jproc(fj) if jproc else fj.process)
    tp = tproc(ft) if tproc else ft.process
    sj, yj = _stream(jp, fj.init_state((C,), jnp.dtype(dtype)),
                     jnp.asarray(x), cuts, "jax")
    st, yt = _stream(tp, ft.init_state((C,), getattr(torch, dtype), "cpu"),
                     torch.as_tensor(x), cuts, "torch")
    return _jstate(sj), yj, st, yt


def _check(make_j, make_t, n, cuts, seed, jproc=None, tproc=None):
    """float64 >= 200 dB and states within 1e-12; float32 within 6 dB of
    JAX float32's own SNR against JAX float64."""
    x = _x(n, seed)
    sj, yj, st, yt = _run_both(make_j, make_t, x, cuts, "float64", jproc, tproc)
    assert snr_db(yj, yt) >= 200
    assert _state_err(sj, st) <= 1e-12
    x32 = x.astype(np.float32)
    _, yj32, st32, yt32 = _run_both(make_j, make_t, x32, cuts, "float32", jproc,
                                    tproc)
    assert yt32.dtype == np.float32
    assert snr_db(yj, yt32) >= snr_db(yj, yj32) - 6.0


def test_ring_round_trips():
    buf = torch.arange(10.0).reshape(1, 10).repeat(2, 1)
    for step in (0, 3, 13, torch.tensor(27, dtype=torch.int32)):
        lin = ring.ring_to_linear(buf, step)
        np.testing.assert_array_equal(
            lin.numpy(), np.asarray(jring.ring_to_linear(jnp.asarray(buf.numpy()),
                                                         int(step))))
        np.testing.assert_array_equal(ring.linear_to_ring(lin, step).numpy(),
                                      buf.numpy())
        np.testing.assert_array_equal(
            ring.linear_to_ring(buf, step).numpy(),
            np.asarray(jring.linear_to_ring(jnp.asarray(buf.numpy()), int(step))))


# the Delay's three tiers: the aligned ring (whole blocks from an aligned
# cursor), the linear extension (unaligned cursor or a ragged tail, with
# its rotation back to cursor 0) and the per-sample scan (lags under 130,
# calls under one block)
@pytest.mark.parametrize("tier", ["aligned", "linear", "scan"])
def test_delay_tiers_match_jax(tier):
    kw = dict(delay_seconds=0.02, feedback=0.5, mix=0.4)
    cuts = {"aligned": [0, 512, 1024],
            "linear": [0, 300, 1000, 1300],
            "scan": [0, 100, 700, 800]}[tier]
    if tier == "scan":
        kw["delay_seconds"] = 0.002            # 96 samples
    _check(lambda: JDelay(SR, **kw), lambda: Delay(SR, **kw), cuts[-1], cuts, 1)


def test_delay_retarget_matches_jax():
    """The smoothed lag trajectory toward a new target mid-stream, its
    clamp at the ring's end, and the three tiers it passes through."""
    def proc(fx):
        def run(st, x):
            st, ya = fx.process(st, x[..., :700], target_delay_samples=3000.0)
            st, yb = fx.process(st, x[..., 700:1024],
                                 target_delay_samples=1e6)   # clamped
            st, yc = fx.process(st, x[..., 1024:], target_delay_samples=60.0)
            cat = jnp.concatenate if isinstance(ya, jax.Array) else torch.cat
            return st, cat([ya, yb, yc], -1)
        return run
    kw = dict(delay_seconds=0.01, feedback=0.6, mix=0.5, smooth_ms=5.0)
    _check(lambda: JDelay(SR, **kw), lambda: Delay(SR, **kw), 2048,
           [0, 2048], 2, jproc=proc, tproc=proc)
    dl = Delay(SR, **kw)
    cur = dl.trajectory(torch.tensor(480.0, dtype=torch.float64), 5, 3000.0)
    k = np.arange(5)
    want = 3000.0 + (480.0 - 3000.0) * (1.0 - dl.smooth_coeff) ** (k + 1.0)
    np.testing.assert_allclose(cur.numpy(), want, rtol=1e-15)


def test_freeverb_process_matches_jax():
    kw = dict(wet=0.3, dry=0.7, room_size=0.8, damp=0.4)
    _check(lambda: JFreeverb(**kw), lambda: Freeverb(**kw), 922,
           [0, 461, 922], 3)


def test_freeverb_process_blocks_and_scan_match_jax():
    _check(JFreeverb, Freeverb, 1024, [0, 1024], 4,
           jproc=lambda fx: lambda st, x: fx.process_blocks(st, x, block_size=256),
           tproc=lambda fx: lambda st, x: fx.process_blocks(st, x, block_size=256))
    _check(JFreeverb, Freeverb, 600, [0, 300, 600], 5,
           jproc=lambda fx: fx.process_scan, tproc=lambda fx: fx.process_scan)


def test_fdn_process_matches_jax():
    kw = dict(wet=0.4, dry=0.6, rt60_seconds=1.2, damp=0.25,
              mod_depth_seconds=0.001, mod_rate_hz=0.3)
    _check(lambda: JFDN(SR, **kw), lambda: FDNReverb(SR, **kw), 2200,
           [0, 1100, 2200], 6)


def test_fdn_process_blocks_and_scan_match_jax():
    _check(lambda: JFDN(SR), lambda: FDNReverb(SR), 2048, [0, 2048], 7,
           jproc=lambda fx: fx.process_blocks, tproc=lambda fx: fx.process_blocks)
    _check(lambda: JFDN(SR), lambda: FDNReverb(SR), 500, [0, 250, 500], 8,
           jproc=lambda fx: fx.process_scan, tproc=lambda fx: fx.process_scan)


@pytest.mark.parametrize("effect", ["delay", "freeverb", "fdn"])
def test_state_across_ragged_calls_equals_one_call(effect):
    """The port streamed in ragged calls against the port in one call
    (and JAX in one call), float64: the outputs >= 200 dB, the states
    within 1e-12. The Delay's cursor depends on the calls (its linear
    extension returns with the cursor at 0), so its ring is compared in
    shift-register layout, oldest sample first."""
    make_t, make_j, n = {
        "delay": (lambda: Delay(SR, delay_seconds=0.01),
                  lambda: JDelay(SR, delay_seconds=0.01), 2000),
        "freeverb": (Freeverb, JFreeverb, 1800),
        "fdn": (lambda: FDNReverb(SR), lambda: JFDN(SR), 2300)}[effect]
    x = _x(n, 9)
    ft = make_t()
    st1, y1 = ft.process(ft.init_state((C,), torch.float64, "cpu"),
                         torch.as_tensor(x))
    st2, y2 = _stream(ft.process, ft.init_state((C,), torch.float64, "cpu"),
                      torch.as_tensor(x), [0, 1, 130, 611, 1024, 1500, n], "torch")
    assert snr_db(y1.numpy(), y2) >= 200
    fj = make_j()
    sj, yj = ref_jit(fj.process)(fj.init_state((C,), jnp.float64), jnp.asarray(x))
    assert snr_db(np.asarray(yj), y2) >= 200
    sj = _jstate(sj)
    st1 = {k: (list(map(np.asarray, v)) if isinstance(v, list) else np.asarray(v))
           for k, v in st1.items()}
    if effect == "delay":
        lin = lambda st: {"hist": np.asarray(ring.ring_to_linear(
            torch.tensor(np.array(st["buf"])), int(st["write"]))),
            "current": np.asarray(st["current"])}
        sj, st1 = lin(sj), lin(st1)
        st2 = {k: torch.as_tensor(v) for k, v in lin(st2).items()}
    assert _state_err(sj, st2) <= 1e-12
    assert _state_err(st1, st2) <= 1e-12
