"""The port's Moog gradient (`MoogLadderFn` and `MoogZDFFn` under
`MoogFilter.process`; on the CPU their backward runs the plain reverse
sweeps, which the adjoint kernels of csrc/moog.cu repeat formula for
formula) against jitted `jax.grad` of a loss on the JAX package's
`MoogFilter.process`, which runs `_run_scan` on the CPU: the function the
reference's custom VJP (`_kernel_chunk_diff`) differentiates. The same
numpy inputs from a seed go to both; JAX runs in float64.

Tolerances (SNR of a gradient against the reference's):
- float64 >= 200 dB: both sides differentiate the same float64 scan, and
  only the tanh implementations and the order of sums separate them
  (~300 dB measured);
- float32 >= 80 dB against the float64 reference, tests/test_diff.py's
  bar for float32 gradients (~120-140 dB measured);
- the plain reverse sweeps against torch.autograd through the plain
  forward, float64 >= 250 dB (~300 dB measured) on the whole input
  gradient (dx and dstate8 together): the same arithmetic in another
  order (no state sits on the +-32 clip there, where jnp.clip and
  torch.clamp differ). At T = 1 and os 4, dx alone is a sum that cancels
  to ~1e-4 of its terms, so its own SNR reads ~240 dB;
- exact where the reference is exact: 0 for Huovilainen's tanh rows and
  the classic family's prev row, the ZDF tanh rows equal to their
  cotangent. ZDF's d(prev_out) is the sensitivity to the Newton starting
  guess, ~1e-30 in float64 here: held to |error| <= 1e-12 (float64) and
  1e-6 (float32) times max |dx|.
"""

import tests.torch_port_setup  # noqa: F401  (first: one PyTorch thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algodsp_tpu.filters.moog import MoogFilter as JMoog, MoogVariant as JV
from algodsp_tpu_torch.filters.moog import MoogFilter as TMoog, MoogVariant as TV
from algodsp_tpu_torch.ops import moog as moog_ops
from tests.torch_port_setup import ref_jit

SR = 48000.0
C = 3
STEPS = 64               # ladder steps a channel (T * os)
SNR_BAR = {"float64": 200.0, "float32": 80.0}
PREV_BAR = {"float64": 1e-12, "float32": 1e-6}
KEYS = ("stage", "tanh_last", "prev_out")
CLASSIC = ("classic", "classic_lightweight", "improved_classic",
           "improved_classic_lightweight")


def snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    err = ref - np.asarray(test, np.float64)
    p_err = float(np.sum(err * err))
    return np.inf if p_err == 0 else 10 * np.log10(np.sum(ref * ref) / p_err)


def _pair(variant, **kw):
    return (JMoog(SR, variant=JV(variant), **kw),
            TMoog(SR, variant=TV(variant), **kw))


def _inputs(rng, c, t):
    """x, a state with every row nonzero (Huovilainen's tanh rows are not
    tanh(ds s)), and the loss weights of y and of the final state."""
    x = 0.5 * rng.standard_normal((c, t))
    st = {"stage": 0.2 * rng.standard_normal((c, 4)),
          "tanh_last": 0.2 * rng.standard_normal((c, 3)),
          "prev_out": 0.2 * rng.standard_normal(c)}
    w = rng.standard_normal((c, t))
    ws = {k: rng.standard_normal(v.shape) for k, v in st.items()}
    return x, st, w, ws


def _jax_grads(jm, x, st, w, ws):
    """d loss / d(state, x) through the jitted JAX scan in float64, loss =
    sum(y w) + sum(final state * ws)."""
    def loss(state, xv, wy, wst):
        state, y = jm.process(state, xv)
        return jnp.sum(y * wy) + sum(jnp.sum(state[k] * wst[k]) for k in KEYS)

    as_j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    gs, gx = ref_jit(jax.grad(loss, argnums=(0, 1)))(
        as_j(st), jnp.asarray(x), jnp.asarray(w), as_j(ws))
    return {k: np.asarray(v) for k, v in gs.items()}, np.asarray(gx)


def _port_grads(tm, x, st, w, ws, dtype, cuts=None):
    """The same through the port on CPU tensors of `dtype`, the signal
    streamed in blocks cut at `cuts` with the state carried."""
    xt = torch.tensor(x, dtype=dtype, requires_grad=True)
    st0 = {k: torch.tensor(v, dtype=dtype, requires_grad=True)
           for k, v in st.items()}
    state, ys = st0, []
    bounds = [0] + list(cuts or []) + [x.shape[-1]]
    for a, b in zip(bounds[:-1], bounds[1:]):
        state, y = tm.process(state, xt[..., a:b])
        ys.append(y)
    y = torch.cat(ys, -1)
    loss = torch.sum(y * torch.tensor(w, dtype=dtype)) + sum(
        torch.sum(state[k] * torch.tensor(ws[k], dtype=dtype)) for k in KEYS)
    loss.backward()
    return {k: v.grad.numpy() for k, v in st0.items()}, xt.grad.numpy()


def _hold(variant, ref, port, dtype):
    """Hold the port's (state grads, dx) to the reference's at the bars of
    the module docstring, exact rows included."""
    (gs_j, gx_j), (gs_t, gx_t) = ref, port
    bar = SNR_BAR[dtype]
    assert snr_db(gx_j, gx_t) >= bar, (variant, dtype, "dx")
    assert snr_db(gs_j["stage"], gs_t["stage"]) >= bar, (variant, dtype)
    if variant == "huovilainen":
        assert not np.any(gs_j["tanh_last"]) and not np.any(gs_t["tanh_last"])
    elif variant == "zdf":
        assert np.array_equal(gs_t["tanh_last"],
                              gs_j["tanh_last"].astype(dtype))
    else:
        assert snr_db(gs_j["tanh_last"], gs_t["tanh_last"]) >= bar, variant
    if variant in CLASSIC:
        assert not np.any(gs_j["prev_out"]) and not np.any(gs_t["prev_out"])
    elif variant == "zdf":
        err = np.max(np.abs(gs_t["prev_out"] - gs_j["prev_out"]))
        assert err <= PREV_BAR[dtype] * np.max(np.abs(gx_j)), (dtype, err)
    else:
        assert snr_db(gs_j["prev_out"], gs_t["prev_out"]) >= bar, dtype


@pytest.mark.parametrize("oversampling", [1, 4])
@pytest.mark.parametrize("variant", [v.value for v in JV])
def test_process_grad_matches_jax(variant, oversampling):
    """x and every state row, all six variants at os 1 and 4 (ZDF with 1
    and 3 Newton iterations; 8 below, against autograd: JAX takes ~5 s
    to compile it), resonance 2, float64 and float32, in one call and
    streamed in four ragged blocks with the state carried (the gradient
    crosses each carry), against one JAX call over the whole signal."""
    rng = np.random.default_rng([v.value for v in JV].index(variant)
                                + 10 * oversampling)
    jm, tm = _pair(variant, cutoff_hz=1500.0, resonance=2.0, drive=2.0,
                   thermal_voltage=0.8, oversampling=oversampling,
                   newton_iters=1 if oversampling == 1 else 3)
    t = STEPS // oversampling
    x, st, w, ws = _inputs(rng, C, t)
    ref = _jax_grads(jm, x, st, w, ws)
    for dtype in ("float64", "float32"):
        for cuts in (None, [t // 8, t // 3, t // 3 + 1]):
            _hold(variant, ref, _port_grads(tm, x, st, w, ws,
                                            getattr(torch, dtype), cuts),
                  dtype)


def _autograd_vs_sweep(fwd, adj, x, st8, gy, gst):
    """SNR of the sweep's (dx, dstate8) against autograd's, together."""
    xa = x.clone().requires_grad_()
    sa = st8.clone().requires_grad_()
    s_out, y = fwd(xa, sa)
    (torch.sum(y * gy) + torch.sum(s_out * gst)).backward()
    dx, dst = adj(x, st8, gy, gst)
    return snr_db(torch.cat([xa.grad.flatten(), sa.grad.flatten()]),
                  torch.cat([dx.flatten(), dst.flatten()]))


@pytest.mark.parametrize("kernel", ["moog_ladder", "moog_zdf"])
def test_plain_sweeps_match_autograd(kernel):
    """The explicit reverse sweeps against torch.autograd through
    `moog_*_plain`, float64: every ladder mode, ZDF with 1 and 8 Newton
    iterations, os 1, 2 and 4, C = 3, and T = 1."""
    rng = np.random.default_rng(31)
    if kernel == "moog_zdf":
        p = TMoog(SR, variant=TV.ZDF, cutoff_hz=1500.0, resonance=2.0,
                  drive=2.0).kernel_params()
        runs = [dict(newton_iters=n) for n in (1, 8)]
        fwd_fn, adj_fn = moog_ops.moog_zdf_plain, moog_ops.moog_zdf_adjoint_plain
    else:
        p = TMoog(SR, cutoff_hz=1500.0, resonance=2.0, drive=2.0,
                  thermal_voltage=0.8).kernel_params()
        runs = [dict(fast_tanh=f, huovilainen=h)
                for f, h in ((False, False), (True, False), (False, True))]
        fwd_fn, adj_fn = (moog_ops.moog_ladder_plain,
                          moog_ops.moog_ladder_adjoint_plain)
    for kw in runs:
        for c, t, os in ((C, 30, 1), (C, 15, 2), (2, 1, 1), (2, 1, 4)):
            x = torch.tensor(0.5 * rng.standard_normal((c, t)))
            st8 = torch.tensor(0.2 * rng.standard_normal((8, c)))
            gy = torch.tensor(rng.standard_normal((c, t)))
            gst = torch.tensor(rng.standard_normal((8, c)))
            snr = _autograd_vs_sweep(
                lambda a, b: fwd_fn(a, b, p, os=os, **kw),
                lambda a, b, g, h: adj_fn(a, b, p, g, h, os=os, **kw),
                x, st8, gy, gst)
            assert snr >= 250.0, (kw, c, t, os, snr)


def test_state_clip_grad_matches_jax():
    """test_torch_moog.py's clip case (DC of 100 past the +-32 clip):
    the gradient through a stage the clip cut is 0, and half on the bound,
    as jnp.clip's; float64, where the two trajectories meet the bound at
    the same steps."""
    rng = np.random.default_rng(4)
    jm, tm = _pair("classic", cutoff_hz=8000.0, resonance=0.5, drive=1.0,
                   thermal_voltage=20.0)
    x = 100.0 + rng.standard_normal((2, 200))
    st = {"stage": np.zeros((2, 4)), "tanh_last": np.zeros((2, 3)),
          "prev_out": np.zeros(2)}
    w = rng.standard_normal(x.shape)
    ws = {k: rng.standard_normal(v.shape) for k, v in st.items()}
    gs_j, gx_j = _jax_grads(jm, x, st, w, ws)
    gs_t, gx_t = _port_grads(tm, x, st, w, ws, torch.float64)
    cut = gx_j == 0
    assert cut.sum() > 100 and np.array_equal(gx_t == 0, cut)
    assert snr_db(gx_j, gx_t) >= 200.0
    for k in ("stage", "tanh_last"):
        assert snr_db(gs_j[k], gs_t[k]) >= 200.0, k
    assert not np.any(gs_t["prev_out"])


def test_functions_take_a_missing_cotangent():
    """`MoogLadderFn` / `MoogZDFFn` with only y or only the new state in
    the loss: autograd hands the other cotangent in as zeros, and the
    gradients equal the plain sweeps' with that cotangent 0, bit for
    bit."""
    rng = np.random.default_rng(6)
    x = torch.tensor(0.5 * rng.standard_normal((C, 30)))
    st8 = torch.tensor(0.2 * rng.standard_normal((8, C)))
    gy = torch.tensor(rng.standard_normal((C, 30)))
    gst = torch.tensor(rng.standard_normal((8, C)))
    p = TMoog(SR, cutoff_hz=1500.0, resonance=2.0).kernel_params()
    calls = [
        (lambda a, b: moog_ops.moog_ladder(a, b, p, huovilainen=True, os=2),
         lambda g, h: moog_ops.moog_ladder_adjoint_plain(
             x, st8, p, g, h, fast_tanh=False, huovilainen=True, os=2)),
        (lambda a, b: moog_ops.moog_zdf(a, b, p, newton_iters=3),
         lambda g, h: moog_ops.moog_zdf_adjoint_plain(
             x, st8, p, g, h, newton_iters=3))]
    for fn, sweep in calls:
        for use_y in (True, False):
            xa = x.clone().requires_grad_()
            sa = st8.clone().requires_grad_()
            s_out, y = fn(xa, sa)
            loss = torch.sum(y * gy) if use_y else torch.sum(s_out * gst)
            dx, dst = torch.autograd.grad(loss, (xa, sa))
            rx, rst = sweep(gy if use_y else torch.zeros_like(gy),
                            torch.zeros_like(gst) if use_y else gst)
            assert torch.equal(dx, rx) and torch.equal(dst, rst), use_y


def test_adjoint_wrappers_and_plan():
    """On the CPU the adjoint wrappers are the plain sweeps, and their
    walk's final state is the forward's bit for bit; the kernels' segment
    plan keeps shared memory under 48 KB for every record they take; bad
    arguments raise."""
    rng = np.random.default_rng(7)
    x = torch.tensor(0.5 * rng.standard_normal((2, 25)))
    st8 = torch.tensor(0.2 * rng.standard_normal((8, 2)))
    gy, gst = torch.ones_like(x), torch.ones_like(st8)
    p = TMoog(SR, cutoff_hz=1500.0, resonance=2.0).kernel_params()
    s_f, _ = moog_ops.moog_ladder_plain(x, st8, p, fast_tanh=True,
                                        huovilainen=False, os=3)
    dx, dst, s_a = moog_ops.moog_ladder_adjoint(
        x, st8, p, gy, gst, fast_tanh=True, os=3, return_state=True)
    assert torch.equal(s_a, s_f) and dx.shape == x.shape
    s_f, _ = moog_ops.moog_zdf_plain(x, st8, p, newton_iters=2)
    s_a = moog_ops.moog_zdf_adjoint(x, st8, p, gy, gst, newton_iters=2,
                                    return_state=True)[2]
    assert torch.equal(s_a, s_f)
    records = [moog_ops.LADDER_RECORD] + [
        moog_ops.zdf_record(n) for n in range(1, moog_ops.MAX_NEWTON_ITERS + 1)]
    for rec in records:
        for itemsize in (4, 8):
            seg = moog_ops.adjoint_plan(rec, itemsize)
            assert 1 <= seg <= moog_ops.ADJ_MAX_SEGMENT
            assert seg * (rec + 2) * 32 * itemsize <= 48 * 1024
    with pytest.raises(ValueError):
        moog_ops.moog_zdf_adjoint(x, st8, p, gy, gst, newton_iters=9)
    with pytest.raises(ValueError):
        moog_ops.moog_ladder_adjoint(x, st8[:, :1], p, gy, gst)
