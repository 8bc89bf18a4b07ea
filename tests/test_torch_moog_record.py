"""The record route of the port's Moog gradient (`ops/moog.py`): the
forward under autograd keeps each ladder step's record, and the backward
is one reverse sweep over it. On the CPU the record is the plain walk's
(`moog_*_plain(..., record=True)`) and the sweep is
`moog_*_reverse_plain`; the kernels of csrc/moog.cu repeat both formula
for formula, and chip_smoke.py holds them to these on the card.

Tolerances:
- bit for bit where the two sides run the same arithmetic: the recording
  forward's y and state against the plain forward's, the reverse sweep
  over a saved record against the checkpoint route's adjoint (which walks
  again from (x, state8)), and the two routes of the Functions;
- the record's values against their formulas recomputed from the state
  in, exactly (the same operations in the same order);
- against jitted `jax.grad` through the JAX `MoogFilter.process` (its
  `_run_scan`, the function the reference's custom VJP differentiates):
  float64 >= 200 dB and float32 >= 80 dB, tests/test_torch_moog_grad.py's
  bars (only the tanh implementations and the order of sums differ).
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
C = 33                  # two blocks of 32 lanes, the second one padded
VARIANTS = ["classic", "classic_lightweight", "improved_classic",
            "improved_classic_lightweight", "huovilainen", "zdf"]


def snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    err = ref - np.asarray(test, np.float64)
    p_err = float(np.sum(err * err))
    return np.inf if p_err == 0 else 10 * np.log10(np.sum(ref * ref) / p_err)


def _filter(variant, os, newton=4):
    return TMoog(SR, variant=TV(variant), cutoff_hz=1500.0, resonance=2.0,
                 drive=2.0, thermal_voltage=0.8, oversampling=os,
                 newton_iters=newton)


def _calls(mf):
    """(forward, recording forward, reverse, adjoint) of mf's kernel with
    its arguments bound."""
    p, os = mf.kernel_params(), mf.oversampling
    if mf.variant.value == "zdf":
        kw = dict(newton_iters=mf.newton_iters, os=os)
        return (lambda x, s: moog_ops.moog_zdf(x, s, p, **kw),
                lambda x, s: moog_ops.moog_zdf_record(x, s, p, **kw),
                lambda r, s, g, h: moog_ops.moog_zdf_reverse(r, s, p, g, h,
                                                             **kw),
                lambda x, s, g, h: moog_ops.moog_zdf_adjoint(x, s, p, g, h,
                                                             **kw))
    kw = dict(fast_tanh="lightweight" in mf.variant.value,
              huovilainen=mf.variant.value == "huovilainen", os=os)
    return (lambda x, s: moog_ops.moog_ladder(x, s, p, **kw),
            lambda x, s: moog_ops.moog_ladder_record(x, s, p, **kw),
            lambda r, s, g, h: moog_ops.moog_ladder_reverse(r, s, p, g, h,
                                                            **kw),
            lambda x, s, g, h: moog_ops.moog_ladder_adjoint(x, s, p, g, h,
                                                            **kw))


def _inputs(rng, c, t, dtype=torch.float64):
    return [torch.tensor(v, dtype=dtype) for v in (
        0.5 * rng.standard_normal((c, t)), 0.2 * rng.standard_normal((8, c)),
        rng.standard_normal((c, t)), rng.standard_normal((8, c)))]


def _nv(mf):
    return (moog_ops.zdf_record(mf.newton_iters)
            if mf.variant.value == "zdf" else moog_ops.LADDER_RECORD)


@pytest.mark.parametrize("variant", VARIANTS)
def test_record_route_bit_equal_to_checkpoint_route(variant):
    """Per variant, at os 1 and 4 (ZDF with 1 and 8 Newton iterations):
    the recording forward's y and state equal the forward's, the reverse
    sweep over its record equals the checkpoint route's adjoint, and
    autograd through `moog_ladder` / `moog_zdf` (the record route) gives
    the same gradients, all bit for bit."""
    rng = np.random.default_rng(VARIANTS.index(variant))
    for os, newton in ((1, 1), (4, 8)):
        mf = _filter(variant, os, newton)
        fwd, rec_fwd, rev, adj = _calls(mf)
        t = 24 // os
        x, st8, gy, gst = _inputs(rng, C, t)
        s_f, y_f = fwd(x, st8)
        s_r, y_r, rec = rec_fwd(x, st8)
        assert torch.equal(s_r, s_f) and torch.equal(y_r, y_f)
        assert rec.shape == moog_ops.record_shape(C, t, os, _nv(mf))
        dx, dst = rev(rec, st8, gy, gst)
        dx_a, dst_a = adj(x, st8, gy, gst)
        assert torch.equal(dx, dx_a) and torch.equal(dst, dst_a), (os, newton)
        xa, sa = x.clone().requires_grad_(), st8.clone().requires_grad_()
        s_out, y = fwd(xa, sa)
        assert y.grad_fn.saved_tensors[0].shape == rec.shape
        gx, gs = torch.autograd.grad((s_out, y), (xa, sa), (gst, gy))
        assert torch.equal(gx, dx) and torch.equal(gs, dst), (os, newton)


def test_ladder_record_layout_and_values():
    """The ladder's record: (ceil(C / 32), T * os, 9, 32), channel c at
    [c // 32, :, :, c % 32], padding lanes 0; step 0's values recomputed
    from the state in (exact tanh, so the classic step): coef ds tanh'(ds
    u), ds tanh'(ds s_i) of the new stages, 1 - coef ds tanh'(ds s3) of
    the old s3, and the four clip masks (1 inside, 0 where the DC of 100
    drives a stage past the clip)."""
    rng = np.random.default_rng(11)
    mf = TMoog(SR, cutoff_hz=1500.0, resonance=2.0, thermal_voltage=0.8)
    coef, ds, fb, ig, _ = mf.kernel_params()
    x, st8, _, _ = _inputs(rng, C, 5)
    _, _, rec = moog_ops.moog_ladder_record(x, st8, mf.kernel_params())
    assert rec.shape == (2, 5, moog_ops.LADDER_RECORD, 32)
    assert not torch.any(rec[1, :, :, 1:])
    per = rec.permute(1, 2, 0, 3).reshape(5, 9, 64)[..., :C]
    assert torch.equal(moog_ops._record_steps(rec, C), per)
    s = st8
    u = x[:, 0] * ig - fb * s[3]
    t_in = torch.tanh(ds * u)
    v0 = s[0] + coef * (t_in - s[4])
    t0 = torch.tanh(ds * torch.clamp(v0, -32, 32))
    v1 = s[1] + coef * (t0 - s[5])
    t1 = torch.tanh(ds * torch.clamp(v1, -32, 32))
    v2 = s[2] + coef * (t1 - s[6])
    t2 = torch.tanh(ds * torch.clamp(v2, -32, 32))
    ts3 = torch.tanh(ds * s[3])
    want = [coef * ds * (1 - t_in * t_in), ds * (1 - t0 * t0),
            ds * (1 - t1 * t1), ds * (1 - t2 * t2),
            1 - coef * ds * (1 - ts3 * ts3)]
    for i, v in enumerate(want):
        assert torch.equal(per[0, i], v), i
    assert torch.all(per[:, 5:] == 1)
    clip = TMoog(SR, cutoff_hz=8000.0, resonance=0.5, drive=1.0,
                 thermal_voltage=20.0)
    xc = 100.0 + torch.tensor(rng.standard_normal((2, 64)))
    _, _, rc = moog_ops.moog_ladder_record(xc, torch.zeros(8, 2, dtype=xc.dtype),
                                           clip.kernel_params())
    masks = moog_ops._record_steps(rc, 2)[:, 5:]
    assert torch.all((masks == 0) | (masks == 0.5) | (masks == 1))
    assert torch.any(masks == 0)


def test_zdf_record_layout_and_values():
    """The ZDF record: 12 + 6 newton_iters values a step, in the order
    0-3 tanh(shape s_i) of the old stages (step 0: the state in), 4-7 the
    clip masks, 8 + 6 it + (0-3, 4, 5) the four tanh, J and the step of
    update it, 8 + 6 newton_iters + (0-3) the last pass's tanh: each J is
    -k prod gk (1 - ty_i^2) - 1 of its own tanh, and the last pass's
    fourth tanh gives the output through y3 = vs (ty_3 - ts_3) + s3."""
    rng = np.random.default_rng(12)
    newton = 3
    mf = _filter("zdf", 1, newton)
    gk, shape, k, _, osc = mf.kernel_params()
    x, st8, _, _ = _inputs(rng, 5, 7)
    _, y, rec = moog_ops.moog_zdf_record(x, st8, mf.kernel_params(),
                                         newton_iters=newton)
    per = moog_ops._record_steps(rec, 5)
    assert per.shape == (7, moog_ops.zdf_record(newton), 5)
    for i in range(4):
        assert torch.equal(per[0, i], torch.tanh(shape * st8[i]))
    assert torch.all(per[:, 4:8] == 1)
    for it in range(newton):
        u = 8 + 6 * it
        ty = per[:, u:u + 4]
        d = [gk * (1 - ty[:, i] * ty[:, i]) for i in range(4)]
        jac = d[0] * d[1] * d[2] * d[3] * (-k) - 1.0
        assert torch.equal(per[:, u + 4], jac), it
    last = per[:, 8 + 6 * newton:]
    y3 = gk / shape * (last[:, 3] - per[:, 3])
    assert torch.equal(y[:, 0], osc * (y3[0] + st8[3]))


@pytest.mark.parametrize("kernel", ["moog_ladder", "moog_zdf"])
def test_functions_record_only_when_a_gradient_is_wanted(kernel,
                                                         monkeypatch):
    """The Function records (its forward asks the walk for the record and
    saves it with state8) when x or state8 requires grad under grad mode,
    and saves nothing and records nothing with no input requiring grad or
    under torch.no_grad."""
    rng = np.random.default_rng(13)
    mf = _filter("huovilainen" if kernel == "moog_ladder" else "zdf", 2)
    fwd = _calls(mf)[0]
    plain = getattr(moog_ops, f"{kernel}_plain")
    asked = []

    def spy(*args, record=False, **kw):
        asked.append(record)
        return plain(*args, record=record, **kw)

    monkeypatch.setattr(moog_ops, f"{kernel}_plain", spy)
    x, st8, _, _ = _inputs(rng, 3, 6)
    for xg, sg in ((True, False), (False, True)):
        _, y = fwd(x.clone().requires_grad_(xg), st8.clone().requires_grad_(sg))
        saved = y.grad_fn.saved_tensors
        assert saved[0].shape == moog_ops.record_shape(3, 6, 2, _nv(mf))
        assert torch.equal(saved[1], st8) and asked.pop() is True
    _, y = fwd(x, st8)
    assert y.grad_fn is None and asked.pop() is False
    with torch.no_grad():
        _, y = fwd(x.clone().requires_grad_(), st8.clone().requires_grad_())
    assert y.grad_fn is None and asked.pop() is False


@pytest.mark.parametrize("kernel", ["moog_ladder", "moog_zdf"])
def test_budget_sends_a_larger_record_to_the_checkpoint_route(kernel,
                                                             monkeypatch):
    """A record one byte over RECORD_BUDGET_BYTES (patched down to this
    call's size) takes the checkpoint route: the forward saves (x, state8)
    and the backward is the adjoint, with the record route's gradients bit
    for bit; at the budget exactly it records."""
    rng = np.random.default_rng(14)
    mf = _filter("classic" if kernel == "moog_ladder" else "zdf", 4, 2)
    fwd = _calls(mf)[0]
    x, st8, gy, gst = _inputs(rng, 3, 5)
    size = moog_ops.record_bytes(3, 5, 4, _nv(mf), 8)
    grads = {}
    for budget in (size, size - 1):
        monkeypatch.setattr(moog_ops, "RECORD_BUDGET_BYTES", budget)
        xa, sa = x.clone().requires_grad_(), st8.clone().requires_grad_()
        s_out, y = fwd(xa, sa)
        saved = y.grad_fn.saved_tensors
        want = (moog_ops.record_shape(3, 5, 4, _nv(mf)) if budget == size
                else x.shape)
        assert saved[0].shape == want, budget
        grads[budget] = torch.autograd.grad((s_out, y), (xa, sa), (gst, gy))
    assert all(torch.equal(a, b) for a, b in zip(grads[size],
                                                 grads[size - 1]))


def test_reverse_wrappers_check_the_record():
    """A record of another shape than `record_shape` gives (fewer steps
    than gy has, or another Newton count's values) raises."""
    rng = np.random.default_rng(15)
    mf = _filter("zdf", 1, 2)
    _, rec_fwd, rev, _ = _calls(mf)
    x, st8, gy, gst = _inputs(rng, 3, 4)
    rec = rec_fwd(x, st8)[2]
    with pytest.raises(ValueError, match="record_shape"):
        rev(rec[:, :3], st8, gy, gst)
    with pytest.raises(ValueError, match="record_shape"):
        moog_ops.moog_zdf_reverse(rec, st8, mf.kernel_params(), gy, gst,
                                  newton_iters=3)


def test_record_route_grad_matches_jax():
    """The chain's Moog node (Huovilainen at os 4) differentiated through
    `MoogFilter.process` on the record route, streamed in two blocks with
    the state carried, against jitted `jax.grad` of the JAX
    `MoogFilter.process` over the whole signal: x and every state row,
    float64 >= 200 dB, float32 >= 80 dB; the tanh rows get exactly 0
    (Huovilainen never reads them)."""
    rng = np.random.default_rng(16)
    kw = dict(variant="huovilainen", cutoff_hz=1200.0, resonance=2.0,
              drive=2.0, oversampling=4)
    jm = JMoog(SR, **{**kw, "variant": JV.HUOVILAINEN})
    tm = TMoog(SR, **{**kw, "variant": TV.HUOVILAINEN})
    x = 0.5 * rng.standard_normal((3, 16))
    st = {"stage": 0.2 * rng.standard_normal((3, 4)),
          "tanh_last": 0.2 * rng.standard_normal((3, 3)),
          "prev_out": 0.2 * rng.standard_normal(3)}
    w = rng.standard_normal(x.shape)
    w_stage = rng.standard_normal((3, 4))

    def j_loss(state, xv):
        state, y = jm.process(state, xv)
        return jnp.sum(y * w) + jnp.sum(state["stage"] * w_stage)

    gs_j, gx_j = ref_jit(jax.grad(j_loss, argnums=(0, 1)))(
        {k: jnp.asarray(v) for k, v in st.items()}, jnp.asarray(x))
    for dtype, bar in ((torch.float64, 200.0), (torch.float32, 80.0)):
        xt = torch.tensor(x, dtype=dtype, requires_grad=True)
        st0 = {k: torch.tensor(v, dtype=dtype, requires_grad=True)
               for k, v in st.items()}
        state, y0 = tm.process(st0, xt[:, :7])
        assert y0.grad_fn.next_functions[0][0].saved_tensors[0].ndim == 4
        state, y1 = tm.process(state, xt[:, 7:])
        loss = (torch.sum(torch.cat([y0, y1], -1) * torch.tensor(w, dtype=dtype))
                + torch.sum(state["stage"] * torch.tensor(w_stage, dtype=dtype)))
        loss.backward()
        assert snr_db(gx_j, xt.grad.numpy()) >= bar, dtype
        for k in ("stage", "prev_out"):
            assert snr_db(gs_j[k], st0[k].grad.numpy()) >= bar, (k, dtype)
        assert not torch.any(st0["tanh_last"].grad)
