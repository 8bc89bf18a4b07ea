"""The feedback loops of the delay, the algorithmic reverbs and the
flanger: R1 (Delay), R2 (Freeverb), R3 (FDN) and M1 (Flanger),
counterparts of the per-sample and blocked `lax.scan`s of
`algodsp_tpu/effects/delay_effect.py`, `effects/reverb/freeverb.py`,
`effects/reverb/fdn.py` and `effects/modulation/modulation.py` (no
Pallas).

Each loop reads its own output back through a delay line, so it runs
sample by sample. The CUDA kernels of `csrc/feedback.cu` walk that
recurrence in place on the rings the JAX package keeps as state: R1, R2
and M1 one warp a channel, a chunk of 32 samples on the 32 lanes, the
damping one-poles in order on lanes 0-7; R3 one block a channel, a whole
stretch (a reference block, or up to as many samples of the per-sample
tier) a pass, its damping a scan over the stretch, since no read lags
less than the stretch. `*_plain` are the JAX package's own
`process` algorithms in plain PyTorch: the blocked tiers (a Python loop
over 128-sample or `_block` blocks, Freeverb's damping as a Toeplitz
product under `full_float32()`, the FDN's as a Hillis-Steele scan) and
the per-sample step for tails.

A CUDA tensor runs the kernel (or raises); a CPU tensor runs the plain
version, through which autograd differentiates as `jax.grad` does the
scans. The kernels have no backward yet: a gradient wanted on the card
raises. On the card the rings of the state passed in are updated in
place and returned in the new state: a state is consumed by the call
that takes it. The plain versions leave their inputs as they are.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from algodsp_tpu_torch import _build
from algodsp_tpu_torch.ops import ring
from algodsp_tpu_torch.ops.linrec import full_float32

DELAY_BLOCK = 128       # the reference Delay's and Freeverb's block
SQUELCH = 1e-23         # Freeverb's denormal squelch
_TWO_PI = 2.0 * np.pi

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# delay_feedback_f{32,64}(buf, x, cur, y, w_in, w_out, C, L, N, prm, stream)
_DELAY_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_longlong, ctypes.c_void_p,
                                       ctypes.c_void_p]
# freeverb_f{32,64}(rings, lens, fs_in, fs_out, step_in, step_out, x, y,
#                   C, N, prm, stream)
_FREEVERB_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_longlong,
                                          ctypes.c_void_p, ctypes.c_void_p]
# fdn_f{32,64}(lines, fst_in, fst_out, lfo_in, lfo_out, step_in, step_out,
#              x, inp, y, C, L, N, B, nb, prm, stream)
_FDN_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_longlong, ctypes.c_void_p,
                                      ctypes.c_void_p]
# flanger_f{32,64}(buf, x, d, y, w_in, w_out, C, L, N, B, nb, prm, stream)
_FLANGER_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_longlong, ctypes.c_void_p,
                                         ctypes.c_void_p]
# ring_chunk_latency(n, L, lag, ring, cycles, stream)
_RING_LAT_ARGS = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
# damp_latency_f{32,64}(squelch, n, x0, damp, cycles, sink, stream)
_LAT_ARGS = [ctypes.c_int, ctypes.c_longlong, ctypes.c_double, ctypes.c_double,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def _card_call(what: str, x, *tensors):
    """Check a kernel call's input on the card: a float32 or float64
    tensor on CUDA, no gradient wanted, at least one channel."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype not in _SUFFIX:
        raise ValueError(f"{what}: takes float32 or float64, got {x.dtype}")
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"{what}: every tensor must be on {x.device}")
    _build.refuse_grad(what, "its adjoint is not ported", x, *tensors)
    if x.ndim < 1 or x.shape[:-1].numel() == 0:
        raise ValueError(f"{what}: no channel to process")


def _channels(t, tail):
    """t as a contiguous (C, *tail) view (a copy only where t is not
    contiguous) whose writes land in the tensor returned with it."""
    if not t.is_contiguous():
        t = t.contiguous()
    return t, t.view((-1,) + tuple(tail))


# ---------------------------------------------------------------------------
# R1: the feedback delay
# ---------------------------------------------------------------------------

def delay_feedback(dl, buf, write, x, cur):
    """The feedback delay `dl` (effects.delay_effect.Delay) over x
    (..., N) from the ring buf (..., L) and write cursor `write` (int32),
    along the smoothed lag trajectory cur (N,). Returns (buf, write, y).

    The kernel (R1) for a CUDA tensor, the plain version for a CPU one.
    `launches` counts the kernel's launches; N = 0 launches nothing."""
    if x.device.type == "cpu":
        return delay_feedback_plain(dl, buf, write, x, cur)
    _card_call("delay_feedback", x, buf, write, cur)
    L, N = dl.buf_len, x.shape[-1]
    lead = x.shape[:-1]
    if tuple(buf.shape) != tuple(lead) + (L,) or buf.dtype != x.dtype \
            or cur.dtype != x.dtype or tuple(cur.shape) != (N,):
        raise ValueError("delay_feedback: buf must be (..., L) and cur (N,) "
                         "of x's type")
    if N == 0:
        return buf, torch.remainder(write, L).to(torch.int32), x.clone()
    fn = _build.entry("feedback", f"delay_feedback_{_SUFFIX[x.dtype]}",
                      _DELAY_ARGS)
    buf, b2 = _channels(buf, (L,))
    x2 = x.reshape(-1, N).contiguous()
    cur = cur.contiguous()
    w_in = write.to(torch.int32).contiguous()
    w_out = torch.empty((), dtype=torch.int32, device=x.device)
    y = torch.empty_like(x2)
    prm = (ctypes.c_double * 2)(dl.feedback, dl.mix)
    with torch.cuda.device(x.device):
        code = fn(*(_build.ptr(t) for t in (b2, x2, cur, y, w_in, w_out)),
                  b2.shape[0], L, N, ctypes.addressof(prm),
                  _build.stream_of(x))
        delay_feedback.launches += 1
    _build.check("feedback", code, "delay_feedback")
    return buf, w_out, y.reshape(x.shape)


delay_feedback.launches = 0


def _delay_taps(buf, idx0, idx1, frac):
    return buf[..., idx0] * (1 - frac) + buf[..., idx1] * frac


def delay_scan_plain(dl, buf, w, x, cur):
    """The reference's per-sample scan (`delay_effect.py:72-91`) from
    cursor w (an int, not reduced as it advances). Returns
    (buf, write, y)."""
    L, N = dl.buf_len, x.shape[-1]
    buf = buf.clone()
    ys = []
    for k in range(N):
        v = w + k
        pos = torch.remainder(v - cur[k], float(L))
        fl = torch.floor(pos)
        frac = pos - fl
        i0 = fl.long()
        i1 = torch.remainder(i0 + 1, L)
        delayed = _delay_taps(buf, i0.clamp(0, L - 1), i1, frac)
        xv = x[..., k]
        buf[..., v % L] = xv + delayed * dl.feedback
        ys.append(xv * (1.0 - dl.mix) + delayed * dl.mix)
    y = torch.stack(ys, dim=-1) if ys else x.clone()
    return buf, torch.tensor((w + N) % L, dtype=torch.int32,
                             device=x.device), y


def delay_feedback_plain(dl, buf, write, x, cur):
    """Plain PyTorch version of R1: the reference's three tiers
    (`delay_effect.py:93-157, 186-199`), picked from cur and the cursor
    as the reference picks them."""
    B, L, N = DELAY_BLOCK, dl.buf_len, x.shape[-1]
    w = int(torch.remainder(write, L))
    nb, rem = divmod(N, B)
    ok = nb > 0 and bool(torch.all((cur >= B + 2.0) & (cur <= L - 2.0)))
    if not ok:
        return delay_scan_plain(dl, buf, w, x, cur)
    t = torch.arange(B, device=x.device)
    ys = []
    if rem == 0 and w % B == 0:
        # the aligned ring: one contiguous write a block
        buf = buf.clone()
        base = w
        for b in range(nb):
            curb, xb = cur[b * B:(b + 1) * B], x[..., b * B:(b + 1) * B]
            pos = torch.remainder((base + t).to(x.dtype) - curb, float(L))
            fl = torch.floor(pos)
            i0 = fl.long()
            delayed = _delay_taps(buf, i0.clamp(0, L - 1),
                                  torch.remainder(i0 + 1, L), pos - fl)
            buf[..., base:base + B] = xb + delayed * dl.feedback
            ys.append(xb * (1.0 - dl.mix) + delayed * dl.mix)
            base = (base + B) % L
        return buf, torch.tensor(base, dtype=torch.int32, device=x.device), \
            torch.cat(ys, dim=-1)
    # the linear extension: reorder once, extend, cursor back to 0
    ext = torch.cat([ring.ring_to_linear(buf, w),
                     x.new_zeros(x.shape[:-1] + (nb * B,))], dim=-1)
    base = L
    for b in range(nb):
        curb, xb = cur[b * B:(b + 1) * B], x[..., b * B:(b + 1) * B]
        pos = (base + t).to(x.dtype) - curb
        fl = torch.floor(pos)
        i0 = fl.long()
        delayed = _delay_taps(ext, i0, i0 + 1, pos - fl)
        ext[..., base:base + B] = xb + delayed * dl.feedback
        ys.append(xb * (1.0 - dl.mix) + delayed * dl.mix)
        base += B
    buf, w0 = ext[..., ext.shape[-1] - L:], torch.zeros(
        (), dtype=torch.int32, device=x.device)
    if rem:
        buf, w0, yt = delay_scan_plain(dl, buf, 0, x[..., nb * B:],
                                       cur[nb * B:])
        ys.append(yt)
    return buf, w0, torch.cat(ys, dim=-1)


# ---------------------------------------------------------------------------
# R2: Freeverb
# ---------------------------------------------------------------------------

def freeverb_feedback(fv, state, x):
    """Freeverb `fv` (effects.reverb.Freeverb) over x (..., N) from
    `state` (its `init_state` layout). Returns (state, y).

    The kernel (R2) for a CUDA tensor, the plain version for a CPU one.
    `launches` counts the kernel's launches; N = 0 launches nothing."""
    if x.device.type == "cpu":
        return freeverb_feedback_plain(fv, state, x)
    rings = list(state["combs"]) + list(state["allpasses"])
    _card_call("freeverb_feedback", x, state["filter_store"], state["step"],
               *rings)
    N, lead = x.shape[-1], x.shape[:-1]
    lens = [r.shape[-1] for r in rings]
    if any(r.dtype != x.dtype or tuple(r.shape[:-1]) != tuple(lead)
           for r in rings + [state["filter_store"]]):
        raise ValueError("freeverb_feedback: the state's rings and filter "
                         "store must have x's type and batch")
    if N == 0:
        return dict(state), x.clone()
    fn = _build.entry("feedback", f"freeverb_{_SUFFIX[x.dtype]}",
                      _FREEVERB_ARGS)
    full, views = [], []
    for r, n in zip(rings, lens):
        r, v = _channels(r, (n,))
        full.append(r)
        views.append(v)
    x2 = x.reshape(-1, N).contiguous()
    fs_in = state["filter_store"].reshape(-1, 8).contiguous()
    step_in = state["step"].to(torch.int32).contiguous()
    fs_out = torch.empty_like(fs_in)
    step_out = torch.empty((), dtype=torch.int32, device=x.device)
    y = torch.empty_like(x2)
    ptrs = (ctypes.c_void_p * 12)(*(v.data_ptr() for v in views))
    lens_c = (ctypes.c_int * 12)(*lens)
    prm = (ctypes.c_double * 6)(fv.input_gain, fv.damp, fv.comb_feedback,
                                fv.allpass_feedback, fv.wet, fv.dry)
    with torch.cuda.device(x.device):
        code = fn(ctypes.addressof(ptrs), ctypes.addressof(lens_c),
                  *(_build.ptr(t) for t in (fs_in, fs_out, step_in, step_out,
                                            x2, y)),
                  x2.shape[0], N, ctypes.addressof(prm), _build.stream_of(x))
        freeverb_feedback.launches += 1
    _build.check("feedback", code, "freeverb_feedback")
    return ({"combs": full[:8], "filter_store": fs_out.reshape(lead + (8,)),
             "allpasses": full[8:], "step": step_out}, y.reshape(x.shape))


freeverb_feedback.launches = 0


def freeverb_scan_plain(fv, combs, fstore, allp, step, x):
    """The reference's per-sample walk (`freeverb.py:121-151`) on the ring
    layout from the int step. Returns (combs, fstore, allp, y)."""
    from algodsp_tpu_torch.effects.reverb.freeverb import (ALLPASS_TUNINGS,
                                                           COMB_TUNINGS)
    combs = [c.clone() for c in combs]
    allp = [a.clone() for a in allp]
    fst = [fstore[..., i] for i in range(len(COMB_TUNINGS))]
    ys = []
    for k in range(x.shape[-1]):
        n = step + k
        xv = x[..., k]
        inp = xv * fv.input_gain
        acc = torch.zeros_like(xv)
        for i, size in enumerate(COMB_TUNINGS):
            out = combs[i][..., n % size].clone()
            fs = out * (1.0 - fv.damp) + fst[i] * fv.damp
            fs = torch.where(torch.abs(fs) < SQUELCH, torch.zeros_like(fs), fs)
            combs[i][..., n % size] = inp + fs * fv.comb_feedback
            fst[i] = fs
            acc = acc + out
        for j, size in enumerate(ALLPASS_TUNINGS):
            bo = allp[j][..., n % size].clone()
            out = bo - acc
            allp[j][..., n % size] = acc + bo * fv.allpass_feedback
            acc = out
        ys.append(acc * fv.wet + xv * fv.dry)
    y = torch.stack(ys, dim=-1) if ys else x.clone()
    return combs, torch.stack(fst, dim=-1), allp, y


def _freeverb_block(fv, combs, fstore, allp, xb, T, p):
    """One 128-sample block on the shift-register layout
    (`freeverb.py:82-119`)."""
    B = xb.shape[-1]
    inp = xb * fv.input_gain
    out = torch.stack([c[..., :B] for c in combs], dim=-2)        # (..., 8, B)
    with full_float32():
        fs = out @ T.transpose(0, 1) + fstore[..., None] * p
    fs = torch.where(torch.abs(fs) < SQUELCH, torch.zeros_like(fs), fs)
    wr = inp[..., None, :] + fs * fv.comb_feedback
    combs = [torch.cat([combs[i][..., B:], wr[..., i, :]], dim=-1)
             for i in range(len(combs))]
    acc = torch.sum(out, dim=-2)
    new_allp = []
    for a in allp:
        buf_out = a[..., :B]
        new_allp.append(torch.cat([a[..., B:], acc + buf_out * fv.allpass_feedback],
                                  dim=-1))
        acc = buf_out - acc
    return combs, fs[..., :, -1], new_allp, acc * fv.wet + xb * fv.dry


def freeverb_feedback_plain(fv, state, x):
    """Plain PyTorch version of R2: the reference's `process` (full
    128-sample blocks on the shift-register layout, the tail per
    sample)."""
    N = x.shape[-1]
    nb, rem = divmod(N, DELAY_BLOCK)
    combs, fstore = list(state["combs"]), state["filter_store"]
    allp, step = list(state["allpasses"]), state["step"]
    s0 = int(step)
    ys = []
    if nb:
        combs = [ring.ring_to_linear(c, s0) for c in combs]
        allp = [ring.ring_to_linear(a, s0) for a in allp]
        T = torch.as_tensor(fv._damp_T, dtype=x.dtype, device=x.device)
        p = torch.as_tensor(fv._damp_p, dtype=x.dtype, device=x.device)
        for b in range(nb):
            combs, fstore, allp, yb = _freeverb_block(
                fv, combs, fstore, allp,
                x[..., b * DELAY_BLOCK:(b + 1) * DELAY_BLOCK], T, p)
            ys.append(yb)
        s1 = s0 + nb * DELAY_BLOCK
        combs = [ring.linear_to_ring(c, s1) for c in combs]
        allp = [ring.linear_to_ring(a, s1) for a in allp]
    if rem:
        combs, fstore, allp, yt = freeverb_scan_plain(
            fv, combs, fstore, allp, s0 + nb * DELAY_BLOCK, x[..., nb * DELAY_BLOCK:])
        ys.append(yt)
    y = torch.cat(ys, dim=-1) if ys else x.clone()
    return ({"combs": combs, "filter_store": fstore, "allpasses": allp,
             "step": torch.as_tensor(s0 + N, dtype=torch.int32,
                                     device=x.device)}, y)


# ---------------------------------------------------------------------------
# R3: the FDN
# ---------------------------------------------------------------------------

def _fdn_blocks(rv, n: int) -> int:
    """Full `_block` blocks of an n-sample call in the blocked form (none
    for tiny-delay configurations, as the reference's `process`)."""
    B = rv._block
    return n // B if B >= 16 else 0


def _fdn_params(rv) -> "ctypes.Array":
    """The kernel's 95 parameters (csrc/feedback.cu::fdn_launch)."""
    dphase = _TWO_PI * rv.mod_rate / rv.sample_rate
    off = _TWO_PI * np.arange(8) / 8
    vals = np.concatenate([rv.base_delays, rv.feedback_gains, off,
                           np.asarray(rv.hadamard, np.float64).reshape(-1),
                           [rv.mod_depth, dphase, dphase * rv._block,
                            rv.gain, rv.damp, rv.wet, rv.dry]])
    return (ctypes.c_double * vals.size)(*vals.tolist())


def fdn_feedback(rv, lines, fstate, lfo, step, x, inp):
    """The FDN `rv` (effects.reverb.FDNReverb) feedback loop over x
    (..., N) and its pre-delayed input inp, from lines (..., 8, L), the
    damping state fstate (..., 8), the LFO phase and the int32 step.
    Returns (lines, fstate, lfo, step, y).

    The kernel (R3) for a CUDA tensor, the plain version for a CPU one.
    `launches` counts the kernel's launches; N = 0 launches nothing."""
    if x.device.type == "cpu":
        return fdn_feedback_plain(rv, lines, fstate, lfo, step, x, inp)
    _card_call("fdn_feedback", x, lines, fstate, lfo, step, inp)
    L, N, lead = rv.line_len, x.shape[-1], x.shape[:-1]
    if (tuple(lines.shape) != tuple(lead) + (8, L)
            or tuple(fstate.shape) != tuple(lead) + (8,)
            or tuple(inp.shape) != tuple(x.shape)
            or any(t.dtype != x.dtype for t in (lines, fstate, lfo, inp))):
        raise ValueError("fdn_feedback: lines (..., 8, L), fstate (..., 8) "
                         "and inp like x, all of x's type")
    if N == 0:
        return lines, fstate, lfo, step, x.clone()
    fn = _build.entry("feedback", f"fdn_{_SUFFIX[x.dtype]}", _FDN_ARGS)
    lines, l2 = _channels(lines, (8, L))
    x2 = x.reshape(-1, N).contiguous()
    i2 = inp.reshape(-1, N).contiguous()
    f_in = fstate.reshape(-1, 8).contiguous()
    lfo_in = lfo.contiguous()
    step_in = step.to(torch.int32).contiguous()
    f_out = torch.empty_like(f_in)
    lfo_out = torch.empty_like(lfo_in)
    step_out = torch.empty((), dtype=torch.int32, device=x.device)
    y = torch.empty_like(x2)
    prm = _fdn_params(rv)
    with torch.cuda.device(x.device):
        code = fn(*(_build.ptr(t) for t in (l2, f_in, f_out, lfo_in, lfo_out,
                                            step_in, step_out, x2, i2, y)),
                  x2.shape[0], L, N, rv._block, _fdn_blocks(rv, N),
                  ctypes.addressof(prm), _build.stream_of(x))
        fdn_feedback.launches += 1
    _build.check("feedback", code, "fdn_feedback")
    return (lines, f_out.reshape(lead + (8,)), lfo_out, step_out,
            y.reshape(x.shape))


fdn_feedback.launches = 0


def fdn_consts(rv, x):
    d = dict(dtype=x.dtype, device=x.device)
    return (torch.as_tensor(rv.hadamard, **d),
            torch.as_tensor(rv.feedback_gains, **d),
            torch.as_tensor(rv.base_delays, **d),
            torch.as_tensor(_TWO_PI * np.arange(8) / 8, **d))


def fdn_step_plain(rv, lines, fstate, lfo, n: int, xv, inp, consts):
    """One per-sample step (`fdn.py:235-253`) on the ring layout at step
    n; lines is updated in place. Returns (fstate, lfo, y)."""
    had, fb_g, base, phase_off = consts
    L = rv.line_len
    mod = 0.5 * (1.0 + torch.sin(lfo + phase_off))
    delays = base + rv.mod_depth * mod
    wp = n % L
    pos = wp - delays
    fl = torch.floor(pos)
    frac = pos - fl
    i0 = torch.remainder(fl.long(), L)
    i1 = torch.remainder(i0 + 1, L)
    rows = torch.arange(8, device=lines.device)
    d = lines[..., rows, i0] * (1 - frac) + lines[..., rows, i1] * frac
    with full_float32():
        feedback = d @ had.transpose(0, 1)
    damp = torch.as_tensor(rv.damp, dtype=xv.dtype)
    filtered = feedback * (1 - damp) + fstate * damp
    lines[..., :, wp] = inp[..., None] * rv.gain + filtered * fb_g
    y = xv * rv.dry + torch.sum(d, dim=-1) * rv.gain * rv.wet
    lfo = torch.remainder(lfo + _TWO_PI * rv.mod_rate / rv.sample_rate, _TWO_PI)
    return filtered, lfo, y


def _damp_block(rv, feedback, fstate):
    """The in-loop damping one-pole over one block, a Hillis-Steele scan
    with scalar sweep weights (`fdn.py:134-164`)."""
    da = float(rv.damp)
    b = (1.0 - da) * feedback
    n = b.shape[-1]
    tol = 1e-12 if feedback.dtype == torch.float32 else 1e-20
    shift = 1
    while shift < n:
        m = da ** shift
        if abs(m) > tol:
            b = torch.cat([b[..., :shift], b[..., shift:] + m * b[..., :-shift]],
                          dim=-1)
        shift *= 2
    cp = torch.as_tensor(np.power(da, np.arange(n) + 1.0), dtype=b.dtype,
                         device=b.device)
    return b + fstate[..., None] * cp


def _fdn_block(rv, lines, fstate, lfo, xb, inpb, consts):
    """One `_block` block on the shift-register layout (`fdn.py:166-220`):
    the modulated reads gathered directly (the reference's in-window
    shifts select the same two samples with the same weights)."""
    had, fb_g, base, phase_off = consts
    B, L = xb.shape[-1], rv.line_len
    dphase = _TWO_PI * rv.mod_rate / rv.sample_rate
    t = torch.arange(B, device=xb.device)
    lfo_t = torch.remainder(lfo + dphase * t.to(xb.dtype), _TWO_PI)
    mod = 0.5 * (1.0 + torch.sin(lfo_t[:, None] + phase_off))      # (B, 8)
    delays = base + rv.mod_depth * mod
    pos = (L + t[:, None]).to(xb.dtype) - delays
    fl = torch.floor(pos)
    frac = (pos - fl).transpose(0, 1)                               # (8, B)
    i0 = fl.long().transpose(0, 1)
    idx = i0.expand(lines.shape[:-2] + i0.shape)
    d = (torch.gather(lines, -1, idx) * (1 - frac)
         + torch.gather(lines, -1, idx + 1) * frac)                 # (..., 8, B)
    with full_float32():
        feedback = had @ d
    filtered = _damp_block(rv, feedback, fstate)
    write = inpb[..., None, :] * rv.gain + filtered * fb_g[:, None]
    lines = torch.cat([lines[..., B:], write], dim=-1)
    y = xb * rv.dry + torch.sum(d, dim=-2) * rv.gain * rv.wet
    lfo = torch.remainder(lfo + dphase * B, _TWO_PI)
    return lines, filtered[..., :, -1], lfo, y


def fdn_feedback_plain(rv, lines, fstate, lfo, step, x, inp):
    """Plain PyTorch version of R3: the reference's `process` feedback
    loop (full `_block` blocks on the shift-register layout, the tail
    per sample)."""
    N = x.shape[-1]
    B = rv._block
    nb = _fdn_blocks(rv, N)
    consts = fdn_consts(rv, x)
    s0 = int(step)
    ys = []
    if nb:
        lin = ring.ring_to_linear(lines, s0)
        for b in range(nb):
            sl = slice(b * B, (b + 1) * B)
            lin, fstate, lfo, yb = _fdn_block(rv, lin, fstate, lfo,
                                              x[..., sl], inp[..., sl], consts)
            ys.append(yb)
        lines = ring.linear_to_ring(lin, s0 + nb * B)
    if N > nb * B:
        lines = lines.clone()
        for k in range(nb * B, N):
            fstate, lfo, yk = fdn_step_plain(rv, lines, fstate, lfo, s0 + k,
                                             x[..., k], inp[..., k], consts)
            ys.append(yk[..., None])
    y = torch.cat(ys, dim=-1) if ys else x.clone()
    return (lines, fstate, lfo,
            torch.as_tensor(s0 + N, dtype=torch.int32, device=x.device), y)


# ---------------------------------------------------------------------------
# M1: the flanger
# ---------------------------------------------------------------------------

def _flanger_blocks(fl, n: int) -> int:
    """Full `_block` blocks of an n-sample call in the blocked form (none
    where the block is under 16 samples, as the reference's `process`)."""
    B = fl._block
    return n // B if B >= 16 else 0


def flanger_feedback(fl, buf, write, x, d):
    """The flanger `fl` (effects.modulation.Flanger) feedback loop over x
    (..., N) from the ring buf (..., L) and the int32 write counter
    `write` (never reduced, as the reference's), along the lag trajectory
    d (N,). Returns (buf, write, y).

    The kernel (M1) for a CUDA tensor, the plain version for a CPU one.
    `launches` counts the kernel's launches; N = 0 launches nothing."""
    if x.device.type == "cpu":
        return flanger_feedback_plain(fl, buf, write, x, d)
    _card_call("flanger_feedback", x, buf, write, d)
    L, N = fl.buf_len, x.shape[-1]
    lead = x.shape[:-1]
    if tuple(buf.shape) != tuple(lead) + (L,) or buf.dtype != x.dtype \
            or d.dtype != x.dtype or tuple(d.shape) != (N,):
        raise ValueError("flanger_feedback: buf must be (..., L) and d (N,) "
                         "of x's type")
    if N == 0:
        return buf, write.to(torch.int32), x.clone()
    fn = _build.entry("feedback", f"flanger_{_SUFFIX[x.dtype]}", _FLANGER_ARGS)
    buf, b2 = _channels(buf, (L,))
    x2 = x.reshape(-1, N).contiguous()
    d = d.contiguous()
    w_in = write.to(torch.int32).contiguous()
    w_out = torch.empty((), dtype=torch.int32, device=x.device)
    y = torch.empty_like(x2)
    prm = (ctypes.c_double * 2)(fl.feedback, fl.mix)
    with torch.cuda.device(x.device):
        code = fn(*(_build.ptr(t) for t in (b2, x2, d, y, w_in, w_out)),
                  b2.shape[0], L, N, fl._block, _flanger_blocks(fl, N),
                  ctypes.addressof(prm), _build.stream_of(x))
        flanger_feedback.launches += 1
    _build.check("feedback", code, "flanger_feedback")
    return buf, w_out, y.reshape(x.shape)


flanger_feedback.launches = 0


def flanger_scan_plain(fl, buf, w: int, x, d):
    """The reference's per-sample scan (`modulation.py:233-252`) from the
    counter w (an int, not reduced as it advances). Returns (buf, y)."""
    L = fl.buf_len
    buf = buf.clone()
    ys = []
    for k in range(x.shape[-1]):
        pos = torch.as_tensor(w + k, dtype=x.dtype, device=x.device) - d[k]
        fl_ = torch.floor(pos)
        i0, frac = fl_.long(), pos - fl_
        delayed = (buf[..., torch.remainder(i0, L)] * (1 - frac)
                   + buf[..., torch.remainder(i0 + 1, L)] * frac)
        xv = x[..., k]
        buf[..., (w + k) % L] = xv + delayed * fl.feedback
        ys.append(xv * (1.0 - fl.mix) + delayed * fl.mix)
    return buf, (torch.stack(ys, dim=-1) if ys else x.clone())


def flanger_feedback_plain(fl, buf, write, x, d):
    """Plain PyTorch version of M1: the reference's `process` feedback
    loop (`modulation.py:254-299`): whole `_block` blocks on the
    linearised ring, reading at (L + t) - d, then the per-sample scan for
    the tail. The blocked form's in-window shifts select the same two
    samples with the same weights as the direct gather here."""
    L, N = fl.buf_len, x.shape[-1]
    B = fl._block
    nb = _flanger_blocks(fl, N)
    w = int(write)
    ys = []
    if nb:
        lin = ring.ring_to_linear(buf, w)
        t = torch.arange(B, device=x.device)
        for b in range(nb):
            sl = slice(b * B, (b + 1) * B)
            pos = (L + t).to(x.dtype) - d[sl]
            fl_ = torch.floor(pos)
            i0 = fl_.long()
            frac = pos - fl_
            delayed = lin[..., i0] * (1 - frac) + lin[..., i0 + 1] * frac
            xb = x[..., sl]
            lin = torch.cat([lin[..., B:], xb + delayed * fl.feedback], dim=-1)
            ys.append(xb * (1.0 - fl.mix) + delayed * fl.mix)
        buf = ring.linear_to_ring(lin, w + nb * B)
    if N > nb * B:
        buf, yt = flanger_scan_plain(fl, buf, w + nb * B, x[..., nb * B:],
                                     d[nb * B:])
        ys.append(yt)
    y = torch.cat(ys, dim=-1) if ys else x.clone()
    return buf, torch.as_tensor(w + N, dtype=torch.int32, device=x.device), y


# ---------------------------------------------------------------------------
# the damping chain's cycles, for the kernels' chain bound
# ---------------------------------------------------------------------------

def damp_step_cycles(damp: float, squelch: bool, dtype=torch.float32,
                     n: int = 1 << 16, device="cuda") -> float:
    """SM cycles of one dependent damping step (R2's with its squelch, R3's
    without) on one thread, clock64 stamps around n steps: with the SM
    clock, the chain bound of a T-sample walk is T times this."""
    fn = _build.entry("feedback", f"damp_latency_{_SUFFIX[dtype]}", _LAT_ARGS)
    cycles = torch.zeros(1, dtype=torch.int64, device=device)
    sink = torch.zeros(1, dtype=dtype, device=device)
    for _ in range(2):      # the first run warms the instruction cache
        code = fn(int(squelch), n, 0.7, float(damp), _build.ptr(cycles),
                  _build.ptr(sink), _build.stream_of(cycles))
        _build.check("feedback", code, "damp_latency")
        torch.cuda.synchronize(cycles.device)
    return int(cycles.item()) / n


def ring_chunk_cycles(L: int, lag: int, n: int = 1 << 14, device="cuda") -> float:
    """SM cycles of one 32-sample chunk of M1's dependent walk on one warp
    (each lane loads the ring slot `lag` samples back, then stores its
    own), clock64 stamps around n chunks: with the SM clock, the chain
    bound of an N-sample walk is ceil(N / 32) times this."""
    fn = _build.entry("feedback", "ring_chunk_latency", _RING_LAT_ARGS)
    ring = torch.zeros(L, dtype=torch.float32, device=device)
    cycles = torch.zeros(1, dtype=torch.int64, device=device)
    for _ in range(2):      # the first run warms the instruction cache
        code = fn(n, L, lag, _build.ptr(ring), _build.ptr(cycles),
                  _build.stream_of(ring))
        _build.check("feedback", code, "ring_chunk_latency")
        torch.cuda.synchronize(ring.device)
    return int(cycles.item()) / n
