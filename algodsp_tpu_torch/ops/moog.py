"""Nonlinear Moog ladders: the CUDA kernels `csrc/moog.cu`, their adjoint
kernels, and the plain PyTorch versions of both.

Replaces the Pallas kernels `algodsp_tpu/ops/pallas_kernels.py::
_moog_kernel` (K5, front door `moog_ladder_pallas`: the classic ladder
with exact or rational tanh, and the Huovilainen ladder) and
`::_moog_zdf_kernel` (K6, front door `moog_zdf_pallas`: the ZDF ladder
with a fixed number of Newton iterations). Same contract: x (C, T),
state8 (8, C) = [s0..s3, t0..t2, prev], five parameters in the order
`MoogFilter` builds them; returns (new state8, y (C, T)). Unlike the
TPU path, every T >= 1 runs in the kernel and the state out is the
carry after the last real sample. The oversampling factor `os` is
fused: the result is that of the ladder over x zero-stuffed to T * os
samples (x * os on the first of each os) with every os-th output kept,
as `MoogFilter.process` defines it; os = 1 is the TPU kernels' contract.

`moog_ladder` and `moog_zdf` run through `MoogLadderFn` / `MoogZDFFn`,
differentiable in x and state8: the port of the reference's custom VJP
`algodsp_tpu/filters/moog.py::_kernel_chunk_diff`, whose backward is the
VJP of the per-sample scan over the zero-stuffed input. CUDA tensors
(float32 or float64) launch the forward kernels and, in the backward,
the adjoint kernels `moog_ladder_adjoint` / `moog_zdf_adjoint`; CPU
tensors use the plain versions: `moog_ladder_plain` / `moog_zdf_plain`,
a per-sample loop over the step functions of `algodsp_tpu/filters/
moog.py`, and `moog_ladder_adjoint_plain` / `moog_zdf_adjoint_plain`,
explicit reverse sweeps written to the adjoint kernels' formulas.

The adjoint is the reference's function exactly: the clip passes no
gradient where it cuts and half where its argument sits on the bound
(`jnp.clip`'s rule), the rational tanh's derivative is 0 where |z| > 3,
the ZDF step is differentiated through its unrolled Newton loop (the
Jacobian's second derivatives and the `|J| < 1e-15` selection included),
and the state rows a variant never reads get 0: t0..t2 for Huovilainen
(it takes tanh(ds s) of the stages), prev for the classic family, while
ZDF passes t0..t2 through.
"""

from __future__ import annotations

import ctypes

import torch

from algodsp_tpu_torch import _build

STATE_LIMIT = 32.0
MAX_NEWTON_ITERS = 8
# moog_ladder_f32/f64(x, st_in, st_out, y, p0..p4, C, T, mode, os, stream)
# and moog_zdf_f32/f64(x, st_in, st_out, y, p0..p4, C, T, newton_iters, os,
# stream)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_double] * 5
             + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])
# moog_ladder_adjoint_f32/f64(x, st_in, gy, gst, dx, dst, ck, st_fin,
# p0..p4, C, T, mode, os, seg, stream), and moog_zdf_adjoint_* with
# newton_iters in mode's place
_ADJ_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_double] * 5
                 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

# The adjoint kernels' shared memory a block (one warp, 32 channels):
# per ladder step of a segment, the step's x and output cotangent and
# the values its reverse reads (LADDER_RECORD, `zdf_record`)
ADJ_SMEM_BYTES = 46 * 1024
ADJ_MAX_SEGMENT = 64
LADDER_RECORD = 9


def zdf_record(newton_iters: int) -> int:
    """Values a ZDF step keeps for its reverse: tanh of the four stages,
    four clip masks, four tanh a ladder pass (newton_iters + 1 passes),
    and each Newton update's Jacobian and step."""
    return 12 + 6 * newton_iters


def adjoint_plan(record: int, itemsize: int) -> int:
    """Steps a segment of the adjoint kernels holds in shared memory:
    as many as ADJ_SMEM_BYTES takes at `record` values a step (plus x
    and the cotangent), at most ADJ_MAX_SEGMENT."""
    per_step = (record + 2) * 32 * itemsize
    return max(1, min(ADJ_MAX_SEGMENT, ADJ_SMEM_BYTES // per_step))


def _clip(v):
    return torch.clamp(v, -STATE_LIMIT, STATE_LIMIT)


def _clip_mask(v):
    """d clip(v) / dv as `jnp.clip` takes it: 1 inside the bounds, 1/2 on
    them, 0 outside and for NaN."""
    a = torch.abs(v)
    return torch.where(a < STATE_LIMIT, 1.0, torch.where(a == STATE_LIMIT,
                                                         0.5, 0.0)).to(v.dtype)


def poly_tanh(x):
    """The lightweight variants' rational tanh (`pallas_kernels.py:363`)."""
    x2 = x * x
    return torch.where(x > 3, 1.0, torch.where(
        x < -3, -1.0, torch.clamp(x * (27 + x2) / (27 + 9 * x2), -1, 1)))


def _tanh_slope(z, t, fast: bool):
    """d tanh(z) / dz from t = tanh(z), or for `poly_tanh` from z:
    9 (z^2 - 9)^2 / (27 + 9 z^2)^2, 0 where |z| > 3 (NaN stays NaN)."""
    if not fast:
        return 1 - t * t
    z2 = z * z
    num = z2 - 9
    den = 27 + 9 * z2
    return torch.where((z > 3) | (z < -3), 0.0,
                       9 * num * num / (den * den)).to(z.dtype)


def _stuffed(x, os: int):
    """x zero-stuffed to os times its length, x * os on each first tick,
    as `MoogFilter.process` runs an oversampled ladder."""
    if os == 1:
        return x
    x_run = x.new_zeros(x.shape[:-1] + (x.shape[-1] * os,))
    x_run[..., ::os] = x * os
    return x_run


def moog_ladder_plain(x, state8, params, *, fast_tanh: bool,
                      huovilainen: bool, os: int = 1):
    """Plain PyTorch K5, one time step at a time (`moog.py:107-140`),
    over x zero-stuffed by `os`, keeping every os-th output."""
    st8, y, _ = _ladder_walk(x, state8, params, fast_tanh, huovilainen, os,
                             record=False)
    return st8, y


def _ladder_walk(x, state8, params, fast_tanh, huovilainen, os, record):
    """K5's plain walk; with `record`, also each step's LADDER_RECORD
    values for the reverse: coef ds tanh'(ds u), ds tanh'(ds s_i) of the
    new stages 0-2, 1 - coef ds tanh'(ds s3) of the old s3, and the four
    clip masks."""
    coef, ds, fb, ig, osc = (float(p) for p in params)
    x = _stuffed(x, os)
    fast = fast_tanh and not huovilainen
    tanh_fn = poly_tanh if fast else torch.tanh
    s0, s1, s2, s3, t0, t1, t2, prev = state8.to(x.dtype).unbind(0)
    ys, recs = [], []
    for i in range(x.shape[-1]):
        xv = x[..., i]
        if huovilainen:
            u = xv * ig - fb * (0.5 * (s3 + prev))
            ts0 = torch.tanh(ds * s0)
            ts1 = torch.tanh(ds * s1)
            ts2 = torch.tanh(ds * s2)
        else:
            u = xv * ig - fb * s3
            ts0, ts1, ts2 = t0, t1, t2
        zu, z3 = ds * u, ds * s3
        t_in = tanh_fn(zu)
        ts3 = tanh_fn(z3)
        v0 = s0 + coef * (t_in - ts0)
        s0 = _clip(v0)
        t0 = tanh_fn(ds * s0)
        v1 = s1 + coef * (t0 - ts1)
        s1 = _clip(v1)
        t1 = tanh_fn(ds * s1)
        v2 = s2 + coef * (t1 - ts2)
        s2 = _clip(v2)
        t2 = tanh_fn(ds * s2)
        v3 = s3 + coef * (t2 - ts3)
        if record:
            recs.append((
                coef * ds * _tanh_slope(zu, t_in, fast),
                ds * _tanh_slope(ds * s0, t0, fast),
                ds * _tanh_slope(ds * s1, t1, fast),
                ds * _tanh_slope(ds * s2, t2, fast),
                1 - coef * ds * _tanh_slope(z3, ts3, fast),
                _clip_mask(v0), _clip_mask(v1), _clip_mask(v2),
                _clip_mask(v3)))
        s3 = _clip(v3)
        prev = s3
        ys.append(osc * s3)
    return (torch.stack([s0, s1, s2, s3, t0, t1, t2, prev]),
            torch.stack(ys, -1)[..., os - 1::os], recs)


def _cotangent_ticks(gy, os: int, n: int, osc: float):
    """osc * gy on the last tick of each sample, 0 on the others: the
    output cotangent of each of the n ladder steps."""
    g = gy.new_zeros(gy.shape[:-1] + (n,))
    g[..., os - 1::os] = osc * gy
    return g


def moog_ladder_adjoint_plain(x, state8, params, gy, gstate8, *,
                              fast_tanh: bool, huovilainen: bool,
                              os: int = 1, return_state: bool = False):
    """Plain PyTorch reverse sweep of K5: the VJP of `moog_ladder_plain`
    (the reference's scan) at (x, state8) for the cotangents gy (C, T) of
    y and gstate8 (8, C) of the new state. Returns (dx (C, T), dstate8
    (8, C)), and the walk's final state8 with `return_state`.

    The walk records each step's LADDER_RECORD values; the sweep runs the
    steps backward with the carries g = d/d(s0..s3, t0..t2) of the state
    after the step, in the adjoint kernel's order:
      g_s3 += osc gy (last tick of a sample); gv3 = m3 g_s3;
      g_t2 += coef gv3; g_s2 += d2 g_t2; gv2 = m2 g_s2; ... ; gv0 = m0 g_s0;
      gu = cu gv0; dx_run = ig gu;
    and the state before the step takes g_si = gv_i (i < 3), g_ti = -coef
    gv_i, g_s3 = q3 gv3 + w (-fb gu), w = 1/2 for Huovilainen's first
    step (whose feedback is (s3 + prev) / 2) and 1 otherwise (the
    feedback is s3). dx = os dx_run on each first tick."""
    coef, ds, fb, ig, osc = (float(p) for p in params)
    st8, _, recs = _ladder_walk(x, state8, params, fast_tanh, huovilainen,
                                os, record=True)
    dtype = st8.dtype
    gst = gstate8.to(dtype)
    gys = _cotangent_ticks(gy.to(dtype), os, len(recs), osc)
    g_s = [gst[0], gst[1], gst[2], gst[3] + gst[7]]
    g_t = [gst[4], gst[5], gst[6]]
    dx_run = torch.empty_like(gys)
    g_prev = torch.zeros_like(gst[7])
    for i in range(len(recs) - 1, -1, -1):
        cu, d0, d1, d2, q3, m0, m1, m2, m3 = recs[i]
        g_s[3] = g_s[3] + gys[..., i]
        gv3 = m3 * g_s[3]
        g_t[2] = g_t[2] + coef * gv3
        g_s[2] = g_s[2] + d2 * g_t[2]
        gv2 = m2 * g_s[2]
        g_t[1] = g_t[1] + coef * gv2
        g_s[1] = g_s[1] + d1 * g_t[1]
        gv1 = m1 * g_s[1]
        g_t[0] = g_t[0] + coef * gv1
        g_s[0] = g_s[0] + d0 * g_t[0]
        gv0 = m0 * g_s[0]
        gu = cu * gv0
        dx_run[..., i] = ig * gu
        g_fb = -fb * gu
        half = huovilainen and i == 0
        g_s = [gv0, gv1, gv2, q3 * gv3 + (0.5 * g_fb if half else g_fb)]
        g_t = [-coef * gv0, -coef * gv1, -coef * gv2]
        if half:
            g_prev = 0.5 * g_fb
    s_in = state8.to(dtype)
    if huovilainen:
        # its first step takes tanh(ds s_i) of the stages, not rows 4-6
        for j in range(3):
            t = torch.tanh(ds * s_in[j])
            g_s[j] = g_s[j] + g_t[j] * (ds * (1 - t * t))
        g_t = [torch.zeros_like(v) for v in g_t]
    out = (os * dx_run[..., ::os], torch.stack(g_s + g_t + [g_prev]))
    return out + (st8,) if return_state else out


def moog_zdf_plain(x, state8, params, *, newton_iters: int, os: int = 1):
    """Plain PyTorch K6, one time step at a time (`moog.py:142-183`),
    over x zero-stuffed by `os`, keeping every os-th output."""
    st8, y, _ = _zdf_walk(x, state8, params, newton_iters, os, record=False)
    return st8, y


def _zdf_walk(x, state8, params, newton_iters, os, record):
    """K6's plain walk; with `record`, also each step's values for the
    reverse: (ts (tanh of the four old stages), masks (the four clips),
    passes (newton_iters times (ty, J, q): a pass's four tanh, its
    Jacobian and its Newton step), ty of the last pass)."""
    gk, shape, k, ig, osc = (float(p) for p in params)
    x = _stuffed(x, os)
    v_scale = gk / shape
    st = state8.to(x.dtype)
    s = list(st[:4].unbind(0))
    prev = st[7]
    ys, recs = [], []
    for i in range(x.shape[-1]):
        inp = x[..., i] * ig
        ts = [torch.tanh(shape * si) for si in s]

        def ladder(y3est):
            tu = torch.tanh(shape * (inp - k * y3est))
            v0 = v_scale * (tu - ts[0])
            d0 = gk * (1 - tu * tu)
            ty0 = torch.tanh(shape * (v0 + s[0]))
            v1 = v_scale * (ty0 - ts[1])
            d1 = gk * (1 - ty0 * ty0)
            ty1 = torch.tanh(shape * (v1 + s[1]))
            v2 = v_scale * (ty1 - ts[2])
            d2 = gk * (1 - ty1 * ty1)
            ty2 = torch.tanh(shape * (v2 + s[2]))
            v3 = v_scale * (ty2 - ts[3])
            d3 = gk * (1 - ty2 * ty2)
            return ((v0, v1, v2, v3), v3 + s[3], d0 * d1 * d2 * d3,
                    (tu, ty0, ty1, ty2))

        y3est = prev
        passes = []
        for _ in range(newton_iters):
            _, y3, dprod, ty = ladder(y3est)
            jac = dprod * (-k) - 1.0
            flat = torch.abs(jac) < 1e-15
            q = (y3 - y3est) / torch.where(flat, 1.0, jac)
            y3est = torch.where(flat, y3est, y3est - q)
            passes.append((ty, jac, q))
        v, y3, _, ty = ladder(y3est)
        w = [si + 2 * vi for si, vi in zip(s, v)]
        if record:
            recs.append((ts, [_clip_mask(wi) for wi in w], passes, ty))
        s = [_clip(wi) for wi in w]
        prev = y3
        ys.append(osc * y3)
    return (torch.stack(s + [st[4], st[5], st[6], prev]),
            torch.stack(ys, -1)[..., os - 1::os], recs)


def _zdf_pass_reverse(shape, vs, k, ty, gv, g_ty, g_s, g_ts):
    """Reverse of one ZDF ladder pass at its four tanh ty, given the
    cotangents gv of v0..v3 and g_ty added to the tanh (from the
    Jacobian); adds to g_s and g_ts in place. Returns (d/d inp,
    d/d y3est): ty_{i+1} = tanh(shape (vs (ty_i - ts_i) + s_i)),
    ty_0 = tanh(shape (inp - k y3est))."""
    gt = vs * gv[3] + g_ty[3]
    g_ts[3] = g_ts[3] - vs * gv[3]
    for i in (3, 2, 1):
        gyy = gt * (shape * (1 - ty[i] * ty[i]))
        g_s[i - 1] = g_s[i - 1] + gyy
        gvv = gv[i - 1] + gyy
        g_ts[i - 1] = g_ts[i - 1] - vs * gvv
        gt = vs * gvv + g_ty[i - 1]
    gz = gt * (shape * (1 - ty[0] * ty[0]))
    return gz, -k * gz


def moog_zdf_adjoint_plain(x, state8, params, gy, gstate8, *,
                           newton_iters: int, os: int = 1,
                           return_state: bool = False):
    """Plain PyTorch reverse sweep of K6: the VJP of `moog_zdf_plain` (the
    reference's scan, its Newton loop unrolled) at (x, state8) for the
    cotangents gy (C, T) and gstate8 (8, C). Returns (dx (C, T),
    dstate8 (8, C)), and the walk's final state8 with `return_state`.

    Per step, backward: the clips (g_si = m_i g_Si, gv_i = 2 m_i g_Si),
    y3 = v3 + s3 (its cotangent g_prev + osc gy), the last pass; then
    each Newton update y3est' = y3est - q, q = (y3 - y3est) / J,
    J = -k prod_i gk (1 - ty_i^2) - 1, skipped where |J| < 1e-15 (the
    estimate was kept): g_q = -g_e, g_r = g_q / J, g_J = -g_q q / J,
    g_e -= g_r, and its pass reversed with gv3 = g_r and the Jacobian's
    g_ty_i = -k g_J prod_{j != i} D_j (-2 gk ty_i). The stages' tanh
    ts_i collect g_ts, which reach the stages through shape (1 - ts_i^2);
    g_e is the cotangent of the previous step's y3 (prev)."""
    gk, shape, k, ig, osc = (float(p) for p in params)
    vs = gk / shape
    st8, _, recs = _zdf_walk(x, state8, params, newton_iters, os,
                             record=True)
    dtype = st8.dtype
    gst = gstate8.to(dtype)
    gys = _cotangent_ticks(gy.to(dtype), os, len(recs), osc)
    g_S = [gst[0], gst[1], gst[2], gst[3]]
    g_p = gst[7]
    dx_run = torch.empty_like(gys)
    zero = torch.zeros_like(g_p)
    for i in range(len(recs) - 1, -1, -1):
        ts, masks, passes, ty = recs[i]
        gy3 = g_p + gys[..., i]
        g_s = [m * g for m, g in zip(masks, g_S)]
        gv = [2 * g for g in g_s]
        gv[3] = gv[3] + gy3
        g_s[3] = g_s[3] + gy3
        g_ts = [zero] * 4
        g_inp, g_e = _zdf_pass_reverse(shape, vs, k, ty, gv, [zero] * 4, g_s,
                                       g_ts)
        for ty_p, jac, q in reversed(passes):
            flat = torch.abs(jac) < 1e-15
            g_q = -g_e
            g_r = torch.where(flat, 0.0, g_q / jac).to(dtype)
            g_j = torch.where(flat, 0.0, -g_q * q / jac).to(dtype)
            g_e = g_e - g_r
            g_dprod = -k * g_j
            d = [gk * (1 - t * t) for t in ty_p]
            others = [d[1] * d[2] * d[3], d[0] * d[2] * d[3],
                      d[0] * d[1] * d[3], d[0] * d[1] * d[2]]
            g_ty = [g_dprod * o * (-2 * gk * t) for o, t in zip(others, ty_p)]
            g_s[3] = g_s[3] + g_r
            gi, ge = _zdf_pass_reverse(shape, vs, k, ty_p,
                                       [zero, zero, zero, g_r], g_ty, g_s,
                                       g_ts)
            g_inp = g_inp + gi
            g_e = g_e + ge
        g_S = [g + gt * (shape * (1 - t * t))
               for g, gt, t in zip(g_s, g_ts, ts)]
        g_p = g_e
        dx_run[..., i] = ig * g_inp
    out = (os * dx_run[..., ::os],
           torch.stack(g_S + [gst[4], gst[5], gst[6], g_p]))
    return out + (st8,) if return_state else out


def _check(name, x, state8, params, os):
    if x.ndim != 2 or x.shape[-1] < 1:
        raise ValueError(f"{name}: x must be (C, T) with T >= 1, got "
                         f"{tuple(x.shape)}")
    if not isinstance(os, int) or os < 1:
        raise ValueError(f"{name}: os must be an integer >= 1, got {os!r}")
    if tuple(state8.shape) != (8, x.shape[0]):
        raise ValueError(f"{name}: state8 must be (8, {x.shape[0]}), got "
                         f"{tuple(state8.shape)}")
    if len(params) != 5:
        raise ValueError(f"{name}: takes 5 parameters, got {len(params)}")


def _check_newton(name, newton_iters):
    if not 1 <= newton_iters <= MAX_NEWTON_ITERS:
        raise ValueError(f"{name}: newton_iters must be in [1, "
                         f"{MAX_NEWTON_ITERS}], got {newton_iters}")


def _entry(name, symbol, x, argtypes, tensors):
    """The kernel entry `symbol` of csrc/moog.cu for x's type, after
    checking that every tensor of `tensors` ((label, tensor, shape)) is a
    contiguous tensor of x's type on x's device."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _SUFFIX or not x.is_contiguous():
        raise ValueError(f"{name}: the kernel takes contiguous float32 or "
                         f"float64, got {x.dtype}")
    fn = _build.entry("moog", f"{symbol}_{_SUFFIX[x.dtype]}", argtypes)
    for label, v, shape in tensors:
        if (tuple(v.shape) != shape or v.dtype != x.dtype
                or v.device != x.device or not v.is_contiguous()):
            raise ValueError(f"{name}: {label} must be a contiguous "
                             f"{x.dtype} {shape} tensor on {x.device}")
    return fn


def _launch(name, symbol, x, state8, params, last_arg, os):
    """Run kernel `symbol` of csrc/moog.cu on CUDA tensors; returns
    (new state8, y)."""
    c, t = x.shape
    fn = _entry(name, symbol, x, _ARGTYPES, [("state8", state8, (8, c))])
    y = torch.empty_like(x)
    st_out = torch.empty_like(state8)
    with torch.cuda.device(x.device):
        code = fn(_build.ptr(x), _build.ptr(state8), _build.ptr(st_out),
                  _build.ptr(y), *(float(p) for p in params), c, t, last_arg,
                  os, _build.stream_of(x))
    _build.check("moog", code, name)
    return st_out, y


def _launch_adjoint(name, symbol, x, state8, params, gy, gstate8, last_arg,
                    os, record, return_state):
    """Run adjoint kernel `symbol` of csrc/moog.cu on CUDA tensors, with
    its checkpoint scratch (one state8 every segment of
    `adjoint_plan(record, ...)` steps); returns (dx, dstate8), and the
    recomputed final state8 with `return_state`."""
    c, t = x.shape
    fn = _entry(name, symbol, x, _ADJ_ARGTYPES,
                [("state8", state8, (8, c)), ("gy", gy, (c, t)),
                 ("gstate8", gstate8, (8, c))])
    seg = adjoint_plan(record, x.element_size())
    scratch = torch.empty(((t * os + seg - 1) // seg, 8, c), dtype=x.dtype,
                          device=x.device)
    dx = torch.empty_like(x)
    dst = torch.empty_like(state8)
    st_fin = torch.empty_like(state8) if return_state else None
    with torch.cuda.device(x.device):
        code = fn(_build.ptr(x), _build.ptr(state8), _build.ptr(gy),
                  _build.ptr(gstate8), _build.ptr(dx), _build.ptr(dst),
                  _build.ptr(scratch),
                  ctypes.c_void_p(0 if st_fin is None else st_fin.data_ptr()),
                  *(float(p) for p in params), c, t, last_arg, os, seg,
                  _build.stream_of(x))
    _build.check("moog", code, name)
    return (dx, dst, st_fin) if return_state else (dx, dst)


def _ladder(x, state8, params, fast_tanh, huovilainen, os):
    """K5 for a CUDA tensor, the plain version for a CPU one."""
    if x.device.type == "cpu":
        return moog_ladder_plain(x, state8, params, fast_tanh=fast_tanh,
                                 huovilainen=huovilainen, os=os)
    mode = 2 if huovilainen else int(bool(fast_tanh))
    out = _launch("moog_ladder", "moog_ladder", x, state8, params, mode, os)
    moog_ladder.launches += 1
    return out


def _zdf(x, state8, params, newton_iters, os):
    """K6 for a CUDA tensor, the plain version for a CPU one."""
    if x.device.type == "cpu":
        return moog_zdf_plain(x, state8, params, newton_iters=newton_iters,
                              os=os)
    out = _launch("moog_zdf", "moog_zdf", x, state8, params,
                  int(newton_iters), os)
    moog_zdf.launches += 1
    return out


def moog_ladder_adjoint(x, state8, params, gy, gstate8, *,
                        fast_tanh: bool = False, huovilainen: bool = False,
                        os: int = 1, return_state: bool = False):
    """K5's adjoint (`moog_ladder_adjoint_plain`'s function): (dx, dstate8)
    for the cotangents gy (C, T) and gstate8 (8, C), and with
    `return_state` the final state8 the adjoint's own walk recomputed
    (the forward's, bit for bit, on the card). CUDA tensors run the
    kernel (float32 or float64, contiguous), CPU tensors the plain
    reverse sweep. `launches` counts the kernel's launches."""
    _check("moog_ladder_adjoint", x, state8, params, os)
    if x.device.type == "cpu":
        return moog_ladder_adjoint_plain(
            x, state8, params, gy, gstate8, fast_tanh=fast_tanh,
            huovilainen=huovilainen, os=os, return_state=return_state)
    mode = 2 if huovilainen else int(bool(fast_tanh))
    out = _launch_adjoint("moog_ladder_adjoint", "moog_ladder_adjoint", x,
                          state8, params, gy, gstate8, mode, os,
                          LADDER_RECORD, return_state)
    moog_ladder_adjoint.launches += 1
    return out


moog_ladder_adjoint.launches = 0


def moog_zdf_adjoint(x, state8, params, gy, gstate8, *, newton_iters: int = 4,
                     os: int = 1, return_state: bool = False):
    """K6's adjoint (`moog_zdf_adjoint_plain`'s function), as
    `moog_ladder_adjoint`. `launches` counts the kernel's launches."""
    _check("moog_zdf_adjoint", x, state8, params, os)
    _check_newton("moog_zdf_adjoint", newton_iters)
    if x.device.type == "cpu":
        return moog_zdf_adjoint_plain(x, state8, params, gy, gstate8,
                                      newton_iters=newton_iters, os=os,
                                      return_state=return_state)
    out = _launch_adjoint("moog_zdf_adjoint", "moog_zdf_adjoint", x, state8,
                          params, gy, gstate8, int(newton_iters), os,
                          zdf_record(newton_iters), return_state)
    moog_zdf_adjoint.launches += 1
    return out


moog_zdf_adjoint.launches = 0


class MoogLadderFn(torch.autograd.Function):
    """(new state8, y) of K5 over (x, state8), differentiable in both (the
    reference's `_kernel_chunk_diff`). It saves its inputs only, as the
    reference does; the backward's adjoint recomputes the trajectory. A
    cotangent that autograd leaves out arrives as zeros."""

    @staticmethod
    def forward(ctx, x, state8, params, fast_tanh, huovilainen, os):
        out = _ladder(x, state8, params, fast_tanh, huovilainen, os)
        ctx.save_for_backward(x, state8)
        ctx.args = (params, fast_tanh, huovilainen, os)
        return out

    @staticmethod
    def backward(ctx, g_state8, g_y):
        x, state8 = ctx.saved_tensors
        params, fast_tanh, huovilainen, os = ctx.args
        dx, dst = moog_ladder_adjoint(
            x, state8, params, g_y.contiguous(), g_state8.contiguous(),
            fast_tanh=fast_tanh, huovilainen=huovilainen, os=os)
        return dx, dst, None, None, None, None


class MoogZDFFn(torch.autograd.Function):
    """(new state8, y) of K6 over (x, state8), as `MoogLadderFn`."""

    @staticmethod
    def forward(ctx, x, state8, params, newton_iters, os):
        out = _zdf(x, state8, params, newton_iters, os)
        ctx.save_for_backward(x, state8)
        ctx.args = (params, newton_iters, os)
        return out

    @staticmethod
    def backward(ctx, g_state8, g_y):
        x, state8 = ctx.saved_tensors
        params, newton_iters, os = ctx.args
        dx, dst = moog_zdf_adjoint(x, state8, params, g_y.contiguous(),
                                   g_state8.contiguous(),
                                   newton_iters=newton_iters, os=os)
        return dx, dst, None, None, None


def moog_ladder(x, state8, params, *, fast_tanh: bool = False,
                huovilainen: bool = False, os: int = 1):
    """K5 over x (C, T) at oversampling `os`: returns (new state8 (8, C),
    y (C, T)), differentiable in x and state8 (`MoogLadderFn`).
    params = [coef, drive_scale, feedback, input_gain, output_scale].
    CUDA tensors run the kernels; CPU tensors run `moog_ladder_plain` and
    `moog_ladder_adjoint_plain`. The Huovilainen ladder always takes the
    exact tanh."""
    _check("moog_ladder", x, state8, params, os)
    return MoogLadderFn.apply(x, state8, list(params), bool(fast_tanh),
                              bool(huovilainen), os)


moog_ladder.launches = 0


def moog_zdf(x, state8, params, *, newton_iters: int = 4, os: int = 1):
    """K6 over x (C, T) at oversampling `os`: returns (new state8 (8, C),
    y (C, T)), differentiable in x and state8 (`MoogZDFFn`).
    params = [zdf_gk, drive_scale, feedback, input_gain, output_scale].
    CUDA tensors run the kernels; CPU tensors run `moog_zdf_plain` and
    `moog_zdf_adjoint_plain`."""
    _check("moog_zdf", x, state8, params, os)
    _check_newton("moog_zdf", newton_iters)
    return MoogZDFFn.apply(x, state8, list(params), int(newton_iters), os)


moog_zdf.launches = 0
