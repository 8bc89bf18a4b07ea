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
VJP of the per-sample scan over the zero-stuffed input. Two routes
compute that backward, to the same bits:
- the record route, where the call's record fits RECORD_BUDGET_BYTES:
  the forward under autograd runs the recording instance of the kernel
  (`moog_ladder_record` / `moog_zdf_record`), which also stores each
  ladder step's values for the reverse, in the layout `record_shape`
  gives; the backward is one reverse sweep over them
  (`moog_ladder_reverse` / `moog_zdf_reverse`);
- the checkpoint route, for a larger record: the forward saves (x,
  state8) only, and the backward's adjoint kernel (`moog_ladder_adjoint`
  / `moog_zdf_adjoint`) walks the forward again from checkpoints.
CUDA tensors (float32 or float64) launch the kernels; CPU tensors use the
plain versions: `moog_ladder_plain` / `moog_zdf_plain`, a per-sample loop
over the step functions of `algodsp_tpu/filters/moog.py` (with
`record`, also the record), `moog_ladder_reverse_plain` /
`moog_zdf_reverse_plain`, explicit reverse sweeps over a record written
to the kernels' formulas, and `moog_*_adjoint_plain`, the walk and the
sweep in one call.

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
# moog_ladder_f32/f64(x, st_in, st_out, y, rec, p0..p4, C, T, mode, os,
# stream) and moog_zdf_f32/f64 with newton_iters in mode's place; rec
# null runs K5 / K6, otherwise their recording instance
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_double] * 5
             + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])
# moog_ladder_adjoint_f32/f64(x, st_in, gy, gst, dx, dst, ck, st_fin,
# p0..p4, C, T, mode, os, seg, stream), and moog_zdf_adjoint_* with
# newton_iters in mode's place
_ADJ_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_double] * 5
                 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
# moog_ladder_reverse_f32/f64(rec, st_in, gy, gst, dx, dst, p0..p4, C, T,
# mode, os, stream), and moog_zdf_reverse_* with newton_iters in mode's
# place
_REV_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_double] * 5
                 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p])
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

# The adjoint kernels' shared memory a block (one warp, 32 channels):
# per ladder step of a segment, the step's x and output cotangent and
# the values its reverse reads (LADDER_RECORD, `zdf_record`)
ADJ_SMEM_BYTES = 46 * 1024
ADJ_MAX_SEGMENT = 64
LADDER_RECORD = 9
# The largest record one call keeps for its backward; a call whose record
# would be larger takes the checkpoint route. 4 GiB is 1/20 of an H100's
# 80 GB, so a graph of a few such calls fits beside its activations, and
# it holds the largest record the paths make: 128 x 2^16 ZDF at newton 8
# (2.0 GB; the chain block's is 4.7 MB). The reference keeps a chunk's
# per-step residuals whatever their size.
RECORD_BUDGET_BYTES = 4 << 30
_LANES = 32


ZDF_UPDATE = 6


def zdf_record(newton_iters: int) -> int:
    """Values a ZDF step keeps for its reverse: tanh of the four stages,
    four clip masks, four tanh a ladder pass (newton_iters + 1 passes),
    and each Newton update's Jacobian and step (ZDF_UPDATE values an
    update with its pass's tanh)."""
    return 12 + ZDF_UPDATE * newton_iters


def record_shape(c: int, t: int, os: int, nv: int) -> tuple:
    """The record's layout: (ceil(C / 32) blocks of 32 channels, T * os
    steps, nv values, 32 lanes), so one block's record is contiguous and
    step-major, and value v of step k of channel c is at
    [c // 32, k, v, c % 32] (the lanes past C are padding)."""
    return (-(-c // _LANES), t * os, nv, _LANES)


def record_bytes(c: int, t: int, os: int, nv: int, itemsize: int) -> int:
    """Bytes of the record of one call (padding lanes included)."""
    b, k, v, w = record_shape(c, t, os, nv)
    return b * k * v * w * itemsize


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
                      huovilainen: bool, os: int = 1, record: bool = False):
    """Plain PyTorch K5, one time step at a time (`moog.py:107-140`),
    over x zero-stuffed by `os`, keeping every os-th output. With
    `record`, returns (new state8, y, record) as the recording kernel
    does (`record_shape`, the LADDER_RECORD values of `_ladder_walk`)."""
    st8, y, recs = _ladder_walk(x, state8, params, fast_tanh, huovilainen,
                                os, record)
    return (st8, y, _pack_record(recs, x.shape[0])) if record else (st8, y)


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


def _pack_record(recs, c: int):
    """A plain walk's record (per step, a tuple of nv (C,) tensors) in the
    kernels' layout (`record_shape`), padding lanes 0."""
    vals = torch.stack([torch.stack(r) for r in recs])      # (steps, nv, C)
    steps, nv, _ = vals.shape
    nb = -(-c // _LANES)
    out = vals.new_zeros(steps, nv, nb * _LANES)
    out[..., :c] = vals
    return out.reshape(steps, nv, nb, _LANES).permute(2, 0, 1, 3).contiguous()


def _record_steps(record, c: int):
    """The record (`record_shape`) as (steps, nv, C)."""
    nb, steps, nv, w = record.shape
    return record.permute(1, 2, 0, 3).reshape(steps, nv, nb * w)[..., :c]


def _cotangent_ticks(gy, os: int, n: int, osc: float):
    """osc * gy on the last tick of each sample, 0 on the others: the
    output cotangent of each of the n ladder steps."""
    g = gy.new_zeros(gy.shape[:-1] + (n,))
    g[..., os - 1::os] = osc * gy
    return g


def moog_ladder_reverse_plain(record, state8, params, gy, gstate8, *,
                              fast_tanh: bool, huovilainen: bool,
                              os: int = 1):
    """Plain PyTorch reverse sweep of K5 over its record (`record_shape`,
    as `moog_ladder_plain(..., record=True)` or the recording kernel
    writes it) of the walk from state8: (dx (C, T), dstate8 (8, C)) for
    the cotangents gy (C, T) of y and gstate8 (8, C) of the new state.

    The sweep runs the steps backward with the carries g = d/d(s0..s3,
    t0..t2) of the state after the step, in the reverse kernels' order:
      g_s3 += osc gy (last tick of a sample); gv3 = m3 g_s3;
      g_t2 += coef gv3; g_s2 += d2 g_t2; gv2 = m2 g_s2; ... ; gv0 = m0 g_s0;
      gu = cu gv0; dx_run = ig gu;
    and the state before the step takes g_si = gv_i (i < 3), g_ti = -coef
    gv_i, g_s3 = q3 gv3 + w (-fb gu), w = 1/2 for Huovilainen's first
    step (whose feedback is (s3 + prev) / 2) and 1 otherwise (the
    feedback is s3). dx = os dx_run on each first tick."""
    del fast_tanh   # the record holds the tanh slopes of either tanh
    coef, ds, fb, ig, osc = (float(p) for p in params)
    dtype = record.dtype
    recs = _record_steps(record, state8.shape[1])
    gst = gstate8.to(dtype)
    gys = _cotangent_ticks(gy.to(dtype), os, recs.shape[0], osc)
    g_s = [gst[0], gst[1], gst[2], gst[3] + gst[7]]
    g_t = [gst[4], gst[5], gst[6]]
    dx_run = torch.empty_like(gys)
    g_prev = torch.zeros_like(gst[7])
    for i in range(recs.shape[0] - 1, -1, -1):
        cu, d0, d1, d2, q3, m0, m1, m2, m3 = recs[i].unbind(0)
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
    return os * dx_run[..., ::os], torch.stack(g_s + g_t + [g_prev])


def moog_ladder_adjoint_plain(x, state8, params, gy, gstate8, *,
                              fast_tanh: bool, huovilainen: bool,
                              os: int = 1, return_state: bool = False):
    """Plain PyTorch VJP of `moog_ladder_plain` (the reference's scan) at
    (x, state8) for the cotangents gy (C, T) and gstate8 (8, C): the
    recording walk and `moog_ladder_reverse_plain` in one call. Returns
    (dx (C, T), dstate8 (8, C)), and the walk's final state8 with
    `return_state`."""
    st8, _, rec = moog_ladder_plain(x, state8, params, fast_tanh=fast_tanh,
                                    huovilainen=huovilainen, os=os,
                                    record=True)
    out = moog_ladder_reverse_plain(rec, state8, params, gy, gstate8,
                                    fast_tanh=fast_tanh,
                                    huovilainen=huovilainen, os=os)
    return out + (st8,) if return_state else out


def moog_zdf_plain(x, state8, params, *, newton_iters: int, os: int = 1,
                   record: bool = False):
    """Plain PyTorch K6, one time step at a time (`moog.py:142-183`),
    over x zero-stuffed by `os`, keeping every os-th output. With
    `record`, returns (new state8, y, record) as the recording kernel
    does (`record_shape`, the `zdf_record` values of `_zdf_walk`)."""
    st8, y, recs = _zdf_walk(x, state8, params, newton_iters, os, record)
    return (st8, y, _pack_record(recs, x.shape[0])) if record else (st8, y)


def _zdf_walk(x, state8, params, newton_iters, os, record):
    """K6's plain walk; with `record`, also each step's `zdf_record`
    values for the reverse, in the kernels' order: 0-3 the tanh of the
    four old stages, 4-7 the four clip masks, 8 + 6 it + (0-3, 4, 5) the
    four tanh, the Jacobian and the step of Newton iteration it, and
    8 + 6 newton_iters + (0-3) the four tanh of the last pass."""
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
            passes += [*ty, jac, q]
        v, y3, _, ty = ladder(y3est)
        w = [si + 2 * vi for si, vi in zip(s, v)]
        if record:
            recs.append((*ts, *(_clip_mask(wi) for wi in w), *passes, *ty))
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


def moog_zdf_reverse_plain(record, state8, params, gy, gstate8, *,
                           newton_iters: int, os: int = 1):
    """Plain PyTorch reverse sweep of K6 over its record (`record_shape`,
    as `moog_zdf_plain(..., record=True)` or the recording kernel writes
    it) for the cotangents gy (C, T) and gstate8 (8, C). Returns (dx
    (C, T), dstate8 (8, C)); state8 gives only C (ZDF's reverse reads
    none of it).

    Per step, backward: the clips (g_si = m_i g_Si, gv_i = 2 m_i g_Si),
    y3 = v3 + s3 (its cotangent g_prev + osc gy), the last pass; then
    each Newton update y3est' = y3est - q, q = (y3 - y3est) / J,
    J = -k prod_i gk (1 - ty_i^2) - 1, skipped where |J| < 1e-15 (the
    estimate was kept): g_q = -g_e, g_r = g_q / J, g_J = -g_q q / J,
    g_e -= g_r, and its pass reversed with gv3 = g_r and the Jacobian's
    g_ty_i = -k g_J prod_{j != i} D_j (-2 gk ty_i). The stages' tanh
    ts_i collect g_ts, which reach the stages through shape (1 - ts_i^2);
    g_e is the cotangent of the previous step's y3 (prev). The quotients
    by J are divisions (the reverse kernel forms them from 1 / J, to the
    same rounding where nothing over- or underflows)."""
    gk, shape, k, ig, osc = (float(p) for p in params)
    vs = gk / shape
    dtype = record.dtype
    recs = _record_steps(record, state8.shape[1])
    if recs.shape[1] != zdf_record(newton_iters):
        raise ValueError(f"moog_zdf_reverse_plain: a record of "
                         f"{recs.shape[1]} values a step is not that of "
                         f"{newton_iters} Newton iterations")
    gst = gstate8.to(dtype)
    gys = _cotangent_ticks(gy.to(dtype), os, recs.shape[0], osc)
    g_S = [gst[0], gst[1], gst[2], gst[3]]
    g_p = gst[7]
    dx_run = torch.empty_like(gys)
    zero = torch.zeros_like(g_p)
    for i in range(recs.shape[0] - 1, -1, -1):
        r = recs[i].unbind(0)
        ts, masks = r[:4], r[4:8]
        ty = r[8 + ZDF_UPDATE * newton_iters:]
        gy3 = g_p + gys[..., i]
        g_s = [m * g for m, g in zip(masks, g_S)]
        gv = [2 * g for g in g_s]
        gv[3] = gv[3] + gy3
        g_s[3] = g_s[3] + gy3
        g_ts = [zero] * 4
        g_inp, g_e = _zdf_pass_reverse(shape, vs, k, ty, gv, [zero] * 4, g_s,
                                       g_ts)
        for it in range(newton_iters - 1, -1, -1):
            u = 8 + ZDF_UPDATE * it
            ty_p, jac, q = r[u:u + 4], r[u + 4], r[u + 5]
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
    return (os * dx_run[..., ::os],
            torch.stack(g_S + [gst[4], gst[5], gst[6], g_p]))


def moog_zdf_adjoint_plain(x, state8, params, gy, gstate8, *,
                           newton_iters: int, os: int = 1,
                           return_state: bool = False):
    """Plain PyTorch VJP of `moog_zdf_plain` (the reference's scan, its
    Newton loop unrolled) at (x, state8) for the cotangents gy (C, T) and
    gstate8 (8, C): the recording walk and `moog_zdf_reverse_plain` in
    one call. Returns (dx (C, T), dstate8 (8, C)), and the walk's final
    state8 with `return_state`."""
    st8, _, rec = moog_zdf_plain(x, state8, params,
                                 newton_iters=newton_iters, os=os,
                                 record=True)
    out = moog_zdf_reverse_plain(rec, state8, params, gy, gstate8,
                                 newton_iters=newton_iters, os=os)
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


def _check_record(name, record, gy, os, nv):
    want = record_shape(gy.shape[0], gy.shape[1], os, nv)
    if tuple(record.shape) != want:
        raise ValueError(f"{name}: record must be {want} (record_shape), "
                         f"got {tuple(record.shape)}")


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


def _launch(name, symbol, x, state8, params, last_arg, os, nv=0):
    """Run kernel `symbol` of csrc/moog.cu on CUDA tensors; returns (new
    state8, y), and with nv > 0 its recording instance's record too
    (`record_shape`, nv values a step)."""
    c, t = x.shape
    fn = _entry(name, symbol, x, _ARGTYPES, [("state8", state8, (8, c))])
    y = torch.empty_like(x)
    st_out = torch.empty_like(state8)
    rec = (torch.empty(record_shape(c, t, os, nv), dtype=x.dtype,
                       device=x.device) if nv else None)
    with torch.cuda.device(x.device):
        code = fn(_build.ptr(x), _build.ptr(state8), _build.ptr(st_out),
                  _build.ptr(y), ctypes.c_void_p(0 if rec is None
                                                 else rec.data_ptr()),
                  *(float(p) for p in params), c, t, last_arg, os,
                  _build.stream_of(x))
    _build.check("moog", code, name)
    return (st_out, y, rec) if nv else (st_out, y)


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


def _launch_reverse(name, symbol, record, state8, params, gy, gstate8,
                    last_arg, os, nv):
    """Run reverse kernel `symbol` of csrc/moog.cu on CUDA tensors over
    `record` (`record_shape`, nv values a step); returns (dx, dstate8)."""
    c, t = gy.shape
    fn = _entry(name, symbol, gy, _REV_ARGTYPES,
                [("record", record, record_shape(c, t, os, nv)),
                 ("state8", state8, (8, c)), ("gstate8", gstate8, (8, c))])
    if record.data_ptr() % 16:
        raise ValueError(f"{name}: the record must be 16-byte aligned (its "
                         f"stages are read by bulk copies)")
    dx = torch.empty_like(gy)
    dst = torch.empty_like(gstate8)
    with torch.cuda.device(gy.device):
        code = fn(_build.ptr(record), _build.ptr(state8), _build.ptr(gy),
                  _build.ptr(gstate8), _build.ptr(dx), _build.ptr(dst),
                  *(float(p) for p in params), c, t, last_arg, os,
                  _build.stream_of(gy))
    _build.check("moog", code, name)
    return dx, dst


def _ladder(x, state8, params, fast_tanh, huovilainen, os, record=False):
    """K5 (its recording instance with `record`) for a CUDA tensor, the
    plain version for a CPU one."""
    if x.device.type == "cpu":
        return moog_ladder_plain(x, state8, params, fast_tanh=fast_tanh,
                                 huovilainen=huovilainen, os=os,
                                 record=record)
    mode = 2 if huovilainen else int(bool(fast_tanh))
    out = _launch("moog_ladder", "moog_ladder", x, state8, params, mode, os,
                  LADDER_RECORD if record else 0)
    moog_ladder.launches += 1
    moog_ladder.record_launches += int(record)
    return out


def _zdf(x, state8, params, newton_iters, os, record=False):
    """K6 (its recording instance with `record`) for a CUDA tensor, the
    plain version for a CPU one."""
    if x.device.type == "cpu":
        return moog_zdf_plain(x, state8, params, newton_iters=newton_iters,
                              os=os, record=record)
    out = _launch("moog_zdf", "moog_zdf", x, state8, params,
                  int(newton_iters), os,
                  zdf_record(newton_iters) if record else 0)
    moog_zdf.launches += 1
    moog_zdf.record_launches += int(record)
    return out


def moog_ladder_record(x, state8, params, *, fast_tanh: bool = False,
                       huovilainen: bool = False, os: int = 1):
    """K5's recording instance, not differentiable: (new state8, y,
    record), y and the state bit-equal to K5's, the record in the layout
    of `record_shape` (LADDER_RECORD values a step) for
    `moog_ladder_reverse`. CPU tensors run the plain walk. Counted in
    `moog_ladder.launches` and `.record_launches`."""
    _check("moog_ladder_record", x, state8, params, os)
    return _ladder(x, state8, params, fast_tanh, huovilainen, os,
                   record=True)


def moog_zdf_record(x, state8, params, *, newton_iters: int = 4,
                    os: int = 1):
    """K6's recording instance, as `moog_ladder_record` (`zdf_record`
    values a step)."""
    _check("moog_zdf_record", x, state8, params, os)
    _check_newton("moog_zdf_record", newton_iters)
    return _zdf(x, state8, params, newton_iters, os, record=True)


def moog_ladder_reverse(record, state8, params, gy, gstate8, *,
                        fast_tanh: bool = False, huovilainen: bool = False,
                        os: int = 1):
    """The reverse sweep of K5 over its record (`moog_ladder_record`'s)
    of the walk from state8: (dx, dstate8) for the cotangents gy (C, T)
    and gstate8 (8, C), bit for bit those of `moog_ladder_adjoint` on the
    card. CUDA tensors run the kernel, CPU tensors
    `moog_ladder_reverse_plain`. `launches` counts the kernel's
    launches."""
    _check("moog_ladder_reverse", gy, state8, params, os)
    _check_record("moog_ladder_reverse", record, gy, os, LADDER_RECORD)
    if gy.device.type == "cpu":
        return moog_ladder_reverse_plain(
            record, state8, params, gy, gstate8, fast_tanh=fast_tanh,
            huovilainen=huovilainen, os=os)
    mode = 2 if huovilainen else int(bool(fast_tanh))
    out = _launch_reverse("moog_ladder_reverse", "moog_ladder_reverse",
                          record, state8, params, gy, gstate8, mode, os,
                          LADDER_RECORD)
    moog_ladder_reverse.launches += 1
    return out


moog_ladder_reverse.launches = 0


def moog_zdf_reverse(record, state8, params, gy, gstate8, *,
                     newton_iters: int = 4, os: int = 1):
    """The reverse sweep of K6 over its record (`moog_zdf_record`'s), as
    `moog_ladder_reverse`. `launches` counts the kernel's launches."""
    _check("moog_zdf_reverse", gy, state8, params, os)
    _check_newton("moog_zdf_reverse", newton_iters)
    _check_record("moog_zdf_reverse", record, gy, os,
                  zdf_record(newton_iters))
    if gy.device.type == "cpu":
        return moog_zdf_reverse_plain(record, state8, params, gy, gstate8,
                                      newton_iters=newton_iters, os=os)
    out = _launch_reverse("moog_zdf_reverse", "moog_zdf_reverse", record,
                          state8, params, gy, gstate8, int(newton_iters), os,
                          zdf_record(newton_iters))
    moog_zdf_reverse.launches += 1
    return out


moog_zdf_reverse.launches = 0


def moog_ladder_adjoint(x, state8, params, gy, gstate8, *,
                        fast_tanh: bool = False, huovilainen: bool = False,
                        os: int = 1, return_state: bool = False):
    """K5's adjoint from (x, state8) alone, the checkpoint route
    (`moog_ladder_adjoint_plain`'s function): (dx, dstate8) for the
    cotangents gy (C, T) and gstate8 (8, C), and with `return_state` the
    final state8 the adjoint's own walk recomputed (the forward's, bit
    for bit, on the card). CUDA tensors run the kernel (float32 or
    float64, contiguous), CPU tensors the plain walk and sweep.
    `launches` counts the kernel's launches."""
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
    """K6's adjoint from (x, state8) alone (`moog_zdf_adjoint_plain`'s
    function), as `moog_ladder_adjoint`. `launches` counts the kernel's
    launches."""
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


def _records(x, os, nv) -> bool:
    """The record route for a call over x: its record fits
    RECORD_BUDGET_BYTES (read at each call). Sizes alone decide."""
    return record_bytes(x.shape[0], x.shape[1], os, nv,
                        x.dtype.itemsize) <= RECORD_BUDGET_BYTES


class MoogLadderFn(torch.autograd.Function):
    """(new state8, y) of K5 over (x, state8), differentiable in both (the
    reference's `_kernel_chunk_diff`). `grad` says whether a backward is
    wanted (`_build.wants_grad` at the call): without one the forward is
    K5 and saves nothing; with one it saves the recording instance's
    record and the backward is `moog_ladder_reverse`, or, where the
    record would pass RECORD_BUDGET_BYTES, it saves (x, state8) and the
    backward is `moog_ladder_adjoint`. A cotangent that autograd leaves
    out arrives as zeros."""

    @staticmethod
    def forward(ctx, x, state8, params, fast_tanh, huovilainen, os, grad):
        ctx.args = (params, fast_tanh, huovilainen, os)
        ctx.recorded = grad and _records(x, os, LADDER_RECORD)
        if ctx.recorded:
            st_out, y, rec = _ladder(x, state8, params, fast_tanh,
                                     huovilainen, os, record=True)
            ctx.save_for_backward(rec, state8)
            return st_out, y
        if grad:
            ctx.save_for_backward(x, state8)
        return _ladder(x, state8, params, fast_tanh, huovilainen, os)

    @staticmethod
    def backward(ctx, g_state8, g_y):
        saved, state8 = ctx.saved_tensors
        params, fast_tanh, huovilainen, os = ctx.args
        fn = moog_ladder_reverse if ctx.recorded else moog_ladder_adjoint
        dx, dst = fn(saved, state8, params, g_y.contiguous(),
                     g_state8.contiguous(), fast_tanh=fast_tanh,
                     huovilainen=huovilainen, os=os)
        return dx, dst, None, None, None, None, None


class MoogZDFFn(torch.autograd.Function):
    """(new state8, y) of K6 over (x, state8), as `MoogLadderFn`: the
    record route's backward is `moog_zdf_reverse`, the checkpoint
    route's `moog_zdf_adjoint`."""

    @staticmethod
    def forward(ctx, x, state8, params, newton_iters, os, grad):
        ctx.args = (params, newton_iters, os)
        ctx.recorded = grad and _records(x, os, zdf_record(newton_iters))
        if ctx.recorded:
            st_out, y, rec = _zdf(x, state8, params, newton_iters, os,
                                  record=True)
            ctx.save_for_backward(rec, state8)
            return st_out, y
        if grad:
            ctx.save_for_backward(x, state8)
        return _zdf(x, state8, params, newton_iters, os)

    @staticmethod
    def backward(ctx, g_state8, g_y):
        saved, state8 = ctx.saved_tensors
        params, newton_iters, os = ctx.args
        fn = moog_zdf_reverse if ctx.recorded else moog_zdf_adjoint
        dx, dst = fn(saved, state8, params, g_y.contiguous(),
                     g_state8.contiguous(), newton_iters=newton_iters, os=os)
        return dx, dst, None, None, None, None


def moog_ladder(x, state8, params, *, fast_tanh: bool = False,
                huovilainen: bool = False, os: int = 1):
    """K5 over x (C, T) at oversampling `os`: returns (new state8 (8, C),
    y (C, T)), differentiable in x and state8 (`MoogLadderFn`).
    params = [coef, drive_scale, feedback, input_gain, output_scale].
    CUDA tensors run the kernels; CPU tensors run their plain versions.
    The Huovilainen ladder always takes the exact tanh. `launches` counts
    K5's launches, `record_launches` those of its recording instance
    among them."""
    _check("moog_ladder", x, state8, params, os)
    return MoogLadderFn.apply(x, state8, list(params), bool(fast_tanh),
                              bool(huovilainen), os,
                              _build.wants_grad(x, state8))


moog_ladder.launches = 0
moog_ladder.record_launches = 0


def moog_zdf(x, state8, params, *, newton_iters: int = 4, os: int = 1):
    """K6 over x (C, T) at oversampling `os`: returns (new state8 (8, C),
    y (C, T)), differentiable in x and state8 (`MoogZDFFn`).
    params = [zdf_gk, drive_scale, feedback, input_gain, output_scale].
    CUDA tensors run the kernels; CPU tensors run their plain versions.
    `launches` and `record_launches` count as `moog_ladder`'s."""
    _check("moog_zdf", x, state8, params, os)
    _check_newton("moog_zdf", newton_iters)
    return MoogZDFFn.apply(x, state8, list(params), int(newton_iters), os,
                           _build.wants_grad(x, state8))


moog_zdf.launches = 0
moog_zdf.record_launches = 0
