"""Nonlinear Moog ladders: the CUDA kernels `csrc/moog.cu` and their
plain PyTorch versions.

Replaces the Pallas kernels `algodsp_tpu/ops/pallas_kernels.py::
_moog_kernel` (K5, front door `moog_ladder_pallas`: the classic ladder
with exact or rational tanh, and the Huovilainen ladder) and
`::_moog_zdf_kernel` (K6, front door `moog_zdf_pallas`: the ZDF ladder
with a fixed number of Newton iterations). Same contract: x (C, T),
state8 (8, C) = [s0..s3, t0..t2, prev], five parameters in the order
`MoogFilter` builds them; returns (new state8, y (C, T)). Unlike the
TPU path, every T >= 1 runs in the kernel and the state out is the
carry after the last real sample.

`moog_ladder` and `moog_zdf` launch the kernels for CUDA tensors
(float32 or float64) and use `moog_ladder_plain` / `moog_zdf_plain`, a
per-sample loop over the step functions of `algodsp_tpu/filters/moog.py`,
only for CPU tensors. Forward only: the recompute VJP comes with the
other custom VJPs (ROADMAP.md).
"""

from __future__ import annotations

import ctypes

import torch

from algodsp_tpu_torch import _build

STATE_LIMIT = 32.0
MAX_NEWTON_ITERS = 8
# moog_ladder_f32/f64(x, st_in, st_out, y, p0..p4, C, T, mode, stream) and
# moog_zdf_f32/f64(x, st_in, st_out, y, p0..p4, C, T, newton_iters, stream)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_double] * 5
             + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _clip(v):
    return torch.clamp(v, -STATE_LIMIT, STATE_LIMIT)


def poly_tanh(x):
    """The lightweight variants' rational tanh (`pallas_kernels.py:363`)."""
    x2 = x * x
    return torch.where(x > 3, 1.0, torch.where(
        x < -3, -1.0, torch.clamp(x * (27 + x2) / (27 + 9 * x2), -1, 1)))


def moog_ladder_plain(x, state8, params, *, fast_tanh: bool,
                      huovilainen: bool):
    """Plain PyTorch K5, one time step at a time (`moog.py:107-140`)."""
    coef, ds, fb, ig, osc = (float(p) for p in params)
    tanh_fn = poly_tanh if fast_tanh and not huovilainen else torch.tanh
    s0, s1, s2, s3, t0, t1, t2, prev = state8.to(x.dtype).unbind(0)
    ys = []
    for i in range(x.shape[-1]):
        xv = x[..., i]
        if huovilainen:
            u = xv * ig - fb * (0.5 * (s3 + prev))
            t_in = torch.tanh(ds * u)
            ts0 = torch.tanh(ds * s0)
            ts1 = torch.tanh(ds * s1)
            ts2 = torch.tanh(ds * s2)
            ts3 = torch.tanh(ds * s3)
        else:
            u = xv * ig - fb * s3
            t_in = tanh_fn(ds * u)
            ts0, ts1, ts2, ts3 = t0, t1, t2, tanh_fn(ds * s3)
        s0 = _clip(s0 + coef * (t_in - ts0))
        t0 = tanh_fn(ds * s0)
        s1 = _clip(s1 + coef * (t0 - ts1))
        t1 = tanh_fn(ds * s1)
        s2 = _clip(s2 + coef * (t1 - ts2))
        t2 = tanh_fn(ds * s2)
        s3 = _clip(s3 + coef * (t2 - ts3))
        prev = s3
        ys.append(osc * s3)
    return torch.stack([s0, s1, s2, s3, t0, t1, t2, prev]), torch.stack(ys, -1)


def moog_zdf_plain(x, state8, params, *, newton_iters: int):
    """Plain PyTorch K6, one time step at a time (`moog.py:142-183`)."""
    gk, shape, k, ig, osc = (float(p) for p in params)
    v_scale = gk / shape
    st = state8.to(x.dtype)
    s = list(st[:4].unbind(0))
    prev = st[7]
    ys = []
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
            return (v0, v1, v2, v3), v3 + s[3], d0 * d1 * d2 * d3

        y3est = prev
        for _ in range(newton_iters):
            _, y3, dprod = ladder(y3est)
            jac = dprod * (-k) - 1.0
            flat = torch.abs(jac) < 1e-15
            y3est = torch.where(flat, y3est, y3est - (y3 - y3est)
                                / torch.where(flat, 1.0, jac))
        v, y3, _ = ladder(y3est)
        s = [_clip(si + 2 * vi) for si, vi in zip(s, v)]
        prev = y3
        ys.append(osc * y3)
    return torch.stack(s + [st[4], st[5], st[6], prev]), torch.stack(ys, -1)


def _check(name, x, state8, params):
    if x.ndim != 2 or x.shape[-1] < 1:
        raise ValueError(f"{name}: x must be (C, T) with T >= 1, got "
                         f"{tuple(x.shape)}")
    if tuple(state8.shape) != (8, x.shape[0]):
        raise ValueError(f"{name}: state8 must be (8, {x.shape[0]}), got "
                         f"{tuple(state8.shape)}")
    if len(params) != 5:
        raise ValueError(f"{name}: takes 5 parameters, got {len(params)}")


def _launch(name, symbol, x, state8, params, last_arg):
    """Run kernel `symbol` of csrc/moog.cu on CUDA tensors; returns
    (new state8, y)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _SUFFIX or not x.is_contiguous():
        raise ValueError(f"{name}: the kernel takes contiguous float32 or "
                         f"float64, got {x.dtype}")
    fn = _build.entry("moog", f"{symbol}_{_SUFFIX[x.dtype]}", _ARGTYPES)
    if (state8.dtype != x.dtype or state8.device != x.device
            or not state8.is_contiguous()):
        raise ValueError(f"{name}: state8 must be contiguous {x.dtype} on "
                         f"{x.device}")
    c, t = x.shape
    y = torch.empty_like(x)
    st_out = torch.empty_like(state8)
    with torch.cuda.device(x.device):
        code = fn(_build.ptr(x), _build.ptr(state8), _build.ptr(st_out),
                  _build.ptr(y), *(float(p) for p in params), c, t, last_arg,
                  _build.stream_of(x))
    _build.check("moog", code, name)
    return st_out, y


def moog_ladder(x, state8, params, *, fast_tanh: bool = False,
                huovilainen: bool = False):
    """K5 over x (C, T): returns (new state8 (8, C), y (C, T)).
    params = [coef, drive_scale, feedback, input_gain, output_scale].
    CUDA tensors run the kernel; CPU tensors run `moog_ladder_plain`.
    The Huovilainen ladder always takes the exact tanh."""
    _check("moog_ladder", x, state8, params)
    if x.device.type == "cpu":
        return moog_ladder_plain(x, state8, params, fast_tanh=fast_tanh,
                                 huovilainen=huovilainen)
    mode = 2 if huovilainen else int(bool(fast_tanh))
    out = _launch("moog_ladder", "moog_ladder", x, state8, params, mode)
    moog_ladder.launches += 1
    return out


moog_ladder.launches = 0


def moog_zdf(x, state8, params, *, newton_iters: int = 4):
    """K6 over x (C, T): returns (new state8 (8, C), y (C, T)).
    params = [zdf_gk, drive_scale, feedback, input_gain, output_scale].
    CUDA tensors run the kernel; CPU tensors run `moog_zdf_plain`."""
    _check("moog_zdf", x, state8, params)
    if not 1 <= newton_iters <= MAX_NEWTON_ITERS:
        raise ValueError(f"moog_zdf: newton_iters must be in [1, "
                         f"{MAX_NEWTON_ITERS}], got {newton_iters}")
    if x.device.type == "cpu":
        return moog_zdf_plain(x, state8, params, newton_iters=newton_iters)
    out = _launch("moog_zdf", "moog_zdf", x, state8, params, int(newton_iters))
    moog_zdf.launches += 1
    return out


moog_zdf.launches = 0
