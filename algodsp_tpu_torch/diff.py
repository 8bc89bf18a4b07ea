"""Differentiable (traced-coefficient) filter design and runtime
(counterpart of `algodsp_tpu/diff.py`).

The main designers (`filters.design.*`) run on the host in float64 NumPy
and give constant coefficients, which the runtime engines fold into
their kernels; autograd does not reach their parameters. This module
writes the same RBJ cookbook maths over tensors, plus the response of
a tensor SOS stack and a differentiable SOS and FIR runtime. With the
custom backwards of the kernels (`ops/biquad_cascade.py`,
`ops/envscan.py`, `ops/fdlconv.py`) gradient-based design runs end to
end on the card:

    params -> diff.peak(...) -> sos_response / sos_filter -> loss
    loss.backward() reaches the centre frequencies, Qs and gains.

As in the reference, these designers keep none of the host designers'
invalid-parameter conventions (zero coefficients, default-Q fallback):
those are data-dependent branches in the middle of an optimisation
landscape. Callers keep parameters in range; `constrain()` is the
smooth reparameterisation.

Every function runs on the device of the tensors among its arguments
(they must agree); where none is a tensor, on `device`, which is the
CUDA card unless the caller passes `device="cpu"` (`resolve_device`).
Design parameters given as Python numbers alone are float64; otherwise
they take the promoted type of the tensors among them.
"""

from __future__ import annotations

import math

import torch

from ._device import resolve_device


# ---------------------------------------------------------------------------
# Smooth parameter constraints
# ---------------------------------------------------------------------------

def _device_of(vals, device):
    """The device of the tensors among `vals`, which must agree with
    each other and with `device` where it is given; where none is a
    tensor, `resolve_device(device)`. Work meant for the card never
    moves to the host on its own."""
    devs = {v.device for v in vals if torch.is_tensor(v)}
    if len(devs) > 1:
        raise ValueError(f"diff: tensors on different devices: "
                         f"{sorted(str(d) for d in devs)}")
    if not devs:
        return resolve_device(device)
    dev = devs.pop()
    if device is not None:
        want = torch.device(device)
        if want.type != dev.type or want.index not in (None, dev.index):
            raise ValueError(f"diff: device={want} given for tensors on "
                             f"{dev}")
    return dev


def constrain(raw, lo, hi, *, device=None):
    """Smooth sigmoid reparameterisation of an unconstrained value onto
    (lo, hi): keeps gradient-descent iterates inside valid design
    ranges (frequencies inside (0, Nyquist), Q > 0) without clipping.
    `torch.sigmoid` keeps the value and its gradient finite for raw of
    any magnitude."""
    raw = torch.as_tensor(raw, device=_device_of([raw], device))
    return lo + (hi - lo) * torch.sigmoid(raw)


# ---------------------------------------------------------------------------
# RBJ cookbook designers over tensors
# ---------------------------------------------------------------------------

def _params(*vals, device=None):
    """The design parameters as tensors of one floating type and device:
    the promoted type of the tensors among them, float64 for Python
    numbers alone; the device as `_device_of` gives it."""
    tensors = [v for v in vals if torch.is_tensor(v)]
    dtype = torch.float64
    if tensors:
        dtype = tensors[0].dtype
        for t in tensors[1:]:
            dtype = torch.promote_types(dtype, t.dtype)
        if not dtype.is_floating_point:
            dtype = torch.float64
    device = _device_of(vals, device)
    return [torch.as_tensor(v, dtype=dtype, device=device) for v in vals]


def _wa(freq, q, sample_rate):
    w0 = 2.0 * math.pi * freq / sample_rate
    cw, sw = torch.cos(w0), torch.sin(w0)
    return cw, sw, sw / (2.0 * q)


def _norm(b0, b1, b2, a0, a1, a2):
    inv = 1.0 / a0
    return torch.stack([b0 * inv, b1 * inv, b2 * inv, a1 * inv, a2 * inv])


def lowpass(freq, q, sample_rate, *, device=None):
    """RBJ lowpass over tensors; maths of `filters.design.lowpass`."""
    cw, sw, alpha = _wa(*_params(freq, q, device=device), sample_rate)
    return _norm((1 - cw) / 2, 1 - cw, (1 - cw) / 2,
                 1 + alpha, -2 * cw, 1 - alpha)


def highpass(freq, q, sample_rate, *, device=None):
    cw, sw, alpha = _wa(*_params(freq, q, device=device), sample_rate)
    return _norm((1 + cw) / 2, -(1 + cw), (1 + cw) / 2,
                 1 + alpha, -2 * cw, 1 - alpha)


def bandpass(freq, q, sample_rate, *, device=None):
    cw, sw, alpha = _wa(*_params(freq, q, device=device), sample_rate)
    return _norm(sw / 2, torch.zeros_like(sw), -sw / 2,
                 1 + alpha, -2 * cw, 1 - alpha)


def notch(freq, q, sample_rate, *, device=None):
    cw, sw, alpha = _wa(*_params(freq, q, device=device), sample_rate)
    one = torch.ones_like(cw)
    return _norm(one, -2 * cw, one, 1 + alpha, -2 * cw, 1 - alpha)


def allpass(freq, q, sample_rate, *, device=None):
    cw, sw, alpha = _wa(*_params(freq, q, device=device), sample_rate)
    return _norm(1 - alpha, -2 * cw, 1 + alpha,
                 1 + alpha, -2 * cw, 1 - alpha)


def peak(freq, gain_db, q, sample_rate, *, device=None):
    freq, gain_db, q = _params(freq, gain_db, q, device=device)
    cw, sw, alpha = _wa(freq, q, sample_rate)
    a = 10.0 ** (gain_db / 40.0)
    return _norm(1 + alpha * a, -2 * cw, 1 - alpha * a,
                 1 + alpha / a, -2 * cw, 1 - alpha / a)


def low_shelf(freq, gain_db, q, sample_rate, *, device=None):
    freq, gain_db, q = _params(freq, gain_db, q, device=device)
    cw, sw, alpha = _wa(freq, q, sample_rate)
    a = 10.0 ** (gain_db / 40.0)
    beta = 2.0 * torch.sqrt(a) * alpha
    return _norm(a * ((a + 1) - (a - 1) * cw + beta),
                 2 * a * ((a - 1) - (a + 1) * cw),
                 a * ((a + 1) - (a - 1) * cw - beta),
                 (a + 1) + (a - 1) * cw + beta,
                 -2 * ((a - 1) + (a + 1) * cw),
                 (a + 1) + (a - 1) * cw - beta)


def high_shelf(freq, gain_db, q, sample_rate, *, device=None):
    freq, gain_db, q = _params(freq, gain_db, q, device=device)
    cw, sw, alpha = _wa(freq, q, sample_rate)
    a = 10.0 ** (gain_db / 40.0)
    beta = 2.0 * torch.sqrt(a) * alpha
    return _norm(a * ((a + 1) + (a - 1) * cw + beta),
                 -2 * a * ((a - 1) + (a + 1) * cw),
                 a * ((a + 1) + (a - 1) * cw - beta),
                 (a + 1) - (a - 1) * cw + beta,
                 2 * ((a - 1) - (a + 1) * cw),
                 (a + 1) - (a - 1) * cw - beta)


# ---------------------------------------------------------------------------
# Response evaluation and SOS runtime over tensor coefficients
# ---------------------------------------------------------------------------

def _sos_response_parts(sos, freqs, sample_rate, device=None):
    """(re, im) of the cascade response, in real arithmetic as the
    reference computes it, on the device `_device_of` gives. `freqs`
    keeps its own type (NumPy float64 stays float64), and the usual
    promotion follows."""
    dev = _device_of([sos, freqs], device)
    sos = torch.atleast_2d(torch.as_tensor(sos, device=dev))
    w = 2.0 * math.pi * torch.as_tensor(freqs, device=dev) / sample_rate
    c1, s1 = torch.cos(w), torch.sin(w)                     # e^{-iw} = c1 - i s1
    c2, s2 = torch.cos(2 * w), torch.sin(2 * w)
    b0, b1, b2, a1, a2 = (sos[:, i][:, None] for i in range(5))
    nre = b0 + b1 * c1 + b2 * c2
    nim = -(b1 * s1 + b2 * s2)
    dre = 1.0 + a1 * c1 + a2 * c2
    dim = -(a1 * s1 + a2 * s2)
    dmag = dre * dre + dim * dim
    hre = (nre * dre + nim * dim) / dmag                    # (S, F)
    him = (nim * dre - nre * dim) / dmag
    re, im = hre[0], him[0]
    for k in range(1, hre.shape[0]):
        re, im = re * hre[k] - im * him[k], re * him[k] + im * hre[k]
    return re, im


def sos_response(sos, freqs, sample_rate, *, device=None):
    """Complex frequency response of a tensor (S, 5) [or (5,)] SOS stack
    at `freqs` Hz, differentiable in the coefficients (and through them
    in the design parameters)."""
    re, im = _sos_response_parts(sos, freqs, sample_rate, device)
    return torch.complex(re, im)


def sos_magnitude_db(sos, freqs, sample_rate, floor_db: float = -200.0, *,
                     device=None):
    """|H| in dB with a differentiable floor (no log(0) at exact
    response nulls), in real arithmetic."""
    re, im = _sos_response_parts(sos, freqs, sample_rate, device)
    p = re * re + im * im
    return 10.0 * torch.log10(p + 10.0 ** (floor_db / 10.0))


def sos_filter(sos, x, state=None, *, device=None):
    """Apply a tensor SOS cascade along the last axis (Direct Form II
    Transposed, the `section.go:47-53` recurrence), differentiable in
    the coefficients, x and the state.

    A plain Python loop over time, as the reference's `lax.scan`: the
    tool for fitting short excerpts, not for bulk processing (once
    fitted, freeze the coefficients into a `BiquadChain` for the
    kernels). The reference has no Pallas kernel here, so neither has
    the port.

    sos: (S, 5) or (5,) coefficients [b0 b1 b2 a1 a2]; x: (..., T);
    state: optional (..., S, 2) DF2T state [d0, d1], zeros when None.
    Returns (y (..., T), new_state (..., S, 2)) in the promoted type of
    x and sos.
    """
    dev = _device_of([sos, x, state], device)
    sos = torch.atleast_2d(torch.as_tensor(sos, device=dev))
    x = torch.as_tensor(x, device=dev)
    dtype = torch.promote_types(x.dtype, sos.dtype)
    x = x.to(dtype)
    sos = sos.to(dtype)
    s = sos.shape[0]
    lead = x.shape[:-1]
    if state is None:
        state = x.new_zeros(lead + (s, 2))
    else:
        state = torch.as_tensor(state, device=dev).to(dtype)
    b0, b1, b2, a1, a2 = (sos[:, i] for i in range(5))
    d0 = [state[..., k, 0] for k in range(s)]
    d1 = [state[..., k, 1] for k in range(s)]
    ys = []
    for t in range(x.shape[-1]):
        v = x[..., t]
        for k in range(s):
            y = b0[k] * v + d0[k]
            d0[k] = b1[k] * v - a1[k] * y + d1[k]
            d1[k] = b2[k] * v - a2[k] * y
            v = y
        ys.append(v)
    y = torch.stack(ys, dim=-1) if ys else x.clone()
    new_state = torch.stack(
        [torch.stack([d0[k], d1[k]], dim=-1) for k in range(s)], dim=-2)
    return y, new_state


def fir_filter(taps, x, *, device=None):
    """Causal FIR of a tap tensor along the last axis (zero initial
    state), differentiable in both arguments: y[n] = sum_k taps[k]
    x[n - k], as a sum of shifted, scaled copies of x in the promoted
    type (elementwise multiply-adds, so no cuDNN `conv1d`, which runs in
    TF32 on the card by default)."""
    dev = _device_of([taps, x], device)
    taps = torch.as_tensor(taps, device=dev)
    x = torch.as_tensor(x, device=dev)
    dtype = torch.promote_types(x.dtype, taps.dtype)
    x = x.to(dtype)
    taps = taps.reshape(-1).to(dtype)
    m, n = taps.shape[0], x.shape[-1]
    xp = torch.nn.functional.pad(x, (m - 1, 0))
    y = taps[0] * x
    for k in range(1, m):
        y = y + taps[k] * xp[..., m - 1 - k:m - 1 - k + n]
    return y
