"""Fractional delay reads over signals, the delay-line primitive
(counterpart of `algodsp_tpu/delayline.py`).

Capability parity with `dsp/delay/line.go`: integer and fractional
delayed reads with selectable interpolation (linear, Hermite4,
Lagrange, Lanczos, windowed-sinc-N, allpass; `line.go:128-245`).

A delay is an interpolated gather over the signal's timeline,

    y[n] = interp(x, n - d[n]),

with d scalar or per sample (the modulated delays of the chorus).
Reads before the timeline's start (pre-history) or past its end return
0, like a freshly zeroed delay line. `DelayLine` carries max_delay
samples of history for streaming block processing. Every read is one
`torch.gather` of all the points it needs.
"""

from __future__ import annotations

import torch

from algodsp_tpu_torch import interp as _interp
from algodsp_tpu_torch._device import resolve_device
from algodsp_tpu_torch.interp import Mode


def _gather_points(xh, base_idx, offsets):
    """(..., N, P) samples of xh (..., T) at base_idx[..., n] + offsets[p],
    the leading dims of xh and base_idx broadcasting against each other;
    positions outside [0, T) read 0. One gather over an expanded view of
    xh (no copy of the signal per position row)."""
    total = xh.shape[-1]
    idx = base_idx[..., :, None] + offsets
    flat = idx.reshape(idx.shape[:-2] + (-1,))
    batch = torch.broadcast_shapes(xh.shape[:-1], flat.shape[:-1])
    valid = (flat >= 0) & (flat < total)
    vals = torch.gather(xh.expand(batch + (total,)), -1,
                        torch.clamp(flat, 0, max(total - 1, 0)).expand(
                            batch + flat.shape[-1:]))
    vals = torch.where(valid, vals, torch.zeros_like(vals))
    return vals.reshape(vals.shape[:-1] + idx.shape[-2:])


def fractional_read(x, positions, mode: Mode = Mode.LINEAR,
                    sinc_half_width: int = 8):
    """Interpolated read of x at (possibly fractional) positions.

    x: (..., T) timeline; positions: (..., P) sample positions into x
    (0 = first sample). Returns (..., P). Out-of-range reads are 0.
    """
    pos = torch.as_tensor(positions, dtype=x.dtype, device=x.device)
    fl = torch.floor(pos)
    i0 = fl.long()
    t = pos - fl
    before, total = _interp.points_needed(mode, sinc_half_width)
    offsets = torch.arange(-before, -before + total, device=x.device)
    pts = _gather_points(x, i0, offsets)  # (..., P, total)
    if mode == Mode.LINEAR:
        return _interp.linear2(t, pts[..., 0], pts[..., 1])
    if mode == Mode.HERMITE:
        return _interp.hermite4(t, pts[..., 0], pts[..., 1], pts[..., 2],
                                pts[..., 3])
    if mode == Mode.LAGRANGE3:
        return _interp.lagrange4(t, pts[..., 0], pts[..., 1], pts[..., 2],
                                 pts[..., 3])
    if mode == Mode.LANCZOS3:
        return _interp.lanczos_n(t, pts, 3)
    if mode == Mode.SINC:
        return _interp.sinc_interp(t, pts, sinc_half_width)
    if mode == Mode.ALLPASS:
        # stateless approximation of the allpass read: one tick from rest
        eta = _interp.allpass_coeff(t)
        return pts[..., 1] + eta * (pts[..., 0] - pts[..., 1])
    raise ValueError(f"unknown mode {mode}")


def _walking_weights(pos, mode: Mode):
    """(first tap offset, base index (..., N), weights (ntaps, ..., N)) of
    `walking_read` at positions pos: the reference's polynomial form of
    the Hermite and Lagrange weights (`delayline.py:121-134`), not the
    Horner form of `interp.hermite4`."""
    fl = torch.floor(pos)
    i0 = fl.long()
    frac = pos - fl
    if mode == Mode.LINEAR:
        return 0, i0, torch.stack([1.0 - frac, frac])
    t2, t3 = frac * frac, frac * frac * frac
    if mode == Mode.HERMITE:
        return -1, i0, torch.stack([-0.5 * frac + t2 - 0.5 * t3,
                                    1.0 - 2.5 * t2 + 1.5 * t3,
                                    0.5 * frac + 2.0 * t2 - 1.5 * t3,
                                    -0.5 * t2 + 0.5 * t3])
    d0, d1, d2 = frac, frac - 1.0, frac + 1.0
    return -1, i0, torch.stack([-d0 * d1 * (frac - 2.0) / 6.0,
                                d2 * d1 * (frac - 2.0) / 2.0,
                                -d2 * d0 * (frac - 2.0) / 2.0,
                                d2 * d0 * d1 / 6.0])


def walking_read(x, pos, drift: float, mode: Mode = Mode.HERMITE):
    """Fractional read at positions that WALK: pos[t] = c + t + wobble(t)
    with |wobble'(t)| <= drift per sample (modulated delay lines whose
    lag changes slowly, the chorus's LFOs).

    x: (..., T) known timeline (no feedback); pos: (..., N) positions
    whose leading dims broadcast against x's ((N,) in the reference:
    shared across the batch). `drift` bounds the wobble's rate; it
    shaped the reference's read and is kept for its signature.

    The reference decomposes the read into a static set of contiguous
    dynamic slices a block of samples, combined with selection weights:
    TPU mechanics that keep a slow elementwise gather off the TPU. Here
    the taps are gathered directly, one gather for all of them; the
    arithmetic is the reference's (its polynomial tap weights summed in
    tap order, pre-history reads 0). Modes without a 2- or 4-point
    stencil take `fractional_read`.
    """
    if mode not in (Mode.LINEAR, Mode.HERMITE, Mode.LAGRANGE3):
        return fractional_read(x, pos, mode)
    pos = torch.as_tensor(pos, dtype=x.dtype, device=x.device)
    k0, i0, W = _walking_weights(pos, mode)
    offsets = torch.arange(k0, k0 + W.shape[0], device=x.device)
    pts = _gather_points(x, i0, offsets)            # (..., N, ntaps)
    y = W[0] * pts[..., 0]
    for k in range(1, W.shape[0]):
        y = y + W[k] * pts[..., k]
    return y


def delayed(x, delay, mode: Mode = Mode.LINEAR, **kwargs):
    """y[n] = x[n - delay[n]] with interpolation; delay scalar or (..., N)."""
    n = x.shape[-1]
    d = torch.broadcast_to(torch.as_tensor(delay, dtype=x.dtype,
                                           device=x.device), x.shape)
    pos = torch.arange(n, dtype=x.dtype, device=x.device) - d
    return fractional_read(x, pos, mode, **kwargs)


class DelayLine:
    """Streaming delay line carrying max_delay samples of history
    (`delay/line.go:40-126`)."""

    def __init__(self, max_delay: int, mode: Mode = Mode.LINEAR,
                 sinc_half_width: int = 8):
        if max_delay <= 0:
            raise ValueError("delay: max_delay must be > 0")
        self.max_delay = int(max_delay)
        self.mode = mode
        self.sinc_half_width = sinc_half_width

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        """History plus a small interpolation guard band, on the CUDA card
        unless `device` says otherwise."""
        guard = _interp.points_needed(self.mode, self.sinc_half_width)[1]
        return torch.zeros(tuple(batch_shape) + (self.max_delay + guard,),
                           dtype=dtype, device=resolve_device(device))

    def process(self, state, x, delay):
        """(state, x:(...,N), delay scalar/(...,N)) -> (state, y).

        y[n] = input timeline read at (n - delay[n]), where the timeline
        includes carried history.
        """
        n = x.shape[-1]
        h = state.shape[-1]
        ext = torch.cat([state.to(x.dtype), x], dim=-1)
        d = torch.broadcast_to(torch.as_tensor(delay, dtype=x.dtype,
                                               device=x.device), x.shape)
        pos = h + torch.arange(n, dtype=x.dtype, device=x.device) - d
        y = fractional_read(ext, pos, self.mode,
                            sinc_half_width=self.sinc_half_width)
        return ext[..., -h:], y
