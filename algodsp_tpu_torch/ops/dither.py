"""The quantizer's error-feedback loop, Q1 (counterpart of the per-sample
`lax.scan`s of `algodsp_tpu/dither/quantizer.py::Quantizer.
_process_codes`, :228-242, and `_process_codes_iir`, :256-271; no
Pallas).

Per channel and sample, with s the scaled input and nz the dither:

    FIR  shaped = s - sum_k c_k h_k          (k = 0, 1, ... in order)
    IIR  fo = b0 e + d0;  d0 = b1 e - a1 fo + d1;  d1 = b2 e - a2 fo;
         shaped = s - fo
    q = floor(shaped + nz), clipped to [lo, hi] where the quantizer limits

and the error q - shaped enters the history (FIR: as h_0, the rest
shifted by one; IIR: as e). The CUDA kernel `csrc/dither.cu` walks one
channel a thread; `error_feedback_plain` is the same step in plain
PyTorch, a loop over time on (C,) tensors, in the same order and
rounding, so the two agree bit for bit. A CUDA tensor runs the kernel
(or raises); a CPU tensor runs the plain version. Both go through
`ErrorFeedbackFn`, whose backward is the reference's: `floor` makes the
codes' gradient zero with respect to the input, the dither and the state.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from algodsp_tpu_torch import _build

MAX_ORDER = 32
_SYMBOLS = {torch.float32: "error_feedback_f32", torch.float64: "error_feedback_f64"}
# error_feedback_f{32,64}(scaled, noise, state_in, q_out, state_out, C, n,
#                         order, iir, limit, prm, stream)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_void_p]


@dataclasses.dataclass(frozen=True)
class ShaperParams:
    """The loop's constants, as `Quantizer` derives them: the FIR
    coefficients (empty for the IIR shelf), the shelf's (b0, b1, b2, a1,
    a2) or None, whether the codes are clipped, and the clip range."""
    coeffs: tuple
    shelf: tuple | None
    limit: bool
    lo: float
    hi: float

    def state_width(self) -> int:
        return 3 if self.shelf is not None else len(self.coeffs)


def error_feedback_plain(scaled, noise, state, p: ShaperParams):
    """Plain PyTorch version of Q1 on (..., N) inputs and the (..., K)
    state (FIR: K = order; IIR: K = 3). Returns (q, state)."""
    as_t = lambda v: torch.as_tensor(v, dtype=scaled.dtype, device=scaled.device)

    def code(shaped, nz):
        q = torch.floor(shaped + nz)
        return torch.clamp(q, p.lo, p.hi) if p.limit else q

    qs = []
    if p.shelf is not None:
        b0, b1, b2, a1, a2 = (as_t(v) for v in p.shelf)
        d0, d1, e = state[..., 0], state[..., 1], state[..., 2]
        for t in range(scaled.shape[-1]):
            fo = b0 * e + d0
            d0, d1 = b1 * e - a1 * fo + d1, b2 * e - a2 * fo
            shaped = scaled[..., t] - fo
            q = code(shaped, noise[..., t])
            e = q - shaped
            qs.append(q)
        new_state = torch.stack([d0, d1, e], dim=-1)
    else:
        cs = as_t(p.coeffs)
        hist = [state[..., k] for k in range(len(p.coeffs))]
        for t in range(scaled.shape[-1]):
            acc = cs[0] * hist[0]
            for k in range(1, len(hist)):
                acc = acc + cs[k] * hist[k]
            shaped = scaled[..., t] - acc
            q = code(shaped, noise[..., t])
            hist = [q - shaped] + hist[:-1]
            qs.append(q)
        new_state = torch.stack(hist, dim=-1)
    if not qs:
        return scaled.clone(), state.clone()
    return torch.stack(qs, dim=-1), new_state


def _launch(scaled, noise, state, p: ShaperParams):
    """Q1 on CUDA tensors (..., N), state (..., K)."""
    symbol = _SYMBOLS.get(scaled.dtype)
    if symbol is None:
        raise ValueError(f"error_feedback: takes float32 or float64, got "
                         f"{scaled.dtype}")
    k = p.state_width()
    lead, n = scaled.shape[:-1], scaled.shape[-1]
    for name, t, shape in (("noise", noise, scaled.shape),
                           ("state", state, lead + (k,))):
        if tuple(t.shape) != tuple(shape) or t.dtype != scaled.dtype \
                or t.device != scaled.device:
            raise ValueError(f"error_feedback: {name} must be {scaled.dtype} "
                             f"{tuple(shape)} on {scaled.device}")
    if p.shelf is None and not 1 <= k <= MAX_ORDER:
        raise ValueError(f"error_feedback: FIR order must be in [1, "
                         f"{MAX_ORDER}], got {k}")
    fn = _build.entry("dither", symbol, _ARGTYPES)
    x2 = scaled.reshape(-1, n).contiguous()
    nz = noise.reshape(-1, n).contiguous()
    s_in = state.reshape(-1, k).contiguous()
    q = torch.empty_like(x2)
    s_out = torch.empty_like(s_in)
    if x2.shape[0] == 0 or n == 0:
        return q.reshape(scaled.shape), state.clone()
    shelf = p.shelf if p.shelf is not None else (0.0,) * 5
    prm = (ctypes.c_double * (7 + len(p.coeffs)))(p.lo, p.hi, *shelf, *p.coeffs)
    with torch.cuda.device(scaled.device):
        code = fn(*(_build.ptr(t) for t in (x2, nz, s_in, q, s_out)),
                  x2.shape[0], n, len(p.coeffs), int(p.shelf is not None),
                  int(p.limit), ctypes.addressof(prm), _build.stream_of(x2))
        error_feedback.launches += 1
    _build.check("dither", code, "error_feedback")
    return q.reshape(scaled.shape), s_out.reshape(state.shape)


class ErrorFeedbackFn(torch.autograd.Function):
    """(q, state) of the loop; the gradient of q is zero (floor), as
    `jax.grad` gives it, and the new state carries none."""

    @staticmethod
    def forward(ctx, scaled, noise, state, p):
        if scaled.device.type == "cpu":
            q, new_state = error_feedback_plain(scaled, noise, state, p)
        elif scaled.device.type == "cuda":
            q, new_state = _launch(scaled, noise, state, p)
        else:
            raise ValueError(f"error_feedback: unsupported device {scaled.device}")
        ctx.mark_non_differentiable(new_state)
        ctx.shapes = (scaled.shape, noise.shape, state.shape)
        return q, new_state

    @staticmethod
    def backward(ctx, g_q, g_state):
        return (*(g_q.new_zeros(s) for s in ctx.shapes), None)


def error_feedback(scaled, noise, state, p: ShaperParams):
    """The error-feedback loop over scaled (..., N) with the dither noise
    (..., N) and the state (..., K) of its type: the kernel for a CUDA
    tensor (float32 or float64), the plain version for a CPU one.
    Returns (q, state). `launches` counts the kernel's launches."""
    return ErrorFeedbackFn.apply(scaled, noise, state, p)


error_feedback.launches = 0


def step_cycles(p: ShaperParams, n: int = 1 << 16, device="cuda") -> float:
    """SM cycles of one dependent FIR step of Q1 in float32 on the card
    (one thread, register values, clock64 stamps around n steps): with
    the SM clock, the chain bound of an N-step walk is N times this."""
    fn = _build.entry("dither", "error_feedback_latency_f32",
                      [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p])
    cycles = torch.zeros(1, dtype=torch.int64, device=device)
    sink = torch.zeros(1, dtype=torch.float32, device=device)
    prm = (ctypes.c_double * (7 + len(p.coeffs)))(p.lo, p.hi, *(0.0,) * 5,
                                                   *p.coeffs)
    for _ in range(2):      # the first run warms the instruction cache
        code = fn(len(p.coeffs), ctypes.addressof(prm), n, 1234.5,
                  _build.ptr(cycles), _build.ptr(sink), _build.stream_of(cycles))
        _build.check("dither", code, "error_feedback_latency")
        torch.cuda.synchronize(cycles.device)
    return int(cycles.item()) / n
