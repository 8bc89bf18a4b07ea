"""The feedback-topology dynamics detector, D1 (counterpart of the
per-sample `lax.scan` in `algodsp_tpu/effects/dynamics/core.py::
DynamicsCore._process_feedback`).

Per channel and sample, the envelope reads the previous output's
magnitude src = |y_{n-1}|:

    env_n = src > env ? env + (src - env) * a : src + (env - src) * r
    g_n   = compression_gain(env_n)      (the log2-domain soft knee)
    y_n   = x_n * g_n * makeup

Both branch expressions are the reference's as written: the falling one
is not rewritten as env + (src - env) * (1 - r), which rounds
differently. Each step depends on the last one's gain, so no time split
applies: the CUDA kernel `csrc/dynamics.cu` walks one channel per
thread, and `dynamics_feedback_plain` is the same step in plain PyTorch,
a loop over time on (C,) tensors. A CUDA tensor runs the kernel (or
raises); a CPU tensor runs the plain loop, through which autograd
differentiates as `jax.grad` does the scan. The kernel has no backward
yet: a gradient wanted on the card raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from algodsp_tpu_torch import _build

# dynamics_feedback_f{32,64}(x, env0, prev_abs0, y, gain, env_final,
#                            prev_abs_final, C, n, prm, stream)
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_void_p, ctypes.c_void_p]
_SYMBOLS = {torch.float32: "dynamics_feedback_f32",
            torch.float64: "dynamics_feedback_f64"}
# dynamics_feedback_latency_f{32,64}(prm, n, x0, cycles, sink, stream)
_LAT_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_double,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
_LAT_SYMBOLS = {torch.float32: "dynamics_feedback_latency_f32",
                torch.float64: "dynamics_feedback_latency_f64"}


@dataclasses.dataclass(frozen=True)
class FeedbackParams:
    """The detector's constants, as `DynamicsCore` derives them: the
    envelope's attack and release coefficients, the gain computer's
    threshold and knee (log2 domain), its compression factor
    (1 - 1/ratio, or ratio - 1 under feedback_ratio_scale) and the
    linear makeup gain."""
    attack: float
    release: float
    threshold_log2: float
    knee_db: float
    knee_width_log2: float
    inv_knee_width_log2: float
    compression_factor: float
    makeup: float

    def as_doubles(self):
        """The kernel's eight parameters (csrc/dynamics.cu::make_params)."""
        return (ctypes.c_double * 8)(
            self.attack, self.release, self.threshold_log2, self.knee_db,
            self.knee_width_log2 * 0.5, self.inv_knee_width_log2,
            self.compression_factor, self.makeup)


def dynamics_feedback_plain(x, env0, prev_abs0, p: FeedbackParams):
    """Plain PyTorch version, one time step at a time on (...,) tensors.

    x (..., T); env0, prev_abs0 (...,). Returns (y, gain, env_final,
    prev_abs_final)."""
    from algodsp_tpu_torch.effects.dynamics.core import compression_gain
    env, prev_abs = env0, prev_abs0
    ys, gains = [], []
    for i in range(x.shape[-1]):
        src = prev_abs
        rising = env + (src - env) * p.attack
        falling = src + (env - src) * p.release
        env = torch.where(src > env, rising, falling)
        g = compression_gain(env, p.threshold_log2, p.knee_db,
                             p.knee_width_log2, p.inv_knee_width_log2,
                             p.compression_factor)
        y = x[..., i] * g * p.makeup
        prev_abs = torch.abs(y)
        ys.append(y)
        gains.append(g)
    if not ys:
        return x.clone(), x.clone(), env, prev_abs
    return torch.stack(ys, dim=-1), torch.stack(gains, dim=-1), env, prev_abs


def dynamics_feedback(x, env0, prev_abs0, p: FeedbackParams):
    """The feedback detector over x (C, T) with (C,) env0 and prev_abs0
    of x's type: the kernel for a CUDA tensor (float32 or float64), the
    plain version for a CPU one. Returns (y, gain, env_final,
    prev_abs_final). `launches` counts the kernel's launches; T = 0
    launches nothing."""
    if x.device.type == "cpu":
        return dynamics_feedback_plain(x, env0, prev_abs0, p)
    if x.device.type != "cuda":
        raise ValueError(f"dynamics_feedback: unsupported device {x.device}")
    symbol = _SYMBOLS.get(x.dtype)
    if symbol is None or x.ndim != 2 or not x.is_contiguous():
        raise ValueError("dynamics_feedback: takes a contiguous float32 or "
                         f"float64 (C, T) tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    c, t = x.shape
    for name, v in (("env0", env0), ("prev_abs0", prev_abs0)):
        if (tuple(v.shape) != (c,) or v.dtype != x.dtype
                or v.device != x.device or not v.is_contiguous()):
            raise ValueError(f"dynamics_feedback: {name} must be a contiguous "
                             f"{x.dtype} ({c},) tensor on {x.device}")
    _build.refuse_grad("dynamics_feedback", "the feedback detector's adjoint "
                       "is not ported", x, env0, prev_abs0)
    if t == 0 or c == 0:
        return x.clone(), x.clone(), env0.clone(), prev_abs0.clone()
    fn = _build.entry("dynamics", symbol, _ARGTYPES)
    y = torch.empty_like(x)
    gain = torch.empty_like(x)
    env_f = torch.empty_like(env0)
    abs_f = torch.empty_like(prev_abs0)
    prm = p.as_doubles()
    with torch.cuda.device(x.device):
        code = fn(*(_build.ptr(v) for v in (x, env0, prev_abs0, y, gain, env_f,
                                            abs_f)),
                  c, t, ctypes.addressof(prm), _build.stream_of(x))
        dynamics_feedback.launches += 1
    _build.check("dynamics", code, "dynamics_feedback")
    return y, gain, env_f, abs_f


dynamics_feedback.launches = 0


def step_cycles(p: FeedbackParams, dtype=torch.float32, n: int = 1 << 16,
                device="cuda") -> float:
    """SM cycles of one dependent step of the kernel's walk on the card
    (one thread, register values, clock64 stamps around n steps): with
    the SM clock, the chain bound of a T-step walk is T times this."""
    fn = _build.entry("dynamics", _LAT_SYMBOLS[dtype], _LAT_ARGTYPES)
    cycles = torch.zeros(1, dtype=torch.int64, device=device)
    sink = torch.zeros(1, dtype=dtype, device=device)
    prm = p.as_doubles()
    for _ in range(2):      # the first run warms the instruction cache
        code = fn(ctypes.addressof(prm), n, 0.7, _build.ptr(cycles),
                  _build.ptr(sink), _build.stream_of(cycles))
        _build.check("dynamics", code, "dynamics_feedback_latency")
        torch.cuda.synchronize(cycles.device)
    return int(cycles.item()) / n


def sm_clock_mhz(device="cuda", cycles: int = 200_000_000) -> float:
    """The SM clock of a one-thread kernel: clock64() cycles it spun over
    their CUDA-event time."""
    fn = _build.entry("dynamics", "dynamics_spin",
                      [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p])
    spun = torch.zeros(1, dtype=torch.int64, device=device)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    code = fn(cycles, _build.ptr(spun), _build.stream_of(spun))
    ev[1].record()
    _build.check("dynamics", code, "dynamics_spin")
    ev[1].synchronize()
    return int(spun.item()) / (ev[0].elapsed_time(ev[1]) * 1e3)
