"""Envelope-follower scan (counterpart of `algodsp_tpu/ops/envscan.py`):
one-pole smoothing with branching attack/release coefficients,

    env_n = env_{n-1} + a_n * (t_n - env_{n-1}),
    a_n   = attack  if t_n > env_{n-1} else release.

a_n depends on the running output, so the recurrence is not linear; once
every sample's choice is fixed it is affine, and the CUDA kernel
`csrc/envelope.cu` splits time by that selection fixpoint (the scheme of
`algodsp_tpu/parallel/sharded.py::envelope_time_sharded`, with a
block's chunks in place of shards). It replaces the Pallas kernel
`algodsp_tpu/ops/pallas_kernels.py::_env_kernel` (front door
`envelope_scan_pallas`) and takes float32 and float64.

`envelope_scan` is differentiable in all four inputs through
`EnvelopeFn`, the port of the reference's custom VJP `_envelope_bwd`:
its backward is the reverse-time scan of the adjoint, the CUDA kernel
`envelope_adjoint` of the same source on the card (float32 and
float64; a channel spread over a cluster of blocks where the channels
leave SMs idle, `adjoint_plan`) and `envelope_adjoint_plain` on the
CPU, with the selection read from the forward's own trajectory.
"""

from __future__ import annotations

import ctypes

import torch

from algodsp_tpu_torch import _build

ENV_SMEM_BYTES = 196608    # a segment of x staged in shared memory
ENV_MAX_THREADS = 1024     # one block per channel, one chunk per thread
ENV_MIN_CHUNK = 15         # shorter chunks only add sweeps
ENV_MAX_SWEEPS = 32        # then the block walks the segment exactly
ADJ_MAX_CLUSTER = 8        # blocks per channel (ENV_ADJ_MAX_CLUSTER)
ADJ_MIN_PART = 2048        # samples per block below which a cluster costs more

# envelope_scan_f{32,64}(x, env0, attack, release, traj, env_final, C, n,
#                        seg, L, threads, max_sweeps, counts, stream)
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong]
             + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
_SYMBOLS = {torch.float32: "envelope_scan_f32",
            torch.float64: "envelope_scan_f64"}
# envelope_adjoint_f{32,64}(x, traj, env0, attack, release, g, g_final, dx,
#                           denv0, datt, drel, C, n, seg, L, threads, B,
#                           stream)
_ADJ_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int, ctypes.c_longlong]
                 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_ADJ_SYMBOLS = {torch.float32: "envelope_adjoint_f32",
                torch.float64: "envelope_adjoint_f64"}


def chunk_plan(t: int, itemsize: int) -> tuple[int, int, int]:
    """The kernel's split of a T-sample channel: (segment, chunk length
    L, threads). A segment (at most ENV_SMEM_BYTES of x) is staged in
    shared memory; each thread owns L consecutive samples of it, L odd
    (distinct banks), at least ENV_MIN_CHUNK, and enough for at most
    ENV_MAX_THREADS chunks. A segment no longer than that is one chunk:
    the sequential walk."""
    seg = min(t, ENV_SMEM_BYTES // itemsize)
    length = max(ENV_MIN_CHUNK, -(-seg // ENV_MAX_THREADS)) | 1
    if length >= seg:
        return seg, seg, 32
    chunks = -(-seg // length)
    return seg, length, 32 * -(-chunks // 32)


def envelope_scan_plain(targets, env0, attack, release):
    """Plain PyTorch version, one time step at a time.

    targets (..., T); env0, attack, release broadcastable to (...,).
    Returns (env_final (...,), trajectory (..., T))."""
    lead = targets.shape[:-1]
    env = torch.broadcast_to(env0, lead).clone()
    att = torch.broadcast_to(attack, lead)
    rel = torch.broadcast_to(release, lead)
    out = torch.empty_like(targets)
    for i in range(targets.shape[-1]):
        t = targets[..., i]
        coeff = torch.where(t > env, att, rel)
        env = env + coeff * (t - env)
        out[..., i] = env
    return env, out


def adjoint_plan(t: int, channels: int, sms: int,
                 itemsize: int) -> tuple[int, int, int, int]:
    """The adjoint kernel's split of `channels` channels of t samples
    of `itemsize` bytes on a card of `sms` SMs: (segment, chunk length L,
    threads, blocks per channel B).

    Where 2 * channels <= sms, a channel's time runs on a cluster of B
    blocks (at most ADJ_MAX_CLUSTER, each at least ADJ_MIN_PART
    samples), block b holding the part [b * part, (b + 1) * part),
    part = ceil(t / B); otherwise B = 1. A block walks its part in
    segments of equal length, each at most ENV_SMEM_BYTES of x,
    env_prev and the cotangent with 16 bytes of slack an array (the
    kernel shifts each to its source's 16-byte alignment); each thread owns L consecutive samples
    of a segment, L odd (distinct shared-memory banks), at least
    ENV_MIN_CHUNK, and enough for at most ENV_MAX_THREADS chunks."""
    blocks = 1
    if 2 * channels <= sms:
        blocks = max(1, min(ADJ_MAX_CLUSTER, sms // channels,
                            t // ADJ_MIN_PART))
    part = -(-t // blocks)
    vec = 16 // itemsize
    cap = ENV_SMEM_BYTES // (3 * itemsize) - vec
    seg = -(-part // -(-part // cap))
    length = max(ENV_MIN_CHUNK, -(-seg // ENV_MAX_THREADS)) | 1
    chunks = -(-seg // length)
    return seg, length, 32 * -(-chunks // 32), blocks


def envelope_adjoint_plain(targets, traj, env0, attack, release, g, g_final):
    """Plain PyTorch adjoint of the envelope over (C, T), one time step at
    a time backward: with env_prev the trajectory shifted by env0, the
    selection sel = targets > env_prev and a = attack or release by sel,
    the scan s_n = g_n + (1 - a_{n+1}) s_{n+1} from
    s_{T-1} = g_{T-1} + g_final. Returns (dtargets = a s (C, T),
    denv0 = (1 - a_0) s_0, datt = sum over sel of s (targets - env_prev),
    drel = the same over not sel), the last three (C,).

    The carry is formed as s - a s, not (1 - a) s: for a coefficient
    near 0 (a compressor's release, ~1.4e-4) 1 - a in float32 keeps only
    a few bits of a, and the scan multiplies that error over ~1/a steps
    (85 dB against float64 at the compressor's ballistics, 130 dB as
    s - a s). The forward walks env + a (t - env) for the same reason."""
    env_prev = torch.cat([env0[:, None], traj[:, :-1]], dim=-1)
    sel = targets > env_prev
    a = torch.where(sel, attack[:, None], release[:, None])
    s = torch.empty_like(targets)
    carry = g_final
    for i in range(targets.shape[-1] - 1, -1, -1):
        s[:, i] = g[:, i] + carry
        carry = s[:, i] - a[:, i] * s[:, i]
    sd = s * (targets - env_prev)
    zero = torch.zeros_like(sd)
    return (a * s, carry, torch.where(sel, sd, zero).sum(-1),
            torch.where(sel, zero, sd).sum(-1))


def envelope_adjoint(targets, traj, env0, attack, release, g, g_final):
    """The envelope's adjoint (`envelope_adjoint_plain`'s function) on
    (C, T) and (C,) tensors of one type: CUDA tensors run the kernel
    (float32 or float64, contiguous), CPU tensors the plain version.
    `launches` counts the kernel's launches."""
    if targets.device.type == "cpu":
        return envelope_adjoint_plain(targets, traj, env0, attack, release,
                                      g, g_final)
    if targets.device.type != "cuda":
        raise ValueError(f"envelope_adjoint: unsupported device "
                         f"{targets.device}")
    symbol = _ADJ_SYMBOLS.get(targets.dtype)
    if symbol is None or targets.ndim != 2 or targets.shape[0] == 0 \
            or targets.shape[1] == 0:
        raise ValueError("envelope_adjoint: takes a non-empty float32 or "
                         f"float64 (C, T) tensor, got {targets.dtype} "
                         f"{tuple(targets.shape)}")
    c, t = targets.shape
    fn = _build.entry("envelope", symbol, _ADJ_ARGTYPES)
    for name, v, shape in (("targets", targets, (c, t)), ("traj", traj, (c, t)),
                           ("g", g, (c, t)), ("env0", env0, (c,)),
                           ("attack", attack, (c,)), ("release", release, (c,)),
                           ("g_final", g_final, (c,))):
        if (tuple(v.shape) != shape or v.dtype != targets.dtype
                or v.device != targets.device or not v.is_contiguous()):
            raise ValueError(f"envelope_adjoint: {name} must be a contiguous "
                             f"{targets.dtype} {shape} tensor on "
                             f"{targets.device}")
    seg, length, threads, blocks = adjoint_plan(
        t, c, _build.sm_count(targets.device), targets.element_size())
    dx = torch.empty_like(targets)
    denv0, datt, drel = (torch.empty_like(env0) for _ in range(3))
    with torch.cuda.device(targets.device):
        code = fn(*(_build.ptr(v) for v in (
            targets, traj, env0, attack, release, g, g_final, dx, denv0, datt,
            drel)), c, t, seg, length, threads, blocks,
            _build.stream_of(targets))
        envelope_adjoint.launches += 1
    _build.check("envelope", code, "envelope_adjoint")
    return dx, denv0, datt, drel


envelope_adjoint.launches = 0


class EnvelopeKernel:
    """The CUDA kernel on (C, T) float32 or float64, called as
    `envelope_scan_kernel(targets, env0, attack, release)` with
    attack/release/env0 (C,) tensors of the same type on the same
    device. Returns (env_final (C,), trajectory).

    `launches` counts the calls that launched the kernel. The kernel
    also adds, per channel and segment, to counters on the device that
    `counts()` reads (waiting for the card): solves, sweeps (fixpoint
    sweeps over all solves), exact_walks (solves that hit ENV_MAX_SWEEPS
    and walked the segment in order) and max_sweeps (the most one solve
    took); `sweeps` and `exact_walks` read one each. `reset_counts()`
    zeroes them."""

    def __init__(self):
        self.launches = 0
        self._counts: dict[torch.device, torch.Tensor] = {}

    def _counter(self, device) -> torch.Tensor:
        buf = self._counts.get(device)
        if buf is None:
            buf = torch.zeros(4, dtype=torch.int64, device=device)
            self._counts[device] = buf
        return buf

    def counts(self) -> dict[str, int]:
        total = [0, 0, 0, 0]
        for buf in self._counts.values():
            vals = buf.tolist()
            total = [a + b for a, b in zip(total, vals[:3])] + [
                max(total[3], vals[3])]
        return dict(zip(("solves", "sweeps", "exact_walks", "max_sweeps"),
                        total))

    @property
    def sweeps(self) -> int:
        return self.counts()["sweeps"]

    @property
    def exact_walks(self) -> int:
        return self.counts()["exact_walks"]

    def reset_counts(self) -> None:
        for buf in self._counts.values():
            buf.zero_()

    def __call__(self, targets, env0, attack, release):
        x = targets
        if x.device.type != "cuda":
            raise ValueError(f"envelope_scan_kernel: takes a CUDA tensor, got "
                             f"one on {x.device}")
        symbol = _SYMBOLS.get(x.dtype)
        if symbol is None or x.ndim != 2 or not x.is_contiguous():
            raise ValueError("envelope_scan_kernel: takes a contiguous float32 "
                             f"or float64 (C, T) tensor, got {x.dtype} "
                             f"{tuple(x.shape)}")
        c, t = x.shape
        if t == 0 or c == 0:
            raise ValueError("envelope_scan_kernel: empty input")
        _build.refuse_grad("envelope_scan_kernel", "the raw kernel call has "
                           "no backward; envelope_scan carries it", x, env0,
                           attack, release)
        fn = _build.entry("envelope", symbol, _ARGTYPES)
        for name, v in (("env0", env0), ("attack", attack), ("release", release)):
            if (tuple(v.shape) != (c,) or v.dtype != x.dtype
                    or v.device != x.device or not v.is_contiguous()):
                raise ValueError(f"envelope_scan_kernel: {name} must be a "
                                 f"contiguous {x.dtype} ({c},) tensor on "
                                 f"{x.device}")
        seg, length, threads = chunk_plan(t, x.element_size())
        counts = self._counter(x.device)
        traj = torch.empty_like(x)
        env_final = torch.empty((c,), dtype=x.dtype, device=x.device)
        with torch.cuda.device(x.device):
            code = fn(_build.ptr(x), _build.ptr(env0), _build.ptr(attack),
                      _build.ptr(release), _build.ptr(traj),
                      _build.ptr(env_final), c, t, seg, length, threads,
                      ENV_MAX_SWEEPS, _build.ptr(counts), _build.stream_of(x))
            self.launches += 1
        _build.check("envelope", code, "envelope_scan")
        return env_final, traj


envelope_scan_kernel = EnvelopeKernel()


def _envelope(targets, env0, attack, release):
    """K4 for a CUDA tensor, the plain version for a CPU one, on (C, T)
    and (C,) tensors."""
    if targets.device.type == "cuda":
        return envelope_scan_kernel(targets, env0, attack, release)
    return envelope_scan_plain(targets, env0, attack, release)


class EnvelopeFn(torch.autograd.Function):
    """(env_final, trajectory) of the envelope over (C, T) with (C,)
    env0, attack and release, differentiable in all four (the
    reference's `_envelope_vjp`). It saves its inputs and its own
    trajectory, so the backward's selection targets > env_prev is the
    one the forward took. CUDA tensors run K4 and `envelope_adjoint`,
    CPU tensors their plain versions."""

    @staticmethod
    def forward(ctx, targets, env0, attack, release):
        env_f, traj = _envelope(targets, env0, attack, release)
        ctx.save_for_backward(targets, traj, env0, attack, release)
        return env_f, traj

    @staticmethod
    def backward(ctx, g_final, g):
        return envelope_adjoint(*ctx.saved_tensors, g.contiguous(),
                                g_final.contiguous())


def envelope_scan(targets, env0, attack, release):
    """Run the branching one-pole envelope along the last axis.

    targets: (..., T); env0: (...,); attack, release: scalars or arrays
    broadcastable to (...,) (per-channel ballistics). Returns
    (env_final, trajectory). `env_final` is the state after the last
    real sample.

    Leading dims are flattened onto one channel axis; the inputs run
    through `EnvelopeFn`, differentiable in every tensor argument (the broadcasts unbroadcast the gradients).
    CUDA tensors run the kernels
    (float32 or float64), CPU tensors their plain versions. T = 0
    returns env0 and an empty trajectory without a launch, still
    differentiable in env0."""
    dtype, device = targets.dtype, targets.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"envelope_scan: unsupported device {device}")
    as_t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    env0, attack, release = as_t(env0), as_t(attack), as_t(release)
    lead = targets.shape[:-1]
    t = targets.shape[-1]
    if t == 0:
        # nothing to walk: env0 is the final state
        return torch.broadcast_to(env0, lead).clone(), targets.clone()
    flat = lambda v: torch.broadcast_to(v, lead).reshape(-1).contiguous()
    env_f, traj = EnvelopeFn.apply(targets.reshape(-1, t).contiguous(),
                                   flat(env0), flat(attack), flat(release))
    return env_f.reshape(lead), traj.reshape(lead + (t,))
