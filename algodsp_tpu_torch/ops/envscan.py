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

Forward only: the reverse-scan custom VJP comes with the `diff.py`
slice (ROADMAP.md).
"""

from __future__ import annotations

import ctypes

import torch

from algodsp_tpu_torch import _build

ENV_SMEM_BYTES = 196608    # a segment of x staged in shared memory
ENV_MAX_THREADS = 1024     # one block per channel, one chunk per thread
ENV_MIN_CHUNK = 15         # shorter chunks only add sweeps
ENV_MAX_SWEEPS = 32        # then the block walks the segment exactly

# envelope_scan_f{32,64}(x, env0, attack, release, traj, env_final, C, n,
#                        seg, L, threads, max_sweeps, counts, stream)
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong]
             + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
_SYMBOLS = {torch.float32: "envelope_scan_f32",
            torch.float64: "envelope_scan_f64"}


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


def envelope_scan(targets, env0, attack, release):
    """Run the branching one-pole envelope along the last axis.

    targets: (..., T); env0: (...,); attack, release: scalars or arrays
    broadcastable to (...,) (per-channel ballistics). Returns
    (env_final, trajectory). `env_final` is the state after the last
    real sample.

    CUDA tensors run the kernel (float32 or float64; leading dims are
    flattened onto its channel axis); CPU tensors run
    `envelope_scan_plain`."""
    dtype, device = targets.dtype, targets.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"envelope_scan: unsupported device {device}")
    as_t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    env0, attack, release = as_t(env0), as_t(attack), as_t(release)
    if device.type == "cpu":
        return envelope_scan_plain(targets, env0, attack, release)
    lead = targets.shape[:-1]
    t = targets.shape[-1]
    flat = lambda v: torch.broadcast_to(v, lead).reshape(-1).contiguous()
    env_f, traj = envelope_scan_kernel(
        targets.reshape(-1, t).contiguous(), flat(env0), flat(attack),
        flat(release))
    return env_f.reshape(lead), traj.reshape(lead + (t,))
