"""Envelope-follower scan (counterpart of `algodsp_tpu/ops/envscan.py`):
one-pole smoothing with branching attack/release coefficients,

    env_n = env_{n-1} + a_n * (t_n - env_{n-1}),
    a_n   = attack  if t_n > env_{n-1} else release.

a_n depends on the running output, so the recurrence is not linear and
stays sequential along time; channels run in parallel. The CUDA kernel
`csrc/envelope.cu` replaces the Pallas kernel
`algodsp_tpu/ops/pallas_kernels.py::_env_kernel` (front door
`envelope_scan_pallas`).

Forward only: the reverse-scan custom VJP comes with the `diff.py`
slice (ROADMAP.md).
"""

from __future__ import annotations

import ctypes

import torch

from algodsp_tpu_torch import _build

# envelope_scan_f32(x, env0, attack, release, traj, env_final, C, T, stream)
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


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


def envelope_scan_kernel(targets, env0, attack, release):
    """The CUDA kernel on (C, T) float32: attack/release/env0 are (C,)
    tensors on the same device. Returns (env_final (C,), trajectory)."""
    x = targets
    if x.device.type != "cuda":
        raise ValueError(f"envelope_scan_kernel: takes a CUDA tensor, got "
                         f"one on {x.device}")
    fn = _build.entry("envelope", "envelope_scan_f32", _ARGTYPES)
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError("envelope_scan_kernel: takes a contiguous float32 "
                         f"(C, T) tensor, got {x.dtype} {tuple(x.shape)}")
    c, t = x.shape
    if t == 0:
        raise ValueError("envelope_scan_kernel: empty time axis")
    for name, v in (("env0", env0), ("attack", attack), ("release", release)):
        if (tuple(v.shape) != (c,) or v.dtype != torch.float32
                or v.device != x.device or not v.is_contiguous()):
            raise ValueError(f"envelope_scan_kernel: {name} must be a "
                             f"contiguous float32 ({c},) tensor on {x.device}")
    traj = torch.empty_like(x)
    env_final = torch.empty((c,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = fn(_build.ptr(x), _build.ptr(env0), _build.ptr(attack),
                  _build.ptr(release), _build.ptr(traj), _build.ptr(env_final),
                  c, t, _build.stream_of(x))
        envelope_scan_kernel.launches += 1
    _build.check("envelope", code, "envelope_scan")
    return env_final, traj


envelope_scan_kernel.launches = 0


def envelope_scan(targets, env0, attack, release):
    """Run the branching one-pole envelope along the last axis.

    targets: (..., T); env0: (...,); attack, release: scalars or arrays
    broadcastable to (...,) (per-channel ballistics). Returns
    (env_final, trajectory). `env_final` is the state after the last
    real sample.

    CUDA tensors run the kernel (float32; leading dims are flattened
    onto its channel axis); CPU tensors run `envelope_scan_plain`."""
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
