"""Deterministic signal generators and utilities (counterpart of
`algodsp_tpu/signal/generate.py`).

Capability parity with `dsp/signal/generate.go`: sine, multisine,
impulse, linear/log sweep, white/pink noise, Normalize, Clip, RemoveDC,
EnvelopeFollower.

- The generators are closed-form over a sample-index vector, made on
  the CUDA card unless `device` says otherwise, in `dtype`.
- Noise draws from a `torch.Generator` seeded with `seed` on the target
  device: deterministic per seed and device, but another stream than
  the reference's `jax.random` (threefry), so the two packages' noise
  agrees in its statistics, not sample for sample.
- Pink noise keeps the Voss-McCartney 5-band structure
  (`generate.go:210-250`) with the per-band "update band b and hold"
  found by a running count of the updates (`voss_mccartney`, a function
  of the two uniform vectors, equal to the reference's step on the
  same uniforms).
- `envelope_follower` is the one sequential recurrence (branching
  attack/release, `generate.go:322-350`); it runs the port's
  `envelope_scan`, the CUDA kernel `csrc/envelope.cu` on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from algodsp_tpu_torch._device import resolve_device
from algodsp_tpu_torch.ops.envscan import envelope_scan


def _time_index(samples: int, dtype, device):
    return torch.arange(samples, dtype=dtype, device=resolve_device(device))


def sine(freq_hz: float, amplitude: float, samples: int, sample_rate: float,
         dtype=torch.float32, device=None):
    """Sine wave: amplitude * sin(2*pi*f*i/sr) (`generate.go:76-96`)."""
    if samples <= 0:
        raise ValueError(f"sine samples must be > 0: {samples}")
    if sample_rate <= 0:
        raise ValueError(f"sine sample rate must be > 0: {sample_rate}")
    step = 2.0 * np.pi * freq_hz / sample_rate
    return amplitude * torch.sin(step * _time_index(samples, dtype, device))


def multisine(freqs_hz, amplitude: float, samples: int, sample_rate: float,
              dtype=torch.float32, device=None):
    """Equal-weighted sum of tones (`generate.go:99-125`)."""
    freqs = np.atleast_1d(np.asarray(freqs_hz, dtype=np.float64))
    if samples <= 0:
        raise ValueError(f"multisine samples must be > 0: {samples}")
    if freqs.size == 0:
        raise ValueError("multisine frequencies must not be empty")
    if sample_rate <= 0:
        raise ValueError(f"multisine sample rate must be > 0: {sample_rate}")
    i = _time_index(samples, dtype, device)
    steps = torch.as_tensor(2.0 * np.pi * freqs / sample_rate, dtype=dtype,
                            device=i.device)
    tones = torch.sin(steps[:, None] * i[None, :])
    return (amplitude / freqs.size) * torch.sum(tones, dim=0)


def impulse(amplitude: float, samples: int, pos: int = 0, dtype=torch.float32,
            device=None):
    """Unit impulse at pos (`generate.go:128-141`)."""
    if samples <= 0:
        raise ValueError(f"impulse samples must be > 0: {samples}")
    if pos < 0 or pos >= samples:
        raise ValueError(f"impulse position out of range: pos={pos} samples={samples}")
    out = torch.zeros((samples,), dtype=dtype, device=resolve_device(device))
    out[pos] = amplitude
    return out


def linear_sweep(start_hz: float, end_hz: float, amplitude: float, samples: int,
                 sample_rate: float, dtype=torch.float32, device=None):
    """Linear-frequency sweep (`generate.go:143-163`)."""
    if samples <= 0:
        raise ValueError(f"linear sweep samples must be > 0: {samples}")
    if sample_rate <= 0:
        raise ValueError(f"linear sweep sample rate must be > 0: {sample_rate}")
    duration = samples / sample_rate
    k = (end_hz - start_hz) / duration
    t = _time_index(samples, dtype, device) / sample_rate
    phase = 2.0 * np.pi * (start_hz * t + 0.5 * k * t * t)
    return amplitude * torch.sin(phase)


def log_sweep(start_hz: float, end_hz: float, amplitude: float, samples: int,
              sample_rate: float, dtype=torch.float32, device=None):
    """Exponential-frequency sweep (`generate.go:166-185`)."""
    if samples <= 0:
        raise ValueError(f"log sweep samples must be > 0: {samples}")
    if sample_rate <= 0:
        raise ValueError(f"log sweep sample rate must be > 0: {sample_rate}")
    if start_hz <= 0 or end_hz <= 0:
        raise ValueError(f"log sweep frequencies must be > 0: start={start_hz} end={end_hz}")
    duration = samples / sample_rate
    k = math.log(end_hz / start_hz) / duration
    if k == 0:
        return sine(start_hz, amplitude, samples, sample_rate, dtype, device)
    t = _time_index(samples, dtype, device) / sample_rate
    phase = 2.0 * np.pi * start_hz * ((torch.exp(k * t) - 1.0) / k)
    return amplitude * torch.sin(phase)


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def white_noise(amplitude: float, samples: int, seed: int = 1,
                dtype=torch.float32, device=None):
    """Uniform white noise in [-amplitude, amplitude] (`generate.go:188-205`).

    Drawn from a `torch.Generator` seeded with `seed` on the target
    device: deterministic per seed and device, and another stream than
    the reference's `jax.random` draw."""
    if samples <= 0:
        raise ValueError(f"noise samples must be > 0: {samples}")
    if amplitude < 0:
        raise ValueError(f"noise amplitude must be >= 0: {amplitude}")
    device = resolve_device(device)
    u = torch.rand((samples,), generator=_generator(seed, device),
                   dtype=dtype, device=device)
    # the reference's uniform(minval, maxval): u * (max - min) + min
    return u * (2.0 * amplitude) - amplitude


# Voss-McCartney band weights / cumulative thresholds (generate.go:219-221).
_PINK_A = np.array([0.23980, 0.18727, 0.16380, 0.194685, 0.214463])
_PINK_PSUM = np.array([0.00198, 0.01478, 0.06378, 0.23378, 0.91578])


def voss_mccartney(ur1, val):
    """The Voss-McCartney pink-noise sum for the uniforms ur1 in [0, 1)
    (which band updates) and val in [-1, 1) (its new value), 1-D float32
    of one length, as the reference computes it (`generate.go:210-250`):
    band b updates where ur1 <= psum[b] first, ur1 > psum[-1] updates
    nothing, and each band holds its latest update.

    The reference finds the latest update by a running maximum of the
    update positions; here a running count of the updates indexes a
    table of their values, which picks the same value. torch.cummax
    scans a single long row slowly on the card: 2^24 samples of pink
    noise took 253.0 ms that way on an NVIDIA H100 (700 W), 6.7 ms this
    way (chip_smoke.py)."""
    psum = torch.as_tensor(_PINK_PSUM, dtype=torch.float32, device=ur1.device)
    band = torch.searchsorted(psum, ur1, right=False)  # (samples,) in [0, 5]
    weights = torch.as_tensor(_PINK_A, dtype=torch.float32, device=ur1.device)
    zero = torch.zeros_like(val)

    def held_contribution(b):
        hit = band == b
        v = torch.where(hit, val * weights[b], zero)
        # forward-fill: the value persists until the next hit. count[i]
        # updates so far; table[c] is the c-th update's value, table[0]
        # = 0 before the first (the non-updates all write 0 there)
        count = torch.cumsum(hit, dim=-1)
        table = torch.zeros(val.shape[-1] + 1, dtype=val.dtype,
                            device=val.device).scatter_(
            0, torch.where(hit, count, torch.zeros_like(count)), v)
        return table[count]

    total = held_contribution(0)
    for b in range(1, 5):
        total = total + held_contribution(b)
    return total


def pink_noise(amplitude: float, samples: int, seed: int = 1,
               dtype=torch.float32, device=None):
    """Pink noise (~-3 dB/oct) via Voss-McCartney (`generate.go:210-250`).

    The two float32 uniform vectors are drawn from a `torch.Generator`
    seeded with `seed` on the target device (another stream than the
    reference's `jax.random`); `voss_mccartney` turns them into the sum
    exactly as the reference does with its own."""
    if samples <= 0:
        raise ValueError(f"noise samples must be > 0: {samples}")
    if amplitude < 0:
        raise ValueError(f"noise amplitude must be >= 0: {amplitude}")
    device = resolve_device(device)
    g = _generator(seed, device)
    ur1 = torch.rand((samples,), generator=g, dtype=torch.float32, device=device)
    val = torch.rand((samples,), generator=g, dtype=torch.float32,
                     device=device) * 2.0 - 1.0
    return (voss_mccartney(ur1, val) * amplitude).to(dtype)


def normalize(x, target_peak: float):
    """Scale to target peak amplitude (`generate.go:253-283`)."""
    if target_peak < 0:
        raise ValueError(f"normalize target peak must be >= 0: {target_peak}")
    max_abs = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    nz = max_abs > 0
    scale = torch.where(nz, target_peak / torch.where(nz, max_abs,
                                                      torch.ones_like(max_abs)),
                        torch.zeros_like(max_abs))
    return x * scale


def clip(x, min_val: float, max_val: float):
    """Hard clip to [min_val, max_val] (`generate.go:286-302`)."""
    if min_val > max_val:
        raise ValueError(f"clip min must be <= max: min={min_val} max={max_val}")
    return torch.clamp(x, min_val, max_val)


def remove_dc(x):
    """Subtract the mean along time (`generate.go:305-319`)."""
    return x - torch.mean(x, dim=-1, keepdim=True)


def envelope_follower(x, attack: float, release: float):
    """Peak envelope with instant-branch attack/release (`generate.go:322-350`).

    env += coeff * (|x| - env), coeff = attack when rising else release;
    the trajectory of the port's `envelope_scan` (the CUDA kernel on a
    CUDA tensor, its plain version on a CPU one) from zero.
    """
    if not (0 <= attack <= 1):
        raise ValueError(f"attack must be in [0,1]: {attack}")
    if not (0 <= release <= 1):
        raise ValueError(f"release must be in [0,1]: {release}")
    env0 = x.new_zeros(x.shape[:-1])
    _, env = envelope_scan(torch.abs(x), env0, attack, release)
    return env
