"""Fused biquad cascade: the CUDA kernel `csrc/biquad_cascade.cu` and its
plain PyTorch version.

Replaces the Pallas kernel `algodsp_tpu/ops/pallas_kernels.py::
_biquad_kernel` (front door `biquad_cascade_pallas`). Same contract: an
S-section cascade with input gain over x (C, N) float32, threading the
(C, S, 4) = [x1, x2, y1, y2] state in and out. Unlike the TPU kernel it
returns the true carry for any N, not only for N % 128 == 0.

The kernel runs section by section over a segment of each channel in
shared memory, one chunk of L samples per thread, and carries each
section's two state values across the chunks by a block scan;
`segment_plan` splits a channel, `section_tables` computes the float64
per-section tables the kernel reads.

`biquad_cascade` launches the kernel for CUDA tensors and uses
`biquad_cascade_plain` (the blocked Toeplitz engine of `ops/linrec.py`)
only for CPU tensors.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from algodsp_tpu_torch import _build
from algodsp_tpu_torch.ops import linrec

MAX_SECTIONS = 64           # shared-memory state bound (csrc/biquad_cascade.cu)
SMEM_BYTES = 196608         # float64 segment in shared memory (BQ_SMEM_BYTES)
MAX_THREADS = 512           # one chunk per thread
MIN_CHUNK = 3               # shorter chunks only deepen the scan
MAX_CLUSTER = 8             # blocks per channel (BQ_MAX_CLUSTER)
MIN_PART = 4096             # samples per block below which a cluster costs more
# biquad_cascade_f32(x, y, tab, state_in, state_out, gain, C, n, S, seg, L,
#                    threads, B, stream)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_longlong] \
    + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def segment_plan(n: int, channels: int, sms: int):
    """The kernel's split of `channels` channels of n samples on a card of
    `sms` SMs: (segment, chunk length L, threads, blocks per channel B).

    A segment is at most SMEM_BYTES of float64 samples; each thread owns
    L consecutive samples of it, L odd (distinct shared-memory banks), at
    least MIN_CHUNK, and enough for at most MAX_THREADS chunks. Where the
    channels leave SMs idle, a channel's segments run at once on a
    cluster of B blocks (at most MAX_CLUSTER, each at least MIN_PART
    samples; every segment but the last a whole number of chunks and the
    last at least 2 samples); otherwise B = 1 and one block runs them in
    order."""
    def split(seg):
        length = max(MIN_CHUNK, -(-seg // MAX_THREADS)) | 1
        chunks = -(-seg // length)
        return length, 32 * -(-chunks // 32)

    cap = SMEM_BYTES // 8
    blocks = min(MAX_CLUSTER, sms // channels, n // MIN_PART)
    if blocks > 1:
        length, threads = split(-(-n // blocks))
        seg = -(-n // (blocks * length)) * length
        if seg <= cap and (blocks - 1) * seg + 2 <= n:
            return seg, length, threads, blocks
    seg = -(-n // -(-n // cap))
    return (seg, *split(seg), 1)


def section_tables(sos, length: int, seg: int) -> np.ndarray:
    """(S, 153) float64 per section, the kernel's layout: b0 b1 b2 a1 a2,
    then 2 x 2 matrices, row-major: G, the transition of the section's
    transposed-direct-form state (s1, s2) over L samples of zero input,
    to the powers 1..32, 64, 128, 256 and 512 (the block scan's
    strides); and the transition over `seg` samples (a cluster's
    segment). One sample maps (s1, s2) to (s2 - a1 s1, -a2 s1)."""
    sos = np.asarray(sos, dtype=np.float64).reshape(-1, 5)
    one = np.zeros((sos.shape[0], 2, 2))
    one[:, 0, 0], one[:, 0, 1], one[:, 1, 0] = -sos[:, 3], 1.0, -sos[:, 4]
    g = np.linalg.matrix_power(one, length)
    powers = [g]
    for _ in range(31):
        powers.append(powers[-1] @ g)
    for _ in range(4):
        powers.append(powers[-1] @ powers[-1])
    powers.append(np.linalg.matrix_power(one, seg))
    return np.concatenate(
        [sos, np.stack(powers, axis=1).reshape(sos.shape[0], -1)], axis=1)


@lru_cache(maxsize=64)
def _device_tables(sos_key: bytes, s: int, length: int, seg: int,
                   device: str):
    """`section_tables` copied to `device` once per cascade and plan
    instead of on every call."""
    sos = np.frombuffer(sos_key, dtype=np.float64).reshape(s, 5)
    return torch.as_tensor(section_tables(sos, length, seg)).to(device)


@lru_cache(maxsize=16)
def _sm_count(device: str) -> int:
    props = torch.cuda.get_device_properties(torch.device(device))
    return props.multi_processor_count


def biquad_cascade_plain(x, sos, gain: float = 1.0, state=None):
    """Plain PyTorch cascade on the blocked engine: (y, new_state)."""
    sos = np.asarray(sos, dtype=np.float64).reshape(-1, 5)
    if state is None:
        state = x.new_zeros(x.shape[:-1] + (sos.shape[0], 4))
    if gain != 1.0:
        x = x * gain
    new_state, y = linrec.run_sections(x, sos, state, mode="blocked")
    return y, new_state


def biquad_cascade(x, sos, gain: float = 1.0, state=None):
    """S-section biquad cascade of x (C, N) with gain: returns
    (y (C, N), new_state (C, S, 4)).

    CUDA tensors run the fused kernel (float32, contiguous); CPU tensors
    run `biquad_cascade_plain`."""
    sos = np.asarray(sos, dtype=np.float64).reshape(-1, 5)
    if x.device.type == "cpu":
        return biquad_cascade_plain(x, sos, gain, state)
    if x.device.type != "cuda":
        raise ValueError(f"biquad_cascade: unsupported device {x.device}")
    fn = _build.entry("biquad_cascade", "biquad_cascade_f32", _ARGTYPES)
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError("biquad_cascade: the kernel takes a contiguous "
                         f"float32 (C, N) tensor, got {x.dtype} {tuple(x.shape)}")
    c, n = x.shape
    s = sos.shape[0]
    if n == 0 or c == 0 or not 1 <= s <= MAX_SECTIONS:
        raise ValueError(f"biquad_cascade: the kernel takes C, N >= 1 and 1 "
                         f"to {MAX_SECTIONS} sections, got C={c}, N={n}, "
                         f"S={s}")
    if state is not None:
        if (tuple(state.shape) != (c, s, 4) or state.dtype != torch.float32
                or state.device != x.device or not state.is_contiguous()):
            raise ValueError("biquad_cascade: state must be a contiguous "
                             f"float32 ({c}, {s}, 4) tensor on {x.device}")
    seg, length, threads, blocks = segment_plan(n, c,
                                                _sm_count(str(x.device)))
    tab = _device_tables(np.ascontiguousarray(sos).tobytes(), s, length, seg,
                         str(x.device))
    y = torch.empty_like(x)
    new_state = torch.empty((c, s, 4), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = fn(_build.ptr(x), _build.ptr(y), _build.ptr(tab),
                  ctypes.c_void_p(0 if state is None else state.data_ptr()),
                  _build.ptr(new_state), float(gain), c, n, s, seg, length,
                  threads, blocks, _build.stream_of(x))
        biquad_cascade.launches += 1
    _build.check("biquad_cascade", code, "biquad_cascade")
    return y, new_state


biquad_cascade.launches = 0
