"""Fused biquad cascade: the CUDA kernel `csrc/biquad_cascade.cu` and its
plain PyTorch version.

Replaces the Pallas kernel `algodsp_tpu/ops/pallas_kernels.py::
_biquad_kernel` (front door `biquad_cascade_pallas`). Same contract: an
S-section cascade with input gain over x (C, N) float32, threading the
(C, S, 4) = [x1, x2, y1, y2] state in and out. Unlike the TPU kernel it
returns the true carry for any N, not only for N % 128 == 0.

The kernel cuts time into chunks of CHUNK samples, runs every chunk from
zero state in parallel, carries the true state across chunks, and adds
that state's response; `chunk_tables` computes the float64 tables this
needs on the host.

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

MAX_SECTIONS = 64  # per-thread state array bound in csrc/biquad_cascade.cu
CHUNK = 256        # samples per thread in the kernel's zero-state pass
# biquad_cascade_f32(x, y, coef, R, A, A_last, state_in, state_out, w, zin,
#                    gain, C, N, S, T, stream)
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_float] + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p]


@lru_cache(maxsize=64)
def _chunk_tables_cached(sos_key: bytes, s: int, T: int, last: int):
    sos = np.frombuffer(sos_key, dtype=np.float64).reshape(s, 5)
    d = 4 * s
    st = np.eye(d).reshape(d, s, 4).copy()     # one unit start state per row
    R = np.zeros((d, T))
    A_last = None
    for n in range(T):
        v = np.zeros(d)                        # zero input
        for i, (b0, b1, b2, a1, a2) in enumerate(sos):
            m = st[:, i].copy()
            out = b0 * v + b1 * m[:, 0] + b2 * m[:, 1] - a1 * m[:, 2] - a2 * m[:, 3]
            st[:, i] = np.stack([v, m[:, 0], out, m[:, 2]], axis=-1)
            v = out
        R[:, n] = v
        if n + 1 == last:
            A_last = st.reshape(d, d).T.copy()
    return R, st.reshape(d, d).T.copy(), A_last


def chunk_tables(sos, T: int, last: int):
    """Host float64 tables of the kernel's chunked form, for a cascade with
    flattened state z (4S,) in the (S, 4) layout:
    R (4S, T), the output over T samples from each unit state with zero
    input; A (4S, 4S), the state transition over T samples; A_last, the
    transition over the last chunk's `last` samples (1 <= last <= T)."""
    sos = np.ascontiguousarray(np.asarray(sos, dtype=np.float64).reshape(-1, 5))
    return _chunk_tables_cached(sos.tobytes(), sos.shape[0], int(T), int(last))


@lru_cache(maxsize=64)
def _device_tables(sos_key: bytes, s: int, T: int, last: int, device: str):
    """The kernel's float64 inputs (coefficients, R, A, A_last), copied to
    `device` once per cascade and chunking instead of on every call."""
    sos = np.frombuffer(sos_key, dtype=np.float64).reshape(s, 5)
    tables = (sos,) + chunk_tables(sos, T, last)
    return tuple(torch.as_tensor(np.array(a)).to(device) for a in tables)


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
    if n == 0 or not 1 <= s <= MAX_SECTIONS:
        raise ValueError(f"biquad_cascade: the kernel takes N >= 1 and 1 to "
                         f"{MAX_SECTIONS} sections, got N={n}, S={s}")
    if state is not None:
        if (tuple(state.shape) != (c, s, 4) or state.dtype != torch.float32
                or state.device != x.device or not state.is_contiguous()):
            raise ValueError("biquad_cascade: state must be a contiguous "
                             f"float32 ({c}, {s}, 4) tensor on {x.device}")
    T = min(CHUNK, n)
    k = -(-n // T)
    coef, R, A, A_last = _device_tables(
        np.ascontiguousarray(sos).tobytes(), s, T, n - (k - 1) * T, str(x.device))
    y = torch.empty_like(x)
    new_state = torch.empty((c, s, 4), dtype=torch.float32, device=x.device)
    w = torch.empty((c, k, 4 * s), dtype=torch.float64, device=x.device)
    zin = torch.empty_like(w)
    with torch.cuda.device(x.device):
        code = fn(_build.ptr(x), _build.ptr(y), _build.ptr(coef), _build.ptr(R),
                  _build.ptr(A), _build.ptr(A_last),
                  ctypes.c_void_p(0 if state is None else state.data_ptr()),
                  _build.ptr(new_state), _build.ptr(w), _build.ptr(zin),
                  float(gain), c, n, s, T, _build.stream_of(x))
        biquad_cascade.launches += 1
    _build.check("biquad_cascade", code, "biquad_cascade")
    return y, new_state


biquad_cascade.launches = 0
