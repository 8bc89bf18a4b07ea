"""Staging buffers with reuse semantics (counterpart of
`algodsp_tpu/core/pool.py`).

Capability parity with the reference's `dsp/buffer` package
(`buffer.go:5-110`, `pool.go:7-46`): a `Buffer` wrapping a 1-D float
tensor with Grow/Resize/Zero reuse semantics and a size-stable `Pool`
so hot streaming loops allocate nothing per block. Buffers hold their
tensors on the pool's device: staging tensors that feed blocks into the
card or drain them from it.
"""

from __future__ import annotations

import threading

import torch

from algodsp_tpu_torch._device import resolve_device


class Buffer:
    """A float staging buffer with length/capacity split (`buffer.go:5`).

    `samples` is a view of the live region; writes through it are
    visible to later users, exactly like the Go slice bridge
    (`buffer.go:20-27`). Lives on the CUDA card unless `device` says
    otherwise.
    """

    def __init__(self, length: int = 0, dtype=torch.float32, device=None):
        length = max(int(length), 0)
        self._data = torch.zeros(length, dtype=dtype,
                                 device=resolve_device(device))
        self._len = length

    @classmethod
    def from_array(cls, a: torch.Tensor) -> "Buffer":
        """Wrap an existing tensor, flattened, on its own device and
        without copying where it is contiguous (`buffer.go:20`)."""
        b = cls(0, a.dtype, a.device)
        b._data = a.contiguous().reshape(-1)
        b._len = b._data.numel()
        return b

    @property
    def samples(self) -> torch.Tensor:
        """View of the live region (length `len(self)`), no copy."""
        return self._data[:self._len]

    @property
    def dtype(self) -> torch.dtype:
        return self._data.dtype

    @property
    def device(self) -> torch.device:
        return self._data.device

    def __len__(self) -> int:
        return self._len

    @property
    def capacity(self) -> int:
        return self._data.numel()

    def grow(self, n: int) -> None:
        """Ensure capacity >= n, preserving existing data (`buffer.go:40`)."""
        if n > self._data.numel():
            grown = self._data.new_zeros(n)
            grown[:self._len] = self._data[:self._len]
            self._data = grown

    def resize(self, n: int) -> None:
        """Set length to n, reusing capacity; newly exposed elements are
        zeroed (stale data from previous use, `buffer.go:52-73`)."""
        n = max(int(n), 0)
        self.grow(n)
        if n > self._len:
            self._data[self._len:n] = 0
        self._len = n

    def zero(self) -> None:
        self._data[:self._len] = 0

    def zero_range(self, start: int, end: int) -> None:
        """Zero [start, end), clamped to valid bounds (`buffer.go:82`)."""
        self._data[max(start, 0):min(end, self._len)] = 0

    def copy(self) -> "Buffer":
        b = Buffer(self._len, self._data.dtype, self._data.device)
        b._data[:self._len] = self._data[:self._len]
        return b


class Pool:
    """Thread-safe `Buffer` reuse (`pool.go:7-46`) on one device.

    `get(n)` returns a zeroed Buffer of length n (reusing the largest
    pooled backing tensor); `put` returns it for reuse. The caller must
    not touch a buffer after `put`, the reference's contract. The pool
    lives on the CUDA card unless `device` says otherwise.
    """

    def __init__(self, dtype=torch.float32, device=None):
        self._dtype = dtype
        # as a tensor reports it ("cuda" -> "cuda:0")
        self._device = torch.empty(0, device=resolve_device(device)).device
        self._free: list[Buffer] = []
        self._lock = threading.Lock()

    def get(self, length: int) -> Buffer:
        with self._lock:
            b = None
            if self._free:
                # largest capacity first, so mixed-size request patterns
                # stay allocation-free once warmed up
                i = max(range(len(self._free)),
                        key=lambda j: self._free[j].capacity)
                b = self._free.pop(i)
        if b is None:
            return Buffer(length, self._dtype, self._device)
        # resize from 0 so the whole live region is zeroed exactly once
        b.resize(0)
        b.resize(length)
        return b

    def put(self, b: Buffer | None) -> None:
        if b is None:
            return
        if b.dtype != self._dtype or b.device != self._device:
            raise ValueError(
                f"pool: buffer {b.dtype} on {b.device} != pool {self._dtype} "
                f"on {self._device}")
        with self._lock:
            self._free.append(b)
