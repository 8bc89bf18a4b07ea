"""Partitioned convolution for long impulse responses (counterpart of
`algodsp_tpu/conv/partitioned.py`).

Uniformly partitioned frequency-domain delay-line (FDL) convolver with
the reference's contract: latency 2^min_block_order samples for
arbitrarily long IRs, exact streaming through `process_block` and
`process_stream`.

One-shot float32 calls (`process`) run the FDL kernel of
`ops/fdlconv.py` at an internal partition size chosen for the card (see
`bulk_block_order`); any partition size gives the exact convolution.
The per-block, streaming and float64 paths use `torch.fft` for their
transforms, as the JAX package leaves those to XLA.

State per channel: the FDL of the last P frame spectra as (re, im)
float pairs, (..., P, B+1, 2), and the last input block (..., B).
"""

from __future__ import annotations

import numpy as np
import torch

from algodsp_tpu_torch._device import resolve_device
from algodsp_tpu_torch.core.numeric import next_pow2
from algodsp_tpu_torch.ops.fdlconv import MAX_BLOCK, fdl_conv, kernel_spectra

# Largest internal partition order for one-shot calls: the FDL kernel's
# largest partition (`ops.fdlconv.MAX_BLOCK`), and larger partitions cut
# the MAC work (N*M/B per channel) while the FFT work grows only with
# log2(2B).
BULK_MAX_ORDER = 13


def _complex(t):
    return torch.complex(t[..., 0], t[..., 1])


def _pairs(z):
    return torch.stack([z.real, z.imag], dim=-1)


class PartitionedConvolver:
    """Uniformly partitioned frequency-domain delay-line convolver."""

    def __init__(self, kernel, min_block_order: int,
                 max_block_order: int | None = None):
        kernel = np.asarray(kernel, dtype=np.float64).reshape(-1)
        if kernel.size == 0:
            raise ValueError("partitioned: empty impulse response")
        if min_block_order < 1:
            raise ValueError(
                f"partitioned: min_block_order must be >= 1, got {min_block_order}")
        if max_block_order is not None and max_block_order < min_block_order:
            raise ValueError("partitioned: max_block_order < min_block_order")
        self.block = 1 << min_block_order
        self.min_block_order = min_block_order
        self.kernel_len = kernel.size
        self.num_parts = -(-kernel.size // self.block)
        self.fft_size = 2 * self.block
        self._kernel = kernel
        padded = np.zeros(self.num_parts * self.block)
        padded[:kernel.size] = kernel
        self._part_spectra = np.fft.rfft(
            padded.reshape(self.num_parts, self.block), self.fft_size, axis=-1)
        self._hspec_cache: dict[tuple[int, str], torch.Tensor] = {}

    @property
    def kernel(self) -> np.ndarray:
        """The float64 impulse response this convolver applies."""
        return self._kernel

    @property
    def latency(self) -> int:
        """Algorithmic latency contract: block granularity = 2^order."""
        return self.block

    def init_state(self, batch_shape: tuple[int, ...] = (),
                   dtype=torch.float32, device=None):
        """Zero state, on the CUDA card unless `device` says otherwise."""
        device = resolve_device(device)
        batch_shape = tuple(batch_shape)
        fdl = torch.zeros(batch_shape + (self.num_parts, self.block + 1, 2),
                          dtype=dtype, device=device)
        tail = torch.zeros(batch_shape + (self.block,), dtype=dtype,
                           device=device)
        return {"fdl": fdl, "tail": tail}

    def _spectra(self, like):
        """Partition spectra at the latency block, complex, on like's device."""
        cdtype = torch.complex128 if like.dtype == torch.float64 else torch.complex64
        return torch.as_tensor(self._part_spectra).to(like.device, cdtype)

    def process_block(self, state, x):
        """Process exactly one block of `self.block` samples:
        (state, x (..., B)) -> (state, y (..., B))."""
        if x.shape[-1] != self.block:
            raise ValueError(
                f"partitioned: block must be {self.block} samples, got {x.shape[-1]}")
        frame = torch.cat([state["tail"].to(x.dtype), x], dim=-1)
        spec = torch.fft.rfft(frame, self.fft_size)
        fdl = torch.cat([_pairs(spec)[..., None, :, :],
                         state["fdl"][..., :-1, :, :].to(x.dtype)], dim=-3)
        acc = torch.sum(_complex(fdl) * self._spectra(x), dim=-2)
        y = torch.fft.irfft(acc, self.fft_size)[..., self.block:]
        return {"fdl": fdl, "tail": x}, y

    def process_stream(self, state, x):
        """Streaming continuation over any multiple of the block size.

        Same result as `process_block` per block. float32 calls on the
        card that `stream_rehistory` picks recompute the history as a
        zero-state bulk call through the FDL kernel
        (`_process_stream_rehistory`); the rest runs the P-tap FDL
        recurrence along the block axis with torch.fft transforms."""
        n = x.shape[-1]
        if n % self.block:
            raise ValueError(
                f"partitioned: length {n} not a multiple of block {self.block}")
        if (x.device.type == "cuda" and x.dtype == torch.float32
                and self.stream_rehistory(n)):
            return self._process_stream_rehistory(state, x)
        return self._process_stream_depthwise(state, x)

    def stream_rehistory(self, n: int) -> bool:
        """Whether a float32 streaming call of n samples on the card takes
        `_process_stream_rehistory`. On an H100 it was 1.3-4.1x faster
        than the depthwise path at every point timed by chip_smoke.py
        (8 and 64 rows; P = 8 and 32 at B = 1024; n from 2B to 4PB), so
        it takes every call from those smallest sizes up; below them
        (P < 8 or n < 2B) it is unmeasured and the depthwise path stays."""
        return self.num_parts >= 8 and n >= 2 * self.block

    def _process_stream_depthwise(self, state, x):
        n = x.shape[-1]
        B, P = self.block, self.num_parts
        k = n // B
        batch = x.shape[:-1]
        ext = torch.cat([state["tail"].to(x.dtype), x], dim=-1)
        frames = torch.cat([ext[..., :-B].reshape(batch + (k, B)),
                            ext[..., B:].reshape(batch + (k, B))], dim=-1)
        X = torch.fft.rfft(frames, self.fft_size)                 # (..., k, F)
        past = torch.flip(_complex(state["fdl"][..., :P - 1, :, :].to(x.dtype)),
                          dims=(-2,))
        seq = torch.cat([past, X], dim=-2)                        # (..., k+P-1, F)
        H = self._spectra(x)
        acc = torch.zeros_like(X)
        for p in range(P):
            acc = acc + H[p] * seq[..., P - 1 - p:P - 1 - p + k, :]
        y = torch.fft.irfft(acc, self.fft_size)[..., B:].reshape(batch + (n,))
        new_fdl = _pairs(torch.flip(seq[..., -P:, :], dims=(-2,)))
        return {"fdl": new_fdl.to(state["fdl"].dtype), "tail": x[..., -B:]}, y

    def _process_stream_rehistory(self, state, x):
        """Streaming continuation as a zero-state bulk call.

        The FDL state holds the spectra of the last P frames, whose kept
        halves are the last P*B input samples: at least one kernel span.
        So conv([history || x])[P*B:] is the exact continuation. History
        comes back through one batched irfft; the new state re-frames the
        last P frames with one batched rfft."""
        B, P = self.block, self.num_parts
        batch = x.shape[:-1]
        frames = torch.fft.irfft(_complex(state["fdl"]), self.fft_size)
        hist = torch.flip(frames[..., B:], dims=(-2,)).reshape(
            batch + (P * B,)).to(x.dtype)
        combined = torch.cat([hist, x], dim=-1)
        y = self.process(combined)[..., P * B:]
        seg = combined[..., -(P + 1) * B:]
        new_frames = torch.stack(
            [seg[..., (P - 1 - i) * B:(P + 1 - i) * B] for i in range(P)],
            dim=-2)
        new_fdl = _pairs(torch.fft.rfft(new_frames, self.fft_size))
        return {"fdl": new_fdl.to(state["fdl"].dtype), "tail": x[..., -B:]}, y

    def bulk_block_order(self, n: int) -> int:
        """Internal partition order for a one-shot call of n samples: the
        largest order from min_block_order up to BULK_MAX_ORDER that
        divides n and is no longer than the IR (rounded up to a power
        of two); 0 selects the one-big-FFT path (latency block already
        above the kernel's limit)."""
        if self.block > MAX_BLOCK:
            return 0
        top = min(BULK_MAX_ORDER, max(self.min_block_order,
                                      next_pow2(self.kernel_len).bit_length() - 1))
        for order in range(top, self.min_block_order - 1, -1):
            if n % (1 << order) == 0:
                return order
        return self.min_block_order

    def process(self, x, *, bulk_block_order: int | None = None):
        """One-shot convolution over a whole buffer (zero initial state).
        Length must be a multiple of the block size (latency contract).

        float32 inputs run the FDL (the kernel on the card, its plain
        version on the CPU); float64 inputs, and any call with
        `bulk_block_order=0`, run one big FFT."""
        n = x.shape[-1]
        if n % self.block:
            raise ValueError(
                f"partitioned: length {n} not a multiple of block {self.block}")
        if bulk_block_order is None:
            bulk_block_order = (self.bulk_block_order(n)
                                if x.dtype == torch.float32 else 0)
        if bulk_block_order:
            return self._process_bulk_fdl(x, bulk_block_order)
        size = next_pow2(n + self.kernel_len - 1)
        kern = torch.as_tensor(self._kernel).to(x.device, x.dtype)
        y = torch.fft.irfft(torch.fft.rfft(x, size) * torch.fft.rfft(kern, size),
                            size)
        return y[..., :n]

    def _hspec(self, block_order: int, device) -> torch.Tensor:
        key = (block_order, str(device))
        h = self._hspec_cache.get(key)
        if h is None:
            h = torch.as_tensor(kernel_spectra(self._kernel, 1 << block_order)
                                ).to(device)
            self._hspec_cache[key] = h
        return h

    def _process_bulk_fdl(self, x, block_order: int):
        """Zero-state FDL at internal partition size 2^block_order through
        `ops.fdlconv.fdl_conv`."""
        n = x.shape[-1]
        B = 1 << block_order
        if n % B:
            raise ValueError(
                f"partitioned: bulk length {n} not a multiple of 2^{block_order}")
        batch = x.shape[:-1]
        flat = x.reshape(-1, n).contiguous()
        y = fdl_conv(flat, self._hspec(block_order, x.device).to(x.dtype), B)
        return y.reshape(batch + (n,))

    def process_scan(self, x):
        """Block-recurrence path (the exact streaming semantics), block by
        block through `process_block`: the reference for the others."""
        n = x.shape[-1]
        if n % self.block:
            raise ValueError(
                f"partitioned: length {n} not a multiple of block {self.block}")
        state = self.init_state(x.shape[:-1], x.dtype, x.device)
        ys = []
        for i in range(n // self.block):
            state, y = self.process_block(
                state, x[..., i * self.block:(i + 1) * self.block])
            ys.append(y)
        return torch.cat(ys, dim=-1)
