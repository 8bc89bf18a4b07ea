"""Convolution reverb: partitioned FDL engine + wet/dry mix (counterpart
of `algodsp_tpu/effects/reverb/convolution.py`).

Streaming block convolution with arbitrary-length IRs at latency
2^min_block_order, wet/dry controls (`convolution.go:16-76`). The
Freeverb and FDN reverbs are queued in ROADMAP.md.
"""

from __future__ import annotations

import torch

from algodsp_tpu_torch.conv.partitioned import PartitionedConvolver


class ConvolutionReverb:
    def __init__(self, kernel, min_block_order: int = 9, *,
                 wet: float = 1.0, dry: float = 1.0):
        self.engine = PartitionedConvolver(kernel, min_block_order)
        self.wet = float(wet)
        self.dry = float(dry)

    @property
    def latency(self) -> int:
        return self.engine.latency

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        return self.engine.init_state(batch_shape, dtype, device)

    def process_block(self, state, x):
        """One latency block (`convolution.go:59-76`)."""
        state, rev = self.engine.process_block(state, x)
        return state, self.dry * x + self.wet * rev

    def process(self, state, x):
        """Any multiple of the block length, through the engine's
        streaming path (`PartitionedConvolver.process_stream`)."""
        state, rev = self.engine.process_stream(state, x)
        return state, self.dry * x + self.wet * rev
