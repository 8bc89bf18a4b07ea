"""Processor configuration (counterpart of `algodsp_tpu/core/config.py`).

Parity with `dsp/core/options.go:4-40`: the reference passes
`ProcessorConfig{SampleRate, BlockSize}` via functional options. Here it
is a frozen dataclass; block size doubles as the block of the blocked
IIR engines.
"""

from __future__ import annotations

import dataclasses

DEFAULT_SAMPLE_RATE = 44100.0
DEFAULT_BLOCK_SIZE = 512


@dataclasses.dataclass(frozen=True)
class ProcessorConfig:
    sample_rate: float = DEFAULT_SAMPLE_RATE
    block_size: int = DEFAULT_BLOCK_SIZE

    def __post_init__(self):
        if self.sample_rate <= 0:
            raise ValueError(f"sample_rate must be > 0: {self.sample_rate}")
        if self.block_size <= 0:
            raise ValueError(f"block_size must be > 0: {self.block_size}")
