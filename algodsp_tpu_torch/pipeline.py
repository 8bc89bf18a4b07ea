"""The flagship pipeline on the port.

`FlagshipPipeline` is the forward step of the JAX package's
`__graft_entry__.entry()`: a biquad cascade, then A-weighting, then the
soft-knee compressor, then the partitioned-convolution reverb, returning
the output and its per-channel mean power. `FoldedPipeline` is the
headline formulation of `bench.py`: the 10-section Butterworth cascade
and the A-weighting chain folded into the reverb's IR (`conv/ltifold.py`)
and run as one FDL pass.

Weights are made on the host from a seed with NumPy
(`flagship_params`, `folded_params`) and carried into the port's objects
by `convert.py`, so the JAX package can be fed the same numbers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from algodsp_tpu_torch.conv.ltifold import folded_convolver
from algodsp_tpu_torch.conv.partitioned import PartitionedConvolver
from algodsp_tpu_torch.effects.dynamics.processors import Compressor
from algodsp_tpu_torch.filters.biquad import BiquadChain
from algodsp_tpu_torch.filters.design import butterworth_lp
from algodsp_tpu_torch.filters.weighting import WeightingType, weighting_chain

SAMPLE_RATE = 48000.0


def flagship_params(seed: int = 0, ir_taps: int = 1 << 15,
                    sample_rate: float = SAMPLE_RATE) -> dict:
    """Plain NumPy parameters of the flagship pipeline, as `entry()`
    builds them: 10th-order Butterworth LP at 2 kHz, A-weighting, the
    default compressor, an exponentially decaying noise IR (decay 8000
    samples) drawn from `seed`, and a reverb latency block of 2^10."""
    rng = np.random.default_rng(seed)
    weighting = weighting_chain(WeightingType.A, sample_rate)
    ir = (rng.standard_normal(ir_taps)
          * np.exp(-np.arange(ir_taps) / 8000.0)).astype(np.float32)
    return {
        "cascade": {"sos": butterworth_lp(2000.0, 10, sample_rate), "gain": 1.0},
        "weighting": {"sos": weighting.sos, "gain": weighting.gain},
        "compressor": {"sample_rate": sample_rate},
        "reverb": {"kernel": ir, "min_block_order": 10},
    }


class FlagshipPipeline:
    """cascade -> A-weighting -> compressor -> reverb."""

    def __init__(self, cascade: BiquadChain, weighting: BiquadChain,
                 compressor: Compressor, reverb: PartitionedConvolver):
        self.cascade = cascade
        self.weighting = weighting
        self.compressor = compressor
        self.reverb = reverb

    def init_state(self, channels: int, dtype=torch.float32, device=None):
        """The compressor's state for `channels` channels (on the CUDA
        card unless `device` says otherwise)."""
        return self.compressor.init_state((channels,), dtype, device)

    def forward(self, x, comp_state):
        """x (C, N), N a multiple of the reverb block: returns
        (y (C, N), mean(y^2) per channel), as `entry()`'s forward."""
        y = self.cascade.process(x)
        y = self.weighting.process(y)
        _, y = self.compressor.process(comp_state, y)
        y = self.reverb.process(y)
        return y, torch.mean(y * y, dim=-1)


def folded_params(seed: int = 0, ir_taps: int = 1 << 17,
                  sample_rate: float = SAMPLE_RATE) -> dict:
    """Plain NumPy parameters of `bench.py`'s folded pipeline: the
    Butterworth and A-weighting runtime sections as one cascade with the
    product gain, and a noise IR with decay 20000 samples from `seed`."""
    rng = np.random.default_rng(seed)
    cascade = BiquadChain(butterworth_lp(2000.0, 10, sample_rate))
    weighting = weighting_chain(WeightingType.A, sample_rate)
    ir = (rng.standard_normal(ir_taps)
          * np.exp(-np.arange(ir_taps) / 20000.0)).astype(np.float32)
    return {
        "sos": np.concatenate([cascade.runtime_sos, weighting.runtime_sos]),
        "gain": cascade.gain * weighting.gain,
        "kernel": ir,
        "min_block_order": 10,
    }


@dataclasses.dataclass
class FoldedPipeline:
    """The whole LTI chain as one partitioned convolution."""
    reverb: PartitionedConvolver

    @classmethod
    def from_numpy(cls, params: dict) -> "FoldedPipeline":
        chain = BiquadChain(params["sos"], gain=params["gain"], condition=False)
        return cls(folded_convolver(chain, params["kernel"],
                                    params["min_block_order"]))

    def forward(self, x):
        return self.reverb.process(x)
