"""Dynamics processors built on the shared core (counterpart of
`algodsp_tpu/effects/dynamics/processors.py`).

Only `Compressor` and `BlockMetrics` are ported; the limiter, expander,
gate, lookahead limiter, de-esser, transient shaper and multiband
compressor are queued in ROADMAP.md. Processors are functional:
`process(state, x, ...) -> (state, y)`, vectorized over leading dims.
"""

from __future__ import annotations

import dataclasses

import torch

from algodsp_tpu_torch.effects.dynamics.core import (
    DetectorMode, DynamicsConfig, DynamicsCore, Topology)


@dataclasses.dataclass(frozen=True)
class BlockMetrics:
    """Per-block metering (`compressor.go:31-35`)."""
    input_peak: float
    output_peak: float
    gain_reduction: float


def block_metrics(x, y, gain) -> BlockMetrics:
    """Input and output peak and the smallest gain of one block."""
    return BlockMetrics(
        input_peak=float(torch.max(torch.abs(x))),
        output_peak=float(torch.max(torch.abs(y))),
        gain_reduction=float(torch.min(gain)))


class Compressor:
    """Soft-knee compressor (`compressor.go:77-120` defaults)."""

    def __init__(self, sample_rate: float, *, threshold_db: float = -20.0,
                 ratio: float = 4.0, knee_db: float = 6.0,
                 attack_ms: float = 10.0, release_ms: float = 100.0,
                 makeup_gain_db: float = 0.0, auto_makeup: bool = False,
                 topology: Topology = Topology.FEEDFORWARD,
                 detector_mode: DetectorMode = DetectorMode.PEAK,
                 feedback_ratio_scale: bool = False,
                 rms_window_ms: float = 30.0,
                 sidechain_low_cut_hz: float = 0.0,
                 sidechain_high_cut_hz: float = 0.0):
        self.core = DynamicsCore(DynamicsConfig(
            sample_rate=sample_rate, topology=topology,
            detector_mode=detector_mode,
            feedback_ratio_scale=feedback_ratio_scale,
            threshold_db=threshold_db, ratio=ratio, knee_db=knee_db,
            attack_ms=attack_ms, release_ms=release_ms,
            rms_window_ms=rms_window_ms, auto_makeup=auto_makeup,
            makeup_gain_db=makeup_gain_db,
            sidechain_low_cut_hz=sidechain_low_cut_hz,
            sidechain_high_cut_hz=sidechain_high_cut_hz))

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        return self.core.init_state(batch_shape, dtype, device)

    def process(self, state, x, sidechain=None, *, with_gain: bool = False):
        state, y, gain = self.core.process(state, x, sidechain)
        if with_gain:
            return state, y, gain
        return state, y

    def calculate_output_level(self, input_magnitude):
        """Steady-state output level (`compressor.go:369`)."""
        mag = torch.abs(torch.as_tensor(input_magnitude))
        return mag * self.core.gain_for_level(mag) * self.core.makeup_gain_lin
