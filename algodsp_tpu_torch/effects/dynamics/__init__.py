from algodsp_tpu_torch.effects.dynamics.core import (
    DynamicsConfig,
    DynamicsCore,
    Topology,
    DetectorMode,
    compression_gain,
    downward_expansion_gain,
)
from algodsp_tpu_torch.effects.dynamics.processors import (
    BlockMetrics,
    Compressor,
    block_metrics,
)

__all__ = [
    "BlockMetrics",
    "Compressor",
    "DetectorMode",
    "DynamicsConfig",
    "DynamicsCore",
    "Topology",
    "block_metrics",
    "compression_gain",
    "downward_expansion_gain",
]
