from algodsp_tpu_torch.core.numeric import (
    clamp,
    db_to_linear,
    db_power_to_linear,
    flush_denormals,
    linear_to_db,
    linear_power_to_db,
    nearly_equal,
    next_pow2,
)
from algodsp_tpu_torch.core.config import ProcessorConfig
from algodsp_tpu_torch.core.pool import Buffer, Pool

__all__ = [
    "Buffer",
    "Pool",
    "ProcessorConfig",
    "clamp",
    "db_to_linear",
    "db_power_to_linear",
    "flush_denormals",
    "linear_to_db",
    "linear_power_to_db",
    "nearly_equal",
    "next_pow2",
]
