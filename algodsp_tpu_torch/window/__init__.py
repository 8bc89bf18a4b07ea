from algodsp_tpu_torch.window.window import (
    WindowType,
    Slope,
    generate,
    apply,
    apply_coefficients,
    equivalent_noise_bandwidth,
)
from algodsp_tpu_torch.window.metadata import Metadata, info
from algodsp_tpu_torch.window.analyze import Analysis, analyze

__all__ = [
    "Analysis",
    "Metadata",
    "Slope",
    "WindowType",
    "analyze",
    "apply",
    "apply_coefficients",
    "equivalent_noise_bandwidth",
    "generate",
    "info",
]
