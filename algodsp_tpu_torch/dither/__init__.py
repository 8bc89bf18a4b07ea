from algodsp_tpu_torch.dither.quantizer import (
    Quantizer, DitherType, Preset, preset_coefficients,
    sharp_preset_for_sample_rate)
from algodsp_tpu_torch.dither.designer import design_shaper, ath_weight_db

__all__ = ["DitherType", "Preset", "Quantizer", "ath_weight_db",
           "design_shaper", "preset_coefficients",
           "sharp_preset_for_sample_rate"]
