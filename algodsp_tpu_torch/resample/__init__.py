from algodsp_tpu_torch.resample.resample import (
    Quality,
    QualityProfile,
    quality_profile,
    Resampler,
    resample,
    upsample_2x,
    downsample_2x,
    approximate_ratio,
)

__all__ = [
    "Quality",
    "QualityProfile",
    "Resampler",
    "approximate_ratio",
    "downsample_2x",
    "quality_profile",
    "resample",
    "upsample_2x",
]
