from algodsp_tpu_torch.spectrum.spectrum import (
    magnitude,
    magnitude_from_parts,
    power,
    power_from_parts,
    phase,
    unwrap_phase,
    group_delay_from_phase,
    group_delay_seconds,
    interpolate_linear,
    smooth_fractional_octave,
)
from algodsp_tpu_torch.spectrum.goertzel import (
    Goertzel,
    goertzel_power,
    goertzel_magnitude,
    goertzel_power_db,
)
from algodsp_tpu_torch.spectrum.stft import (stft, istft, spectrogram,
                                             StreamingSTFT, StreamingISTFT)
from algodsp_tpu_torch.spectrum.mel import (
    hz_to_mel,
    mel_to_hz,
    mel_filterbank,
    mel_spectrogram,
    mfcc,
)

__all__ = [
    "Goertzel",
    "StreamingISTFT",
    "StreamingSTFT",
    "hz_to_mel",
    "istft",
    "mel_filterbank",
    "mel_spectrogram",
    "mel_to_hz",
    "mfcc",
    "spectrogram",
    "stft",
    "goertzel_magnitude",
    "goertzel_power",
    "goertzel_power_db",
    "group_delay_from_phase",
    "group_delay_seconds",
    "interpolate_linear",
    "magnitude",
    "magnitude_from_parts",
    "phase",
    "power",
    "power_from_parts",
    "smooth_fractional_octave",
    "unwrap_phase",
]
