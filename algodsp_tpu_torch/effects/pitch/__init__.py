from algodsp_tpu_torch.effects.pitch.spectral import SpectralPitchShifter
from algodsp_tpu_torch.effects.pitch.wsola import WSOLAPitchShifter

__all__ = ["SpectralPitchShifter", "WSOLAPitchShifter"]
