"""Audio effects (counterpart of `algodsp_tpu/effects/`, 31 types).

Subpackages: dynamics, modulation, pitch, reverb; the delay, spatial,
vocoder, waveshaping and spectral effects live at this level.
"""
