from algodsp_tpu_torch.effects.modulation.modulation import (
    AutoWah,
    Chorus,
    Flanger,
    FrequencyShifter,
    Phaser,
    RingModulator,
    Tremolo,
)

__all__ = [
    "AutoWah",
    "Chorus",
    "Flanger",
    "FrequencyShifter",
    "Phaser",
    "RingModulator",
    "Tremolo",
]
