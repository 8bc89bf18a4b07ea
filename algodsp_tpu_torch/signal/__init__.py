from algodsp_tpu_torch.signal.generate import (
    sine,
    multisine,
    impulse,
    linear_sweep,
    log_sweep,
    white_noise,
    pink_noise,
    normalize,
    clip,
    remove_dc,
    envelope_follower,
)

__all__ = [
    "clip",
    "envelope_follower",
    "impulse",
    "linear_sweep",
    "log_sweep",
    "multisine",
    "normalize",
    "pink_noise",
    "remove_dc",
    "sine",
    "white_noise",
]
