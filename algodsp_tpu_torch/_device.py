"""Device resolution for the port's entry points.

Entry points run on the CUDA card unless the caller names another
device. Without a card and without an explicit device they raise: the
port never drifts to the CPU on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a `torch.device`; None means the current CUDA card.

    Raises RuntimeError when `device` is None and CUDA is unavailable,
    so that a run meant for the card cannot fall back to the CPU
    unnoticed. Pass `device="cpu"` to run the plain versions on the host.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "algodsp_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions on the host")
    return torch.device("cuda", torch.cuda.current_device())
