"""Host-side numeric helpers (counterpart of `algodsp_tpu/core/numeric.py`).

Only what the ported modules need; the rest of the JAX module is queued
in ROADMAP.md.
"""

from __future__ import annotations


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (host-side helper for FFT sizing)."""
    if n <= 1:
        return 1
    return 1 << (int(n - 1).bit_length())
