"""LTI pipeline folding: collapse an IIR biquad chain into an adjacent
FIR convolution (counterpart of `algodsp_tpu/conv/ltifold.py`; host-side
float64 NumPy, identical to it).

A biquad cascade and a convolution are both LTI, so

    convolver(chain(x)) == conv(x, h_chain (*) kernel)

exactly, where h_chain is the cascade's impulse response. h_chain decays
geometrically with the cascade's slowest pole radius, so truncating it
once the remaining tail is below the f32 noise floor yields a finite
combined kernel whose output matches the unfused pipeline beyond f32
roundoff (~130 dB SNR). The folded pipeline is ONE frequency-domain
pass instead of cascade-engine + convolution — the DSP analog of
operator fusion (the cascade's per-sample Toeplitz work disappears into
partition spectra precomputed once at setup).

This is a capability the Go reference does not have: it always runs
`Chain.ProcessBlock` then `PartitionedConvolution.ProcessBlock`
serially (`dsp/filter/biquad/chain.go:59`, `dsp/conv/partitioned.go:348`).
Folding preserves the combined system's semantics (same LTI operator,
same latency contract via `PartitionedConvolver`) and is exact for
one-shot/zero-state processing; it does NOT provide the chain's
coefficient hot-swap mid-stream (a folded kernel is static), so
interactive chains should keep the unfused path.

Fold direction is free: conv-then-chain folds to the same combined
kernel (LTI operators commute).
"""

from __future__ import annotations

import numpy as np

from algodsp_tpu_torch.conv.partitioned import PartitionedConvolver
from algodsp_tpu_torch.core.numeric import next_pow2


def iir_tail_length(sos, tol_db: float = 150.0, *, margin_db: float = 60.0,
                    max_len: int = 1 << 21) -> int:
    """Number of samples after which the cascade's impulse response is
    guaranteed below -(tol_db) dB of its peak.

    The response is bounded by C * r^n with r the largest pole radius;
    `margin_db` absorbs the constant C (resonant sections overshoot the
    pure r^n envelope). The caller trims the actual computed response,
    so a generous margin only costs setup FLOPs, not runtime length.
    """
    sos = np.asarray(sos, np.float64).reshape(-1, 5)
    r_max = 0.0
    for b0, b1, b2, a1, a2 in sos:
        roots = np.roots([1.0, a1, a2]) if (a1 or a2) else np.array([0.0])
        r_max = max(r_max, float(np.max(np.abs(roots))))
    if r_max >= 1.0 - 1e-12:
        raise ValueError(
            f"ltifold: cascade has a pole at radius {r_max:.8f} (not "
            "strictly stable); its impulse response cannot be truncated")
    if r_max == 0.0:
        return sos.shape[0] * 2 + 1  # pure FIR sections
    n = int(np.ceil((tol_db + margin_db) / (-20.0 * np.log10(r_max))))
    return min(max(n, 64), max_len)


def chain_impulse_response(chain, n: int) -> np.ndarray:
    """Host-side float64 impulse response of a BiquadChain (gain
    included), computed with the per-sample DF2T recurrence
    (`dsp/filter/biquad/section.go:47-53` semantics) — the f64 oracle
    form, independent of the blocked device engine."""
    h = np.zeros(n, np.float64)
    h[0] = chain.gain
    for b0, b1, b2, a1, a2 in np.asarray(chain.sos, np.float64):
        d0 = d1 = 0.0
        for i in range(n):
            x = h[i]
            y = b0 * x + d0
            d0 = b1 * x - a1 * y + d1
            d1 = b2 * x - a2 * y
            h[i] = y
    return h


def fold_chain_into_kernel(chain, kernel, *, tol_db: float = 150.0
                           ) -> np.ndarray:
    """Combined float64 kernel h_chain (*) kernel, with h_chain truncated
    where its tail drops `tol_db` below its peak."""
    kernel = np.asarray(kernel, np.float64).reshape(-1)
    if kernel.size == 0:
        raise ValueError("ltifold: empty kernel")
    n_tail = iir_tail_length(chain.sos, tol_db)
    h = chain_impulse_response(chain, n_tail)
    peak = np.max(np.abs(h))
    if peak == 0.0:
        return np.zeros(kernel.size)
    keep = np.nonzero(np.abs(h) > peak * 10.0 ** (-tol_db / 20.0))[0]
    h = h[:int(keep[-1]) + 1] if keep.size else h[:1]
    size = next_pow2(kernel.size + h.size - 1)
    combined = np.fft.irfft(np.fft.rfft(kernel, size) * np.fft.rfft(h, size),
                            size)
    return combined[:kernel.size + h.size - 1]


def folded_convolver(chain, kernel, min_block_order: int,
                     *, tol_db: float = 150.0,
                     max_block_order: int | None = None
                     ) -> PartitionedConvolver:
    """A PartitionedConvolver computing chain -> convolve(kernel) (or
    convolve -> chain; LTI operators commute) in a single fused
    frequency-domain pass. Same latency contract (2^min_block_order)."""
    combined = fold_chain_into_kernel(chain, kernel, tol_db=tol_db)
    return PartitionedConvolver(combined, min_block_order,
                                max_block_order=max_block_order)
