"""Cross/auto-correlation (counterpart of `algodsp_tpu/conv/correlate.py`).

Direct and FFT cross-correlation (full length N+M-1), auto- and
normalized variants, peak finding, lag <-> index mapping
(`dsp/conv/correlate.go`).

Correlation convention (as in the reference): corr[k] covers lags
-(len_b-1) .. len_a-1; corr = conv(a, reverse(b)).
"""

from __future__ import annotations

import torch

from algodsp_tpu_torch.conv.conv import FFT_THRESHOLD, direct, fftconvolve


def _rev(b):
    return torch.as_tensor(b).reshape(-1).flip(0)


def correlate_direct(a, b):
    """Time-domain cross-correlation (`correlate.go:31-43`)."""
    return direct(a, _rev(b))


def correlate_fft(a, b):
    """FFT cross-correlation (`correlate.go:111-187`)."""
    return fftconvolve(a, _rev(b))


def correlate(a, b):
    """Auto-selecting cross-correlation (`correlate.go:16-29`)."""
    if torch.as_tensor(b).numel() >= FFT_THRESHOLD:
        return correlate_fft(a, b)
    return correlate_direct(a, b)


def auto_correlate(a):
    """Auto-correlation (`correlate.go:57-61`)."""
    return correlate(a, a)


def auto_correlate_normalized(a):
    """Auto-correlation scaled so the zero-lag value is 1
    (`correlate.go:63-84`)."""
    ac = auto_correlate(a)
    n = a.shape[-1]
    zero_lag = ac[..., n - 1:n]
    return ac / torch.where(zero_lag == 0, torch.ones_like(zero_lag), zero_lag)


def correlate_normalized(a, b):
    """Cross-correlation normalized by ||a||*||b|| (`correlate.go:86-109`)."""
    b = torch.as_tensor(b).to(a.device, a.dtype)
    c = correlate(a, b)
    norm = (torch.sqrt(torch.sum(a * a, dim=-1, keepdim=True))
            * torch.sqrt(torch.sum(b * b, dim=-1)))
    return c / torch.where(norm == 0, torch.ones_like(norm), norm)


def find_peak(corr):
    """(index, value) of the maximum correlation (`correlate.go:200-219`)."""
    idx = torch.argmax(corr, dim=-1)
    val = torch.take_along_dim(corr, idx[..., None], dim=-1)[..., 0]
    return idx, val


def lag_from_index(index, len_b: int):
    """Correlation index -> signal lag (`correlate.go:221-225`)."""
    return index - (len_b - 1)


def index_from_lag(lag, len_b: int):
    """Signal lag -> correlation index (`correlate.go:227-231`)."""
    return lag + (len_b - 1)
