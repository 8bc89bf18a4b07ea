from algodsp_tpu_torch.conv.conv import (
    FFT_THRESHOLD,
    convolve,
    direct,
    direct_circular,
    fftconvolve,
)
from algodsp_tpu_torch.conv.overlap import (
    OverlapAdd,
    OverlapSave,
    overlap_add_convolve,
    overlap_save_convolve,
)
from algodsp_tpu_torch.conv.partitioned import PartitionedConvolver
from algodsp_tpu_torch.conv.ltifold import (
    chain_impulse_response,
    fold_chain_into_kernel,
    folded_convolver,
    iir_tail_length,
)
from algodsp_tpu_torch.conv.correlate import (
    auto_correlate,
    auto_correlate_normalized,
    correlate,
    correlate_direct,
    correlate_fft,
    correlate_normalized,
    find_peak,
    index_from_lag,
    lag_from_index,
)
from algodsp_tpu_torch.conv.deconvolve import (
    DeconvMethod,
    DeconvOptions,
    DivisionByZeroError,
    deconvolve,
    inverse_filter,
    snr,
)

__all__ = [
    "FFT_THRESHOLD",
    "OverlapAdd",
    "OverlapSave",
    "PartitionedConvolver",
    "auto_correlate",
    "auto_correlate_normalized",
    "chain_impulse_response",
    "convolve",
    "correlate",
    "correlate_direct",
    "correlate_fft",
    "correlate_normalized",
    "DeconvMethod",
    "DeconvOptions",
    "DivisionByZeroError",
    "deconvolve",
    "direct",
    "direct_circular",
    "fftconvolve",
    "find_peak",
    "fold_chain_into_kernel",
    "folded_convolver",
    "iir_tail_length",
    "index_from_lag",
    "inverse_filter",
    "lag_from_index",
    "overlap_add_convolve",
    "overlap_save_convolve",
    "snr",
]
