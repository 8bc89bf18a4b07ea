from algodsp_tpu_torch.conv.conv import fftconvolve
from algodsp_tpu_torch.conv.partitioned import PartitionedConvolver
from algodsp_tpu_torch.conv.ltifold import (
    chain_impulse_response,
    fold_chain_into_kernel,
    folded_convolver,
    iir_tail_length,
)

__all__ = ["PartitionedConvolver", "chain_impulse_response", "fftconvolve",
           "fold_chain_into_kernel", "folded_convolver", "iir_tail_length"]
