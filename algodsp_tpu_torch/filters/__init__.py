from algodsp_tpu_torch.filters.biquad import BiquadChain, Section, sos_array

__all__ = ["BiquadChain", "Section", "sos_array"]
