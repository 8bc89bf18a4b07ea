from algodsp_tpu_torch.filters.biquad import BiquadChain, Section, sos_array
from algodsp_tpu_torch.filters.fir import FIRFilter
from algodsp_tpu_torch.filters.crossover import Crossover, MultiBand

__all__ = ["BiquadChain", "Crossover", "FIRFilter", "MultiBand",
           "Section", "sos_array"]
