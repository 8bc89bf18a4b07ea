from algodsp_tpu_torch.effects.reverb.freeverb import Freeverb
from algodsp_tpu_torch.effects.reverb.fdn import FDNReverb
from algodsp_tpu_torch.effects.reverb.convolution import ConvolutionReverb

__all__ = ["ConvolutionReverb", "FDNReverb", "Freeverb"]
