from algodsp_tpu_torch.effects.reverb.convolution import ConvolutionReverb

__all__ = ["ConvolutionReverb"]
