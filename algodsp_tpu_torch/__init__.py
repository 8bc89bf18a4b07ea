"""algodsp_tpu_torch: the PyTorch/CUDA port of `algodsp_tpu`.

Same module layout and contracts as the JAX package, which stays the
reference: arrays are `(..., time)`, state is explicit through
`process(state, x) -> (state, y)`, filter design runs on the host in
float64 NumPy, the runtime dtype follows the input, and biquad state is
`(C, S, 4) = [x1, x2, y1, y2]`.

The hot loops that the JAX package wrote as Pallas TPU kernels are
hand-written CUDA kernels for Hopper (`csrc/*.cu`, built with `nvcc` on
first use by `_build.py`). Each kernel's wrapper launches the kernel on
CUDA tensors and uses its plain PyTorch version only for CPU tensors.

This package imports neither `jax` nor `algodsp_tpu`.
"""

from algodsp_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
