"""Set-up shared by the port's CPU tests (`tests/test_torch_*.py`), which
import this module first.

The tests run under pytest-xdist, several workers beside the JAX
package's tests on one machine, and their tensors are small: PyTorch's
intra-op threads only contend for the cores there. So each worker keeps
one (about a third less summed test time for the port's files, measured
on an 8-core CPU with 6 workers). The JAX references they jit compile
with XLA's backend optimisation off (`ref_jit`).
"""

import torch

torch.set_num_threads(1)

# The references' inputs are small, so compiling them takes most of their
# time: without LLVM's optimisation passes a file such as
# test_torch_reverb_delay.py takes about a quarter less CPU (the HLO, and
# so what each reference computes, is the same).
REF_COMPILER_OPTIONS = {"xla_backend_optimization_level": 0,
                        "xla_llvm_disable_expensive_passes": True}


def ref_jit(fn=None, **kw):
    """`jax.jit` for a JAX reference of the port's tests, compiled with
    `REF_COMPILER_OPTIONS`; also a decorator."""
    import jax

    if fn is None:
        return lambda f: ref_jit(f, **kw)
    return jax.jit(fn, compiler_options=REF_COMPILER_OPTIONS, **kw)


def settled_state(fn, state, *args):
    """`state` cast to the types in which `fn(state, *args)` returns its
    state (JAX's shape evaluation, nothing run). A JAX reference streamed
    block by block through one jitted `fn` then compiles once: a state
    whose types change after the first call (a counter that turns int64
    under x64, a scalar that loses its weak type) makes jit compile the
    whole graph again for the second call. The values stay as they are."""
    import jax
    import jax.numpy as jnp

    out = jax.eval_shape(fn, state, *args)[0]
    return jax.tree_util.tree_map(lambda a, s: jnp.asarray(a, s.dtype), state, out)


def meets_float32_bar(snr32, jax_float32_snr):
    """The float32 bar of the port's tests where the reference's own
    float32 class may be lower: the port's float32 output against JAX's
    float64 reads >= 100 dB, or no more than 6 dB below JAX float32's own
    SNR where that is lower (that is, >= min(100, JAX float32's - 6)).
    `jax_float32_snr` is called, and JAX's float32 run made, only where
    the port reads under 100 dB: at 100 dB or more the bar holds whatever
    JAX float32 reads."""
    return snr32 >= 100.0 or snr32 >= jax_float32_snr() - 6.0
