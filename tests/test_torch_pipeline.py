"""The port's flagship and folded pipelines against the JAX package at a
reduced size (4 ch x 8192 samples, a 4096-tap IR, reverb block 2^10).

The JAX side is the forward of `__graft_entry__.entry()` and the folded
pipeline of `bench.py`, built from the same numbers and run on its CPU
(XLA) paths. Tolerance: >= 100 dB SNR on the output (the bar of the
biquad and compressor stages, the loosest on the path) and per-channel
power within 1e-5 relative.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from algodsp_tpu.conv import PartitionedConvolver as JConv, folded_convolver
from algodsp_tpu.effects.dynamics import Compressor as JCompressor
from algodsp_tpu.filters import BiquadChain as JChain, design as jd
from algodsp_tpu.filters.weighting import WeightingType as JW, weighting_chain as jwc
from algodsp_tpu_torch import convert
from algodsp_tpu_torch.pipeline import (
    FoldedPipeline, flagship_params, folded_params)
from tests.conftest import snr_db

SR = 48000.0
C, N, TAPS = 4, 8192, 4096


def _ir(decay):
    rng = np.random.default_rng(0)
    return (rng.standard_normal(TAPS) * np.exp(-np.arange(TAPS) / decay)
            ).astype(np.float32)


def _x():
    return np.random.default_rng(1).standard_normal((C, N)).astype(np.float32)


def test_flagship_matches_jax_entry_forward():
    cascade = JChain(jd.butterworth_lp(2000.0, 10, SR))
    weighting = jwc(JW.A, SR)
    comp = JCompressor(SR)
    reverb = JConv(_ir(8000.0), min_block_order=10)
    x = _x()

    @jax.jit
    def forward(x, comp_state):
        y = weighting.process(cascade.process(x))
        _, y = comp.process(comp_state, y)
        return reverb.process(y)

    y_j = np.asarray(forward(jnp.asarray(x), comp.init_state((C,))))
    p_j = np.mean(y_j.astype(np.float64) ** 2, axis=-1)

    params = {
        "cascade": {"sos": cascade.sos, "gain": cascade.gain},
        "weighting": {"sos": weighting.sos, "gain": weighting.gain},
        "compressor": dataclasses.asdict(comp.core.cfg),
        "reverb": {"kernel": reverb.kernel,
                   "min_block_order": reverb.min_block_order},
    }
    pipe = convert.flagship_from_numpy(params, device="cpu")
    y_t, p_t = pipe.forward(torch.from_numpy(x), pipe.init_state(C, device="cpu"))
    assert y_t.shape == (C, N) and torch.isfinite(y_t).all()
    assert snr_db(y_j, y_t.numpy()) >= 100
    np.testing.assert_allclose(p_t.numpy(), p_j, rtol=1e-5)


def test_flagship_params_are_the_entry_numbers():
    """`flagship_params` draws the IR as `entry()` does (seeded NumPy) and
    designs the same filters."""
    params = flagship_params(seed=0, ir_taps=TAPS)
    rng = np.random.default_rng(0)
    ir = (rng.standard_normal(TAPS) * np.exp(-np.arange(TAPS) / 8000.0)
          ).astype(np.float32)
    assert np.array_equal(params["reverb"]["kernel"], ir)
    assert np.array_equal(params["cascade"]["sos"], jd.butterworth_lp(2000.0, 10, SR))
    assert np.array_equal(params["weighting"]["sos"], jwc(JW.A, SR).sos)
    assert params["weighting"]["gain"] == jwc(JW.A, SR).gain


def test_folded_pipeline_matches_jax_and_unfolded():
    params = folded_params(seed=0, ir_taps=TAPS)
    ir = params["kernel"]
    jchain = JChain(params["sos"], gain=params["gain"], condition=False)
    x = _x()
    y_j = np.asarray(folded_convolver(jchain, ir, 10).process(jnp.asarray(x)))
    fold = FoldedPipeline.from_numpy(params)
    y_t = fold.forward(torch.from_numpy(x)).numpy()
    assert snr_db(y_j, y_t) >= 100
    # folding is exact up to the truncated IIR tail: same as chain -> conv
    chain = convert.biquad_chain_from_numpy(params["sos"], params["gain"],
                                            condition=False)
    conv = convert.convolver_from_numpy(ir, 10)
    y_u = conv.process(chain.process(torch.from_numpy(x))).numpy()
    assert snr_db(y_u, y_t) >= 100
