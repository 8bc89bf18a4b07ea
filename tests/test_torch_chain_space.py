"""The delay and reverb nodes of the port's effect chain against the JAX
package's on the CPU (the port through its kernels' plain versions, JAX
through its XLA paths, jitted): the four node types' parameters and
defaults, chip_smoke.py's space graph (low-cut -> delay -> Freeverb ->
FDN) streamed in the chain's blocks, its fused form, the delay's LTI
descriptor and the types still waiting for their modules.

Tolerances: float64 >= 200 dB; float32 against JAX float64 no more than
6 dB below JAX float32's own SNR (the reference's float32 class: in
512-sample blocks the FDN runs its per-sample form, whose LFO phase
accumulates in float32);
the fused graph against the unfused one in float64 within 1 dB of the
JAX package's own fused-against-unfused SNR (the fusion pass truncates
the folded impulse response at -150 dB of its peak: 138 dB here).
"""

import tests.torch_port_setup  # noqa: F401  (first: one PyTorch thread)

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algodsp_tpu.chain import Chain as JChain
from algodsp_tpu.chain import default_registry as j_registry
from algodsp_tpu.chain.registry import Context as JContext
from algodsp_tpu_torch.chain import Chain as TChain
from algodsp_tpu_torch.chain import default_registry as t_registry
from algodsp_tpu_torch.chain.registry import NOT_PORTED
from algodsp_tpu_torch.chain.registry import Context as TContext
from tests.conftest import snr_db
from tests.torch_port_setup import ref_jit

SR = 48000.0
C, BLOCK, BLOCKS = 2, 512, 6
SLICE_TYPES = ("delay", "reverb", "reverb-freeverb", "reverb-fdn")

# chip_smoke.py's SPACE_GRAPH with a 30 ms delay, so that its echoes and
# their feedback fall inside the test's six blocks
SPACE_GRAPH = {
    "nodes": [
        {"id": "lowcut", "type": "filter-highpass",
         "params": {"family": "butterworth", "freq": 120, "order": 2}},
        {"id": "echo", "type": "delay",
         "params": {"time": 0.03, "feedback": 0.35, "mix": 0.25}},
        {"id": "room", "type": "reverb-freeverb", "params": {}},
        {"id": "hall", "type": "reverb-fdn", "params": {}}],
    "connections": [{"from": "_input", "to": "lowcut"},
                    {"from": "lowcut", "to": "echo"},
                    {"from": "echo", "to": "room"},
                    {"from": "room", "to": "hall"},
                    {"from": "hall", "to": "_output"}]}


def _x(seed=0):
    rng = np.random.default_rng(seed)
    n = BLOCKS * BLOCK
    burst = np.repeat(rng.uniform(size=(C, n // 256)) > 0.5, 256, axis=1)
    return rng.standard_normal((C, n)) * burst


@functools.lru_cache(maxsize=None)
def _run_space(dtype, fuse=False):
    """SPACE_GRAPH's run, shared by the tests that compare it (the
    arrays are only read)."""
    return _run(SPACE_GRAPH, dtype, fuse)


def _run(graph, dtype, fuse=False):
    raw = json.dumps(graph)
    jc, tc = JChain(SR, block_size=BLOCK), TChain(SR, block_size=BLOCK)
    rj = jc.load_graph(raw, auto_fuse=fuse)
    rt = tc.load_graph(raw, auto_fuse=fuse)
    assert rj == rt
    x = _x().astype(dtype)
    _, yj = ref_jit(jc.process_blocks)(jc.init_state((C,), jnp.dtype(dtype)),
                                        jnp.asarray(x))
    _, yt = tc.process_blocks(tc.init_state((C,), getattr(torch, dtype), "cpu"),
                              torch.as_tensor(x))
    return np.asarray(yj), yt.numpy(), rt


def test_space_graph_matches_jax():
    j64, t64, report = _run_space("float64")
    assert report == [] and t64.dtype == np.float64
    assert snr_db(j64, t64) >= 200
    j32, t32, _ = _run_space("float32")
    assert t32.dtype == np.float32
    assert snr_db(j64, t32) >= snr_db(j64, j32) - 6.0


def test_fused_space_graph_matches_jax_and_unfused():
    """The fusion pass folds the low-cut and the delay's echo train into
    one FIR, as the JAX chain does."""
    j64, t64, report = _run_space("float64", fuse=True)
    assert [r[0] for r in report] == [["lowcut", "echo"]]
    assert snr_db(j64, t64) >= 200
    j_unfused, t_unfused, _ = _run_space("float64")
    assert snr_db(t_unfused, t64) >= snr_db(j_unfused, j64) - 1.0


def test_delay_lti_descriptor_matches_jax():
    for p in ({}, {"time": 0.01, "feedback": 0.0}, {"mix": 0.0},
              {"time": 0.002, "feedback": 0.9, "mix": 1.0}):
        rt = t_registry().lookup("delay")(TContext(SR), p)
        rj = j_registry().lookup("delay")(JContext(SR), p)
        assert rt.lti[0] == rj.lti[0] == "kernel_fn"
        for tol in (60.0, 150.0):
            np.testing.assert_array_equal(rt.lti[1](tol), rj.lti[1](tol))
    for name in SLICE_TYPES[1:]:
        assert t_registry().lookup(name)(TContext(SR), {}).lti is None


@pytest.mark.parametrize("name", SLICE_TYPES)
def test_node_parameters_and_defaults_match_jax(name):
    """Each type builds from {} with the reference's defaults, from
    out-of-range parameters with its clamps, and `reverb` switches on
    `model`."""
    extreme = {"time": 9.0, "feedback": 2.0, "mix": -1.0, "wet": 9.0, "dry": -3.0,
               "roomSize": 5.0, "damp": 2.0, "gain": 1.0, "rt60": 0.01,
               "preDelay": 1.0, "modDepth": 1.0, "modRate": 9.0}
    for params in ({}, extreme, {"model": "FDN ", "rt60": 3.0},
                   {"model": "freeverb", "roomSize": 0.5}):
        rt = t_registry().lookup(name)(TContext(SR), params).effect
        rj = j_registry().lookup(name)(JContext(SR), params).effect
        assert type(rt).__name__ == type(rj).__name__, (name, params)
        keys = sorted(k for k in vars(rj) if not k.startswith("_")) + ["_block"] * (
            type(rj).__name__ == "FDNReverb")
        for key in keys:
            a, b = getattr(rt, key), getattr(rj, key)
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=f"{name}.{key}")
            else:
                assert a == b, (name, key, params)


def test_not_ported_holds_the_15_types_left():
    # 15 types were left after the delay and reverb nodes; every one has
    # since been ported, none is left
    assert len(NOT_PORTED) == 0
    assert not set(SLICE_TYPES) & set(NOT_PORTED)
    assert set(SLICE_TYPES) <= set(t_registry().types())
    assert set(NOT_PORTED) == set(j_registry().types()) - set(t_registry().types())
