"""The dynamics family through the port's effect chain, and the crossovers
it rests on, against the JAX package on the CPU (the port through its
kernels' plain versions, JAX through its XLA paths, jitted).

The two graphs are chip_smoke.py's dynamics graphs:
- DYN_GRAPH: gate -> feedback RMS compressor -> split-band de-esser ->
  3-band multiband compressor (order 4) -> lookahead limiter;
- SPLIT_GRAPH: split-freq, its low port -> transient shaper and its high
  port -> expander, both summed into a limiter.

Tolerances (SNR of the port against JAX over 4 blocks of 4 ch x 512):
float64 >= 200 dB; float32 >= 100 dB (float32 rounding in different
evaluation orders through the nonlinear detectors); crossovers in
float64 >= 200 dB.
"""

import tests.torch_port_setup  # noqa: F401  (first: one PyTorch thread)

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algodsp_tpu.chain import Chain as JChain
from algodsp_tpu.chain import default_registry as j_registry
from algodsp_tpu.chain.registry import Context as JContext
from algodsp_tpu.filters.crossover import Crossover as JCrossover
from algodsp_tpu.filters.crossover import MultiBand as JMultiBand
from algodsp_tpu_torch.chain import Chain as TChain
from algodsp_tpu_torch.chain import default_registry as t_registry
from algodsp_tpu_torch.chain.registry import NOT_PORTED
from algodsp_tpu_torch.chain.registry import Context as TContext
from algodsp_tpu_torch.filters import Crossover, MultiBand
from tests.conftest import snr_db
from tests.torch_port_setup import ref_jit

SR = 48000.0
C, BLOCK, BLOCKS = 4, 512, 4
BARS = {"float64": 200.0, "float32": 100.0}
SLICE_TYPES = ("dyn-limiter", "dyn-lookahead", "dyn-gate", "dyn-expander",
               "dyn-deesser", "dyn-transient", "dyn-multiband", "split-freq")

DYN_GRAPH = {
    "nodes": [
        {"id": "gate", "type": "dyn-gate",
         "params": {"thresholdDB": -45, "holdMs": 5, "rangeDB": -70}},
        {"id": "comp", "type": "dyn-compressor",
         "params": {"topology": "feedback", "detector": "rms",
                    "thresholdDB": -20, "ratio": 4, "rmsWindowMs": 5}},
        {"id": "deess", "type": "dyn-deesser",
         "params": {"mode": "splitband", "freqHz": 6500, "thresholdDB": -30}},
        {"id": "mb", "type": "dyn-multiband",
         "params": {"bands": 3, "order": 4}},
        {"id": "look", "type": "dyn-lookahead",
         "params": {"thresholdDB": -3, "lookaheadMs": 2}}],
    "connections": [{"from": "_input", "to": "gate"},
                    {"from": "gate", "to": "comp"},
                    {"from": "comp", "to": "deess"},
                    {"from": "deess", "to": "mb"},
                    {"from": "mb", "to": "look"},
                    {"from": "look", "to": "_output"}]}

SPLIT_GRAPH = {
    "nodes": [
        {"id": "split", "type": "split-freq",
         "params": {"freqHz": 1200, "order": 4}},
        {"id": "tr", "type": "dyn-transient",
         "params": {"attack": 0.5, "sustain": -0.3, "attackMs": 2}},
        {"id": "ex", "type": "dyn-expander",
         "params": {"thresholdDB": -40, "ratio": 2}},
        {"id": "lim", "type": "dyn-limiter", "params": {"thresholdDB": -6}}],
    "connections": [{"from": "_input", "to": "split"},
                    {"from": "split", "to": "tr", "fromPortIndex": 0},
                    {"from": "split", "to": "ex", "fromPortIndex": 1},
                    {"from": "tr", "to": "lim"},
                    {"from": "ex", "to": "lim"},
                    {"from": "lim", "to": "_output"}]}


def _x(seed=0):
    rng = np.random.default_rng(seed)
    n = BLOCKS * BLOCK
    level = np.repeat([0.5, 0.003, 1.2, 0.05], n // 4)
    t = np.arange(n) / SR
    return (rng.standard_normal((C, n)) * level
            + 0.2 * np.sin(2 * np.pi * 7000.0 * t) * (level > 0.1))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("graph", ["dyn", "split"])
def test_dynamics_graph_matches_jax(graph, dtype):
    raw = json.dumps(DYN_GRAPH if graph == "dyn" else SPLIT_GRAPH)
    jc, tc = JChain(SR, block_size=BLOCK), TChain(SR, block_size=BLOCK)
    assert tc.load_graph(raw) == jc.load_graph(raw) == []
    x = _x().astype(dtype)
    _, y_j = ref_jit(jc.process_blocks)(
        jc.init_state((C,), jnp.dtype(dtype)), jnp.asarray(x))
    _, y_t = tc.process_blocks(tc.init_state((C,), getattr(torch, dtype), "cpu"),
                               torch.as_tensor(x))
    assert y_t.dtype == getattr(torch, dtype) and y_t.shape == x.shape
    assert snr_db(np.asarray(y_j), y_t.numpy()) >= BARS[dtype]


def test_split_freq_ports():
    """split-freq's two outputs are the crossover's low and high bands,
    and each reaches the node wired to its port."""
    rt = t_registry().lookup("split-freq")(TContext(SR), {"freqHz": 900})
    rj = j_registry().lookup("split-freq")(JContext(SR), {"freqHz": 900})
    assert rt.n_outputs == rj.n_outputs == 2
    x = _x(1)
    st, (lo, hi) = rt.process(rt.init_state((C,), torch.float64, "cpu"),
                              torch.as_tensor(x), None)
    _, (lo_j, hi_j) = ref_jit(lambda st_, x_: rj.process(st_, x_, None))(
        rj.init_state((C,), jnp.float64), jnp.asarray(x))
    assert snr_db(np.asarray(lo_j), lo.numpy()) >= 200
    assert snr_db(np.asarray(hi_j), hi.numpy()) >= 200
    graph = {"nodes": [{"id": "s", "type": "split-freq",
                        "params": {"freqHz": 900}},
                       {"id": "d", "type": "delay-simple",
                        "params": {"delayMs": 1}}],
             "connections": [{"from": "_input", "to": "s"},
                             {"from": "s", "to": "d", "fromPortIndex": 1},
                             {"from": "d", "to": "_output"}]}
    tc = TChain(SR)
    tc.load_graph(json.dumps(graph))
    _, y = tc.process(tc.init_state((C,), torch.float64, "cpu"),
                      torch.as_tensor(x))
    d = int(1e-3 * SR)
    np.testing.assert_array_equal(y.numpy()[:, d:], hi.numpy()[:, :-d])


def test_crossovers_match_jax():
    x = _x(2)
    for order in (2, 4):                 # LR2 inverts its high-pass
        tx, jx = Crossover(700.0, order, SR), JCrossover(700.0, order, SR)
        np.testing.assert_array_equal(tx.hp.sos, jx.hp.sos)
        lo, hi = tx.process(torch.as_tensor(x))
        lo_j, hi_j = ref_jit(jx.process)(jnp.asarray(x))
        assert snr_db(np.asarray(lo_j), lo.numpy()) >= 200
        assert snr_db(np.asarray(hi_j), hi.numpy()) >= 200
    tm, jm = MultiBand([250.0, 3000.0], 4, SR), JMultiBand([250.0, 3000.0], 4, SR)
    assert tm.num_bands == jm.num_bands == 3
    st = tm.init_state((C,), torch.float64, "cpu")
    half = x.shape[-1] // 2
    bands = []
    for part in (x[:, :half], x[:, half:]):
        st, b = tm.process_stream(st, torch.as_tensor(part))
        bands.append(b)
    bands_j = ref_jit(jm.process)(jnp.asarray(x))
    for k in range(3):
        got = torch.cat([bands[0][k], bands[1][k]], dim=-1).numpy()
        assert snr_db(np.asarray(bands_j[k]), got) >= 200
    with pytest.raises(ValueError, match="ascending"):
        MultiBand([300.0, 200.0], 4, SR)
    with pytest.raises(ValueError, match="even"):
        Crossover(300.0, 3, SR)


def test_slice_types_registered_with_the_reference_defaults():
    """No type of this slice is left in NOT_PORTED; each builds from {} with
    the reference's defaults, and from out-of-range parameters with its
    clamps."""
    assert not set(SLICE_TYPES) & set(NOT_PORTED)
    treg, jreg = t_registry(), j_registry()
    assert set(SLICE_TYPES) <= set(treg.types())
    extreme = {"thresholdDB": 50, "ratio": 1000, "kneeDB": -3, "attackMs": 1e6,
               "releaseMs": 0, "holdMs": -1, "rangeDB": -500, "lookaheadMs": 0,
               "freqHz": 1e6, "q": 0, "attack": 3, "sustain": -3, "bands": 9,
               "order": 25, "cross1Hz": 1, "cross2Hz": 1e6}
    for name in SLICE_TYPES:
        for params in ({}, extreme):
            rt = treg.lookup(name)(TContext(SR), params).effect
            rj = jreg.lookup(name)(JContext(SR), params).effect
            assert type(rt).__name__ == type(rj).__name__, name
            cores = [(rt, rj)]
            if name == "dyn-lookahead":
                assert rt.delay == rj.delay
                cores = [(rt.comp, rj.comp)]
            elif name == "dyn-multiband":
                cores = list(zip(rt.bands, rj.bands))
                assert [s.freq for s in rt.multiband.stages] == \
                    [s.freq for s in rj.multiband.stages]
            elif name == "split-freq":
                assert (rt.freq, rt.order) == (rj.freq, rj.order)
                cores = []
            elif name == "dyn-transient":
                assert vars(rt) == vars(rj)
                cores = []
            for a, b in cores:
                assert a.core.cfg.__dict__.keys() == b.core.cfg.__dict__.keys()
                for key, v in vars(a.core.cfg).items():
                    assert getattr(v, "value", v) == getattr(
                        getattr(b.core.cfg, key), "value",
                        getattr(b.core.cfg, key)), (name, key)
    comp = treg.lookup("dyn-compressor")(TContext(SR), {"topology": "feedback"})
    assert comp.effect.core.cfg.topology.value == "feedback"
