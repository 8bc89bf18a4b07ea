"""The port's effect chain (`algodsp_tpu_torch.chain`) and the modules it
needs to run a graph (FIR, `fftconvolve`, convolution reverb, built-in
IRs, streaming) against the JAX package's, on the CPU: the port through
its kernels' plain versions, JAX through its XLA paths, jitted.

Tolerances (SNR of the port's output against JAX's):
- float64 >= 200 dB: both sides evaluate the same algebra, so only
  summation order and the tanh and FFT implementations separate them;
- float32 >= 100 dB: float32 rounding in different evaluation orders
  through nonlinear nodes (Moog ladder, compressor) and long FIRs;
- fusion reports, built-in IRs and graph errors are equal exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algodsp_tpu.chain import Chain as JChain
from algodsp_tpu.chain import GraphError as JGraphError
from algodsp_tpu.chain import default_registry as j_registry
from algodsp_tpu.conv import fftconvolve as j_fftconvolve
from algodsp_tpu.effects.reverb import ConvolutionReverb as JReverb
from algodsp_tpu.filters.fir import FIRFilter as JFIR
from algodsp_tpu.utils.irlib import builtin_irs as j_builtin_irs
from algodsp_tpu_torch import convert, streaming
from algodsp_tpu_torch.chain import Chain as TChain
from algodsp_tpu_torch.chain import GraphError as TGraphError
from algodsp_tpu_torch.chain import default_registry as t_registry
from algodsp_tpu_torch.chain.registry import NOT_PORTED
from algodsp_tpu_torch.conv.conv import fftconvolve as t_fftconvolve
from algodsp_tpu_torch.effects.reverb import ConvolutionReverb as TReverb
from algodsp_tpu_torch.filters.fir import FIRFilter as TFIR
from algodsp_tpu_torch.ops.fdlconv import pick_block
from algodsp_tpu_torch.utils.irlib import builtin_irs as t_builtin_irs
from tests.conftest import snr_db

SR = 48000.0
BARS = {"float64": 200.0, "float32": 100.0}

# The chip smoke run's graph (chip_smoke.py): K3, K5, K4 and one fused
# FIR of ~24k taps (K1) per block on the card.
SMOKE_GRAPH = {
    "nodes": [
        {"id": "lp", "type": "filter-lowpass",
         "params": {"family": "butterworth", "freq": 12000, "order": 4}},
        {"id": "moog", "type": "filter-moog",
         "params": {"freq": 1200, "q": 2.0, "gain": 6, "order": 8}},
        {"id": "comp", "type": "dyn-compressor",
         "params": {"thresholdDB": -18, "ratio": 4}},
        {"id": "eq", "type": "filter-peak",
         "params": {"family": "rbj", "freq": 3000, "gain": -4, "q": 1.0}},
        {"id": "verb", "type": "reverb-conv",
         "params": {"irSeconds": 0.5, "seed": 7, "wet": 0.3, "dry": 0.9}}],
    "connections": [{"from": "_input", "to": "lp"}, {"from": "lp", "to": "moog"},
                    {"from": "moog", "to": "comp"}, {"from": "comp", "to": "eq"},
                    {"from": "eq", "to": "verb"},
                    {"from": "verb", "to": "_output"}]}

SMALL_GRAPHS = {
    "fan_in": {
        "nodes": [{"id": "lo", "type": "filter-lowpass",
                   "params": {"freqHz": 500.0}},
                  {"id": "hi", "type": "filter-highpass",
                   "params": {"freqHz": 500.0}},
                  {"id": "d", "type": "delay-simple",
                   "params": {"delayMs": 3.0}}],
        "connections": [{"from": "_input", "to": "lo"},
                        {"from": "_input", "to": "hi"},
                        {"from": "hi", "to": "d"},
                        {"from": "lo", "to": "_output"},
                        {"from": "d", "to": "_output"}]},
    "bypass": {
        "nodes": [{"id": "m", "type": "filter-moog", "bypassed": True,
                   "params": {"freq": 500.0, "q": 3.0}},
                  {"id": "c", "type": "dyn-compressor",
                   "params": {"thresholdDB": -30.0, "ratio": 6.0}},
                  {"id": "w", "type": "widener", "bypassed": True}],
        "connections": [{"from": "_input", "to": "m"},
                        {"from": "m", "to": "c"},
                        {"from": "c", "to": "w"},
                        {"from": "w", "to": "_output"}]},
    "sidechain": {
        "nodes": [{"id": "comp", "type": "dyn-compressor",
                   "params": {"thresholdDB": -30.0, "ratio": 10.0,
                              "attackMs": 1.0, "detector": "rms"}},
                  {"id": "sc", "type": "filter-highpass",
                   "params": {"freqHz": 4000.0}}],
        "connections": [{"from": "_input", "to": "comp"},
                        {"from": "_input", "to": "sc"},
                        {"from": "sc", "to": "comp", "toPortIndex": 1},
                        {"from": "comp", "to": "_output"}]},
}


def _chains(graph, **kw):
    raw = json.dumps(graph)
    jc, tc = JChain(SR), TChain(SR)
    return jc, tc, jc.load_graph(raw, **kw), tc.load_graph(raw, **kw)


def _run_jax(jc, x, dtype, *, blocks=False):
    fn = jc.process_blocks if blocks else jc.process
    st0 = jc.init_state(x.shape[:-1], getattr(jnp, dtype))
    return jax.jit(fn)(st0, jnp.asarray(x, dtype))


def _run_port(tc, x, dtype, *, blocks=False):
    fn = tc.process_blocks if blocks else tc.process
    st0 = tc.init_state(x.shape[:-1], getattr(torch, dtype), "cpu")
    return fn(st0, torch.tensor(x.astype(dtype)))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_smoke_graph_matches_jax(dtype):
    jc, tc, rep_j, rep_t = _chains(SMOKE_GRAPH)
    assert rep_t == rep_j and [m for m, _ in rep_t] == [["eq", "verb"]]
    x = 0.5 * np.random.default_rng(0).standard_normal((2, 4 * 512))
    sj, yj = _run_jax(jc, x, dtype, blocks=True)
    st, yt = _run_port(tc, x, dtype, blocks=True)
    assert yt.shape == (2, 2048) and yt.dtype == getattr(torch, dtype)
    assert snr_db(np.asarray(yj), yt.numpy()) >= BARS[dtype]
    assert snr_db(np.asarray(sj["moog"]["stage"]),
                  st["moog"]["stage"].numpy()) >= BARS[dtype]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", sorted(SMALL_GRAPHS))
def test_small_graph_matches_jax(name, dtype):
    jc, tc, rep_j, rep_t = _chains(SMALL_GRAPHS[name])
    assert rep_t == rep_j
    t = np.arange(2048) / SR
    rng = np.random.default_rng(3)
    x = np.stack([0.5 * np.sin(2 * np.pi * 100.0 * t),
                  0.3 * rng.standard_normal(2048)])
    _, yj = _run_jax(jc, x, dtype)
    _, yt = _run_port(tc, x, dtype)
    assert snr_db(np.asarray(yj), yt.numpy()) >= BARS[dtype]
    if name == "bypass":   # the bypassed ends pass the input through
        assert not torch.equal(yt, torch.tensor(x.astype(dtype)))
        assert tc.runtimes["m"].effect is not None


def test_every_registered_type_matches_jax():
    """A one-node graph with default params for every type the port
    registers, in float64 and float32, against JAX's float64 output, with
    the channel independence check of tests/test_chain.py."""
    types = t_registry().types()
    assert set(types) <= set(j_registry().types())
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 512))
    for typ in types:
        graph = {"nodes": [{"id": "n", "type": typ, "params": {}}],
                 "connections": [{"from": "_input", "to": "n"},
                                 {"from": "n", "to": "_output"}]}
        jc, tc, _, _ = _chains(graph)
        # float32 is held to JAX's float64 output (one JAX compile a type)
        _, yj = _run_jax(jc, x, "float64")
        for dtype in ("float64", "float32"):
            _, yt = _run_port(tc, x, dtype)
            assert yt.shape == (2, 512), typ
            assert np.all(np.isfinite(yt.numpy())), typ
            assert snr_db(np.asarray(yj), yt.numpy()) >= BARS[dtype], (typ, dtype)
        _, y1 = _run_port(tc, x[:1], "float32")
        np.testing.assert_allclose(y1.numpy()[0], yt.numpy()[0], atol=2e-5,
                                   err_msg=typ)


def test_fuse_report_and_fused_output_match_jax():
    lti = {
        "nodes": [{"id": "a", "type": "filter-lowpass",
                   "params": {"freq": 9000.0, "order": 4,
                              "family": "chebyshev1"}},
                  {"id": "b", "type": "delay-simple", "params": {"delayMs": 1}},
                  {"id": "c", "type": "widener"},
                  {"id": "d", "type": "filter-peak", "bypassed": True},
                  {"id": "e", "type": "filter-highshelf",
                   "params": {"freq": 4000.0, "gain": 3.0}},
                  {"id": "f", "type": "dyn-compressor"},
                  {"id": "g", "type": "filter-notch",
                   "params": {"freq": 1000.0}},
                  {"id": "h", "type": "filter-lowshelf",
                   "params": {"freq": 200.0, "gain": -3.0}}],
        "connections": [{"from": "_input", "to": "a"}, {"from": "a", "to": "b"},
                        {"from": "b", "to": "c"}, {"from": "c", "to": "d"},
                        {"from": "d", "to": "e"}, {"from": "e", "to": "f"},
                        {"from": "f", "to": "g"}, {"from": "f", "to": "h"},
                        {"from": "g", "to": "_output"},
                        {"from": "h", "to": "_output"}]}
    x = 0.5 * np.random.default_rng(5).standard_normal((2, 1024))
    jc, tc, rep_j, rep_t = _chains(lti)
    assert rep_t == rep_j and [m for m, _ in rep_t] == [["a", "b", "c", "e"]]
    _, yj = _run_jax(jc, x, "float64")
    _, yt = _run_port(tc, x, "float64")
    assert snr_db(np.asarray(yj), yt.numpy()) >= 200
    # a run whose kernel outgrows max_kernel_len stays unfused
    for kw in ({"tol_db": 120.0}, {"max_kernel_len": 40}):
        jc, tc, _, _ = _chains(lti, auto_fuse=False)
        assert tc.fuse_lti(**kw) == jc.fuse_lti(**kw)


def test_process_blocks_equals_block_by_block():
    graph = {"nodes": [{"id": "lp", "type": "filter-lowpass"},
                       {"id": "c", "type": "dyn-compressor"},
                       {"id": "d", "type": "delay-simple",
                        "params": {"delayMs": 30}},
                       {"id": "v", "type": "reverb-conv",
                        "params": {"irSeconds": 0.05, "seed": 3}}],
             "connections": [{"from": "_input", "to": "lp"},
                             {"from": "lp", "to": "c"},
                             {"from": "c", "to": "d"},
                             {"from": "c", "to": "v"},
                             {"from": "d", "to": "_output"},
                             {"from": "v", "to": "_output"}]}
    tc, report = convert.chain_from_json(json.dumps(graph), SR)
    assert report == []
    x = torch.tensor(np.random.default_rng(6).standard_normal(
        (3, 5 * 512)).astype(np.float32))
    st = tc.init_state((3,), torch.float32, "cpu")
    s_all, y_all = tc.process_blocks(st, x)
    ys = []
    for i in range(5):
        st, y = tc.process(st, x[..., i * 512:(i + 1) * 512])
        ys.append(y)
    assert torch.equal(y_all, torch.cat(ys, -1))
    assert torch.equal(s_all["c"]["envelope"], st["c"]["envelope"])


def test_unported_types_raise_keyerror():
    ported = set(t_registry().types())
    assert set(NOT_PORTED) == set(j_registry().types()) - ported
    for typ in NOT_PORTED:
        graph = {"nodes": [{"id": "n", "type": typ}], "connections": []}
        with pytest.raises(KeyError, match=f"{typ}.*not ported yet"):
            TChain(SR).load_graph(json.dumps(graph))
    with pytest.raises(KeyError, match="unknown effect type"):
        TChain(SR).load_graph(json.dumps(
            {"nodes": [{"id": "n", "type": "does-not-exist"}]}))


def test_graph_errors_and_edge_graphs_match_jax():
    bad = ["{not json", json.dumps({"nodes": [{"id": ""}]}),
           json.dumps({"nodes": [{"id": "a"}, {"id": "a"}]}),
           json.dumps({"nodes": [{"id": "_input"}]}),
           json.dumps({"nodes": [{"id": "a", "params": [1]}]}),
           json.dumps({"nodes": [], "connections": [{"from": "x", "to": "_output"}]}),
           json.dumps({"nodes": [{"id": "a", "type": "widener"},
                                 {"id": "b", "type": "widener"}],
                       "connections": [{"from": "a", "to": "b"},
                                       {"from": "b", "to": "a"}]})]
    for raw in bad:
        with pytest.raises(JGraphError) as ej:
            JChain(SR).load_graph(raw)
        with pytest.raises(TGraphError) as et:
            TChain(SR).load_graph(raw)
        assert str(et.value) == str(ej.value)
    with pytest.raises(ValueError, match="sample_rate"):
        TChain("{}")
    x = np.random.default_rng(2).standard_normal((2, 512))
    for graph in ({}, {"nodes": [{"id": "w", "type": "widener"}],
                       "connections": [{"from": "_input", "to": "w"}]}):
        jc, tc, _, _ = _chains(graph)
        _, yj = _run_jax(jc, x, "float64")
        _, yt = _run_port(tc, x, "float64")
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))


def test_fir_and_fftconvolve_match_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 700))
    for taps in (1, 64, 65, 5000):
        h = rng.standard_normal(taps) * np.exp(-np.arange(taps) / 300.0)
        jf, tf = JFIR(h), TFIR(h)
        j_stream = jax.jit(jf.process_stream)
        for dtype in ("float64", "float32"):
            xt = torch.tensor(x.astype(dtype))
            sj, st = jf.init_state((2,), getattr(jnp, dtype)), \
                tf.init_state((2,), getattr(torch, dtype), "cpu")
            ys = []
            for a in (0, 350):
                sj, yj = j_stream(sj, jnp.asarray(x[:, a:a + 350], dtype))
                st, yt = tf.process_stream(st, xt[:, a:a + 350])
                assert snr_db(np.asarray(yj), yt.numpy()) >= BARS[dtype], \
                    (taps, dtype)
                ys.append(yt)
            # one-shot process from zero history equals the stream
            assert snr_db(torch.cat(ys, -1).numpy(),
                          tf.process(xt).numpy()) >= BARS[dtype] + 20
    h = rng.standard_normal(300)
    for mode in ("full", "same", "valid"):
        ref = np.asarray(j_fftconvolve(jnp.asarray(x), jnp.asarray(h), mode))
        out = t_fftconvolve(torch.tensor(x), h, mode).numpy()
        assert out.shape == ref.shape and snr_db(ref, out) >= 200
    with pytest.raises(ValueError, match="unknown mode"):
        t_fftconvolve(torch.tensor(x), h, "middle")
    assert [pick_block(m, 512) for m in (100, 1024, 4096, 5000, 24040)] == \
        [None, 1024, 4096, 8192, 8192]


def test_convolution_reverb_and_builtin_irs_match_jax():
    irs_j, irs_t = j_builtin_irs(SR), t_builtin_irs(SR)
    assert sorted(irs_j) == sorted(irs_t)
    for k in irs_j:
        assert irs_j[k][0] == irs_t[k][0]
        np.testing.assert_array_equal(irs_j[k][1], irs_t[k][1])
    ir = irs_t["small-room"][1][:3000]
    jr, tr = JReverb(ir, 8, wet=0.4, dry=0.8), TReverb(ir, 8, wet=0.4, dry=0.8)
    x = np.random.default_rng(8).standard_normal((2, 1024))
    sj, st = jr.init_state((2,), jnp.float64), tr.init_state((2,), torch.float64, "cpu")
    for a, b in ((0, 256), (256, 1024)):
        sj, yj = jr.process(sj, jnp.asarray(x[:, a:b]))
        st, yt = tr.process(st, torch.tensor(x[:, a:b]))
        assert snr_db(np.asarray(yj), yt.numpy()) >= 200
    sj, yj = jr.process_block(sj, jnp.asarray(x[:, :256]))
    st, yt = tr.process_block(st, torch.tensor(x[:, :256]))
    assert snr_db(np.asarray(yj), yt.numpy()) >= 200 and tr.latency == 256


def test_streaming_helpers():
    x = torch.arange(24.0).reshape(2, 12)
    blocks = streaming.split_blocks(x, 4)
    assert blocks.shape == (3, 2, 4) and torch.equal(blocks[1], x[:, 4:8])
    assert torch.equal(streaming.merge_blocks(blocks), x)

    def proc(st, a, b):
        return st + 1, (a + b, {"d": a - b})
    st, (s, d) = streaming.scan_blocks(proc, 0, x, 2 * x, block_size=4)
    assert st == 3 and torch.equal(s, 3 * x) and torch.equal(d["d"], -x)
    with pytest.raises(ValueError, match="not a multiple"):
        streaming.split_blocks(x, 5)
