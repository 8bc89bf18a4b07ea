"""The chain's last five node types against the JAX package on the CPU
(the port through its kernels' plain versions): chip_smoke.py's
VOICE_GRAPH (a ring-modulated copy of the input as the vocoder's carrier
on port 1) streamed in the chain's blocks, its PITCH_GRAPH (pitch-time
-> granular -> spectral-freeze) and `pitch-spectral` on both of its
paths through `Chain.process` on whole signals, pitch-time's error on a
512-sample block, the five types built from {} and from the reference's
parameter names (aliases and clamps), and every type of the JAX default
registry building in the port.

Tolerances: float64 >= 200 dB; float32 against JAX float64 >= 100 dB,
or no more than 6 dB below JAX float32's own SNR where that is lower
(the vocoder's slow low bands, the spectral freeze's overlap-add edges:
the reference's float32 class). JAX runs jitted, except where a graph
holds `pitch-spectral` on its bin-shift path: under jit XLA turns the
bin map's b / r into b * (1 / r) and moves floor(b / r) at exact
multiples, so those graphs run op by op (as the C++ golden divides).
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
from algodsp_tpu_torch.chain import Chain as TChain
from algodsp_tpu_torch.chain import default_registry as t_registry
from algodsp_tpu_torch.chain.registry import Context as TContext
from tests.conftest import snr_db
from tests.torch_port_setup import meets_float32_bar, ref_jit

SR = 48000.0
BLOCK = 512
NEW_TYPES = ("pitch-time", "pitch-spectral", "spectral-freeze", "granular",
             "vocoder")

# chip_smoke.py's graphs: a vocal bus whose carrier is the input ring-
# modulated (port 1 of the vocoder), and a one-shot pitch strip
VOICE_GRAPH = {
    "nodes": [{"id": "ring", "type": "ringmod", "params": {}},
              {"id": "voc", "type": "vocoder", "params": {}}],
    "connections": [{"from": "_input", "to": "voc"},
                    {"from": "_input", "to": "ring"},
                    {"from": "ring", "to": "voc", "toPortIndex": 1},
                    {"from": "voc", "to": "_output"}]}


def _line(*nodes):
    ids = [n["id"] for n in nodes]
    conns = [{"from": a, "to": b} for a, b in zip(["_input"] + ids, ids + ["_output"])]
    return {"nodes": list(nodes), "connections": conns}


PITCH_GRAPH = _line({"id": "shift", "type": "pitch-time", "params": {"semitones": 3}},
                    {"id": "grain", "type": "granular", "params": {}},
                    {"id": "freeze", "type": "spectral-freeze", "params": {}})


def _voice(n, seed=0, c=2):
    """Smoothed noise under a level envelope (well-separated correlation
    peaks for the WSOLA search, as the JAX tests' material)."""
    rng = np.random.default_rng(seed)
    x = np.stack([np.convolve(rng.standard_normal(n), np.ones(8) / 8.0, mode="same")
                  for _ in range(c)])
    return 2.0 * x * np.repeat(rng.uniform(0.1, 1.0, (c, -(-n // 1024))), 1024,
                               axis=1)[:, :n]


def _both(graph, x, blocks, jit=True):
    """JAX's float64 output, a callable making its float32 one, and the
    port's outputs, as (j64, j32, t64, t32)."""
    raw = json.dumps(graph)
    jc, tc = JChain(SR, block_size=BLOCK), TChain(SR, block_size=BLOCK)
    assert jc.load_graph(raw) == tc.load_graph(raw)

    def run_jax(dtype):
        fn = jc.process_blocks if blocks else jc.process
        fn = ref_jit(fn) if jit else fn
        _, y = fn(jc.init_state(x.shape[:-1], jnp.dtype(dtype)),
                  jnp.asarray(x.astype(dtype)))
        return np.asarray(y)

    out = [run_jax("float64"), lambda: run_jax("float32")]
    for dtype in ("float64", "float32"):
        fn = tc.process_blocks if blocks else tc.process
        _, y = fn(tc.init_state(x.shape[:-1], getattr(torch, dtype), "cpu"),
                  torch.as_tensor(x.astype(dtype)))
        assert y.dtype == getattr(torch, dtype)
        out.append(y.numpy())
    return out


def _assert_bars(j64, j32, t64, t32):
    assert t64.shape == j64.shape and np.all(np.isfinite(t32))
    assert snr_db(j64, t64) >= 200
    assert meets_float32_bar(snr_db(j64, t32), lambda: snr_db(j64, j32()))


def test_voice_graph_matches_jax():
    _assert_bars(*_both(VOICE_GRAPH, _voice(4 * BLOCK), blocks=True))


def test_pitch_graph_matches_jax():
    _assert_bars(*_both(PITCH_GRAPH, _voice(12000, seed=1), blocks=False))


@pytest.mark.parametrize("semitones", [-4, 1])
def test_pitch_spectral_node_matches_jax(semitones):
    """-4 semitones takes the stretch-and-resample path, +1 the bin shift
    (JAX op by op)."""
    graph = _line({"id": "p", "type": "pitch-spectral",
                   "params": {"semitones": semitones}})
    _assert_bars(*_both(graph, _voice(9000, seed=2), blocks=False,
                        jit=semitones == -4))


def test_pitch_time_raises_on_a_block_like_jax():
    """At the chain's defaults pitch-time needs 4,924 samples at +3
    semitones: a 512-sample block raises the reference's ValueError."""
    raw = json.dumps(PITCH_GRAPH)
    jc, tc = JChain(SR), TChain(SR)
    jc.load_graph(raw)
    tc.load_graph(raw)
    x = _voice(2 * BLOCK)
    with pytest.raises(ValueError) as ej:
        jc.process(jc.init_state((2,), jnp.float64), jnp.asarray(x[:, :BLOCK]))
    with pytest.raises(ValueError) as et:
        tc.process_blocks(tc.init_state((2,), torch.float64, "cpu"),
                          torch.as_tensor(x))
    assert str(et.value) == str(ej.value) == "wsola: input too short (512 < 4924)"


REFERENCE_PARAMS = {
    "pitch-time": {"semitones": -30, "sequence": 130, "overlap": 2, "search": 50},
    "pitch-spectral": {"semitones": -2, "frameSize": 1000, "hopRatio": 0.5},
    "spectral-freeze": {"frameSize": 700, "hopRatio": 0.001, "frozen": 0,
                        "mix": 3, "phaseMode": " HOLD "},
    "granular": {"grain": 0.01, "overlap": 2, "semitones": 12, "spray": 0.002,
                 "mix": 0.7},
    "vocoder": {"attackMs": 0.001, "releaseMs": 5000, "inputLevel": 0.2,
                "synthLevel": 20, "vocoderLevel": 0.8},
}


@pytest.mark.parametrize("typ", NEW_TYPES)
def test_new_types_build_like_jax(typ):
    """From {} and from the reference's parameter names (out-of-range
    values clamped, a non-power-of-two frame rounded up, the granular
    pitch from `semitones`, the phase mode's string), each node gives
    JAX's output on a whole signal (float64 >= 200 dB; pitch-spectral's
    JAX op by op); the vocoder's carrier defaults to its input."""
    x = _voice(12000, seed=3, c=1)
    for params in ({}, REFERENCE_PARAMS[typ]):
        rj = j_registry().lookup(typ)(JContext(SR), params)
        rt = t_registry().lookup(typ)(TContext(SR), params)
        sj = rj.init_state((1,), jnp.float64)
        st = rt.init_state((1,), torch.float64, "cpu")
        run = (rj.process if typ == "pitch-spectral"
               else ref_jit(rj.process, static_argnums=2))
        _, yj = run(sj, jnp.asarray(x), None)
        _, yt = rt.process(st, torch.as_tensor(x), None)
        assert snr_db(np.asarray(yj), yt.numpy()) >= 200, (typ, params)
        if typ == "vocoder":
            for key in ("attack_coeff", "release_coeff", "input_level",
                        "synth_level", "vocoded_level"):
                assert getattr(rt.effect, key) == getattr(rj.effect, key), key


def test_every_jax_type_builds_in_the_port():
    types = j_registry().types()
    assert t_registry().types() == types and len(types) == 41
    for typ in types:
        rt = t_registry().lookup(typ)(TContext(SR), {})
        st = rt.init_state((2,), torch.float32, "cpu")
        assert rt.n_outputs == j_registry().lookup(typ)(JContext(SR), {}).n_outputs
        assert st is not None, typ
