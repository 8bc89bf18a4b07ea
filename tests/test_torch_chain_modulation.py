"""The modulation and waveshaping nodes of the port's effect chain against
the JAX package's on the CPU (the port through its kernels' plain
versions, JAX through its XLA paths, jitted): the ten node types'
parameters and defaults, chip_smoke.py's two graphs streamed in the
chain's blocks, a state carried from JAX to the port mid-stream by
`convert.state_from_numpy`, the parameter normalizers, and that no type
waits for its module any more.

Tolerances: float64 >= 200 dB; float32 against JAX float64 no more than
6 dB below JAX float32's own SNR (the reference's float32 class: LFO
phases accumulated in float32, the transformer's and the bass exciter's
slow poles). The bit crusher leads WAVE_GRAPH, so it quantises the
chain's input itself and no step flips upstream of it.
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
from algodsp_tpu.chain import params as jparams
from algodsp_tpu.chain.registry import Context as JContext
from algodsp_tpu_torch import convert
from algodsp_tpu_torch.chain import Chain as TChain
from algodsp_tpu_torch.chain import default_registry as t_registry
from algodsp_tpu_torch.chain import params as tparams
from algodsp_tpu_torch.chain.registry import NOT_PORTED
from algodsp_tpu_torch.chain.registry import Context as TContext
from tests.conftest import snr_db
from tests.torch_port_setup import ref_jit, settled_state

SR = 48000.0
C, BLOCK, BLOCKS = 2, 512, 3
SLICE_TYPES = ("chorus", "flanger", "ringmod", "phaser", "tremolo",
               "bitcrusher", "distortion", "dist-cheb", "transformer", "bass")


def _line(*nodes):
    ids = [n["id"] for n in nodes]
    conns = [{"from": a, "to": b} for a, b in zip(["_input"] + ids, ids + ["_output"])]
    return {"nodes": list(nodes), "connections": conns}


# chip_smoke.py's two graphs, at the registry's defaults
MOD_GRAPH = _line(
    {"id": "drive", "type": "distortion", "params": {"mode": "tanh", "drive": 1.8}},
    {"id": "chorus", "type": "chorus", "params": {}},
    {"id": "phaser", "type": "phaser", "params": {}},
    {"id": "flanger", "type": "flanger", "params": {}},
    {"id": "tremolo", "type": "tremolo", "params": {}})
WAVE_GRAPH = _line(
    {"id": "crush", "type": "bitcrusher", "params": {}},
    {"id": "cheb", "type": "dist-cheb", "params": {"order": 3, "dcBypass": 1}},
    {"id": "iron", "type": "transformer", "params": {"quality": "high",
                                                       "oversampling": 4}},
    {"id": "bass", "type": "bass", "params": {}},
    {"id": "ring", "type": "ringmod", "params": {}})


def _x(seed=0):
    rng = np.random.default_rng(seed)
    n = BLOCKS * BLOCK
    return 0.5 * rng.standard_normal((C, n)) * np.repeat(
        rng.uniform(0.1, 1.0, (C, BLOCKS * 4)), BLOCK // 4, axis=1)


def _run(graph, dtype):
    """Both chains over BLOCKS blocks (JAX block by block: its bit
    crusher's counter turns int64 under x64, which its `process_blocks`
    scan cannot carry). Returns (JAX y, port y, JAX state after the first
    block, port chain, x)."""
    raw = json.dumps(graph)
    jc, tc = JChain(SR, block_size=BLOCK), TChain(SR, block_size=BLOCK)
    assert jc.load_graph(raw) == tc.load_graph(raw) == []
    x = _x().astype(dtype)
    jp = ref_jit(jc.process)
    sj = settled_state(jc.process, jc.init_state((C,), jnp.dtype(dtype)),
                       jnp.asarray(x[:, :BLOCK]))
    yj = []
    for b in range(BLOCKS):
        sj, y = jp(sj, jnp.asarray(x[:, b * BLOCK:(b + 1) * BLOCK]))
        yj.append(np.asarray(y))
        if b == 0:
            first = jax.tree_util.tree_map(np.asarray, sj)
    _, yt = tc.process_blocks(tc.init_state((C,), getattr(torch, dtype), "cpu"),
                              torch.as_tensor(x))
    return np.concatenate(yj, axis=-1), yt.numpy(), first, tc, x


@functools.lru_cache(maxsize=None)
def _run64(name):
    """`_run` of a graph in float64, once a graph for both its cases."""
    return _run({"mod": MOD_GRAPH, "wave": WAVE_GRAPH}[name], "float64")


@pytest.mark.parametrize("case", ["mod", "wave", "mod-float32", "wave-float32"])
def test_graph_matches_jax(case):
    """The graph streamed in 512-sample blocks, and the port continuing
    from JAX's state after the first block: the state (the Flanger's
    int32 counter, the bit crusher's counter, the scalar LFO phases,
    nested filter and limiter states) crosses by
    `convert.state_from_numpy`. The float32 cases hold the port's
    float32 stream to JAX's float64 one (the float64 cases' run)."""
    name, _, dtype = case.partition("-")
    j64, t64, first, tc, x = _run64(name)
    if dtype == "float32":
        j32, t32, _, _, _ = _run({"mod": MOD_GRAPH, "wave": WAVE_GRAPH}[name],
                                 "float32")
        assert t32.dtype == np.float32
        assert snr_db(j64, t32) >= snr_db(j64, j32) - 6.0
        return
    assert t64.dtype == np.float64 and snr_db(j64, t64) >= 200
    st = convert.state_from_numpy(first, "cpu")
    assert set(st) == set(tc.init_state((C,), torch.float64, "cpu"))
    _, y_rest = tc.process_blocks(st, torch.as_tensor(x[:, BLOCK:]))
    assert snr_db(j64[:, BLOCK:], y_rest.numpy()) >= 200


def _same(a, b, where):
    if isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=where)
    elif hasattr(b, "value") and hasattr(a, "value"):       # the packages' enums
        assert a.value == b.value, where
    elif hasattr(b, "sos"):                                  # BiquadChain
        np.testing.assert_array_equal(a.sos, b.sos, err_msg=where)
    elif hasattr(b, "max_delay"):                            # DelayLine
        assert (a.max_delay, a.mode.value) == (b.max_delay, b.mode.value), where
    elif hasattr(b, "core"):                                 # Limiter
        assert a.core.attack_coeff == b.core.attack_coeff, where
        assert a.core.release_coeff == b.core.release_coeff, where
    else:
        assert a == b, where


@pytest.mark.parametrize("name", SLICE_TYPES)
def test_node_parameters_and_defaults_match_jax(name):
    """Each type builds from {} with the reference's defaults and from
    out-of-range parameters with its clamps, its string enums and
    aliases read as the reference reads them; none is LTI."""
    extreme = {"speedHz": 99, "depth": -5, "baseDelay": 9, "mix": 7, "stages": 40,
               "rateHz": 0.0, "feedback": 3, "carrierHz": 1e9, "minFreqHz": 1,
               "maxFreqHz": 1e9, "smoothingMs": 900, "bitDepth": 0.2,
               "downsample": 1000, "drive": 99, "output": 9, "clip": 0.0,
               "shape": 3, "bias": -4, "order": 40, "gain": 9, "invert": 1,
               "dcBypass": True, "highpassHz": 1, "dampingHz": 1e9,
               "oversampling": 0, "frequency": 1e4, "inputGain": 5,
               "highGain": -1, "original": 9, "harmonic": 9, "decay": 5,
               "responseMs": 0}
    cases = [{}, extreme, {"mode": " Hard_Clip ", "harmonic": "ODD", "order": 5,
                           "w1": 0.5, "w3": 0.25, "quality": "LightWeight",
                           "freqHz": 250, "rateHz": 2.5, "bits": 4.5}]
    for params in cases:
        rt = t_registry().lookup(name)(TContext(SR), params)
        rj = j_registry().lookup(name)(JContext(SR), params)
        assert rt.lti is None and rj.lti is None
        ft, fj = rt.effect, rj.effect
        assert type(ft).__name__ == type(fj).__name__, (name, params)
        for key in sorted(k for k in vars(fj) if k != "_nshift"):
            _same(getattr(ft, key), getattr(fj, key), f"{name}.{key} {params}")


def test_normalizers_match_jax():
    raws = ["", "tanh", " HardClip", "soft_sat", "softsat", "saturate2",
            "chebyshev", "waveshaper7", "nonsense", "Odd", "even", "all"]
    for raw in raws:
        assert (tparams.normalize_distortion_mode(raw).value
                == jparams.normalize_distortion_mode(raw).value), raw
        assert (tparams.normalize_chebyshev_harmonic_mode(raw).value
                == jparams.normalize_chebyshev_harmonic_mode(raw).value), raw


def test_not_ported_holds_the_5_types_left():
    """The last five types are ported: nothing waits, and the port's
    registry has the JAX default registry's type set."""
    assert NOT_PORTED == ()
    assert set(SLICE_TYPES) <= set(t_registry().types())
    assert set(t_registry().types()) == set(j_registry().types())
    for name in ("spectral-freeze", "granular", "vocoder", "pitch-time",
                 "pitch-spectral"):
        assert t_registry().lookup(name) is not None
