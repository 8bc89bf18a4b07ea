"""The port accepts the keyword arguments that the JAX package's
signatures take (`unroll=`, `precision=`, `dtype=`), so that a call
written in the reference's form runs on the port. Each is ignored: the
call with it returns exactly what the call without it returns (equal,
bit for bit), on small inputs made from a seed, on the CPU.
"""

import tests.torch_port_setup  # noqa: F401  (first: one PyTorch thread)

import json

import numpy as np
import pytest
import torch

from algodsp_tpu_torch import streaming
from algodsp_tpu_torch.chain import Chain
from algodsp_tpu_torch.effects.dynamics.core import dynamics_env_scan
from algodsp_tpu_torch.filters.bank import MultirateOctaveAnalyzer
from algodsp_tpu_torch.ops import cascade, envscan, linrec

SR = 48000.0
BLOCK = 32
# two stable sections [b0, b1, b2, a1, a2]
SOS = np.array([[0.2, 0.4, 0.2, -0.5, 0.2], [0.3, -0.1, 0.05, 0.3, 0.1]])
GRAPH = {"nodes": [{"id": "lp", "type": "filter-lowpass",
                    "params": {"freq": 4000, "order": 2}}],
         "connections": [{"from": "_input", "to": "lp"},
                         {"from": "lp", "to": "_output"}]}


def _x(*shape, seed=16):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(shape))


def _process_blocks(kw):
    ch = Chain(SR)
    ch.load_graph(json.dumps(GRAPH))
    st = ch.init_state((2,), torch.float64, "cpu")
    return ch.process_blocks(st, _x(2, 4 * 128), block_size=128, **kw)[1]


def _scan_blocks(kw):
    def acc(s, b):
        s = s + b.sum(-1)
        return s, b * s[..., None]
    return streaming.scan_blocks(acc, torch.zeros(2, dtype=torch.float64),
                                 _x(2, 4 * BLOCK), block_size=BLOCK, **kw)


def _envelope_scan(kw):
    return envscan.envelope_scan(_x(3, 200).abs(), torch.zeros(3), 0.3, 0.01, **kw)


def _dynamics_env_scan(kw):
    return dynamics_env_scan(_x(3, 200).abs(), torch.zeros(3), 0.3, 0.99, **kw)


def _ar2_apply_scan(kw):
    return linrec.ar2_apply_scan(_x(3, 100), -0.5, 0.2, torch.zeros(3),
                                 torch.zeros(3), **kw)


def _ar2_apply_blocked(kw):
    k = linrec.ar2_kernels(SOS[:, 3], SOS[:, 4], BLOCK)
    return linrec.ar2_apply_blocked(_x(3, 4 * BLOCK), k, 1, torch.full((3,), 0.1),
                                    torch.zeros(3), **kw)


def _ar2_apply_blocked_banded(kw):
    k = linrec.ar2_kernels(SOS[:, 3], SOS[:, 4], BLOCK)
    return linrec.ar2_apply_blocked_banded(_x(3, 2, 4 * BLOCK), k,
                                           torch.full((3, 2), 0.1),
                                           torch.zeros(3, 2), **kw)


def _cascade_apply_blocked(kw):
    return cascade.cascade_apply_blocked(_x(3, 4 * BLOCK), SOS, block=BLOCK,
                                         return_state=True, **kw)


def _cascade_apply_blocked_banded(kw):
    return cascade.cascade_apply_blocked_banded(
        _x(3, 2, 4 * BLOCK), np.stack([SOS, SOS[::-1]]), block=BLOCK,
        return_state=True, **kw)


def _analyze(kw):
    return MultirateOctaveAnalyzer(3, SR).analyze(_x(2, 2048), **kw)


CALLS = {
    "Chain.process_blocks": (_process_blocks, {"unroll": 4}),
    "scan_blocks": (_scan_blocks, {"unroll": 4}),
    "envelope_scan": (_envelope_scan, {"unroll": 4}),
    "dynamics_env_scan": (_dynamics_env_scan, {"unroll": 4}),
    "ar2_apply_scan": (_ar2_apply_scan, {"unroll": 4}),
    "ar2_apply_blocked": (_ar2_apply_blocked, {"precision": "highest"}),
    "ar2_apply_blocked_banded": (_ar2_apply_blocked_banded,
                                 {"precision": "highest"}),
    "cascade_apply_blocked": (_cascade_apply_blocked, {"precision": "highest"}),
    "cascade_apply_blocked_banded": (_cascade_apply_blocked_banded,
                                     {"precision": "highest"}),
    "MultirateOctaveAnalyzer.analyze": (_analyze, {"dtype": None}),
}


def _flat(out):
    if torch.is_tensor(out):
        return [out]
    return [t for o in out for t in _flat(o)]


@pytest.mark.parametrize("name", list(CALLS))
def test_reference_keyword_accepted_and_ignored(name):
    call, kw = CALLS[name]
    with_kw, without = _flat(call(kw)), _flat(call({}))
    assert len(with_kw) == len(without) > 0
    for a, b in zip(with_kw, without):
        assert torch.equal(a, b), name
