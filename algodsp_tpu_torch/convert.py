"""Build the port's objects from plain NumPy data.

Every function takes numbers only (arrays, floats, dicts of them), so
the same numbers taken from the JAX package's objects — or made from a
seed — build both sides. Nothing here imports `algodsp_tpu`.
"""

from __future__ import annotations

import numpy as np
import torch

from algodsp_tpu_torch._device import resolve_device
from algodsp_tpu_torch.chain.chain import Chain
from algodsp_tpu_torch.conv.partitioned import PartitionedConvolver
from algodsp_tpu_torch.effects.dynamics.core import DetectorMode, Topology
from algodsp_tpu_torch.effects.dynamics.processors import Compressor
from algodsp_tpu_torch.filters.biquad import BiquadChain
from algodsp_tpu_torch.filters.moog import MoogFilter, MoogVariant
from algodsp_tpu_torch.pipeline import FlagshipPipeline

_COMPRESSOR_FIELDS = (
    "sample_rate", "topology", "detector_mode", "feedback_ratio_scale",
    "threshold_db", "ratio", "knee_db", "attack_ms", "release_ms",
    "rms_window_ms", "auto_makeup", "makeup_gain_db",
    "sidechain_low_cut_hz", "sidechain_high_cut_hz")


def biquad_chain_from_numpy(sos, gain: float = 1.0, block_size: int = 128,
                            condition: bool = True) -> BiquadChain:
    """A BiquadChain from its logical (S, 5) sections and input gain."""
    return BiquadChain(np.asarray(sos, np.float64), gain=float(gain),
                       block_size=block_size, condition=condition)


def convolver_from_numpy(kernel, min_block_order: int) -> PartitionedConvolver:
    return PartitionedConvolver(np.asarray(kernel, np.float64),
                                int(min_block_order))


def compressor_from_config(cfg: dict) -> Compressor:
    """A Compressor from the fields of a `DynamicsConfig` (e.g.
    `dataclasses.asdict` of the JAX one). Enum fields may be given as
    enum members of either package or as their string values."""
    unknown = set(cfg) - set(_COMPRESSOR_FIELDS)
    if unknown:
        raise ValueError(f"compressor_from_config: unknown fields {sorted(unknown)}")
    kw = dict(cfg)
    sample_rate = kw.pop("sample_rate")
    if "topology" in kw:
        kw["topology"] = Topology(getattr(kw["topology"], "value", kw["topology"]))
    if "detector_mode" in kw:
        kw["detector_mode"] = DetectorMode(
            getattr(kw["detector_mode"], "value", kw["detector_mode"]))
    return Compressor(float(sample_rate), **kw)


def moog_from_config(cfg: dict) -> MoogFilter:
    """A MoogFilter from its constructor's fields (`sample_rate`,
    `variant`, `cutoff_hz`, ...); `variant` may be a member of either
    package's MoogVariant or its string value."""
    kw = dict(cfg)
    sample_rate = kw.pop("sample_rate")
    if "variant" in kw:
        kw["variant"] = MoogVariant(getattr(kw["variant"], "value", kw["variant"]))
    return MoogFilter(float(sample_rate), **kw)


def chain_from_json(raw: str, sample_rate: float, *, block_size: int = 512,
                    auto_fuse: bool = True) -> tuple[Chain, list]:
    """A Chain with the graph `raw` loaded (the same JSON loads in both
    packages); returns (chain, fusion report)."""
    chain = Chain(sample_rate, block_size=block_size)
    report = chain.load_graph(raw, auto_fuse=auto_fuse)
    return chain, report


def state_from_numpy(tree, device=None):
    """Turn a state pytree of arrays (dicts, lists, tuples) into tensors
    on `device` (the CUDA card unless given), each keeping its dtype and
    the tree its structure: e.g. a JAX processor's state taken mid-stream
    (`jax.tree.map(np.asarray, state)`), with the Gate's int32 `hold`,
    the LookaheadLimiter's nested {"core", "delay"} dict and the
    multiband compressor's lists of crossover and band states, becomes
    the port's state for the same processor."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: state_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(state_from_numpy(v, device) for v in tree)
    return torch.tensor(np.array(tree), device=device)


def flagship_from_numpy(params: dict, device=None) -> FlagshipPipeline:
    """A FlagshipPipeline from `pipeline.flagship_params`-shaped data:
    {"cascade": {"sos", "gain"}, "weighting": {"sos", "gain"},
    "compressor": DynamicsConfig fields, "reverb": {"kernel",
    "min_block_order"}}. `device` is checked here (CUDA unless given)
    so that a pipeline meant for the card fails early without one."""
    resolve_device(device)
    return FlagshipPipeline(
        biquad_chain_from_numpy(params["cascade"]["sos"],
                                params["cascade"]["gain"]),
        biquad_chain_from_numpy(params["weighting"]["sos"],
                                params["weighting"]["gain"]),
        compressor_from_config(params["compressor"]),
        convolver_from_numpy(params["reverb"]["kernel"],
                             params["reverb"]["min_block_order"]))
