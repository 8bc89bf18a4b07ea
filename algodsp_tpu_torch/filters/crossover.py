"""Linkwitz-Riley crossovers, 2-way and N-way (counterpart of
`algodsp_tpu/filters/crossover.py`).

Capability parity with `dsp/filter/crossover/crossover.go`: a 2-way LR
crossover with the high-pass polarity inverted for orders = 2 mod 4
(`crossover.go:32-52`), and `MultiBand` as a chain of 2-way stages
(`crossover.go:135-213`): stage i splits the running high remainder at
freqs[i]; band outputs are [lowest, ..., highest].

Both bands of a split are `BiquadChain`s over the same input, so they
take the chain's dispatch: float32 on the card runs the cascade kernel
where the sections have no slow poles, and the blocked engine where
they do (a low crossover, e.g. LR4 at 250 Hz at 48 kHz).
"""

from __future__ import annotations

import torch

from algodsp_tpu_torch.filters.biquad import BiquadChain
from algodsp_tpu_torch.filters.design.cascades import (
    linkwitz_riley_hp,
    linkwitz_riley_hp_inverted,
    linkwitz_riley_lp,
    linkwitz_riley_needs_hp_invert,
)


class Crossover:
    """2-way Linkwitz-Riley crossover (`crossover.go:13-52`)."""

    def __init__(self, freq: float, order: int, sample_rate: float,
                 **chain_kwargs):
        if order <= 0 or order % 2 != 0:
            raise ValueError(f"crossover: order must be a positive even "
                             f"integer, got {order}")
        if sample_rate <= 0:
            raise ValueError(f"crossover: sample rate must be positive, got "
                             f"{sample_rate}")
        if freq <= 0 or freq >= sample_rate / 2:
            raise ValueError(f"crossover: frequency must be in "
                             f"(0, {sample_rate / 2}), got {freq}")
        lp_sos = linkwitz_riley_lp(freq, order, sample_rate)
        if linkwitz_riley_needs_hp_invert(order):
            hp_sos = linkwitz_riley_hp_inverted(freq, order, sample_rate)
        else:
            hp_sos = linkwitz_riley_hp(freq, order, sample_rate)
        if lp_sos is None or hp_sos is None:
            raise ValueError(f"crossover: failed to design LR{order} at "
                             f"{freq} Hz")
        self.freq = freq
        self.order = order
        self.sample_rate = sample_rate
        self.lp = BiquadChain(lp_sos, **chain_kwargs)
        self.hp = BiquadChain(hp_sos, **chain_kwargs)

    def process(self, x):
        """(lo, hi) one-shot from zero state (`crossover.go:59-73`)."""
        return self.lp.process(x), self.hp.process(x)

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        return {"lp": self.lp.init_state(batch_shape, dtype, device),
                "hp": self.hp.init_state(batch_shape, dtype, device)}

    def process_stream(self, state, x):
        s_lp, lo = self.lp.process_stream(state["lp"], x)
        s_hp, hi = self.hp.process_stream(state["hp"], x)
        return {"lp": s_lp, "hp": s_hp}, (lo, hi)


class MultiBand:
    """N-way crossover tree (`crossover.go:98-213`)."""

    def __init__(self, freqs, order: int, sample_rate: float, **chain_kwargs):
        freqs = list(freqs)
        if not freqs:
            raise ValueError("crossover: at least one frequency is required")
        for i in range(1, len(freqs)):
            if freqs[i] <= freqs[i - 1]:
                raise ValueError(
                    "crossover: frequencies must be strictly ascending, "
                    f"got {freqs[i]} after {freqs[i - 1]}")
        self.stages = [Crossover(f, order, sample_rate, **chain_kwargs)
                       for f in freqs]
        self.num_bands = len(freqs) + 1

    def process(self, x):
        """Band outputs [band0 (lowest), ..., bandN-1 (highest)]: stage i
        splits the running high remainder at freqs[i]."""
        bands = []
        rest = x
        for st in self.stages:
            lo, rest = st.process(rest)
            bands.append(lo)
        bands.append(rest)
        return bands

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        return [st.init_state(batch_shape, dtype, device) for st in self.stages]

    def process_stream(self, state, x):
        bands = []
        new_state = []
        rest = x
        for st, s in zip(self.stages, state):
            s2, (lo, rest) = st.process_stream(s, rest)
            new_state.append(s2)
            bands.append(lo)
        bands.append(rest)
        return new_state, bands
