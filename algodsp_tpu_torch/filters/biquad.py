"""Biquad sections and cascades (counterpart of `algodsp_tpu/filters/biquad.py`).

Coefficient layout: an SOS array of shape (S, 5) float64 —
[b0, b1, b2, a1, a2] per section, a0 normalized to 1. Design and
conditioning run on the host in float64; the runtime follows the input
tensor's dtype and device.

Runtime engines, picked by `process(mode="auto")`:
- "kernel": the fused CUDA cascade (`ops/biquad_cascade.py`), for
  float32 inputs of any leading shape (flattened onto the kernel's
  channel axis) of chains without slow poles and of at most 64 runtime
  sections. On a CPU tensor the same call runs the kernel's plain
  version.
- "cascade": the whole-cascade block engine of `ops/cascade.py` (one
  Toeplitz product for all sections a block, the compact state carried
  by constant-matrix sweeps), for N a multiple of the block: float32
  chains with slow poles (faster and more accurate there than the
  blocked engine), and `exact=True`, as in the reference.
- "blocked": the per-section Toeplitz engine of `ops/linrec.py`, which
  carries slow poles in the modal basis; it serves everything else:
  float64 inputs, chains over 64 sections, slow poles on other lengths.
- "scan": the per-sample recurrence, the cross-check for short inputs.
Both matrix engines run their float32 products in full float32
(`linrec.full_float32()`). Lane folding (`process_folded` in the
reference) is not ported: it packs few channels into the TPU's 128
lanes, and the CUDA cascade kernel spreads a channel over a cluster of
blocks instead.
"""

from __future__ import annotations

import numpy as np
import torch

from algodsp_tpu_torch._device import resolve_device
from algodsp_tpu_torch.ops import cascade as cascmod
from algodsp_tpu_torch.ops import linrec
from algodsp_tpu_torch.ops.biquad_cascade import MAX_SECTIONS, biquad_cascade


def sos_array(sections) -> np.ndarray:
    """Normalize input to an (S, 5) float64 SOS array.

    Accepts one (5,) section, a list of sections, or an (S, 5) array.
    """
    a = np.asarray(sections, dtype=np.float64)
    if a.ndim == 1:
        a = a[None, :]
    if a.ndim != 2 or a.shape[1] != 5:
        raise ValueError(f"sos must have shape (S, 5), got {a.shape}")
    return a


class BiquadChain:
    """Ordered cascade of biquad sections (the reference's `Chain`).

    `process` is one-shot from zero state; `init_state`/`process_stream`
    thread explicit state for block streaming. Leading batch/channel
    dims broadcast.
    """

    def __init__(self, sos, *, gain: float = 1.0,
                 block_size: int = linrec.DEFAULT_BLOCK,
                 condition: bool = True):
        self.sos = sos_array(sos)
        self.gain = float(gain)
        self.block_size = int(block_size)
        self._condition = bool(condition)
        # ill-conditioned real-pole sections split into first-order pairs
        # (linrec.condition_sos); streaming state follows runtime_sos
        self.runtime_sos = (linrec.condition_sos(self.sos, self.block_size)
                            if condition else self.sos)
        kernels = linrec.ar2_kernels(self.runtime_sos[:, 3],
                                     self.runtime_sos[:, 4], self.block_size)
        # slow complex poles: the direct-form kernel loses 30-50 dB on
        # them in float32, so auto dispatch keeps them on the blocked
        # engine, which carries them in the modal basis
        self._has_slow_poles = bool(np.any(kernels.modal))

    @property
    def num_sections(self) -> int:
        return self.sos.shape[0]

    @property
    def num_runtime_sections(self) -> int:
        """Sections actually executed (>= num_sections when conditioning
        split real-pole sections; see linrec.condition_sos)."""
        return self.runtime_sos.shape[0]

    @property
    def order(self) -> int:
        return 2 * self.sos.shape[0]

    @property
    def has_slow_poles(self) -> bool:
        """True when a section's complex poles are slow enough (within-block
        all-pole response peaking above 4) that the blocked engine carries
        them in the modal basis; pass `exact=True` to `process` for the
        float64 >= 120 dB path."""
        return self._has_slow_poles

    def update_coefficients(self, sos, gain: float | None = None) -> "BiquadChain":
        """A new chain with swapped coefficients. State stays valid when
        the runtime section count is unchanged (`chain.go:99-114`);
        `process_stream` rejects a stale state whose count differs."""
        return BiquadChain(sos, gain=self.gain if gain is None else gain,
                           block_size=self.block_size,
                           condition=self._condition)

    def init_state(self, batch_shape: tuple[int, ...] = (),
                   dtype=torch.float32, device=None):
        """Streaming state (..., S, 4): per runtime section
        (x_{n-1}, x_{n-2}, y_{n-1}, y_{n-2}). Lives on the CUDA card
        unless `device` says otherwise."""
        return torch.zeros(tuple(batch_shape) + (self.num_runtime_sections, 4),
                           dtype=dtype, device=resolve_device(device))

    def _auto_mode(self, x) -> str:
        if x.dtype == torch.float32 and not self._has_slow_poles:
            if self.num_runtime_sections <= MAX_SECTIONS:
                return "kernel"
        elif (x.dtype == torch.float32 and x.shape[-1] > 0
              and x.shape[-1] % self.block_size == 0):
            # slow poles in float32 on block multiples: the whole-cascade
            # engine measured faster than the blocked one and more
            # accurate against float64 (PERF.md section 6)
            return "cascade"
        return "blocked"

    def _run(self, state, x, mode: str):
        if mode == "kernel":
            # leading dims flatten onto the kernel's channel axis
            lead, n = x.shape[:-1], x.shape[-1]
            s = self.num_runtime_sections
            if state is not None:
                state = torch.broadcast_to(state.to(x.dtype), lead + (s, 4))
                state = state.reshape(-1, s, 4).contiguous()
            y, new_state = biquad_cascade(x.reshape(-1, n).contiguous(),
                                          self.runtime_sos, self.gain, state)
            return new_state.reshape(lead + (s, 4)), y.reshape(x.shape)
        if mode == "cascade":
            y, st = self.process_cascade(x, state=state, return_state=True)
            return st, y
        if mode not in ("blocked", "scan"):
            raise ValueError(f"biquad: unknown mode {mode!r}")
        if self.gain != 1.0:
            x = x * self.gain
        return linrec.run_sections(x, self.runtime_sos, state, mode=mode,
                                   block=self.block_size)

    def process(self, x, *, mode: str = "auto", exact: bool = False):
        """One-shot filtering from zero state (`chain.go:74-85`).

        mode: "auto" (the kernel for float32 chains without slow poles
        of at most MAX_SECTIONS = 64 runtime sections, the whole-cascade
        engine for float32 chains with slow poles where N is a multiple
        of the block, the blocked engine otherwise), "kernel",
        "blocked", "cascade" or "scan". On the card mode="kernel" raises
        on longer chains.

        exact: the float64 escape hatch for slow-pole chains: the
        selected engine evaluates in float64 and the result is cast back
        to x.dtype; "auto" takes the whole-cascade engine where N is a
        multiple of the block and the blocked engine otherwise, as the
        reference does.
        """
        if exact:
            if mode == "kernel":
                raise ValueError("exact=True runs on the float64 engines; use "
                                 "mode 'auto', 'blocked', 'cascade' or 'scan'")
            if mode == "auto":
                mode = ("cascade" if x.shape[-1] % self.block_size == 0
                        else "blocked")
            y = self.process(x.to(torch.float64), mode=mode)
            return y.to(x.dtype)
        if mode == "auto":
            mode = self._auto_mode(x)
        if mode == "cascade":
            return self.process_cascade(x)
        state = (None if mode == "kernel" else
                 self.init_state(x.shape[:-1], dtype=x.dtype, device=x.device))
        _, y = self._run(state, x, mode)
        return y

    def process_cascade(self, x, state=None, return_state: bool = False):
        """Whole-cascade block engine (`ops/cascade.py`): the entire SOS
        cascade closed a block by one Toeplitz product plus compact-state
        carry sweeps. Exact (the same recurrence in another order);
        threads the (..., S, 4) streaming state when given. N must be a
        multiple of `block_size`.

        Long one-shot calls (N >= 2^16, a multiple of 256, no state) use
        a 256-sample block with the sections re-conditioned at that
        length, as the reference does; streaming calls keep
        `block_size`, to which the state layout is tied."""
        if (state is None and not return_state and self.block_size == 128
                and x.shape[-1] % 256 == 0 and x.shape[-1] >= (1 << 16)):
            if not hasattr(self, "_sos_bulk256"):
                self._sos_bulk256 = (linrec.condition_sos(self.sos, 256)
                                     if self._condition else self.sos)
            return cascmod.cascade_apply_blocked(
                x, self._sos_bulk256, block=256, gain=self.gain)
        s0 = None if state is None else cascmod.chain_state_to_compact(
            state.to(x.dtype))
        out = cascmod.cascade_apply_blocked(
            x, self.runtime_sos, block=self.block_size, s0=s0,
            return_state=return_state, gain=self.gain)
        if return_state:
            y, s_fin = out
            return y, cascmod.compact_state_to_chain(
                s_fin, self.num_runtime_sections)
        return out

    def process_stream(self, state, x, *, mode: str = "auto"):
        """Streaming block processing: (state, x) -> (state, y), for any
        block length (mode "cascade": a multiple of `block_size`)."""
        if tuple(state.shape[-2:]) != (self.num_runtime_sections, 4):
            raise ValueError(
                f"biquad: state has {tuple(state.shape[-2:])} trailing dims, "
                f"chain needs ({self.num_runtime_sections}, 4) — after a "
                f"coefficient hot-swap the runtime section count must match "
                f"(chain.go:99-114 contract)")
        if mode == "auto":
            mode = self._auto_mode(x)
        return self._run(state, x, mode)

    # -- analysis (host-side float64) ------------------------------------
    def response(self, freqs, sample_rate: float) -> np.ndarray:
        """Complex frequency response of the full cascade x gain."""
        return self.gain * sos_response(self.sos, freqs, sample_rate)

    def magnitude_db(self, freqs, sample_rate: float) -> np.ndarray:
        mag = np.abs(self.response(freqs, sample_rate))
        with np.errstate(divide="ignore"):
            return 20.0 * np.log10(mag)

    def impulse_response(self, n: int, dtype=torch.float64) -> np.ndarray:
        """First n samples of the impulse response (`response.go:77-97`),
        computed in `dtype` on the host."""
        x = torch.zeros(n, dtype=dtype)
        x[0] = 1.0
        return self.process(x, mode="scan" if n < 256 else "blocked").numpy()


class Section(BiquadChain):
    """Single biquad section (the reference's `Section`)."""

    def __init__(self, b0, b1, b2, a1, a2, **kwargs):
        super().__init__([[b0, b1, b2, a1, a2]], **kwargs)


def sos_response(sos, freqs, sample_rate: float) -> np.ndarray:
    """Complex response of an SOS cascade at freqs (Hz):
    H(z) = prod_s (b0 + b1 z^-1 + b2 z^-2) / (1 + a1 z^-1 + a2 z^-2)
    at z = e^{j w}, w = 2 pi f / sr (`response.go:10-23`)."""
    sos = sos_array(sos)
    f = np.atleast_1d(np.asarray(freqs, dtype=np.float64))
    z1 = np.exp(-1j * 2.0 * np.pi * f / sample_rate)
    z2 = z1 * z1
    h = np.ones_like(z1, dtype=np.complex128)
    for b0, b1, b2, a1, a2 in sos:
        h *= (b0 + b1 * z1 + b2 * z2) / (1.0 + a1 * z1 + a2 * z2)
    return h


def magnitude_squared(sos, freqs, sample_rate: float) -> np.ndarray:
    """Closed-form |H|^2 (`response.go:25-75`)."""
    sos = sos_array(sos)
    f = np.atleast_1d(np.asarray(freqs, dtype=np.float64))
    w = 2.0 * np.pi * f / sample_rate
    cw = np.cos(w)
    c2w = np.cos(2.0 * w)
    out = np.ones_like(f)
    for b0, b1, b2, a1, a2 in sos:
        num = (b0 * b0 + b1 * b1 + b2 * b2
               + 2.0 * (b0 * b1 + b1 * b2) * cw + 2.0 * b0 * b2 * c2w)
        den = (1.0 + a1 * a1 + a2 * a2
               + 2.0 * (a1 + a1 * a2) * cw + 2.0 * a2 * c2w)
        out *= num / den
    return out


def poles_zeros(section) -> tuple[np.ndarray, np.ndarray]:
    """Poles and zeros of one section (`polezero.go:15-80`).

    Returns (zeros, poles) as complex arrays (length <= 2 each).
    """
    b0, b1, b2, a1, a2 = np.asarray(section, dtype=np.float64).reshape(5)
    zeros = np.roots([b0, b1, b2]) if b0 != 0 else (
        np.roots([b1, b2]) if b1 != 0 else np.array([]))
    poles = np.roots([1.0, a1, a2])
    return (np.atleast_1d(zeros).astype(np.complex128),
            poles.astype(np.complex128))


def is_stable(sos) -> bool:
    """True if every section's poles are strictly inside the unit circle."""
    for row in sos_array(sos):
        _, poles = poles_zeros(row)
        if np.any(np.abs(poles) >= 1.0):
            return False
    return True
