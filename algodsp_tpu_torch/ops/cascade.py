"""Whole-cascade blocked IIR engine (counterpart of
`algodsp_tpu/ops/cascade.py`): one Toeplitz product closes all S
sections of an SOS cascade per block.

By superposition the whole cascade is one LTI system, so within block k

    y_k     = Lc @ x_k + Cout @ s_k          (within block k)
    s_{k+1} = T @ s_k + Win @ x_k            (across blocks)

with the compact cascade state s of dimension d = 2S + 2 (the input
history x_{n-1}, x_{n-2} and each section's output history y1_s, y2_s;
section s's input history is section s-1's output history) and host
float64 kernels:

  Lc   (B, B)  lower-triangular Toeplitz of the cascade impulse response
  Win  (d, B)  zero-state end-of-block state response to the block input
  Cout (B, d)  within-block output response to the block-entry state
  T    (d, d)  zero-input state transfer over one block

The across-block recurrence is an inclusive scan with constant combine
matrices T^(2^l) (Hillis-Steele), truncated once a power falls below
SWEEP_TOL. Slow complex-pole sections carry in a per-section modal
basis (V), as in `ops/linrec.py`.

The kernels and the sweep matrices are host-side float64 NumPy, the
same as the reference's; they go to the device once per (cascade,
gain, block count, type, device). The runtime is `torch.matmul` for
one cascade and a band-batched `torch.einsum` for a bank: the
reference computes these products outside any Pallas kernel
(`jnp.dot` / `jnp.einsum` at `Precision.HIGHEST`), and here they run
under `linrec.full_float32()`, so float32 stays full float32 whatever
the caller set. One engine serves both entry points:
`cascade_apply_blocked_banded` runs a different cascade in every row
of a band axis (`filters/bank.py`), and `cascade_apply_blocked` is it
with one band.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from algodsp_tpu_torch.ops.linrec import full_float32

SWEEP_TOL = 1e-12


@dataclasses.dataclass(frozen=True)
class CascadeKernels:
    """Host-precomputed (float64) block kernels for an SOS cascade,
    in the per-section modal basis where `modal` (s_direct = V @ s)."""
    Lc: np.ndarray       # (B, B)
    Win: np.ndarray      # (d, B)
    Cout: np.ndarray     # (B, d)
    T: np.ndarray        # (d, d)
    V: np.ndarray        # (d, d)
    Vinv: np.ndarray     # (d, d)
    modal: bool
    block: int
    d: int


def _cascade_affine_step(sos: np.ndarray):
    """Single-sample affine step in the compact basis.

    State layout: [x_{n-1}, x_{n-2}, y1_0, y2_0, ..., y1_{S-1}, y2_{S-1}].
    Returns (A, b, c, d0) with s' = A s + b x_n and y_n = c s + d0 x_n.
    """
    S = sos.shape[0]
    d = 2 * S + 2
    A = np.zeros((d, d))
    b = np.zeros(d)

    def e(i):
        v = np.zeros(d)
        v[i] = 1.0
        return v

    # current input of section s as (state-row, input-coef)
    cur_s, cur_x = np.zeros(d), 1.0           # section 0 input = x_n
    h1_s, h1_x = e(0), 0.0                    # its history x_{n-1}
    h2_s, h2_x = e(1), 0.0                    # x_{n-2}
    for s in range(S):
        b0, b1, b2, a1, a2 = sos[s]
        y_s = (b0 * cur_s + b1 * h1_s + b2 * h2_s
               - a1 * e(2 + 2 * s) - a2 * e(3 + 2 * s))
        y_x = b0 * cur_x + b1 * h1_x + b2 * h2_x
        A[2 + 2 * s] = y_s
        b[2 + 2 * s] = y_x
        A[3 + 2 * s] = e(2 + 2 * s)
        b[3 + 2 * s] = 0.0
        cur_s, cur_x = y_s, y_x
        h1_s, h1_x = e(2 + 2 * s), 0.0
        h2_s, h2_x = e(3 + 2 * s), 0.0
    A[0] = np.zeros(d)
    b[0] = 1.0                                # new x_{n-1} = x_n
    A[1] = e(0)                               # new x_{n-2} = old x_{n-1}
    return A, b, cur_s.copy(), cur_x


@lru_cache(maxsize=64)
def _kernels_cached(sos_key: bytes, s_count: int, block: int) -> CascadeKernels:
    sos = np.frombuffer(sos_key, dtype=np.float64).reshape(s_count, 5)
    A, b, c, d0 = _cascade_affine_step(sos)
    d = A.shape[0]
    B = block

    # cascade impulse response h[0..B-1]: h[0] = d0, h[m] = c @ A^{m-1} @ b
    h = np.empty(B)
    h[0] = d0
    Win = np.empty((d, B))
    Cout = np.empty((B, d))
    M = np.eye(d)
    for m in range(B):
        Cout[m] = c @ M                       # c @ A^m
        if m >= 1:
            h[m] = Cout[m - 1] @ b            # c @ A^{m-1} @ b
        M = A @ M if m < B - 1 else M
    # Win[:, j] = A^{B-1-j} @ b  (backward accumulation)
    v = b.copy()
    for m in range(B):
        Win[:, B - 1 - m] = v
        v = A @ v
    T = A @ M                                 # A^B  (M = A^{B-1})

    idx = np.arange(B)[:, None] - np.arange(B)[None, :]
    Lc = np.where(idx >= 0, h[np.clip(idx, 0, B - 1)], 0.0)

    # per-section modal basis for slow complex-pole sections; the
    # x-history block keeps the identity
    V = np.eye(d)
    modal = False
    for s_i in range(s_count):
        b0, b1, b2, a1, a2 = sos[s_i]
        disc = a1 * a1 - 4.0 * a2
        if disc >= 0.0:
            continue
        # peak of this section's all-pole response within a block
        hp = np.zeros(B + 1)
        hp[0] = 1.0
        if B >= 1:
            hp[1] = -a1
        for m in range(2, B + 1):
            hp[m] = -a1 * hp[m - 1] - a2 * hp[m - 2]
        if np.max(np.abs(hp)) <= 4.0:
            continue
        alpha, beta = -a1 / 2.0, np.sqrt(-disc) / 2.0
        V[2 + 2 * s_i:4 + 2 * s_i, 2 + 2 * s_i:4 + 2 * s_i] = \
            np.array([[alpha, beta], [1.0, 0.0]])
        modal = True
    if modal:
        Vinv = np.linalg.inv(V)
        Win = Vinv @ Win
        Cout = Cout @ V
        T = Vinv @ T @ V
    else:
        Vinv = V
    return CascadeKernels(Lc=Lc, Win=Win, Cout=Cout, T=T, V=V, Vinv=Vinv,
                          modal=modal, block=B, d=d)


def cascade_kernels(sos, block: int = 128) -> CascadeKernels:
    sos = np.ascontiguousarray(np.asarray(sos, dtype=np.float64))
    if sos.ndim != 2 or sos.shape[1] != 5:
        raise ValueError(f"sos must be (S, 5), got {sos.shape}")
    return _kernels_cached(sos.tobytes(), sos.shape[0], int(block))


@lru_cache(maxsize=64)
def _kernels_banded_cached(sos_key: bytes, n_bands: int, s_count: int,
                           block: int) -> CascadeKernels:
    """Per-band cascade kernels stacked on a leading band axis."""
    sos = np.frombuffer(sos_key, dtype=np.float64).reshape(
        n_bands, s_count, 5)
    ks = [_kernels_cached(np.ascontiguousarray(sos[b]).tobytes(),
                          s_count, block) for b in range(n_bands)]
    return CascadeKernels(
        Lc=np.stack([k.Lc for k in ks]), Win=np.stack([k.Win for k in ks]),
        Cout=np.stack([k.Cout for k in ks]), T=np.stack([k.T for k in ks]),
        V=np.stack([k.V for k in ks]), Vinv=np.stack([k.Vinv for k in ks]),
        modal=any(k.modal for k in ks), block=block, d=ks[0].d)


@lru_cache(maxsize=256)
def _sweep_mats_banded(sos_key: bytes, n_bands: int, s_count: int,
                       block: int, k_blocks: int):
    """Hillis-Steele combine matrices T^(2^l) for l = 0.., (bands, d, d)
    each, truncated once every band's falls below SWEEP_TOL."""
    kern = _kernels_banded_cached(sos_key, n_bands, s_count, block)
    mats = []
    M = kern.T                     # (bands, d, d)
    shift = 1
    while shift < k_blocks:
        if np.max(np.abs(M)) < SWEEP_TOL:
            break
        mats.append((shift, M.copy()))
        M = M @ M                  # a product a band
        shift *= 2
    return tuple(mats)


@lru_cache(maxsize=256)
def _device_consts_banded(sos_key: bytes, n_bands: int, s_count: int,
                          block: int, gain: float, k_blocks: int,
                          dtype: torch.dtype, device: torch.device):
    """The engine's weights and sweep matrices, each transposed per band
    to (bands, cols, rows) so that a row vector times it is the product,
    as tensors of `dtype` on `device`, made once per (bank, gain, block
    count, type, device). The input gain is folded into the input-drive
    weights: Lc @ (g x) + Cout @ s == (g Lc) @ x + Cout @ s."""
    kern = _kernels_banded_cached(sos_key, n_bands, s_count, block)
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(np.swapaxes(a, -1, -2)),
                                     dtype=dtype, device=device)
    sweeps = tuple((shift, as_t(M)) for shift, M in _sweep_mats_banded(
        sos_key, n_bands, s_count, block, k_blocks))
    return (as_t(gain * kern.Lc), as_t(gain * kern.Win), as_t(kern.Cout),
            as_t(kern.T), as_t(kern.Vinv), as_t(kern.V), sweeps)


def _apply_banded(xb, sos, block, s0, return_state, gain):
    """The engine: xb (..., bands, N), sos (bands, S, 5) float64."""
    nb, S = sos.shape[:2]
    kern = _kernels_banded_cached(sos.tobytes(), nb, S, int(block))
    B, d = kern.block, kern.d
    if xb.shape[-2] != nb:
        raise ValueError(f"band axis {xb.shape[-2]} != {nb}")
    n = xb.shape[-1]
    if n % B:
        raise ValueError(f"length {n} not a multiple of block {B}")
    K = n // B
    Lc, Win, Cout, T, Vinv, V, sweeps = _device_consts_banded(
        sos.tobytes(), nb, S, int(block), float(gain), K, xb.dtype, xb.device)
    if nb == 1:
        # one cascade: plain products with its weights, which fold the
        # leading dims into one product where that needs no copy
        mm = lambda a, W: a @ W[0]
        mv = lambda M, v: v @ M[0]
    else:
        # the band axis is the products' batch: einsum folds the leading
        # dims and the block axis into the rows of one batched product a
        # band, where a broadcast matmul would copy every weight for
        # every channel
        mm = lambda a, W: torch.einsum("...skb,sbc->...skc", a, W)
        mv = lambda M, v: torch.einsum("sji,...sj->...si", M, v)

    with full_float32():
        xr = xb.reshape(xb.shape[:-1] + (K, B))
        u = mm(xr, Lc)                                 # (..., bands, K, B)
        w = mm(xr, Win)                                # (..., bands, K, d)
        if s0 is None:
            s0 = xb.new_zeros(xb.shape[:-1] + (d,))
        else:
            s0 = torch.broadcast_to(s0.to(xb.dtype), xb.shape[:-1] + (d,))
            if kern.modal:                             # direct -> modal basis
                s0 = mv(Vinv, s0)
            w = torch.cat([w[..., :1, :] + mv(T, s0)[..., None, :],
                           w[..., 1:, :]], dim=-2)
        # inclusive scan e_k = sum_{j<=k} T^{k-j} w_j, constant-matrix sweeps
        for shift, M in sweeps:
            shifted = mm(w[..., :-shift, :], M)
            w = torch.cat([w[..., :shift, :], w[..., shift:, :] + shifted],
                          dim=-2)
        entries = torch.cat([s0[..., None, :], w[..., :-1, :]], dim=-2)
        y = (u + mm(entries, Cout)).reshape(xb.shape[:-1] + (n,))
        if not return_state:
            return y
        s_fin = w[..., -1, :]
        if kern.modal:                                 # back to the direct basis
            s_fin = mv(V, s_fin)
    return y, s_fin


def cascade_apply_blocked(x, sos, *, block: int = 128, s0=None,
                          return_state: bool = False, gain: float = 1.0):
    """Run an entire SOS cascade over x in blocked form.

    x: (..., N) with N a multiple of `block`; s0: optional (..., d)
    entry state in the direct compact basis (zeros if None); gain: the
    input gain, folded into the weights. Returns y or (y, s_final), in
    x's type and on its device; every product runs in full float32
    under `full_float32()` (float64 stays float64). The banded engine
    with one band.
    """
    sos = np.ascontiguousarray(np.asarray(sos, dtype=np.float64))
    if sos.ndim != 2 or sos.shape[1] != 5:
        raise ValueError(f"sos must be (S, 5), got {sos.shape}")
    out = _apply_banded(x[..., None, :], sos[None], block,
                        None if s0 is None else s0[..., None, :],
                        return_state, gain)
    if not return_state:
        return out[..., 0, :]
    return out[0][..., 0, :], out[1][..., 0, :]


def cascade_apply_blocked_banded(xb, sos, *, block: int = 128, s0=None,
                                 return_state: bool = False):
    """Banded whole-cascade engine: band row b runs its own cascade.

    xb: (..., bands, N) with N a multiple of `block`; sos: (bands, S, 5);
    s0: optional (..., bands, d) entry state in the direct compact
    basis. One batched product per kernel with the band axis as the
    batch replaces S sequential banded stages (filter banks, vocoder)
    by a single Toeplitz pass per block. Returns y or (y, s_final) in
    xb's type on its device; the products run in full float32 under
    `full_float32()`.
    """
    sos = np.ascontiguousarray(np.asarray(sos, dtype=np.float64))
    if sos.ndim != 3 or sos.shape[2] != 5:
        raise ValueError(f"banded sos must be (bands, S, 5), got {sos.shape}")
    return _apply_banded(xb, sos, block, s0, return_state, 1.0)


def chain_state_to_compact(state):
    """BiquadChain (..., S, 4) state -> compact (..., 2S+2)."""
    x12 = state[..., 0, 0:2]
    y12 = state[..., :, 2:4].reshape(state.shape[:-2] + (-1,))
    return torch.cat([x12, y12], dim=-1)


def compact_state_to_chain(s, S: int):
    """Compact (..., 2S+2) -> BiquadChain (..., S, 4) state.

    Section s's input history is section s-1's output history (the
    global input history for section 0), recovered exactly."""
    x12 = s[..., 0:2]
    y = s[..., 2:].reshape(s.shape[:-1] + (S, 2))
    xh = torch.cat([x12[..., None, :], y[..., :-1, :]], dim=-2)
    return torch.cat([xh, y], dim=-1)
