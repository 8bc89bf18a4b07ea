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
same as the reference's. The runtime is plain `torch.matmul`: the
reference computes these products outside any Pallas kernel
(`jnp.dot` / `jnp.einsum` at `Precision.HIGHEST`), and here they run
under `linrec.full_float32()`, so float32 stays full float32 whatever
the caller set. The banded variant waits for `filters/bank.py`.
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


@lru_cache(maxsize=256)
def _sweep_mats(sos_key: bytes, s_count: int, block: int, k_blocks: int):
    """Hillis-Steele combine matrices T^(2^l) for l = 0.., truncated
    once the matrix norm falls below SWEEP_TOL."""
    kern = _kernels_cached(sos_key, s_count, block)
    mats = []
    M = kern.T
    shift = 1
    while shift < k_blocks:
        if np.max(np.abs(M)) < SWEEP_TOL:
            break
        mats.append((shift, M.copy()))
        M = M @ M
        shift *= 2
    return tuple(mats)


@lru_cache(maxsize=64)
def _dot_consts(sos_key: bytes, s_count: int, block: int, gain: float):
    """Pre-transposed float64 weights for the flattened 2-D products,
    the input gain folded into the input-drive weights (Lc, Win):
    Lc @ (g x) + Cout @ s == (g Lc) @ x + Cout @ s."""
    kern = _kernels_cached(sos_key, s_count, block)
    return (np.ascontiguousarray(gain * kern.Lc.T),
            np.ascontiguousarray(gain * kern.Win.T),
            np.ascontiguousarray(kern.Cout.T))


@lru_cache(maxsize=256)
def _device_consts(sos_key: bytes, s_count: int, block: int, gain: float,
                   k_blocks: int, dtype: torch.dtype, device: torch.device):
    """The engine's weights and sweep matrices as tensors of `dtype` on
    `device`, made once per (cascade, gain, block count, type, device)."""
    kern = _kernels_cached(sos_key, s_count, block)
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                     device=device)
    LcT, WinT, CoutT = _dot_consts(sos_key, s_count, block, gain)
    sweeps = tuple((shift, as_t(M.T)) for shift, M in
                   _sweep_mats(sos_key, s_count, block, k_blocks))
    return (as_t(LcT), as_t(WinT), as_t(CoutT), as_t(kern.T.T),
            as_t(kern.Vinv.T), as_t(kern.V.T), sweeps)


def cascade_apply_blocked(x, sos, *, block: int = 128, s0=None,
                          return_state: bool = False, gain: float = 1.0):
    """Run an entire SOS cascade over x in blocked form.

    x: (..., N) with N a multiple of `block`; s0: optional (..., d)
    entry state in the direct compact basis (zeros if None); gain: the
    input gain, folded into the weights. Returns y or (y, s_final), in
    x's type and on its device; every product runs in full float32
    under `full_float32()` (float64 stays float64).
    """
    sos = np.ascontiguousarray(np.asarray(sos, dtype=np.float64))
    kern = cascade_kernels(sos, block)
    B, d = kern.block, kern.d
    n = x.shape[-1]
    if n % B:
        raise ValueError(f"length {n} not a multiple of block {B}")
    K = n // B
    LcT, WinT, CoutT, TT, VinvT, VT, sweeps = _device_consts(
        sos.tobytes(), sos.shape[0], int(block), float(gain), K, x.dtype,
        x.device)

    def dot(a, W):
        # flattened 2-D product against a pre-transposed weight
        return torch.matmul(a.reshape(-1, a.shape[-1]), W).reshape(
            a.shape[:-1] + (W.shape[-1],))

    with full_float32():
        xb = x.reshape(x.shape[:-1] + (K, B))
        u = dot(xb, LcT)                               # (..., K, B) zero-state out
        w = dot(xb, WinT)                              # (..., K, d) zero-state end
        if s0 is None:
            s0 = x.new_zeros(x.shape[:-1] + (d,))
        else:
            s0 = torch.broadcast_to(s0.to(x.dtype), x.shape[:-1] + (d,))
            if kern.modal:                             # direct -> modal basis
                s0 = s0 @ VinvT
            w = torch.cat([w[..., :1, :] + (s0 @ TT)[..., None, :],
                           w[..., 1:, :]], dim=-2)
        # inclusive scan e_k = sum_{j<=k} T^{k-j} w_j, constant-matrix sweeps
        for shift, MT in sweeps:
            shifted = w[..., :-shift, :] @ MT
            w = torch.cat([w[..., :shift, :], w[..., shift:, :] + shifted],
                          dim=-2)
        entries = torch.cat([s0[..., None, :], w[..., :-1, :]], dim=-2)
        y = (u + dot(entries, CoutT)).reshape(x.shape[:-1] + (n,))
        if not return_state:
            return y
        s_fin = w[..., -1, :]
        if kern.modal:                                 # back to the direct basis
            s_fin = s_fin @ VT
    return y, s_fin


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
