"""Blocked second-order linear recurrence engine (counterpart of
`algodsp_tpu/ops/linrec.py`).

Per biquad section the direct-form recurrence

    f_n = b0 x_n + b1 x_{n-1} + b2 x_{n-2}       (FIR part, parallel)
    y_n = f_n - a1 y_{n-1} - a2 y_{n-2}          (AR part, sequential)

is evaluated block by block: within a block of B samples with initial
conditions (y_{-1}, y_{-2}),

    y = L @ f + y_{-1} * p + y_{-2} * q,

with L[i, j] = h[i - j] the lower-triangular Toeplitz matrix of the
all-pole impulse response h, and the 2-vector block carry obeys the
affine recurrence c_k = G c_{k-1} + w_k, solved here by a log-depth
doubling scan. Slow complex poles carry in the modal basis. Everything
host-side (kernels, conditioning, residual flags) is float64 NumPy and
identical to the JAX module; the runtime is PyTorch.

This engine serves float64 chains, chains over 64 sections and
slow-pole float32 chains on lengths that are no block multiple, and it
is the cascade kernel's plain version on the CPU; chains without slow
poles on the card go to the fused CUDA cascade (`ops/biquad_cascade.py`),
slow-pole float32 chains on block multiples to `ops/cascade.py`. Its Toeplitz products and carry products are
float32 `torch.einsum`s and `@`s, run under `full_float32()`: whatever
the caller set (`torch.set_float32_matmul_precision("high")` puts
float32 matmuls on 10-bit TF32 on the card, "medium" on bfloat16 in
oneDNN on the CPU), they run in full float32, as the reference pins
`Precision.HIGHEST`, and the caller's setting is restored afterwards.

`ar2_apply_blocked_banded` runs a different section in every row of a
band axis (the filter bank's per-section path), the band axis as the
products' batch.

`affine2_scan` and `affine_scan_nd` solve time-varying affine
recurrences s_n = A_n s_{n-1} + w_n whose coefficients are known up
front (the modulation effects): on the card the CUDA kernels M3 and M2
(`csrc/affine.cu`, chunked scans over time planned by `m3_plan` and
`m2_plan`), on the CPU their plain
versions, the reference's log-depth composition written as
Hillis-Steele doubling.

Streaming state is (x_{n-1}, x_{n-2}, y_{n-1}, y_{n-2}) per section.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
from functools import lru_cache

import numpy as np
import torch

from algodsp_tpu_torch import _build

DEFAULT_BLOCK = 128


def _precision_backends():
    """The per-backend float32 matmul settings of PyTorch's newer API
    (`torch.backends.cuda.matmul.fp32_precision` and the oneDNN one),
    where this PyTorch has them."""
    out = []
    for m in (torch.backends.cuda.matmul,
              getattr(getattr(torch.backends, "mkldnn", None), "matmul", None)):
        try:
            m.fp32_precision
        except (AttributeError, RuntimeError):
            continue
        out.append(m)
    return out


@contextlib.contextmanager
def full_float32():
    """Run float32 matmuls in full float32 inside the block, whatever
    the caller set, and restore the caller's settings on exit, also on
    an exception.

    Sets `torch.set_float32_matmul_precision("highest")` and
    `torch.backends.cuda.matmul.allow_tf32 = False`. Where PyTorch has
    per-backend settings (`fp32_precision`), those are saved and
    restored as they were, "none" included, so that the caller's state
    reads back the same through either API; a caller whose settings
    already mix the two APIs (the global getter raises) keeps its
    global value, and only the per-backend ones are pinned to "ieee"."""
    backends = _precision_backends()
    saved_backends = [(m, m.fp32_precision) for m in backends]
    try:
        saved_global = torch.get_float32_matmul_precision()
    except RuntimeError:
        saved_global = None
    saved_tf32 = None if backends else torch.backends.cuda.matmul.allow_tf32
    if saved_global is None:
        for m in backends:
            m.fp32_precision = "ieee"
    else:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        if saved_global is not None:
            torch.set_float32_matmul_precision(saved_global)
        if saved_tf32 is not None:
            torch.backends.cuda.matmul.allow_tf32 = saved_tf32
        for m, v in saved_backends:
            m.fp32_precision = v


@contextlib.contextmanager
def full_float32_conv():
    """Run cuDNN convolutions in full float32 inside the block, and
    restore the caller's settings on exit, also on an exception.

    `torch.backends.cudnn.allow_tf32` is True by default, so a float32
    `conv1d` on the card would round its products to TF32. The flag is
    cleared and restored through the API the caller's settings read back
    through: the legacy flag, or, where the caller set the per-operation
    settings apart (`torch.backends.cudnn.conv.fp32_precision`; the legacy
    getter then raises), the convolution's, pinned to "ieee"."""
    cudnn = torch.backends.cudnn
    try:
        saved = cudnn.allow_tf32
    except RuntimeError:
        saved = None
    if saved is not None:
        cudnn.allow_tf32 = False
        try:
            yield
        finally:
            cudnn.allow_tf32 = saved
        return
    saved = cudnn.conv.fp32_precision
    cudnn.conv.fp32_precision = "ieee"
    try:
        yield
    finally:
        cudnn.conv.fp32_precision = saved


@dataclasses.dataclass(frozen=True, eq=False)
class AR2Kernels:
    """Host-precomputed block kernels for a batch of S second-order
    AR sections (float64 NumPy).

    For slow complex-pole sections (|h| peaking above ~4 in a block —
    e.g. low-frequency highpass filters) the carry recurrence is run in
    the MODAL basis: with λ = α ± iβ the pole pair and
    Vr = [[α, β], [1, 0]], the carry c' = Vr^-1 (y1, y2) propagates by
    Gm = r^B * rotation(Bθ) — every entry bounded by r^B <= 1 — and the
    within-block correction rows Pm = Vr^T [p; q] are bounded modal
    responses. The direct basis (S = I) keeps G entries and p/q rows of
    magnitude peak(h) (~80 for a 60 Hz filter at 48 kHz) that cancel in
    f32, costing 30-60 dB; the modal basis removes that cancellation
    exactly (host f64 precompute) at identical device cost.

    Compared and hashed by identity: `ar2_kernels` hands out one object
    per (sections, block), which keys its tables on a device."""
    L: np.ndarray      # (S, B, B) lower-triangular Toeplitz of h
    G: np.ndarray      # (S, 2, 2) block carry propagation (direct basis)
    p: np.ndarray      # (S, B) response column for y_{-1} (direct basis)
    q: np.ndarray      # (S, B) response column for y_{-2} (direct basis)
    S: np.ndarray      # (S, 2, 2) carry-basis transform (I = direct)
    Gm: np.ndarray     # (S, 2, 2) carry propagation in the S basis
    Pm: np.ndarray     # (S, 2, B) correction rows in the S basis
    modal: np.ndarray  # (S,) bool: section uses the modal carry basis
    block: int


def _ar2_impulse_response(a1: np.ndarray, a2: np.ndarray, n: int) -> np.ndarray:
    """h[s, 0..n] for each section: the all-pole impulse response."""
    s = a1.shape[0]
    h = np.zeros((s, n + 1), dtype=np.float64)
    h[:, 0] = 1.0
    if n >= 1:
        h[:, 1] = -a1
    for i in range(2, n + 1):
        h[:, i] = -a1 * h[:, i - 1] - a2 * h[:, i - 2]
    return h


@lru_cache(maxsize=512)
def _ar2_kernels_cached(a1_key: bytes, a2_key: bytes, s: int, block: int) -> AR2Kernels:
    a1 = np.frombuffer(a1_key, dtype=np.float64).copy()
    a2 = np.frombuffer(a2_key, dtype=np.float64).copy()
    b = block
    h = _ar2_impulse_response(a1, a2, b)  # (S, B+1)

    idx = np.arange(b)[:, None] - np.arange(b)[None, :]  # (B, B) i-j
    L = np.where(idx >= 0, h[:, np.clip(idx, 0, b)], 0.0)  # (S, B, B)

    p = h[:, 1:b + 1]                      # (S, B): h[n+1]
    q = -a2[:, None] * h[:, :b]            # (S, B): -a2*h[n]

    G = np.empty((s, 2, 2), dtype=np.float64)
    G[:, 0, 0] = h[:, b]
    G[:, 0, 1] = -a2 * h[:, b - 1]
    G[:, 1, 0] = h[:, b - 1]
    G[:, 1, 1] = -a2 * h[:, b - 2]

    Smat = np.tile(np.eye(2), (s, 1, 1))
    Gm = G.copy()
    Pm = np.stack([p, q], axis=1)                   # (S, 2, B)
    modal = np.zeros(s, dtype=bool)
    for i in range(s):
        disc = a1[i] * a1[i] - 4.0 * a2[i]
        if disc >= 0.0 or np.max(np.abs(h[i])) <= 4.0:
            continue                                # direct basis is fine
        alpha = -a1[i] / 2.0
        beta = np.sqrt(-disc) / 2.0
        lam_b = complex(alpha, beta) ** b
        # basis columns (vr, vi) of the eigenvector v = (λ, 1):
        # A [vr vi] = [vr vi] [[α, β], [-β, α]], so G = A^B maps to the
        # scaled rotation [[Re λ^B, Im λ^B], [-Im λ^B, Re λ^B]]
        Vr = np.array([[alpha, beta], [1.0, 0.0]])
        Smat[i] = np.linalg.inv(Vr)
        Gm[i] = np.array([[lam_b.real, lam_b.imag],
                          [-lam_b.imag, lam_b.real]])
        # corr = y1*p + y2*q with (y1, y2) = Vr @ c'
        Pm[i] = np.stack([Vr[0, 0] * p[i] + Vr[1, 0] * q[i],
                          Vr[0, 1] * p[i] + Vr[1, 1] * q[i]])
        modal[i] = True
    return AR2Kernels(L=L, G=G, p=p, q=q, S=Smat, Gm=Gm, Pm=Pm, modal=modal,
                      block=b)


def ar2_kernels(a1, a2, block: int = DEFAULT_BLOCK) -> AR2Kernels:
    """Precompute block kernels for S sections (host, float64)."""
    a1 = np.atleast_1d(np.asarray(a1, dtype=np.float64))
    a2 = np.atleast_1d(np.asarray(a2, dtype=np.float64))
    if a1.shape != a2.shape or a1.ndim != 1:
        raise ValueError("a1/a2 must be 1-D arrays of equal length")
    return _ar2_kernels_cached(a1.tobytes(), a2.tobytes(), a1.size, int(block))


def condition_sos(sos: np.ndarray, block: int = DEFAULT_BLOCK,
                  peak_threshold: float = 8.0) -> np.ndarray:
    """Split ill-conditioned real-pole sections into first-order pairs.

    The blocked engine evaluates each section as (zero-IC Toeplitz
    response) + (carry correction). For sections whose all-pole impulse
    response h grows large within a block — e.g. the A-weighting 20.6 Hz
    highpass, a double real pole at r=0.99731 where h peaks at ~91 —
    those two terms are each ~500x the output and cancel, costing ~60 dB
    of f32 SNR. When both poles AND both zeros are real, the section
    splits exactly into two first-order sections (a2=0) with each zero
    paired to its nearest pole, so every intermediate stays O(1) and
    |h| <= 1 per sub-section.

    Returns a new (S', 5) float64 SOS array (S' >= S) that is
    input/output identical to `sos` in exact arithmetic. Sections with
    complex poles, complex zeros, or small in-block growth pass through
    unchanged.
    """
    sos = np.asarray(sos, dtype=np.float64)
    out = []
    for b0, b1, b2, a1, a2 in sos:
        # peak of the all-pole impulse response within one block
        h = _ar2_impulse_response(np.array([a1]), np.array([a2]), block)[0]
        # relative tolerance: a repeated real pole computes disc ~ -eps*a1^2
        tol = 1e-9 * max(a1 * a1, abs(4.0 * a2), 1e-30)
        disc = a1 * a1 - 4.0 * a2
        if np.max(np.abs(h)) <= peak_threshold or disc < -tol or b0 == 0.0:
            out.append([b0, b1, b2, a1, a2])
            continue
        rt = np.sqrt(max(disc, 0.0))
        p_lo, p_hi = sorted([(-a1 - rt) / 2.0, (-a1 + rt) / 2.0])
        ztol = 1e-9 * max(b1 * b1, abs(4.0 * b0 * b2), 1e-30)
        zdisc = b1 * b1 - 4.0 * b0 * b2
        if b2 == 0.0 and b1 == 0.0:
            z_lo = z_hi = 0.0          # pure all-pole: zeros at origin
        elif zdisc < -ztol:
            out.append([b0, b1, b2, a1, a2])   # complex zeros: keep
            continue
        else:
            zrt = np.sqrt(max(zdisc, 0.0))
            z_lo, z_hi = sorted([(-b1 - zrt) / (2.0 * b0),
                                 (-b1 + zrt) / (2.0 * b0)])
        # nearest pairing keeps each sub-section's gain flat (for the
        # weighting HP case: (1 - z^-1)/(1 - 0.9973 z^-1) twice)
        if abs(z_hi - p_hi) + abs(z_lo - p_lo) <= \
           abs(z_hi - p_lo) + abs(z_lo - p_hi):
            pairs = [(z_hi, p_hi), (z_lo, p_lo)]
        else:
            pairs = [(z_hi, p_lo), (z_lo, p_hi)]
        out.append([b0, -b0 * pairs[0][0], 0.0, -pairs[0][1], 0.0])
        out.append([1.0, -pairs[1][0], 0.0, -pairs[1][1], 0.0])
    return np.asarray(out, dtype=np.float64).reshape(-1, 5)


def residual_flags(sos: np.ndarray, block: int = DEFAULT_BLOCK) -> np.ndarray:
    """Per-section flags: evaluate via the residual decomposition
    H(z) = b0 + (B(z) - b0*A(z))/A(z)?

    The blocked engine's error scales with its largest intermediate:
    |L @ f| ~ peak(h) * ||b|| for the direct drive versus
    |b0| + peak(h) * ||e|| for the residual drive (e1 = b1 - a1*b0,
    e2 = b2 - a2*b0). For sections whose zeros nearly cancel slow poles
    (low-frequency highpass/shelf: complex poles near z = 1 with
    B ~ b0*A), ||e|| << ||b|| and the decomposition recovers 30-50 dB
    of f32 SNR. For ordinary sections ||e|| ~ ||b|| and the flag stays
    False, keeping the long-validated direct path.
    """
    sos = np.asarray(sos, dtype=np.float64).reshape(-1, 5)
    flags = np.zeros(sos.shape[0], dtype=bool)
    peaks = np.max(np.abs(_ar2_impulse_response(
        sos[:, 3], sos[:, 4], block)), axis=1)
    for s, (b0, b1, b2, a1, a2) in enumerate(sos):
        e = np.hypot(b1 - a1 * b0, b2 - a2 * b0)
        bn = np.hypot(np.hypot(b0, b1), b2)
        flags[s] = (peaks[s] > 4.0
                    and abs(b0) + peaks[s] * e < 0.5 * peaks[s] * bn)
    return flags


@lru_cache(maxsize=512)
def _device_tables(kernels: AR2Kernels, dtype: torch.dtype,
                   device: torch.device):
    """(L, S, Gm, Pm) of every section as tensors of `dtype` on `device`,
    made once per (kernels, type, device)."""
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                     device=device)
    return as_t(kernels.L), as_t(kernels.S), as_t(kernels.Gm), as_t(kernels.Pm)


def fir3(x, b0, b1, b2, x1, x2):
    """3-tap causal FIR f_n = b0 x_n + b1 x_{n-1} + b2 x_{n-2} with explicit
    2-sample history (x1 = x_{n-1} carry-in, x2 = x_{n-2})."""
    xm1 = torch.cat([x1[..., None], x[..., :-1]], dim=-1)
    if x.shape[-1] >= 2:
        xm2 = torch.cat([x2[..., None], x1[..., None], x[..., :-2]], dim=-1)
    else:
        xm2 = x2[..., None]
    return b0 * x + b1 * xm1 + b2 * xm2


def _affine_scan(G, w):
    """Inclusive scan of c_k = G c_{k-1} + w_k over axis -2 of w, c_{-1} = 0.

    G: (2, 2); w: (..., K, 2). Hillis-Steele doubling: after the step
    with shift d every c_k holds sum_{j < 2d} G^j w_{k-j}. Call it under
    `full_float32()`."""
    c = w
    A = G
    d = 1
    K = w.shape[-2]
    while d < K:
        shifted = torch.einsum("ij,...kj->...ki", A, c[..., :-d, :])
        c = torch.cat([c[..., :d, :], c[..., d:, :] + shifted], dim=-2)
        A = A @ A
        d *= 2
    return c


def ar2_apply_blocked(f, kernels: AR2Kernels, section: int, y1, y2,
                      *, precision=None):
    """Apply one AR section to the (already FIR-filtered) drive f.

    f: (..., N) with N a multiple of kernels.block.
    y1, y2: (...,) initial conditions y_{-1}, y_{-2}.
    Returns y: (..., N). Its products run in full float32
    (`full_float32()`). `precision` is accepted for the reference's
    signature and ignored, whatever its value: full float32 is the
    reference's `HIGHEST`, and the port always pins it.
    """
    b = kernels.block
    n = f.shape[-1]
    if n % b:
        raise ValueError(f"length {n} not a multiple of block {b}")
    k = n // b
    L, S, Gm, Pm = (t[section] for t in _device_tables(kernels, f.dtype,
                                                        f.device))

    fb = f.reshape(f.shape[:-1] + (k, b))
    with full_float32():
        u = torch.einsum("...kb,cb->...kc", fb, L)              # zero-IC
        w = torch.stack([u[..., b - 1], u[..., b - 2]], dim=-1)  # (..., K, 2)
        c_init = torch.stack([y1, y2], dim=-1).to(f.dtype)
        if bool(kernels.modal[section]):
            w = torch.einsum("ij,...j->...i", S, w)
            c_init = torch.einsum("ij,...j->...i", S, c_init)
        # fold the initial conditions into w_0: c_0 = Gm c_{-1} + w_0
        w0 = (w[..., :1, :]
              + torch.einsum("ij,...j->...i", Gm, c_init)[..., None, :])
        w = torch.cat([w0, w[..., 1:, :]], dim=-2)
        c = _affine_scan(Gm, w)
    # carry INTO block k is c_{k-1}; block 0 gets the true ICs
    c_prev = torch.cat([c_init[..., None, :], c[..., :-1, :]], dim=-2)
    y = u + c_prev[..., 0:1] * Pm[0] + c_prev[..., 1:2] * Pm[1]
    return y.reshape(f.shape[:-1] + (n,))


def ar2_apply_blocked_banded(f, kernels: AR2Kernels, y1, y2,
                             *, precision=None):
    """Banded variant: apply section b of `kernels` to band row b.

    f: (..., B, N) with B == number of sections in `kernels` and N a
    multiple of kernels.block. y1, y2: (..., B) initial conditions.
    Returns y: (..., B, N). Parallel filter banks (octave bank, vocoder)
    run a different biquad in every band over the same timeline: one
    batched product with the band axis as the batch. Its products run
    in full float32 (`full_float32()`). `precision` is accepted for the
    reference's signature and ignored, whatever its value: full float32
    is the reference's `HIGHEST`, and the port always pins it.
    """
    b = kernels.block
    nbands = kernels.L.shape[0]
    if f.shape[-2] != nbands:
        raise ValueError(f"band axis {f.shape[-2]} != kernel sections {nbands}")
    n = f.shape[-1]
    if n % b:
        raise ValueError(f"length {n} not a multiple of block {b}")
    k = n // b
    # (B, blk, blk), (B, 2, 2), (B, 2, 2), (B, 2, blk)
    L, S, Gm, Pm = _device_tables(kernels, f.dtype, f.device)

    fb = f.reshape(f.shape[:-1] + (k, b))
    with full_float32():
        # the band axis is the batch of one product a band
        u = torch.einsum("...skb,scb->...skc", fb, L)          # (..., B, K, blk)
        w = torch.stack([u[..., b - 1], u[..., b - 2]], dim=-1)  # (..., B, K, 2)
        c_init = torch.stack([y1, y2], dim=-1).to(f.dtype)      # (..., B, 2)
        if bool(np.any(kernels.modal)):  # carry in the modal basis per band
            w = torch.einsum("sij,...skj->...ski", S, w)
            c_init = torch.einsum("sij,...sj->...si", S, c_init)
        w0 = w[..., :1, :] + torch.einsum("sij,...sj->...si", Gm,
                                          c_init)[..., None, :]
        w = torch.cat([w0, w[..., 1:, :]], dim=-2)
        c = _affine_scan_banded(Gm, w)
    c_prev = torch.cat([c_init[..., None, :], c[..., :-1, :]], dim=-2)
    y = (u + c_prev[..., 0:1] * Pm[:, None, 0, :]
         + c_prev[..., 1:2] * Pm[:, None, 1, :])
    return y.reshape(f.shape[:-1] + (n,))


def _affine_scan_banded(G, w):
    """Like _affine_scan but G is per band (B, 2, 2) and w is
    (..., B, K, 2); scans over K by the same doubling. Call it under
    `full_float32()`."""
    c = w
    A = G
    d = 1
    K = w.shape[-2]
    while d < K:
        shifted = torch.einsum("sij,...skj->...ski", A, c[..., :-d, :])
        c = torch.cat([c[..., :d, :], c[..., d:, :] + shifted], dim=-2)
        A = A @ A
        d *= 2
    return c


def ar2_apply_scan(f, a1, a2, y1, y2, *, unroll: int = 8):
    """Sequential evaluation of the same AR recurrence, one sample at a
    time: the cross-check of the blocked engine and the `mode="scan"`
    path for short signals. `unroll` is accepted for the reference's
    signature and ignored: it tunes the unrolling of the reference's
    `lax.scan`, and this Python loop has nothing to unroll."""
    a1 = float(a1)
    a2 = float(a2)
    ym1 = torch.as_tensor(y1, dtype=f.dtype, device=f.device)
    ym2 = torch.as_tensor(y2, dtype=f.dtype, device=f.device)
    out = torch.empty_like(f)
    for i in range(f.shape[-1]):
        y = f[..., i] - a1 * ym1 - a2 * ym2
        out[..., i] = y
        ym1, ym2 = y, ym1
    return out


def run_sections(x, sos, state, *, mode: str = "blocked",
                 block: int = DEFAULT_BLOCK):
    """Cascade of the runtime sections `sos` (S, 5) over x (..., N), one
    section after another, threading state (..., S, 4).

    mode "blocked" runs each section on the Toeplitz engine (padding N
    to a block multiple and taking the carry from the true last
    samples; sections flagged by `residual_flags` use the exact
    residual drive); mode "scan" runs the per-sample recurrence.
    Returns (new_state, y)."""
    sos = np.asarray(sos, dtype=np.float64).reshape(-1, 5)
    n = x.shape[-1]
    kernels = ar2_kernels(sos[:, 3], sos[:, 4], block)
    residual = residual_flags(sos, block)
    pad = (-n) % block if mode == "blocked" else 0
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
    state = state.to(x.dtype)
    new_states = []
    for s in range(sos.shape[0]):
        b0, b1, b2, a1, a2 = (float(v) for v in sos[s])
        st = state[..., s, :]
        x_in = x
        if mode == "blocked" and residual[s]:
            # v = y - b0*x obeys the same AR recurrence driven by the
            # residual FIR (0, b1-a1*b0, b2-a2*b0)
            f = fir3(x, 0.0, b1 - a1 * b0, b2 - a2 * b0, st[..., 0], st[..., 1])
            v = ar2_apply_blocked(f, kernels, s, st[..., 2] - b0 * st[..., 0],
                                  st[..., 3] - b0 * st[..., 1])
            y = b0 * x + v
        else:
            f = fir3(x, b0, b1, b2, st[..., 0], st[..., 1])
            if mode == "blocked":
                y = ar2_apply_blocked(f, kernels, s, st[..., 2], st[..., 3])
            else:
                y = ar2_apply_scan(f, a1, a2, st[..., 2], st[..., 3])
        # carry-out from the true (unpadded) sample positions
        if n >= 2:
            ns = torch.stack([x_in[..., n - 1], x_in[..., n - 2],
                              y[..., n - 1], y[..., n - 2]], dim=-1)
        else:
            ns = torch.stack([x_in[..., n - 1], st[..., 0],
                              y[..., n - 1], st[..., 2]], dim=-1)
        new_states.append(ns)
        x = y
    y_out = x[..., :n] if pad else x
    return torch.stack(new_states, dim=-2), y_out


# ---------------------------------------------------------------------------
# Time-varying affine scans: M3 (affine2_scan) and M2 (affine_scan_nd)
# ---------------------------------------------------------------------------

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# affine_scan_nd_f{32,64}(A, w, s0, after, fin, C, N, d, G, K, L, threads,
# B, stream)
_ND_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong] + [
    ctypes.c_int] * 6 + [ctypes.c_void_p]
# affine2_scan_f{32,64}(A, w, s0, entry, fin, C, N, L, threads, B, stream)
_TWO_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong] + [
    ctypes.c_int] * 3 + [ctypes.c_void_p]
MAX_ND = 32          # M2's composites hold column j of a product on lane j

# The chunked scans' schedule (csrc/affine.cu), the one place it is set:
# the wrappers launch the kernels with these plans, and the CPU models of
# the kernels (tests/test_torch_modulation_walks.py) follow them.
M3_CHUNK = 15        # steps a chunk (a thread); odd, for conflict-free banks
M2_CHUNK = 5         # steps a chunk (a thread a channel); odd, likewise
M3_MAX_THREADS = 512
M2_MAX_THREADS = 256
M2_MAX_GROUP = 8     # channels a block of M2
MAX_CLUSTER = 8      # blocks of a channel along time (a portable cluster)
SMEM_BYTES = 225280  # the kernels' opt-in dynamic shared memory
H100_SMS = 132


def _round_vec(n: int, itemsize: int) -> int:
    v = 16 // itemsize
    return -(-n // v) * v


def _region(n: int, itemsize: int) -> int:
    """Elements of a staging region for n elements: whole 16-byte pieces
    and 16 bytes of slack (`region_len` in csrc/affine.cu)."""
    return _round_vec(n, itemsize) + 16 // itemsize


def m3_smem_bytes(threads: int, itemsize: int, L: int) -> int:
    """M3's dynamic shared memory for chunks of L steps: the tile's A
    and w."""
    tile = threads * L
    return (_region(4 * tile, itemsize) + _region(2 * tile, itemsize)) * itemsize


def m3_plan(n: int, C: int, itemsize: int, sms: int = H100_SMS):
    """M3's schedule for C channels of n steps: (L, threads, B, tile).

    A thread takes a chunk of L = M3_CHUNK steps, a block a tile of
    threads x L steps a pass. Where the channels leave SMs free, a
    channel's time is cut over a cluster of B <= 8 blocks (an SM each at
    most, and at least 64 chunks a block); the threads cover the block's
    share of the chunks, up to what the shared memory holds."""
    L = M3_CHUNK
    chunks = -(-n // L)
    B = max(1, min(MAX_CLUSTER, sms // C, chunks // 64))
    cap = M3_MAX_THREADS
    while m3_smem_bytes(cap, itemsize, L) > SMEM_BYTES:
        cap -= 32
    threads = min(cap, -(-chunks // (B * 32)) * 32)
    return L, threads, B, threads * L


def m2_smem_bytes(d: int, G: int, K: int, B: int, itemsize: int,
                  L: int) -> int:
    """M2's dynamic shared memory (`nd_layout` in csrc/affine.cu): A's
    tile, G channels' w tiles, K composites, K + 1 prefix products, the
    chunk entries, two states a channel, the tile's map twice and, in a
    cluster, the B ranks' maps."""
    tile, dd = K * L, d * d

    def rv(n):
        return _round_vec(n, itemsize)
    sl = rv(dd + G * d)
    total = (_region(tile * dd, itemsize) + G * _region(tile * d, itemsize)
             + rv(K * dd) + rv((K + 1) * dd) + rv(G * K * d) + 2 * rv(G * d)
             + 2 * sl + (B * sl if B > 1 else 0))
    return total * itemsize


def m2_plan(n: int, C: int, d: int, itemsize: int, sms: int = H100_SMS):
    """M2's schedule for C channels of n steps of a d-state:
    (G, K, L, threads, B).

    A block takes G <= 8 channels and a tile of K chunks of L = M2_CHUNK
    steps a pass, a thread a (channel, chunk) pair. Where the channel
    groups leave SMs free, time is cut over a cluster of B <= 8 blocks (at
    least 4 chunks a block); K covers the block's share of the chunks, up
    to 256 threads and what the shared memory holds (for a large d, G and
    then B give way)."""
    L = M2_CHUNK
    g0 = min(C, M2_MAX_GROUP)
    chunks = -(-n // L)
    B = max(1, min(MAX_CLUSTER, sms // -(-C // g0), chunks // 4))
    while True:
        for G in range(g0, 0, -1):
            for K in range(min(M2_MAX_THREADS // G, -(-chunks // B)), 0, -1):
                if m2_smem_bytes(d, G, K, B, itemsize, L) <= SMEM_BYTES:
                    return G, K, L, -(-(G * K) // 32) * 32, B
        if B == 1:
            raise ValueError(f"affine_scan_nd: d = {d} does not fit")
        B //= 2


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _aligned(t):
    """t, or a copy of it that starts on 16 bytes (M3's vector loads)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _mat2(a_r, a_l):
    """a_r @ a_l of 2 x 2 matrices packed [m00, m01, m10, m11]."""
    return torch.stack([
        a_r[..., 0] * a_l[..., 0] + a_r[..., 1] * a_l[..., 2],
        a_r[..., 0] * a_l[..., 1] + a_r[..., 1] * a_l[..., 3],
        a_r[..., 2] * a_l[..., 0] + a_r[..., 3] * a_l[..., 2],
        a_r[..., 2] * a_l[..., 1] + a_r[..., 3] * a_l[..., 3]], dim=-1)


def _vec2(a, b):
    """a @ b of a packed 2 x 2 matrix and a 2-vector."""
    return torch.stack([a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1],
                        a[..., 2] * b[..., 0] + a[..., 3] * b[..., 1]], dim=-1)


def affine2_scan_plain(A, w, s0):
    """Plain PyTorch version of M3: the reference's log-depth composition
    of (matrix, vector) pairs (`linrec.py:428-466`), as Hillis-Steele
    doubling: after the step with shift d, pair n holds the composition
    of steps n-2d+1..n. Returns (entry, final)."""
    lead = torch.broadcast_shapes(A.shape[:-2], w.shape[:-2], s0.shape[:-1])
    n = A.shape[-2]
    A = torch.broadcast_to(A, lead + A.shape[-2:])
    w = torch.broadcast_to(w, lead + w.shape[-2:])
    s0b = torch.broadcast_to(s0, lead + (2,))
    if n == 0:
        return w.clone(), s0b.clone()
    # fold the initial state into the first step's offset
    w = torch.cat([(_vec2(A[..., 0, :], s0b) + w[..., 0, :])[..., None, :],
                   w[..., 1:, :]], dim=-2)
    a, b = A, w
    d = 1
    with full_float32():
        while d < n:
            a_r, b_r = a[..., d:, :], b[..., d:, :]
            a = torch.cat([a[..., :d, :], _mat2(a_r, a[..., :-d, :])], dim=-2)
            b = torch.cat([b[..., :d, :], _vec2(a_r, b[..., :-d, :]) + b_r],
                          dim=-2)
            d *= 2
    entry = torch.cat([s0b[..., None, :], b[..., :-1, :]], dim=-2)
    return entry, b[..., -1, :]


def affine_scan_nd_plain(A, w, s0):
    """Plain PyTorch version of M2: the reference's log-depth composition
    (`linrec.py:469-506`) as Hillis-Steele doubling, its d x d products
    under `full_float32()`. Returns (after, final)."""
    n, d = A.shape[0], A.shape[-1]
    lead = torch.broadcast_shapes(w.shape[:-2], s0.shape[:-1])
    w = torch.broadcast_to(w, lead + w.shape[-2:])
    if n == 0:
        return w.clone(), torch.broadcast_to(s0, lead + (d,)).clone()
    with full_float32():
        w0 = torch.einsum("ij,...j->...i", A[0], torch.broadcast_to(s0, lead + (d,)))
        b = torch.cat([(w[..., 0, :] + w0)[..., None, :], w[..., 1:, :]], dim=-2)
        a = A
        shift = 1
        while shift < n:
            a_r = a[shift:]
            b = torch.cat([b[..., :shift, :],
                           torch.einsum("nij,...nj->...ni", a_r, b[..., :-shift, :])
                           + b[..., shift:, :]], dim=-2)
            a = torch.cat([a[:shift], a_r @ a[:-shift]], dim=0)
            shift *= 2
    return b, b[..., -1, :]


def _card_scan(what: str, *tensors):
    x = tensors[0]
    if x.dtype not in _SUFFIX:
        raise ValueError(f"{what}: takes float32 or float64, got {x.dtype}")
    for t in tensors:
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{what}: every tensor must be {x.dtype} on "
                             f"{x.device}")
    _build.refuse_grad(what, "its adjoint is not ported", *tensors)


def affine2_scan(A, w, s0):
    """Time-varying 2-state affine recurrence s_n = A_n s_{n-1} + w_n
    along axis -2 (`algodsp_tpu/ops/linrec.py::affine2_scan`).

    A: (..., N, 4) per-step 2 x 2 matrices packed [m00, m01, m10, m11];
    w: (..., N, 2); s0: (..., 2), the leading dims broadcasting. Returns
    (entry, final): entry[..., n, :] is the state BEFORE step n
    (entry[..., 0, :] == s0), final the state after step N-1.

    The kernel M3 for CUDA tensors (a chunked scan over time, scheduled
    by `m3_plan`; a gradient wanted there raises), the plain version for
    CPU tensors. `launches` counts the kernel's launches; N = 0 launches
    nothing."""
    if A.device.type == "cpu":
        return affine2_scan_plain(A, w, s0)
    if A.device.type != "cuda":
        raise ValueError(f"affine2_scan: unsupported device {A.device}")
    _card_scan("affine2_scan", A, w, s0)
    lead = torch.broadcast_shapes(A.shape[:-2], w.shape[:-2], s0.shape[:-1])
    n = A.shape[-2]
    if A.shape[-1] != 4 or w.shape[-1] != 2 or w.shape[-2] != n:
        raise ValueError("affine2_scan: A must be (..., N, 4) and w (..., N, 2)")
    if n == 0 or lead.numel() == 0:      # nothing to walk
        return (torch.broadcast_to(w, lead + (n, 2)).clone(),
                torch.broadcast_to(s0, lead + (2,)).clone())
    fn = _build.entry("affine", f"affine2_scan_{_SUFFIX[A.dtype]}", _TWO_ARGS)
    flat = lambda t, tail: torch.broadcast_to(t, lead + tail).reshape(
        (-1,) + tail).contiguous()
    A2, w2, s2 = flat(A, (n, 4)), flat(w, (n, 2)), flat(s0, (2,))
    A2, w2 = _aligned(A2), _aligned(w2)
    entry = torch.empty_like(w2)
    fin = torch.empty_like(s2)
    C = A2.shape[0]
    L, threads, B, _ = m3_plan(n, C, A.element_size(),
                               _sm_count(A.device.index or 0))
    with torch.cuda.device(A.device):
        code = fn(*(_build.ptr(t) for t in (A2, w2, s2, entry, fin)),
                  C, n, L, threads, B, _build.stream_of(A))
        affine2_scan.launches += 1
    _build.check("affine", code, "affine2_scan")
    return entry.reshape(lead + (n, 2)), fin.reshape(lead + (2,))


affine2_scan.launches = 0


def affine_scan_nd(A, w, s0):
    """d-dimensional time-varying affine recurrence s_n = A_n s_{n-1} + w_n
    (`algodsp_tpu/ops/linrec.py::affine_scan_nd`).

    A: (N, d, d) per-step matrices shared by the batch (LFO-driven
    coefficients); w: (..., N, d) per-step offsets; s0: (..., d). Returns
    (after, final): after[..., n, :] is the state AFTER step n.

    The kernel M2 for CUDA tensors (d <= 32; a chunked scan over time,
    scheduled by `m2_plan`; a gradient wanted there raises), the plain
    version for CPU tensors. `launches` counts the
    kernel's launches; N = 0 launches nothing."""
    if A.device.type == "cpu":
        return affine_scan_nd_plain(A, w, s0)
    if A.device.type != "cuda":
        raise ValueError(f"affine_scan_nd: unsupported device {A.device}")
    _card_scan("affine_scan_nd", A, w, s0)
    n, d = A.shape[0], A.shape[-1]
    if (A.ndim != 3 or A.shape[1] != d or w.shape[-2:] != (n, d)
            or not 1 <= d <= MAX_ND):
        raise ValueError(f"affine_scan_nd: A must be (N, d, d) with d <= "
                         f"{MAX_ND} and w (..., N, d)")
    lead = torch.broadcast_shapes(w.shape[:-2], s0.shape[:-1])
    if n == 0 or lead.numel() == 0:      # nothing to walk
        return (torch.broadcast_to(w, lead + (n, d)).clone(),
                torch.broadcast_to(s0, lead + (d,)).clone())
    fn = _build.entry("affine", f"affine_scan_nd_{_SUFFIX[A.dtype]}", _ND_ARGS)
    w2 = torch.broadcast_to(w, lead + (n, d)).reshape(-1, n, d).contiguous()
    s2 = torch.broadcast_to(s0, lead + (d,)).reshape(-1, d).contiguous()
    A2 = A.contiguous()
    after = torch.empty_like(w2)
    fin = torch.empty_like(s2)
    C = w2.shape[0]
    G, K, L, threads, B = m2_plan(n, C, d, A.element_size(),
                                  _sm_count(A.device.index or 0))
    with torch.cuda.device(A.device):
        code = fn(*(_build.ptr(t) for t in (A2, w2, s2, after, fin)),
                  C, n, d, G, K, L, threads, B, _build.stream_of(A))
        affine_scan_nd.launches += 1
    _build.check("affine", code, "affine_scan_nd")
    return after.reshape(lead + (n, d)), fin.reshape(lead + (d,))


affine_scan_nd.launches = 0


# affine_latency_f{32,64}(kind, n, d, cycles, sink, stream)
_LAT_ARGS = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p]


# the latency probes' kinds (csrc/affine.cu::latency)
STEP_WALK_ND = 2     # a walk in order's step of M2: one warp, d shuffles
STEP_WALK_2 = 3      # M3's walk step: one thread, 2 x 2 in registers
STEP_LOCAL_2 = 4     # M3's local step: the chunk map composed with a step
SCAN_LEVEL_2 = 5     # a level of M3's shuffle scan
STEP_ND = 6          # M2's chunked step: a thread's d-vector, A in shared memory


def scan_step_cycles(d: int, dtype=torch.float32, n: int = 1 << 16,
                     device="cuda", kind: int | None = None) -> float:
    """SM cycles of one dependent step, clock64 stamps around n steps.
    By default the walk in order's step (M2's for d > 2, one warp with the
    matrix row in registers; M3's for d = 2, one thread): with the SM
    clock, the chain bound of an N-step walk is N times this. `kind`
    picks another probe (`STEP_LOCAL_2`, `SCAN_LEVEL_2`, `STEP_ND`), the
    pieces of the chunked scans' critical paths."""
    if kind is None:
        kind = STEP_WALK_2 if d == 2 else STEP_WALK_ND
    fn = _build.entry("affine", f"affine_latency_{_SUFFIX[dtype]}", _LAT_ARGS)
    cycles = torch.zeros(1, dtype=torch.int64, device=device)
    sink = torch.full((32,), 0.25, dtype=dtype, device=device)
    for _ in range(2):      # the first run warms the instruction cache
        code = fn(kind, n, d, _build.ptr(cycles), _build.ptr(sink),
                  _build.stream_of(cycles))
        _build.check("affine", code, "affine_latency")
        torch.cuda.synchronize(cycles.device)
    return int(cycles.item()) / n
