"""The port's gradients against `jax.grad` of the JAX package on the CPU.

The three autograd Functions of the port (`BiquadCascadeFn`,
`EnvelopeFn`, `FDLConvFn`) run their plain forwards and plain adjoints
on CPU tensors: the same backward formulas that launch the kernels on
the card. The references are `jax.grad` of the JAX package's XLA paths
(jitted, never interpreted Pallas): the blocked biquad engine, the
envelope scan with its own custom VJP, the FFT branch of
`conv.fftconvolve`, and the flagship pipeline's classes.

Tolerances: float64 against float64, the envelope at rtol and atol
1e-10, the cascade, the FDL and the flagship at >= 200 dB; float32
against the float64 reference, >= 100 dB for signal gradients and
>= 80 dB for an IR's (tests/test_diff.py's bar). Slow-pole chains (the
A-weighting, so the flagship) are held in float64 only.
"""

import tests.torch_port_setup  # noqa: F401  (first: one PyTorch thread)

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from algodsp_tpu.conv import PartitionedConvolver as JConv
from algodsp_tpu.conv.conv import fftconvolve as j_fftconvolve
from algodsp_tpu.effects.dynamics import Compressor as JCompressor
from algodsp_tpu.filters import BiquadChain as JChain, design as jd
from algodsp_tpu.filters.weighting import WeightingType as JW, weighting_chain as jwc
from algodsp_tpu.ops.envscan import envelope_scan as j_envelope
from algodsp_tpu_torch import convert
from algodsp_tpu_torch.conv import fftconvolve
from algodsp_tpu_torch.effects.dynamics import Compressor
from algodsp_tpu_torch.effects.dynamics import core as dyn_core
from algodsp_tpu_torch.filters import BiquadChain
from algodsp_tpu_torch.ops import biquad_cascade as bq, envscan, fdlconv
from tests.conftest import snr_db
from tests.torch_port_setup import ref_jit

SR = 48000.0
DT = {"float32": torch.float32, "float64": torch.float64}


def _t(a, dtype=torch.float64, grad=False):
    return torch.tensor(np.asarray(a), dtype=dtype, requires_grad=grad)


def _np(t):
    return t.detach().numpy().astype(np.float64)


# -- A2: the cascade ---------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_cascade_grad_matches_jax_blocked(dtype, rng):
    """dx through BiquadCascadeFn (mode "kernel": the Function; on the CPU
    its plain forward and flip-cascade-flip backward) against jax.grad of
    the JAX chain's blocked engine in float64."""
    sos = jd.butterworth_lp(2000.0, 4, SR)
    x = rng.standard_normal((3, 700))
    w = rng.standard_normal((3, 700))
    j_chain = JChain(sos, gain=0.7)
    g_ref = ref_jit(jax.grad(lambda v: jnp.sum(
        j_chain.process(v, mode="blocked") * w)))(jnp.asarray(x))
    chain = convert.biquad_chain_from_numpy(sos, 0.7)
    xt = _t(x, DT[dtype], grad=True)
    y = chain.process(xt, mode="kernel")
    assert "BiquadCascadeFn" in type(y.grad_fn.next_functions[0][0]).__name__
    (y * _t(w, DT[dtype])).sum().backward()
    assert snr_db(np.asarray(g_ref), _np(xt.grad)) >= (
        200 if dtype == "float64" else 100)


@pytest.mark.parametrize("op", ["cascade", "fdl"])
def test_adjoint_identity(op, rng):
    """<f(x), g> = <x, vjp(g)> for K3's and K1's Functions (float64)."""
    x = _t(rng.standard_normal((2, 1024)), grad=True)
    g = _t(rng.standard_normal((2, 1024)))
    if op == "cascade":
        y, _ = bq.biquad_cascade(x, jd.butterworth_lp(3000.0, 6, SR), 1.3)
    else:
        h = rng.standard_normal(600) * np.exp(-np.arange(600) / 150.0)
        hspec = torch.as_tensor(fdlconv.kernel_spectra(h, 256))
        y = fdlconv.fdl_conv(x, hspec, 256)
    (dx,) = torch.autograd.grad(y, x, g)
    lhs, rhs = float(torch.sum(y.detach() * g)), float(torch.sum(x.detach() * dx))
    assert abs(lhs - rhs) <= 1e-10 * abs(lhs)


# -- A3: the envelope --------------------------------------------------------

@pytest.mark.parametrize("case", ["scalar", "per_channel_broadcast_env0"])
def test_envelope_grad_matches_jax(case, rng):
    """All four gradients through EnvelopeFn against jax.grad of the JAX
    envelope_scan (lax.scan with the reference's own _envelope_bwd), in
    float64; per-channel ballistics with a broadcast env0 unbroadcast
    to their shapes."""
    t = np.abs(rng.standard_normal((2, 3, 80)))
    if case == "scalar":
        e0, att, rel = rng.random((2, 3)) * 0.1, np.float64(0.31), np.float64(0.045)
    else:
        e0 = np.float64(0.05)
        att = rng.uniform(0.05, 0.6, (2, 3))
        rel = rng.uniform(0.001, 0.1, (1, 3))
    w = rng.standard_normal(t.shape)
    v = rng.standard_normal(t.shape[:-1])

    def j_loss(t, e0, a, r):
        ef, tr = j_envelope(t, e0, a, r)
        return jnp.sum(tr * w) + jnp.sum(ef * v)

    g_ref = ref_jit(jax.grad(j_loss, argnums=(0, 1, 2, 3)))(
        *(jnp.asarray(a) for a in (t, e0, att, rel)))
    args = [_t(a, grad=True) for a in (t, e0, att, rel)]
    ef, tr = envscan.envelope_scan(*args)
    assert "EnvelopeFn" in type(tr.grad_fn.next_functions[0][0]).__name__
    (torch.sum(tr * _t(w)) + torch.sum(ef * _t(v))).backward()
    for gr, a in zip(g_ref, args):
        assert a.grad.shape == a.shape
        np.testing.assert_allclose(_np(a.grad), np.asarray(gr), rtol=1e-10,
                                   atol=1e-10)


def test_envelope_adjoint_plain_and_the_kernel_plan(rng):
    """The plain adjoint in float32 against the float64 one on the same
    trajectory (>= 100 dB on dtargets; the sums to float32 roundoff),
    and the adjoint kernel's split of a channel: one chunk a thread, at
    most 1024 threads in whole warps, covering every segment; segments
    that fit shared memory and tile each block's part; a cluster of at
    most 8 blocks only where 2 C <= SMs."""
    c, t = 4, 300
    targets = np.abs(rng.standard_normal((c, t)))
    e0, att, rel = rng.random(c) * 0.1, np.full(c, 0.2), rng.uniform(0.01, 0.1, c)
    _, traj = envscan.envelope_scan_plain(*(_t(a) for a in (targets, e0, att, rel)))
    g, gf = rng.standard_normal((c, t)), rng.standard_normal(c)
    ref = envscan.envelope_adjoint_plain(
        _t(targets), traj, *(_t(a) for a in (e0, att, rel, g, gf)))
    f32 = envscan.envelope_adjoint(
        *(_t(a, torch.float32) for a in (targets, traj.numpy(), e0, att, rel,
                                         g, gf)))
    assert snr_db(_np(ref[0]), _np(f32[0])) >= 100
    for r, f in zip(ref[1:], f32[1:]):
        np.testing.assert_allclose(_np(f), _np(r), rtol=1e-5, atol=1e-5)
    for n in (1, 14, 15, 16, 47, 1000, 15360, 15361, 48128, 1 << 20):
        for channels, itemsize in ((8, 4), (67, 4), (2, 8)):
            seg, length, threads, blocks = envscan.adjoint_plan(
                n, channels, 132, itemsize)
            assert threads % 32 == 0 and 32 <= threads <= envscan.ENV_MAX_THREADS
            assert threads * length >= seg and length >= envscan.ENV_MIN_CHUNK
            assert (threads - 32) * length < seg or threads == 32
            part = -(-n // blocks)
            vec = 16 // itemsize
            assert 3 * (-(-seg // vec) + 1) * vec * itemsize <= (
                envscan.ENV_SMEM_BYTES)
            assert seg <= part and (blocks - 1) * part < n
            assert -(-part // seg) * seg - part < -(-part // seg)
            assert blocks == 1 or 2 * channels <= 132


def test_envelope_adjoint_float32_at_compressor_ballistics(rng):
    """At the default Compressor's ballistics (release' = 1 - release
    ~ 1.44e-4, so an s sums ~7000 samples) the plain float32 adjoint
    stays >= 100 dB against float64 on the same inputs: its carry is
    s - a s, not (1 - a) s, whose 1 - a keeps only ~11 bits of a in
    float32 (that form falls below the bar here)."""
    c, t = 2, 20000
    core = Compressor(SR).core
    att, rel = core.attack_coeff, 1.0 - core.release_coeff
    targets = np.abs(rng.standard_normal((c, t))).astype(np.float32)
    args = [torch.as_tensor(targets), torch.zeros(c), torch.full((c,), att),
            torch.full((c,), rel)]
    _, traj = envscan.envelope_scan_plain(*args)
    g = torch.as_tensor(rng.standard_normal((c, t)).astype(np.float32))
    adj = (args[0], traj, *args[1:], g, torch.zeros(c))
    f32 = envscan.envelope_adjoint_plain(*adj)
    f64 = envscan.envelope_adjoint_plain(*(v.double() for v in adj))
    for r, f in zip(f64, f32):
        assert snr_db(_np(r), _np(f)) >= 100


def test_envelope_t0_keeps_env0_differentiable():
    """T = 0 returns env0 and an empty trajectory without the Function;
    the gradient reaches env0 and the empty targets."""
    targets = torch.zeros(2, 0, dtype=torch.float64, requires_grad=True)
    env0 = torch.tensor([0.3, 0.5], dtype=torch.float64, requires_grad=True)
    ef, tr = envscan.envelope_scan(targets, env0, 0.1, 0.01)
    assert tr.shape == (2, 0) and torch.equal(ef, env0)
    (ef.sum() * 2.0 + tr.sum()).backward()
    assert torch.equal(env0.grad, torch.full((2,), 2.0, dtype=torch.float64))
    assert targets.grad.shape == (2, 0)


# -- A1: the FDL -------------------------------------------------------------

def _fdl_fftconvolve(a, b, B):
    """The port's fftconvolve FDL branch: a padded to whole blocks, b's
    spectra from kernel_spectra_torch, fdl_conv, the full length kept."""
    n, m = a.shape[-1], b.shape[-1]
    total = n + m - 1
    padded = -(-total // B) * B
    flat = torch.nn.functional.pad(a, (0, padded - n))
    hspec = fdlconv.kernel_spectra_torch(b, B, -(-m // B))
    return fdlconv.fdl_conv(flat, hspec, B)[:, :total]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fdl_grad_matches_jax_fftconvolve(dtype, rng):
    """d/da and d/db of the FDL branch (FDLConvFn + kernel_spectra_torch)
    against jax.grad of the JAX conv.fftconvolve's FFT branch in float64;
    the port's own fftconvolve (its torch.fft branch on the CPU) agrees
    with it too."""
    n, m, B = 3000, 1500, 512
    a = rng.standard_normal((2, n))
    b = rng.standard_normal(m) * np.exp(-np.arange(m) / 400.0)
    w = rng.standard_normal((2, n + m - 1))
    ga, gb = ref_jit(jax.grad(lambda a, b: jnp.sum(j_fftconvolve(a, b) * w),
                              argnums=(0, 1)))(jnp.asarray(a), jnp.asarray(b))
    at, bt = _t(a, DT[dtype], grad=True), _t(b, DT[dtype], grad=True)
    y = _fdl_fftconvolve(at, bt, B)
    assert "FDLConvFn" in type(y.grad_fn.next_functions[0][0]).__name__
    (y * _t(w, DT[dtype])).sum().backward()
    bars = (200, 200) if dtype == "float64" else (100, 80)
    assert snr_db(np.asarray(ga), _np(at.grad)) >= bars[0]
    assert snr_db(np.asarray(gb), _np(bt.grad)) >= bars[1]
    a64, b64 = _t(a, grad=True), _t(b, grad=True)
    (fftconvolve(a64, b64) * _t(w)).sum().backward()
    assert snr_db(np.asarray(ga), _np(a64.grad)) >= 200
    assert snr_db(np.asarray(gb), _np(b64.grad)) >= 200


def test_fdl_spectra_adjoint_matches_autograd_and_zeroes_unseen_partitions(rng):
    """P > F: dhspec from FDLConvFn's spectra adjoint against torch
    autograd through fdl_conv_plain in float64 (the half-spectrum weight
    c_k / 2B and the DC and Nyquist imaginary parts included), the rows
    of partitions p >= F exactly zero, and the IR gradient past the
    signal exactly zero."""
    B, F, P = 64, 3, 5
    x = _t(rng.standard_normal((3, F * B)))
    g = _t(rng.standard_normal((3, F * B)))
    hspec = _t(rng.standard_normal((P, B + 1, 2)), grad=True)
    (d_fn,) = torch.autograd.grad(fdlconv.fdl_conv(x, hspec, B), hspec, g)
    (d_ad,) = torch.autograd.grad(fdlconv.fdl_conv_plain(x, hspec, B), hspec, g)
    assert snr_db(_np(d_ad), _np(d_fn)) >= 200
    assert torch.all(d_fn[F:] == 0) and torch.all(d_fn[:, [0, B], 1] == 0)
    h = _t(rng.standard_normal(P * B), grad=True)
    y = fdlconv.fdl_conv(x, fdlconv.kernel_spectra_torch(h, B, P), B)
    (dh,) = torch.autograd.grad(y, h, g)
    assert torch.all(dh[F * B:] == 0) and bool(torch.any(dh[:F * B] != 0))
    np.testing.assert_allclose(
        _np(fdlconv.kernel_spectra_torch(h, B, P)),
        fdlconv.kernel_spectra(_np(h), B), rtol=0, atol=1e-5)


def test_fdl_needs_only_the_adjoint_it_is_asked_for(monkeypatch, rng):
    """IR learning asks for no dx: the backward skips the signal adjoint
    (and keeps no frame spectra when hspec needs no gradient)."""
    B = 128
    x = _t(rng.standard_normal((2, 4 * B)))
    hspec = _t(rng.standard_normal((3, B + 1, 2)), grad=True)
    calls = []
    plain = fdlconv.fdl_conv_plain
    monkeypatch.setattr(fdlconv, "fdl_conv_plain",
                        lambda *a: calls.append("dx") or plain(*a))
    fdlconv.fdl_conv(x, hspec, B).sum().backward()
    assert calls == [] and hspec.grad is not None
    xg = x.clone().requires_grad_()
    y = fdlconv.fdl_conv(xg, hspec.detach(), B)
    assert y.grad_fn.saved_tensors[1] is None
    y.sum().backward()
    assert calls == ["dx"]


# -- the flagship and the compressor ------------------------------------------

def test_flagship_grad_matches_jax(rng):
    """d mean(y^2) / dx and / d(input gain) through the flagship forward
    (cascade -> A-weighting -> compressor -> reverb, 2 ch x 4096, a
    4096-tap IR, reverb block 2^8) against jax.grad of the JAX package's
    classes, float64. The JAX chains run their scan mode, the exact
    recurrence: jax.grad of their blocked engine takes seconds to
    compile."""
    c, n, taps = 2, 4096, 4096
    ir = rng.standard_normal(taps) * np.exp(-np.arange(taps) / 800.0)
    cascade = JChain(jd.butterworth_lp(2000.0, 10, SR))
    weighting = jwc(JW.A, SR)
    comp = JCompressor(SR)
    reverb = JConv(ir, min_block_order=8)
    x = rng.standard_normal((c, n))

    def j_loss(x, gain):
        y = weighting.process(cascade.process(gain * x, mode="scan"),
                              mode="scan")
        _, y = comp.process(comp.init_state((c,), jnp.float64), y)
        y = reverb.process(y)
        return jnp.mean(y * y)

    gx_ref, gg_ref = ref_jit(jax.grad(j_loss, argnums=(0, 1)))(
        jnp.asarray(x), jnp.float64(0.8))
    pipe = convert.flagship_from_numpy({
        "cascade": {"sos": cascade.sos, "gain": cascade.gain},
        "weighting": {"sos": weighting.sos, "gain": weighting.gain},
        "compressor": dataclasses.asdict(comp.core.cfg),
        "reverb": {"kernel": reverb.kernel, "min_block_order": 8},
    }, device="cpu")
    xt, gain = _t(x, grad=True), _t(0.8, grad=True)
    y, _ = pipe.forward(gain * xt, pipe.init_state(c, torch.float64, "cpu"))
    torch.mean(y * y).backward()
    assert snr_db(np.asarray(gx_ref), _np(xt.grad)) >= 200
    assert snr_db(np.asarray(gg_ref), _np(gain.grad)) >= 200


def test_prefilter_takes_the_blocked_engine_when_a_gradient_is_wanted(monkeypatch):
    """float32 on the card: the sidechain prefilter runs the cascade
    kernel (explicit state) unless grad mode is on and x requires grad,
    where it takes the blocked engine, which autograd differentiates."""
    class FakeCuda:
        def __init__(self, requires_grad):
            self.shape = torch.Size((2, 64))
            self.dtype = torch.float32
            self.device = torch.device("cuda", 0)
            self.requires_grad = requires_grad

        def new_zeros(self, shape):
            return torch.zeros(shape)

        def reshape(self, *shape):
            return self

        contiguous = reshape

    taken = []
    monkeypatch.setattr(dyn_core, "biquad_cascade", lambda x, sos, gain, st: (
        taken.append("kernel") or (torch.zeros(2, 64), None)))
    monkeypatch.setattr(dyn_core.linrec, "run_sections", lambda x, sos, st, mode: (
        taken.append(mode) or (None, torch.zeros(2, 64))))
    state = torch.zeros(2)
    lp = dyn_core.DynamicsCore._one_pole_lp
    lp(state, FakeCuda(False), 0.1)
    lp(state, FakeCuda(True), 0.1)
    with torch.no_grad():
        lp(state, FakeCuda(True), 0.1)
    lp(state.clone().requires_grad_(), FakeCuda(False), 0.1)
    lp(state, torch.zeros(2, 64), 0.1)
    assert taken == ["kernel", "blocked", "kernel", "blocked", "blocked"]


def test_prefiltered_compressor_grad_matches_jax(rng):
    """The float32 Compressor with 80 Hz / 6 kHz sidechain prefilters is
    differentiable in x (through the blocked prefilter and EnvelopeFn),
    against jax.grad of the JAX Compressor in float64 (>= 100 dB)."""
    cfg = {"sidechain_low_cut_hz": 80.0, "sidechain_high_cut_hz": 6000.0}
    j_comp = JCompressor(SR, **cfg)
    x = 0.5 * rng.standard_normal((2, 1024))

    def j_loss(x):
        _, y = j_comp.process(j_comp.init_state((2,), jnp.float64), x)
        return jnp.mean(y * y)

    g_ref = ref_jit(jax.grad(j_loss))(jnp.asarray(x))
    comp = Compressor(SR, **cfg)
    xt = _t(x, torch.float32, grad=True)
    _, y = comp.process(comp.init_state((2,), torch.float32, "cpu"), xt)
    torch.mean(y * y).backward()
    assert snr_db(np.asarray(g_ref), _np(xt.grad)) >= 100
