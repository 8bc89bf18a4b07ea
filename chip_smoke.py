#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`algodsp_tpu_torch`) on one card.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. build   — compile every kernel of csrc/ with nvcc (all at once);
  2. kernels — hold each CUDA kernel against its plain PyTorch version on
               the card, at the main path's shapes and at edge shapes
               (the cascade at N = 1 and 2, a one-sample last chunk,
               segments in order and in a cluster, first-order sections,
               S = 64, 512 x 2^16, and streamed in ragged blocks; the
               envelope on inputs that stress its selection fixpoint,
               printing its sweep counters, and in float64; the FDL at
               every B from 2 to 8192; the Moog ladders in every variant
               at the chain's shape with fused oversampling, at C = 65,
               T = 1 and T = 333, from a Huovilainen state whose tanh
               rows are not tanh(ds s), with NaN and +-inf in x, fused
               oversampling against the zero-stuffed input bit for bit,
               and in float64), the two adjoint kernels (the envelope's
               in float32 and float64 with scalar and per-channel
               ballistics, a broadcast env0, T = 1, a T that is no chunk
               multiple and C = 65; the FDL spectra adjoint with C = 1,
               an odd C and P > F; the Moog adjoints (A4) at the chain
               block, the direct ZDF block, C = 65, T = 1, T = 333, os 1,
               2, 4 and 8, newton 1-8, float64, the clip case, a
               Huovilainen state whose tanh rows are not tanh(ds s) and
               NaN in x, each with its recomputed final state against
               the forward's bit for bit) and each autograd Function's
               gradients on the card against the CPU path's, then one
               check per fault of the port (ROADMAP.md section 3): the
               explicit-state cascade and the raw envelope kernel refuse
               a CUDA tensor that requires grad while the cascade,
               envelope, FDL, fftconvolve and Moog calls carry a grad_fn, a
               float64 Compressor with sidechain prefilters (and the
               gradient of a float32 one), a 70-section float32 chain in
               auto mode, and envelope_scan with T = 0;
  3. flagship — drive the flagship forward (8 ch x 48128 samples,
               Butterworth -> A-weighting -> compressor -> 2^15-tap
               reverb) through the port's entry points, check that it
               went through every kernel, and hold it against the port's
               plain path on the CPU;
  4. chain   — load the effect-chain graph CHAIN_GRAPH (Butterworth
               low-pass -> Moog ladder -> compressor -> peak EQ + reverb
               fused into one FIR), stream 64 ch x 94 blocks of 512
               through `Chain.process_blocks`, check each block went
               through the cascade, Moog, envelope and FDL kernels once,
               and hold 8 blocks against the port's plain CPU path;
  5. moog    — stream a ZDF `MoogFilter` directly (64 ch x 94 blocks;
               no chain node builds one) through the ZDF kernel, held
               against the plain CPU path;
  6. timing  — CUDA-event means of the flagship forward, the folded
               pipeline at 8 ch x 2^24, the cascade kernel alone at
               512 ch x 2^16 x 15 sections, each kernel (device time
               from CUDA-graph replay, and time as back-to-back calls)
               beside its bound, its plain version and a library call
               where one exists (the FDL's also at the chain's and the
               folded shape) and device time per launch (profiler) of
               K1, K3 and K4, the reverb's two streaming paths, the
               chain's time per block and real-time factor, the two
               Moog kernels at 128 ch x 2^16, the two adjoint kernels at
               the training shapes, and the two Moog adjoints at the
               chain block, the ZDF block and 128 ch x 2^16.
  7. train   — the trainer of examples/gradient_eq_fit.py at the
               flagship's width with torch.optim.Adam: IR learning of
               the flagship's 2^15-tap IR through kernel_spectra_torch
               and the FDL (8 ch x 48128, B = 1024, P = 32, 300 steps),
               the gradient of the flagship forward in x and in an input
               gain, and the 3-band EQ fit through diff.py (800 steps);
               each held against the CPU path in float64 or the
               example's own bar, with the launches of the backward;
  8. moog grad — the Moog gradient path: the chain's filter-moog node
               (Huovilainen, os 4) and the direct ZDF ladder streamed
               over 64 ch x 94 blocks of 512 under autograd with the
               state carried, differentiated in x and the initial state
               (one adjoint launch a block, no plain version), held
               against the card's float64 run and, for 2 blocks, the CPU
               plain path in float64; and a fit of an input gain in front
               of the chain's node over 8 streamed blocks (Adam);
  9. kernels — the line of every kernel with its launches by path.
The line before the last is the card's name and power limit; the last is
{"ok": true, "device": {...}}. Any failed check exits non-zero. There is
no CPU fallback: without CUDA, or without the package beside this file,
the script fails.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

SR = 48000.0
CHANNELS, N_FLAGSHIP = 8, 48128
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
CHAIN_CH, CHAIN_BLOCK, CHAIN_BLOCKS = 64, 512, 94
IR_BLOCK, IR_PARTS = 1024, 32   # IR learning: the flagship's 2^15-tap IR

# The effect chain at full width: 64 ch at 48 kHz in the chain's default
# 512-sample blocks. The peak EQ is an RBJ one: the elliptic family reads
# `q` as a bandwidth in Hz (at most 8 after the registry's clamp), whose
# poles sit so close to the unit circle that the EQ + reverb run would
# pass the fusion pass's kernel-length limit and stay unfused.
CHAIN_GRAPH = {
    "nodes": [
        {"id": "lp", "type": "filter-lowpass",
         "params": {"family": "butterworth", "freq": 12000, "order": 4}},
        {"id": "moog", "type": "filter-moog",
         "params": {"freq": 1200, "q": 2.0, "gain": 6, "order": 8}},
        {"id": "comp", "type": "dyn-compressor",
         "params": {"thresholdDB": -18, "ratio": 4}},
        {"id": "eq", "type": "filter-peak",
         "params": {"family": "rbj", "freq": 3000, "gain": -4, "q": 1.0}},
        {"id": "verb", "type": "reverb-conv",
         "params": {"irSeconds": 0.5, "seed": 7, "wet": 0.3, "dry": 0.9}}],
    "connections": [{"from": "_input", "to": "lp"}, {"from": "lp", "to": "moog"},
                    {"from": "moog", "to": "comp"}, {"from": "comp", "to": "eq"},
                    {"from": "eq", "to": "verb"},
                    {"from": "verb", "to": "_output"}]}

# Operations per ladder step, counting each tanh as one operation (so the
# operation bound is a floor): the classic step is the feedback input
# (3), five scaled tanh (10), four stage updates (12) and the output (1);
# Huovilainen adds three tanh with their scaling (6) and the half-sample
# feedback (2). A ZDF step is four scaled tanh of the old stages (8), the
# input (1), newton_iters Newton iterations of one ladder pass (37) and
# its update (5), a last ladder pass (37), four stage updates (8) and the
# output (1).
MOOG_STEP_OPS = {"classic": 26, "huovilainen": 34}


def zdf_step_ops(newton_iters: int) -> int:
    return 8 + 1 + 42 * newton_iters + 37 + 8 + 1


# Operations a reverse step of the A4 adjoints adds to the forward's: a
# ladder step records 4 tanh slopes (3 each), 4 clip masks (2) and its
# two products (4), and sweeps 12 multiplies and FMAs and its 5 state
# updates; a ZDF step reverses each of its newton_iters + 1 passes (23)
# and each Newton update (Jacobian products and slopes, 26), and its
# clips and stage slopes (24).
MOOG_ADJ_REVERSE_OPS = 12 + 8 + 4 + 12 + 5


def zdf_adjoint_reverse_ops(newton_iters: int) -> int:
    return 23 * (newton_iters + 1) + 26 * newton_iters + 24


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def snr_db(ref, test) -> float:
    ref = np.asarray(ref, np.float64)
    err = ref - np.asarray(test, np.float64)
    p_err = float(np.sum(err * err))
    if p_err == 0.0:
        return math.inf
    return 10.0 * math.log10(float(np.sum(ref * ref)) / p_err)


def host(t):
    return t.detach().to("cpu", copy=True).numpy()


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean time of one call as the caller sees it: CUDA events around
    `reps` calls launched back to back. Where the host's work per call
    (argument checks, allocation, launches) is longer than the card's,
    this is the host's time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(torch, fn, reps: int) -> float:
    """Mean device time of one call: `reps` calls captured into one CUDA
    graph, replayed between two CUDA events, so that no host work is in
    the time. Warm-up runs on a side stream first, as capture needs."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    del graph
    return a.elapsed_time(b) / reps


def kernel_breakdown(torch, fn, reps: int, prefixes) -> dict:
    """Device time per kernel, mean per call, from torch.profiler over
    `reps` calls of fn: the kernels whose names start with one of
    `prefixes`. Empty where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        name = e.key.split("(")[0].removeprefix("void ")
        t = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
        if t and name.startswith(tuple(prefixes)):
            out[name] = out.get(name, 0.0) + t / 1e3 / reps
    return out


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def biquad_work(c, n, s):
    """Bytes (x in, y out, state in and out) and operations (5 multiplies
    and 4 adds per section per sample, plus the gain)."""
    return 8.0 * c * n + 32.0 * c * s, float(c * n * (9 * s + 1))


def envelope_work(c, t):
    """Bytes (x in, trajectory out) and operations (compare, subtract,
    multiply, add per sample)."""
    return 8.0 * c * t + 16.0 * c, 4.0 * c * t


def fdl_work(c, n, b, p):
    """Bytes (x in, y out, spectra in) and operations of the FDL: per frame
    two real 2B-point FFTs at 2.5 n log2 n each and the complex MAC over
    the taps that frame needs (8 per tap per bin)."""
    nf = n // b
    fft = 2 * 2.5 * (2 * b) * math.log2(2 * b)
    taps = sum(min(p, f + 1) for f in range(nf))
    flops = c * (nf * fft + 8.0 * (b + 1) * taps)
    return 8.0 * c * n + 8.0 * p * (b + 1), flops


def envelope_adjoint_work(c, t):
    """Bytes (targets, trajectory and cotangent in, dtargets out, the
    seven (C,) vectors) and operations (compare, select, 1 - a, add, two
    multiplies, subtract, the carry's multiply and a sum per sample)."""
    return 16.0 * c * t + 28.0 * c, 9.0 * c * t


def spectra_adjoint_work(c, nf, b, p):
    """Bytes (X and dV in, dH out) and operations (8 for a complex
    multiply-add per bin and per (channel, frame, lag) that the data has:
    lags below nf only) of the FDL spectra adjoint."""
    pairs = sum(nf - q for q in range(min(p, nf)))
    return (16.0 * c * nf * (b + 1) + 8.0 * p * (b + 1),
            8.0 * c * (b + 1) * pairs)


def moog_work(c, t, ops_per_step, os=1):
    """Bytes (x in, y out at the base rate, state8 in and out) and
    operations of a Moog ladder over (C, T) float32 at oversampling os."""
    return 8.0 * c * t + 64.0 * c, float(ops_per_step) * c * t * os


def moog_call(moog_ops, mf, x, st8, plain=False, os=None):
    """The K5 or K6 wrapper (or its plain version) for MoogFilter `mf`,
    at its oversampling unless `os` is given."""
    p = mf.kernel_params()
    os = mf.oversampling if os is None else os
    if mf.variant.value == "zdf":
        fn = moog_ops.moog_zdf_plain if plain else moog_ops.moog_zdf
        return fn(x, st8, p, newton_iters=mf.newton_iters, os=os)
    fn = moog_ops.moog_ladder_plain if plain else moog_ops.moog_ladder
    return fn(x, st8, p, fast_tanh="lightweight" in mf.variant.value,
              huovilainen=mf.variant.value == "huovilainen", os=os)


def moog_adjoint_call(moog_ops, mf, x, st8, gy, gst, plain=False,
                      return_state=False):
    """The A4 adjoint wrapper (or its plain reverse sweep) for MoogFilter
    `mf` at its oversampling: (dx, dstate8[, final state8])."""
    p, os = mf.kernel_params(), mf.oversampling
    if mf.variant.value == "zdf":
        fn = (moog_ops.moog_zdf_adjoint_plain if plain
              else moog_ops.moog_zdf_adjoint)
        return fn(x, st8, p, gy, gst, newton_iters=mf.newton_iters, os=os,
                  return_state=return_state)
    fn = (moog_ops.moog_ladder_adjoint_plain if plain
          else moog_ops.moog_ladder_adjoint)
    return fn(x, st8, p, gy, gst, fast_tanh="lightweight" in mf.variant.value,
              huovilainen=mf.variant.value == "huovilainen", os=os,
              return_state=return_state)


def moog_adjoint_work(c, t, ops_per_step, os=1):
    """Bytes (x, gy in, dx out at the base rate; state8, its cotangent in,
    dstate8 out) and operations (the forward step's and the reverse's) of
    a Moog adjoint over (C, T) float32 at oversampling os."""
    return 12.0 * c * t + 96.0 * c, float(ops_per_step) * c * t * os


def chain_moog_node(MoogFilter, MoogVariant):
    """The `filter-moog` node of CHAIN_GRAPH as chain/registry.py builds
    it: Huovilainen, 1200 Hz, q 2, +6 dB drive, order 8 (oversampling 4),
    normalized output."""
    return MoogFilter(SR, variant=MoogVariant.HUOVILAINEN, oversampling=4,
                      cutoff_hz=1200.0, resonance=2.0,
                      drive=10.0 ** (6.0 / 20.0), normalize_output=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "the card", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "algodsp_tpu_torch")):
        print("chip_smoke: the algodsp_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 1
    sys.path.insert(0, root)

    from algodsp_tpu_torch import _build, convert, diff, streaming
    from algodsp_tpu_torch.chain import Chain
    from algodsp_tpu_torch.conv import fftconvolve
    from algodsp_tpu_torch.filters import BiquadChain, design
    from algodsp_tpu_torch.filters.biquad import sos_response
    from algodsp_tpu_torch.filters.design import butterworth_lp
    from algodsp_tpu_torch.filters.fir import FIRFilter
    from algodsp_tpu_torch.filters.moog import MoogFilter, MoogVariant
    from algodsp_tpu_torch.filters.weighting import WeightingType, weighting_chain
    from algodsp_tpu_torch.ops import biquad_cascade as bqmod
    from algodsp_tpu_torch.ops import envscan, fdlconv, linrec
    from algodsp_tpu_torch.ops import moog as moog_ops
    from algodsp_tpu_torch.pipeline import (
        FoldedPipeline, flagship_params, folded_params)

    assert torch.backends.cuda.matmul.allow_tf32 is False, \
        "float32 matmuls must run in full float32"
    dev = torch.device("cuda", 0)
    gpu = card()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {gpu}")
    rng = np.random.default_rng(0)

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.KERNEL_SOURCES:
        _build.load(name)
    print(f"build: {time.perf_counter() - t0:.2f} s for "
          f"{', '.join(_build.KERNEL_SOURCES)} ({gpu})")

    kernels = {
        "biquad_cascade": {"route": "cuda",
                           "source": "algodsp_tpu_torch/csrc/biquad_cascade.cu",
                           "replaces": "algodsp_tpu/ops/pallas_kernels.py:152",
                           "wrapper": bqmod.biquad_cascade, "errs": []},
        "envelope": {"route": "cuda",
                     "source": "algodsp_tpu_torch/csrc/envelope.cu",
                     "replaces": "algodsp_tpu/ops/pallas_kernels.py:30",
                     "wrapper": envscan.envelope_scan_kernel, "errs": []},
        "fdl_conv": {"route": "cuda",
                     "source": "algodsp_tpu_torch/csrc/fdlconv.cu",
                     "replaces": "algodsp_tpu/ops/fdlconv.py:440 (K1) and "
                                 "algodsp_tpu/ops/fdlconv.py:316 (K2)",
                     "wrapper": fdlconv.fdl_conv, "errs": []},
        "moog_ladder": {"route": "cuda",
                        "source": "algodsp_tpu_torch/csrc/moog.cu",
                        "replaces": "algodsp_tpu/ops/pallas_kernels.py:370",
                        "wrapper": moog_ops.moog_ladder, "errs": []},
        "moog_zdf": {"route": "cuda",
                     "source": "algodsp_tpu_torch/csrc/moog.cu",
                     "replaces": "algodsp_tpu/ops/pallas_kernels.py:478",
                     "wrapper": moog_ops.moog_zdf, "errs": []},
        "envelope_adjoint": {"route": "cuda",
                             "source": "algodsp_tpu_torch/csrc/envelope.cu",
                             "replaces": "algodsp_tpu/ops/envscan.py:102 "
                                         "(the custom-VJP backward of K4)",
                             "wrapper": envscan.envelope_adjoint, "errs": []},
        "fdl_spectra_adjoint": {"route": "cuda",
                                "source": "algodsp_tpu_torch/csrc/fdlconv.cu",
                                "replaces": "algodsp_tpu/ops/fdlconv.py:236 "
                                            "(the custom-VJP backward of K1)",
                                "wrapper": fdlconv.fdl_spectra_adjoint,
                                "errs": []},
        "moog_ladder_adjoint": {"route": "cuda",
                                "source": "algodsp_tpu_torch/csrc/moog.cu",
                                "replaces": "algodsp_tpu/filters/moog.py:234 "
                                            "(the custom-VJP backward of K5)",
                                "wrapper": moog_ops.moog_ladder_adjoint,
                                "errs": []},
        "moog_zdf_adjoint": {"route": "cuda",
                             "source": "algodsp_tpu_torch/csrc/moog.cu",
                             "replaces": "algodsp_tpu/filters/moog.py:234 "
                                         "(the custom-VJP backward of K6)",
                             "wrapper": moog_ops.moog_zdf_adjoint,
                             "errs": []},
    }

    def randn(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=dev)

    # -- 2. kernel checks ----------------------------------------------------
    cascade = BiquadChain(butterworth_lp(2000.0, 10, SR))
    weighting = weighting_chain(WeightingType.A, SR)
    # the K3 cases: the main shapes, N = 1 and 2, a last chunk of one
    # sample, one sample past the longest segment (two segments in order
    # where the channels fill the card, a cluster of six blocks where they
    # do not), only first-order sections (as condition_sos leaves the
    # A-weighting's high-pass), S = 64, and the timing shape 512 x 2^16
    # with S = 15
    cascade20 = np.concatenate([cascade.runtime_sos] * 4)
    sos15 = np.concatenate([cascade.runtime_sos, weighting.runtime_sos,
                            butterworth_lp(8000.0, 8, SR)])
    assert sos15.shape[0] == 15 and not BiquadChain(sos15, condition=False).has_slow_poles
    sos64 = np.concatenate([sos15] * 4 + [cascade.runtime_sos[:4]])
    first = weighting.runtime_sos[weighting.runtime_sos[:, 4] == 0.0]
    n_chunk1 = 5006                                   # n % L == 1
    n_seg1 = bqmod.SMEM_BYTES // 8 + 1
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    c_fill = sms // 2 + 1                             # one block a channel
    assert n_chunk1 % bqmod.segment_plan(n_chunk1, 3, sms)[1] == 1
    assert bqmod.segment_plan(n_seg1, c_fill, sms)[3] == 1
    assert bqmod.segment_plan(n_seg1, 3, sms)[3] > 1 and len(first) >= 2
    for label, sos, gain, c, n, with_state in [
            ("cascade main", cascade.runtime_sos, cascade.gain, CHANNELS, N_FLAGSHIP, False),
            ("weighting main", weighting.runtime_sos, weighting.gain, CHANNELS, N_FLAGSHIP, False),
            ("cascade C=1 N=1000 state", cascade.runtime_sos, cascade.gain, 1, 1000, True),
            ("weighting C=3 N=1000 state", weighting.runtime_sos, weighting.gain, 3, 1000, True),
            ("cascade C=5 N=129 state", cascade.runtime_sos, cascade.gain, 5, 129, True),
            ("cascade x4 C=2 N=3000 state", cascade20, 1.0, 2, 3000, True),
            ("cascade N=1 state", cascade.runtime_sos, cascade.gain, 4, 1, True),
            ("weighting N=2 state", weighting.runtime_sos, weighting.gain, 4, 2, True),
            (f"cascade N={n_chunk1} (last chunk 1 sample) state",
             cascade.runtime_sos, cascade.gain, 3, n_chunk1, True),
            (f"weighting C={c_fill} N={n_seg1} (two segments in order) state",
             weighting.runtime_sos, weighting.gain, c_fill, n_seg1, True),
            (f"weighting C=3 N={n_seg1} (cluster) state",
             weighting.runtime_sos, weighting.gain, 3, n_seg1, True),
            ("first-order sections C=4 N=3000 state", first, 1.0, 4, 3000, True),
            ("S=64 C=2 N=20000 state", sos64, 1.0, 2, 20000, True),
            ("S=15 C=512 N=2^16", sos15, 1.0, 512, 1 << 16, False)]:
        x = randn(c, n)
        st = (0.1 * randn(c, sos.shape[0], 4)) if with_state else None
        y, s_out = bqmod.biquad_cascade(x, sos, gain, st)
        y_p, s_p = bqmod.biquad_cascade_plain(x, sos, gain, st)
        y64, s64 = bqmod.biquad_cascade_plain(
            x.double(), sos, gain, None if st is None else st.double())
        torch.cuda.synchronize()
        snr_p, snr_64 = snr_db(host(y_p), host(y)), snr_db(host(y64), host(y))
        snr_st = snr_db(host(s64), host(s_out))
        err = float(torch.max(torch.abs(y - y_p)))
        kernels["biquad_cascade"]["errs"].append(err)
        print(f"check biquad_cascade {label}: S={sos.shape[0]} "
              f"SNR vs plain f32 {snr_p:.1f} dB, vs plain f64 {snr_64:.1f} dB, "
              f"state vs f64 {snr_st:.1f} dB, max|err| {err:.3e}")
        assert snr_p >= 100 and snr_64 >= 120 and snr_st >= 100, label
    # streamed in ragged blocks with the state carried, against one call
    sos = weighting.runtime_sos
    x = randn(CHANNELS, N_FLAGSHIP)
    y_w, _ = bqmod.biquad_cascade(x, sos, weighting.gain)
    st = torch.zeros(CHANNELS, sos.shape[0], 4, device=dev)
    cuts = np.cumsum([0, 1, 2, 5, 511, 3000, n_seg1, 10000, N_FLAGSHIP])
    parts = []
    for a, b in zip(cuts[:-1], np.minimum(cuts[1:], N_FLAGSHIP)):
        y_b, st = bqmod.biquad_cascade(x[:, a:b].contiguous(), sos,
                                       weighting.gain, st)
        parts.append(y_b)
    y_s = torch.cat(parts, dim=1)
    y64, s64 = bqmod.biquad_cascade_plain(x.double(), sos, weighting.gain)
    snr_w, snr_64 = snr_db(host(y_w), host(y_s)), snr_db(host(y64), host(y_s))
    snr_st = snr_db(host(s64), host(st))
    print(f"check biquad_cascade weighting streamed in {len(parts)} ragged "
          f"blocks: SNR vs one call {snr_w:.1f} dB, vs plain f64 "
          f"{snr_64:.1f} dB, state vs f64 {snr_st:.1f} dB")
    assert snr_w >= 100 and snr_64 >= 120 and snr_st >= 100

    comp_core = convert.compressor_from_config({"sample_rate": SR}).core
    a_main = comp_core.attack_coeff
    r_main = 1.0 - comp_core.release_coeff
    k4 = envscan.envelope_scan_kernel
    n = np.arange(N_FLAGSHIP)

    def env_case(c, x, env0, att, rel, dtype=np.float32):
        per_ch = lambda v: torch.as_tensor(
            np.broadcast_to(np.asarray(v, dtype), (c,)).copy(), device=dev)
        return (torch.as_tensor(np.asarray(x, dtype), device=dev),
                per_ch(env0), per_ch(att), per_ch(rel))

    def hold(c, t):
        # |noise| under a falling staircase: every chunk's maximum is
        # below the one before it, so later chunks hold the first peak
        steps = np.repeat(np.linspace(1.0, 0.05, -(-t // 47)), 47)[:t]
        return np.abs(rng.standard_normal((c, t))) * steps

    nan_x = np.abs(rng.standard_normal((2, N_FLAGSHIP)))
    nan_x[0, 30000] = np.nan
    ch64 = 64
    env_cases = [
        ("main", *env_case(CHANNELS, np.abs(rng.standard_normal(
            (CHANNELS, N_FLAGSHIP))), 0.0, a_main, r_main)),
        ("C=1 T=1000", *env_case(1, np.abs(rng.standard_normal((1, 1000))),
                                 0.3, a_main, r_main)),
        ("C=3 T=1000 per-channel", *env_case(
            3, np.abs(rng.standard_normal((3, 1000))), rng.uniform(0, 1, 3),
            rng.uniform(0.01, 0.5, 3), rng.uniform(0.001, 0.05, 3))),
        ("slow release 1e-5 hovering", *env_case(
            CHANNELS, 0.5 + 0.05 * np.sin(2 * np.pi * n / 480.0)
            + 1e-3 * rng.standard_normal((CHANNELS, N_FLAGSHIP)), 0.5, 0.3,
            1e-5)),
        ("peak hold", *env_case(CHANNELS, hold(CHANNELS, N_FLAGSHIP), 0.0,
                                1.0, 0.0)),
        ("all ties", *env_case(CHANNELS, np.full((CHANNELS, N_FLAGSHIP), 0.25),
                               0.25, a_main, r_main)),
        ("40000 silent then noise", *env_case(
            CHANNELS, np.where(n < 40000, 0.0, np.abs(rng.standard_normal(
                (CHANNELS, N_FLAGSHIP)))), 0.0, a_main, r_main)),
        ("NaN at 30000", *env_case(2, nan_x, 0.0, a_main, r_main)),
        ("T=1", *env_case(CHANNELS, np.abs(rng.standard_normal((CHANNELS, 1))),
                          0.2, a_main, r_main)),
        ("T=47", *env_case(CHANNELS, np.abs(rng.standard_normal((CHANNELS, 47))),
                           0.2, a_main, r_main)),
        ("C=1 T=2^20", *env_case(1, np.abs(rng.standard_normal((1, 1 << 20))),
                                 0.0, a_main, r_main)),
        ("C=64 T=4096 per-channel", *env_case(
            ch64, np.abs(rng.standard_normal((ch64, 4096))),
            rng.uniform(0, 1, ch64), rng.uniform(0.01, 0.5, ch64),
            rng.uniform(1e-5, 0.05, ch64))),
        ("float64 main", *env_case(CHANNELS, np.abs(rng.standard_normal(
            (CHANNELS, N_FLAGSHIP))), 0.0, a_main, r_main, np.float64)),
        ("float64 peak hold", *env_case(CHANNELS, hold(CHANNELS, N_FLAGSHIP),
                                        0.0, 1.0, 0.0, np.float64))]
    for label, x, env0, att, rel in env_cases:
        k4.reset_counts()
        ef, tr = k4(x, env0, att, rel)
        counts = k4.counts()
        # the plain version on host copies of the same inputs: one Python
        # step per sample costs ~20 us per tensor op on the card
        ef_p, tr_p = envscan.envelope_scan_plain(x.cpu(), env0.cpu(),
                                                 att.cpu(), rel.cpu())
        tr, ef, tr_p, ef_p = (v.cpu().numpy() for v in (tr, ef, tr_p, ef_p))
        nan_same = bool(np.array_equal(np.isnan(tr), np.isnan(tr_p))
                        and np.array_equal(np.isnan(ef), np.isnan(ef_p)))
        fin, ef_fin = ~np.isnan(tr_p), ~np.isnan(ef_p)
        err = float(np.max(np.abs(tr - tr_p)[fin], initial=0.0))
        ef_err = float(np.max(np.abs(ef - ef_p)[ef_fin], initial=0.0))
        snr = snr_db(tr_p[fin], tr[fin])
        print(f"check envelope {label}: {x.dtype} C={x.shape[0]} "
              f"T={x.shape[1]} SNR vs plain {snr:.1f} dB, max|err| "
              f"{err:.3e}, env_final max|err| {ef_err:.3e}, NaN where plain "
              f"has NaN {nan_same}, sweeps {counts['sweeps']} over "
              f"{counts['solves']} solves (most {counts['max_sweeps']}), "
              f"exact walks {counts['exact_walks']}")
        assert nan_same, label
        if x.dtype == torch.float64:
            scale = float(np.max(np.abs(tr_p[fin]), initial=0.0))
            assert tr.dtype == np.float64 and err <= 1e-12 * scale, label
        else:
            ef_scale = 1.0 + float(np.max(np.abs(ef_p[ef_fin]), initial=0.0))
            assert snr >= 100 and ef_err <= 1e-5 * ef_scale, label
        assert counts["max_sweeps"] <= envscan.ENV_MAX_SWEEPS, label
        if label.startswith("NaN"):
            assert counts["exact_walks"] == 0, label
        kernels["envelope"]["errs"].append(err)
    # float64 through the entry point: a float64 compressor on the card
    comp64 = convert.compressor_from_config({"sample_rate": SR})
    x64 = randn(2, 4096).double()
    _, y64 = comp64.process(comp64.init_state((2,), torch.float64), x64)
    _, y64_p = comp64.process(comp64.init_state((2,), torch.float64, "cpu"),
                              x64.cpu())
    snr64 = snr_db(y64_p.numpy(), host(y64))
    print(f"check float64 Compressor on the card 2x4096: {y64.dtype}, SNR vs "
          f"plain CPU path {snr64:.1f} dB")
    assert y64.dtype == torch.float64 and snr64 >= 200

    flag = flagship_params(seed=0)
    ir = flag["reverb"]["kernel"]
    fdl_cases = [
        ("main", CHANNELS, N_FLAGSHIP, 1024, ir.size, False),
        ("C=1", 1, 8 * 1024, 1024, 3000, False),
        ("C=3 quiet channel", 3, 6 * 1024, 1024, 5000, True),
        ("C=5 P > N/B", 5, 4 * 256, 256, 10 * 256, False),
        ("B=8192 P=3", 2, 4 * 8192, 8192, 20000, False)]
    fdl_cases += [(f"B={b} sweep", 3, 4 * b, b, max(1, 5 * b // 2), False)
                  for b in (1 << e for e in range(1, 14))]
    for label, c, n, b, taps, quiet in fdl_cases:
        h = ir[:taps].astype(np.float64)
        hspec = torch.as_tensor(fdlconv.kernel_spectra(h, b), device=dev)
        x = randn(c, n)
        if quiet:
            x[0] *= 1e-6
        y = fdlconv.fdl_conv(x, hspec, b)
        y_p = fdlconv.fdl_conv_plain(x, hspec, b)
        h64 = torch.as_tensor(h, device=dev)
        size = 1 << (n + taps - 1).bit_length()
        y64 = torch.fft.irfft(torch.fft.rfft(x.double(), size)
                              * torch.fft.rfft(h64, size), size)[..., :n]
        torch.cuda.synchronize()
        y_h, y64_h = host(y), host(y64)
        snr_ch = min(snr_db(y64_h[i], y_h[i]) for i in range(c))
        snr_p = snr_db(host(y_p), y_h)
        err = float(torch.max(torch.abs(y - y_p)))
        kernels["fdl_conv"]["errs"].append(err)
        print(f"check fdl_conv {label}: C={c} N={n} B={b} P={hspec.shape[0]} "
              f"SNR vs plain f32 {snr_p:.1f} dB, worst channel vs f64 "
              f"{snr_ch:.1f} dB, max|err| {err:.3e}")
        assert snr_ch >= 110 and snr_p >= 110, label

    # Moog ladders: every variant against its plain version, at the
    # chain's main shape (64 x 512 at oversampling 4, fused in the kernel:
    # 2048 steps a channel), C = 1 (256 samples at oversampling 4), C = 3
    # with T = 1000 from a nonzero state (for Huovilainen its rows 4-6 are
    # not tanh(ds s), which the kernel must not read), C = 65 (a ragged
    # last warp) at T = 1 and T = 333 (no tile multiple), and the
    # state-clip case of tests/test_pallas.py (DC of 100, Vt = 20). Bars:
    # atol 1e-5 on y and the state (1e-4 in the clip case), the JAX
    # package's bars against its scan, and SNR >= 100 dB. The plain
    # versions run on host copies of the same inputs: one Python step per
    # sample costs ~20 us per tensor op on the card and a few on the host.
    chain_moog = dict(cutoff_hz=2000.0, resonance=2.0, thermal_voltage=0.5,
                      oversampling=4)
    moog_cases = [
        ("main", chain_moog, lambda: 0.3 * randn(CHAIN_CH, CHAIN_BLOCK),
         False, 1e-5),
        ("C=1", chain_moog, lambda: 0.3 * randn(1, CHAIN_BLOCK // 2), False,
         1e-5),
        ("C=3 T=1000 state", dict(cutoff_hz=2000.0, resonance=2.0,
                                  thermal_voltage=0.5),
         lambda: 0.3 * randn(3, 1000), True, 1e-5),
        ("C=65 T=1 state", dict(cutoff_hz=2000.0, resonance=2.0,
                                thermal_voltage=0.5),
         lambda: 0.3 * randn(65, 1), True, 1e-5),
        ("C=65 T=333 state", dict(cutoff_hz=2000.0, resonance=2.0,
                                  thermal_voltage=0.5),
         lambda: 0.3 * randn(65, 333), True, 1e-5),
        ("clip", dict(cutoff_hz=8000.0, resonance=0.5, drive=1.0,
                      thermal_voltage=20.0),
         lambda: 100.0 + randn(2, 1024), False, 1e-4)]
    for variant, iters in [("classic", 4), ("classic_lightweight", 4),
                           ("improved_classic", 4),
                           ("improved_classic_lightweight", 4),
                           ("huovilainen", 4), ("zdf", 1), ("zdf", 4),
                           ("zdf", 8)]:
        name = "moog_zdf" if variant == "zdf" else "moog_ladder"
        for label, kw, make_x, with_state, atol in moog_cases:
            mf = MoogFilter(SR, variant=MoogVariant(variant),
                            newton_iters=iters, **kw)
            xm = make_x()
            st8 = (0.2 * randn(8, xm.shape[0]) if with_state
                   else torch.zeros(8, xm.shape[0], device=dev))
            if variant == "huovilainen" and with_state:
                assert not torch.allclose(st8[4:7], torch.tanh(
                    mf.kernel_params()[1] * st8[:3]))
            s_k, y_k = moog_call(moog_ops, mf, xm, st8)
            s_p, y_p = moog_call(moog_ops, mf, xm.cpu(), st8.cpu(), plain=True)
            y_k, s_k = y_k.cpu(), s_k.cpu()
            err = float(torch.max(torch.abs(y_k - y_p)))
            s_err = float(torch.max(torch.abs(s_k - s_p)))
            snr = snr_db(y_p.numpy(), y_k.numpy())
            kernels[name]["errs"].append(err)
            print(f"check {name} {variant} (newton {iters}) {label}: "
                  f"C={xm.shape[0]} T={xm.shape[1]} os={mf.oversampling} "
                  f"max|err| y {err:.3e} state {s_err:.3e}, SNR vs plain "
                  f"{snr:.1f} dB")
            assert err <= atol and s_err <= atol and snr >= 100, \
                (name, variant, label)
    # NaN and +-inf in x: NaN where the plain version has NaN (a NaN runs
    # on through the channel's state), the rest within the bar
    for variant in ("classic", "huovilainen", "zdf"):
        name = "moog_zdf" if variant == "zdf" else "moog_ladder"
        mf = MoogFilter(SR, variant=MoogVariant(variant), cutoff_hz=2000.0,
                        resonance=2.0, thermal_voltage=0.5)
        xm = 0.3 * randn(4, 600)
        xm[0, 100] = float("nan")
        xm[1, 50] = float("inf")
        xm[2, 70] = -float("inf")
        st8 = torch.zeros(8, 4, device=dev)
        s_k, y_k = moog_call(moog_ops, mf, xm, st8)
        s_p, y_p = moog_call(moog_ops, mf, xm.cpu(), st8.cpu(), plain=True)
        y_k, s_k = y_k.cpu(), s_k.cpu()
        nan_same = bool(torch.equal(torch.isnan(y_k), torch.isnan(y_p))
                        and torch.equal(torch.isnan(s_k), torch.isnan(s_p)))
        fin = ~torch.isnan(y_p)
        err = float(torch.max(torch.abs(y_k - y_p)[fin]))
        s_fin = ~torch.isnan(s_p)
        s_err = float(torch.max(torch.abs(s_k - s_p)[s_fin]))
        print(f"check {name} {variant} NaN and +-inf in x: NaN where plain "
              f"has NaN {nan_same} ({int((~fin).sum())} samples), max|err| "
              f"finite y {err:.3e} state {s_err:.3e}")
        assert nan_same and bool(torch.isnan(y_k[0, 100:]).all())
        assert err <= 1e-5 and s_err <= 1e-5, (name, variant)
    # fused oversampling: the same kernel on the zero-stuffed input, every
    # os-th output kept, bit for bit (state included)
    for variant in ("classic", "huovilainen", "zdf"):
        name = "moog_zdf" if variant == "zdf" else "moog_ladder"
        for os_ in (2, 4):
            mf = MoogFilter(SR, variant=MoogVariant(variant),
                            cutoff_hz=2000.0, resonance=2.0,
                            thermal_voltage=0.5, oversampling=os_)
            xm = 0.3 * randn(CHAIN_CH, 300)
            st8 = 0.2 * randn(8, CHAIN_CH)
            s_f, y_f = moog_call(moog_ops, mf, xm, st8)
            xs = torch.zeros(CHAIN_CH, 300 * os_, device=dev)
            xs[:, ::os_] = xm * os_
            s_z, y_z = moog_call(moog_ops, mf, xs, st8, os=1)
            same = (torch.equal(y_f, y_z[:, os_ - 1::os_])
                    and torch.equal(s_f, s_z))
            print(f"check {name} {variant} fused os={os_} {CHAIN_CH}x300 vs "
                  f"the zero-stuffed {CHAIN_CH}x{300 * os_}: bit-equal {same}")
            assert same, (name, variant, os_)
    # one float64 call of each kernel: the same template in double with
    # libm tanh and IEEE division
    for variant in ("huovilainen", "zdf"):
        name = "moog_zdf" if variant == "zdf" else "moog_ladder"
        mf = MoogFilter(SR, variant=MoogVariant(variant), **chain_moog)
        xm = 0.3 * randn(CHAIN_CH, CHAIN_BLOCK).double()
        st8 = torch.zeros(8, CHAIN_CH, dtype=torch.float64, device=dev)
        s_k, y_k = moog_call(moog_ops, mf, xm, st8)
        s_p, y_p = moog_call(moog_ops, mf, xm.cpu(), st8.cpu(), plain=True)
        err = float(torch.max(torch.abs(y_k.cpu() - y_p)))
        s_err = float(torch.max(torch.abs(s_k.cpu() - s_p)))
        print(f"check {name} {variant} float64 main: max|err| y {err:.3e} "
              f"state {s_err:.3e}")
        assert y_k.dtype == torch.float64 and err <= 1e-9 and s_err <= 1e-9
    # resonance 4 self-oscillates: rounding differences may grow along
    # time, so the float32 kernel is only required to stay finite; its
    # distance from the float64 plain version is printed (on an NVIDIA
    # H100: ~126 dB for K5, ~110 dB for K6, at most 1.4e-6)
    for variant in ("huovilainen", "zdf"):
        name = "moog_zdf" if variant == "zdf" else "moog_ladder"
        mf = MoogFilter(SR, variant=MoogVariant(variant), cutoff_hz=2000.0,
                        resonance=4.0, thermal_voltage=0.5)
        xm = 0.1 * randn(8, 4096)
        st8 = torch.zeros(8, 8, device=dev)
        _, y_k = moog_call(moog_ops, mf, xm, st8)
        _, y_64 = moog_call(moog_ops, mf, xm.cpu().double(),
                            st8.cpu().double(), plain=True)
        y_k = y_k.cpu()
        finite = bool(torch.isfinite(y_k).all())
        print(f"check {name} {variant} resonance 4 (self-oscillating) 8x4096: "
              f"finite {finite}, SNR vs plain f64 "
              f"{snr_db(y_64.numpy(), y_k.numpy()):.1f} dB, max|err| "
              f"{float(torch.max(torch.abs(y_k.double() - y_64))):.3e}")
        assert finite

    # The Moog adjoint kernels (A4) against their plain reverse sweeps on
    # host copies of the same inputs: the chain block (the chain's
    # filter-moog node, Huovilainen at os 4, 64 x 512: 2048 steps a
    # channel), the direct ZDF block (newton 4, 64 x 512), C = 65 (a
    # ragged last warp) at T = 1 and T = 333 (no segment multiple), os 1,
    # 2, 4 and 8, newton 1, 2, 4 and 8, float64, the clip case (DC of 100,
    # Vt = 20), a Huovilainen state whose tanh rows are not tanh(ds s)
    # (their cotangent is 0) and NaN in x. Bars on the SNR of the whole
    # input gradient (dx and dstate8 together): >= 100 dB in float32,
    # >= 200 dB in float64; each part's SNR and the distance from the
    # float64 sweep are printed (at T = 1 with os > 1, dx alone is a sum
    # that cancels to ~1e-4 of its terms). The final state the adjoint's
    # own walk recomputes equals the forward kernel's st_out bit for bit.
    def cat(*vs):
        return np.concatenate([np.asarray(v, np.float64).ravel() for v in vs])

    edge_kw = dict(cutoff_hz=2000.0, resonance=2.0, thermal_voltage=0.5)
    clip_kw = dict(cutoff_hz=8000.0, resonance=0.5, drive=1.0,
                   thermal_voltage=20.0)
    zdf_kw = dict(cutoff_hz=1200.0, resonance=2.0, drive=2.0)
    f32, f64 = np.float32, np.float64
    adj_cases = [
        # label, variant, newton, os, filter kw (None: the chain's node),
        # (C, T), random state, x offset (the clip case's DC), dtype
        ("chain block", "huovilainen", 4, 4, None, (CHAIN_CH, CHAIN_BLOCK),
         False, 0.0, f32),
        ("chain block float64", "huovilainen", 4, 4, None,
         (CHAIN_CH, CHAIN_BLOCK), False, 0.0, f64),
        ("C=65 T=1", "classic", 4, 1, edge_kw, (65, 1), True, 0.0, f32),
        ("C=65 T=1", "classic_lightweight", 4, 4, edge_kw, (65, 1), True,
         0.0, f32),
        ("C=65 T=333", "improved_classic", 4, 2, edge_kw, (65, 333), True,
         0.0, f32),
        ("C=3 T=333 tanh rows not tanh(ds s)", "huovilainen", 4, 8, edge_kw,
         (3, 333), True, 0.0, f32),
        ("C=65 T=333 float64", "improved_classic_lightweight", 4, 1, edge_kw,
         (65, 333), True, 0.0, f64),
        ("clip", "classic", 4, 1, clip_kw, (2, 1024), False, 100.0, f32),
        ("ZDF block", "zdf", 4, 1, zdf_kw, (CHAIN_CH, CHAIN_BLOCK), False,
         0.0, f32),
        ("ZDF block float64", "zdf", 4, 1, zdf_kw, (CHAIN_CH, CHAIN_BLOCK),
         False, 0.0, f64),
        ("C=65 T=1", "zdf", 1, 1, edge_kw, (65, 1), True, 0.0, f32),
        ("C=65 T=1", "zdf", 8, 8, edge_kw, (65, 1), True, 0.0, f32),
        ("C=65 T=333", "zdf", 4, 2, edge_kw, (65, 333), True, 0.0, f32),
        ("C=3 T=333", "zdf", 2, 4, edge_kw, (3, 333), True, 0.0, f32),
        ("clip", "zdf", 4, 1, clip_kw, (2, 1024), False, 100.0, f32)]
    for label, variant, iters, os_, kw, (c, t), with_state, dc, dtype in \
            adj_cases:
        name = "moog_zdf_adjoint" if variant == "zdf" else "moog_ladder_adjoint"
        mf = (chain_moog_node(MoogFilter, MoogVariant) if kw is None else
              MoogFilter(SR, variant=MoogVariant(variant), newton_iters=iters,
                         oversampling=os_, **kw))
        as_dev = lambda v: torch.as_tensor(np.asarray(v, dtype), device=dev)
        xa = as_dev(dc + 0.3 * rng.standard_normal((c, t)))
        st8 = as_dev(0.2 * rng.standard_normal((8, c)) if with_state
                     else np.zeros((8, c)))
        gy, gst = (as_dev(rng.standard_normal(shape))
                   for shape in ((c, t), (8, c)))
        with torch.no_grad():
            s_fwd, _ = moog_call(moog_ops, mf, xa, st8)
        dx, dst, s_fin = moog_adjoint_call(moog_ops, mf, xa, st8, gy, gst,
                                           return_state=True)
        args = [v.cpu() for v in (xa, st8, gy, gst)]
        p_dx, p_dst = moog_adjoint_call(moog_ops, mf, *args, plain=True)
        q_dx, q_dst = (moog_adjoint_call(moog_ops, mf, *(v.double() for v in args),
                                         plain=True)
                       if dtype == f32 else (p_dx, p_dst))
        dx, dst = dx.cpu(), dst.cpu()
        same_state = bool(torch.equal(s_fin, s_fwd))
        snr_all = snr_db(cat(p_dx, p_dst), cat(dx, dst))
        snr_dx, snr_dst = snr_db(p_dx.numpy(), dx.numpy()), snr_db(
            p_dst.numpy(), dst.numpy())
        snr_64 = snr_db(cat(q_dx, q_dst), cat(dx, dst))
        err = float(torch.max(torch.abs(dx - p_dx)))
        kernels[name]["errs"].append(err)
        if variant == "huovilainen":
            exact = bool(torch.all(dst[4:7] == 0))
        elif variant == "zdf":
            exact = bool(torch.equal(dst[4:7], gst[4:7].cpu()))
        else:
            exact = bool(torch.all(dst[7] == 0))
        cut = int(torch.sum(dx == 0)) if dc else None
        print(f"check {name} {variant} (newton {mf.newton_iters}) {label}: "
              f"{np.dtype(dtype).name} C={c} T={t} os={mf.oversampling} "
              f"SNR vs plain {snr_all:.1f} dB (dx {snr_dx:.1f}, dstate8 "
              f"{snr_dst:.1f}), vs plain f64 {snr_64:.1f} dB, max|err| dx "
              f"{err:.3e}; unread rows exact {exact}; final state bit-equal "
              f"to the forward's {same_state}"
              + (f"; dx exactly 0 at {cut} samples (clip), plain {int(torch.sum(p_dx == 0))}"
                 if dc else ""))
        assert snr_all >= (100 if dtype == f32 else 200), (name, label)
        assert same_state and exact, (name, label)
    # NaN in x: the gradient is NaN where the plain sweep's is, and only in
    # the channel the NaN ran through; the other channels within the bar
    for variant in ("classic", "huovilainen", "zdf"):
        name = "moog_zdf_adjoint" if variant == "zdf" else "moog_ladder_adjoint"
        mf = MoogFilter(SR, variant=MoogVariant(variant), **edge_kw)
        xa = 0.3 * randn(4, 600)
        xa[0, 100] = float("nan")
        st8 = torch.zeros(8, 4, device=dev)
        gy, gst = randn(4, 600), randn(8, 4)
        dx, dst = (v.cpu() for v in moog_adjoint_call(moog_ops, mf, xa, st8,
                                                      gy, gst))
        p_dx, p_dst = moog_adjoint_call(
            moog_ops, mf, *(v.cpu() for v in (xa, st8, gy, gst)), plain=True)
        nan_same = bool(torch.equal(torch.isnan(dx), torch.isnan(p_dx))
                        and torch.equal(torch.isnan(dst), torch.isnan(p_dst)))
        rest = bool(torch.isfinite(dx[1:]).all() and torch.isfinite(dst[:, 1:]).all())
        snr_rest = snr_db(cat(p_dx[1:], p_dst[:, 1:]), cat(dx[1:], dst[:, 1:]))
        print(f"check {name} {variant} NaN in x: NaN where plain has NaN "
              f"{nan_same} ({int(torch.isnan(dx).sum())} of dx's "
              f"{dx.numel()}), other channels finite {rest}, SNR vs plain "
              f"{snr_rest:.1f} dB")
        assert nan_same and rest and snr_rest >= 100, (name, variant)

    # The FIR's direct path (<= 64 taps) is elementwise float32 on the
    # card; a cuDNN conv1d in TF32 (about three decimal digits) would fall
    # far below the bar here. Above 4096 taps its fftconvolve runs the FDL
    # kernel.
    xf = randn(CHAIN_CH, 4 * CHAIN_BLOCK)
    for taps in (48, 24040):
        h = rng.standard_normal(taps) * np.exp(-np.arange(taps) / 2000.0)
        fdlconv.fdl_conv.launches = 0
        y_f = FIRFilter(h).process(xf)
        launched = fdlconv.fdl_conv.launches
        y_64 = FIRFilter(h).process(xf.double().cpu())
        snr = min(snr_db(y_64[i].numpy(), host(y_f[i]))
                  for i in range(CHAIN_CH))
        print(f"check FIR {taps} taps {CHAIN_CH}x{4 * CHAIN_BLOCK} on the card: "
              f"worst channel vs plain f64 {snr:.1f} dB, FDL launches "
              f"{launched}")
        assert snr >= (120 if taps <= 64 else 110), taps
        assert launched == (1 if taps > 4096 else 0), taps

    # The adjoint kernels against their plain versions on host copies of
    # the same inputs (bars 100 dB in float32, 200 dB in float64), and
    # against the plain version in float64 on the same inputs (printed):
    # at the compressor's ballistics an s sums ~7000 cotangent samples,
    # which the plain float32 walk adds in order and the kernel in chunks
    # of ~47 from carries composed in float64.
    def snr_or_inf(ref, test):
        ref = np.asarray(ref, np.float64)
        if not np.any(ref):
            return math.inf if not np.any(test) else -math.inf
        return snr_db(ref, test)

    adj_names = ("dtargets", "denv0", "dattack", "drelease")
    env_adj_cases = [
        ("main", CHANNELS, N_FLAGSHIP, 0.0, a_main, r_main),
        ("C=3 T=1000 per-channel, broadcast env0", 3, 1000, 0.2,
         rng.uniform(0.01, 0.5, 3), rng.uniform(0.001, 0.05, 3)),
        ("T=1", CHANNELS, 1, 0.2, a_main, r_main),
        ("T=15361 (no chunk multiple)", 4, 15361, 0.1, a_main, r_main),
        ("C=65 T=333 per-channel", 65, 333, rng.uniform(0, 1, 65),
         rng.uniform(0.01, 0.5, 65), rng.uniform(1e-5, 0.05, 65))]
    assert 15361 % envscan.adjoint_plan(15361)[0]
    for dtype in (np.float32, np.float64):
        for label, c, t, e0v, av, rv in env_adj_cases:
            xa, e0a, aa, ra = env_case(c, np.abs(rng.standard_normal((c, t))),
                                       e0v, av, rv, dtype)
            _, tra = k4(xa, e0a, aa, ra)
            ga = torch.as_tensor(rng.standard_normal((c, t)).astype(dtype),
                                 device=dev)
            gfa = torch.as_tensor(rng.standard_normal(c).astype(dtype),
                                  device=dev)
            args = (xa, tra, e0a, aa, ra, ga, gfa)
            out = envscan.envelope_adjoint(*args)
            p64 = envscan.envelope_adjoint_plain(*(v.cpu().double() for v in args))
            p_same = (p64 if dtype == np.float64 else
                      envscan.envelope_adjoint_plain(*(v.cpu() for v in args)))
            out = [v.cpu() for v in out]
            snr64 = [snr_or_inf(r.numpy(), o.numpy()) for r, o in zip(p64, out)]
            snr_same = [snr_or_inf(r.numpy(), o.numpy())
                        for r, o in zip(p_same, out)]
            err = max(float(torch.max(torch.abs(o.double() - r)))
                      for o, r in zip(out, p64))
            kernels["envelope_adjoint"]["errs"].append(err)
            bar = 100 if dtype == np.float32 else 200
            print(f"check envelope_adjoint {label}: {np.dtype(dtype).name} "
                  f"C={c} T={t} L={envscan.adjoint_plan(t)[0]} SNR vs plain "
                  f"{np.dtype(dtype).name} " + ", ".join(
                      f"{n} {v:.1f}" for n, v in zip(adj_names, snr_same))
                  + " dB; vs plain f64 on the same inputs " + ", ".join(
                      f"{v:.1f}" for v in snr64) + f" dB; max|err| {err:.3e}")
            assert min(snr_same) >= bar, (label, dtype)

    # the FDL spectra adjoint on K1's own frame spectra (its first launch's
    # scratch, kept as the Function keeps it) and the cotangent spectra,
    # against the plain version in float64 on the same float32 inputs; the
    # kernel sums in float64
    for label, c, n, b, p in [("IR learning main", CHANNELS, N_FLAGSHIP, 1024, 32),
                              ("C=1", 1, 8 * 1024, 1024, 3),
                              ("C=3 odd", 3, 6 * 1024, 1024, 5),
                              ("C=5 P > F", 5, 4 * 256, 256, 10)]:
        xa = randn(c, n)
        hs_a = torch.as_tensor(fdlconv.kernel_spectra(ir[:p * b], b), device=dev)
        _, Xa = fdlconv._launch(xa, hs_a, b, fdlconv.mac_plan(c, n // b, b)[0])
        dVa = fdlconv.cotangent_spectra(randn(c, n), b)
        dH = fdlconv.fdl_spectra_adjoint(Xa, dVa, p)
        dH64 = fdlconv.fdl_spectra_adjoint_plain(Xa.double(), dVa.double(), p)
        dH32 = fdlconv.fdl_spectra_adjoint_plain(Xa, dVa, p)
        nf = n // b
        unseen_zero = bool(torch.all(dH[nf:] == 0)) if p > nf else None
        edges_zero = bool(torch.all(dH[:, [0, b], 1] == 0))
        snr64, snr32 = snr_db(host(dH64), host(dH)), snr_db(host(dH32), host(dH))
        err = float(torch.max(torch.abs(dH.double() - dH64)))
        kernels["fdl_spectra_adjoint"]["errs"].append(err)
        print(f"check fdl_spectra_adjoint {label}: C={c} F={nf} B={b} P={p} "
              f"SNR vs plain f64 {snr64:.1f} dB, vs plain f32 {snr32:.1f} dB, "
              f"max|err| {err:.3e}, rows p >= F zero {unseen_zero}, DC and "
              f"Nyquist imaginary parts zero {edges_zero}")
        assert snr64 >= 100 and edges_zero and unseen_zero in (None, True), label

    # each autograd Function's gradients on the card against the CPU
    # path's Function on host copies of the same inputs: float32 on the
    # card against the CPU in float64 (bar 100 dB) and in float32
    # (printed), float64 against float64 (bar 200 dB)
    def grads_of(loss_fn, inputs, device, dtype):
        leaves = [v.detach().to(device, dtype).requires_grad_() for v in inputs]
        loss_fn(*leaves).backward()
        return [v.grad for v in leaves]

    def weighted(w):
        return lambda y: torch.sum(y * w.to(y.device, y.dtype))

    w_main = randn(CHANNELS, N_FLAGSHIP)
    v_main = randn(CHANNELS)
    hs_fn = torch.as_tensor(fdlconv.kernel_spectra(ir, 1024), device=dev)
    fn_cases = [
        ("BiquadCascadeFn (cascade)", ("dx",), [randn(CHANNELS, N_FLAGSHIP)],
         lambda x: weighted(w_main)(bqmod.biquad_cascade(
             x, cascade.runtime_sos, cascade.gain)[0]), (torch.float32,)),
        ("EnvelopeFn (main ballistics)", adj_names,
         [torch.abs(randn(CHANNELS, N_FLAGSHIP)), torch.zeros(CHANNELS),
          torch.tensor(a_main), torch.tensor(r_main)],
         lambda t, e0, a, r: (lambda o: weighted(w_main)(o[1])
                              + weighted(v_main)(o[0]))(
             envscan.envelope_scan(t, e0, a, r)),
         (torch.float32, torch.float64)),
        ("EnvelopeFn (per-channel, broadcast env0)", adj_names,
         [torch.abs(randn(3, 1000)), torch.tensor(0.2),
          torch.as_tensor(rng.uniform(0.01, 0.5, 3)),
          torch.as_tensor(rng.uniform(0.001, 0.05, 3))],
         lambda t, e0, a, r: torch.sum(envscan.envelope_scan(t, e0, a, r)[1]
                                       * torch.arange(1000, device=t.device,
                                                      dtype=t.dtype)),
         (torch.float32, torch.float64)),
        ("FDLConvFn (x and hspec)", ("dx", "dhspec"),
         [randn(CHANNELS, N_FLAGSHIP), hs_fn],
         lambda x, h: weighted(w_main)(fdlconv.fdl_conv(x, h, 1024)),
         (torch.float32,))]
    for label, names, inputs, loss_fn, dtypes in fn_cases:
        for dtype in dtypes:
            g_card = grads_of(loss_fn, inputs, dev, dtype)
            g_64 = grads_of(loss_fn, inputs, "cpu", torch.float64)
            g_32 = (grads_of(loss_fn, inputs, "cpu", torch.float32)
                    if dtype == torch.float32 else g_64)
            snr64 = [snr_db(host(r), host(g)) for r, g in zip(g_64, g_card)]
            snr32 = [snr_db(host(r), host(g)) for r, g in zip(g_32, g_card)]
            bar = 100 if dtype == torch.float32 else 200
            print(f"check grad {label} {str(dtype).removeprefix('torch.')} on "
                  f"the card vs the CPU path's Function: f64 " + ", ".join(
                      f"{n} {v:.1f}" for n, v in zip(names, snr64))
                  + " dB; f32 " + ", ".join(f"{v:.1f}" for v in snr32) + " dB")
            assert min(snr64) >= bar, (label, dtype)

    # The port's faults against the reference (ROADMAP.md section 3), one
    # check each.
    # Fault 1: a CUDA tensor that requires grad. The kernels write fresh
    # tensors, so a result would carry no grad_fn. The cascade from zero
    # state, the envelope, the FDL, fftconvolve's FDL branch (for its
    # kernel too) and the Moog ladders (in x and in the state) go through
    # their autograd Functions and carry one; the two calls with no
    # backward on the card (the explicit-state cascade and the raw
    # envelope kernel, which the reference cannot differentiate through
    # Pallas either) refuse instead. Under no_grad those run.
    xg = randn(2, 1024).requires_grad_()
    st8g = torch.zeros(8, 2, device=dev)
    hg = torch.as_tensor(fdlconv.kernel_spectra(rng.standard_normal(600), 256),
                         device=dev)
    pg = MoogFilter(SR).kernel_params()
    st_bq = torch.zeros(2, cascade.num_runtime_sections, 4, device=dev)
    zg = torch.zeros(2, device=dev)
    refused = []
    for label, call in [
            ("biquad_cascade with a state", lambda: bqmod.biquad_cascade(
                xg, cascade.runtime_sos, cascade.gain, st_bq)),
            ("envelope_scan_kernel", lambda: envscan.envelope_scan_kernel(
                torch.abs(xg), zg, zg + 0.1, zg + 0.01))]:
        try:
            call()
        except NotImplementedError:
            refused.append(label)
    carried = {}
    for label, call in [
            ("biquad_cascade", lambda: bqmod.biquad_cascade(
                xg, cascade.runtime_sos, cascade.gain)[0]),
            ("envelope_scan", lambda: envscan.envelope_scan(
                torch.abs(xg), 0.0, 0.1, 0.01)[1]),
            ("fdl_conv", lambda: fdlconv.fdl_conv(xg, hg, 256)),
            ("fftconvolve kernel", lambda: fftconvolve(
                randn(2, 8192), torch.ones(5000, device=dev,
                                           requires_grad=True))),
            ("moog_ladder", lambda: moog_ops.moog_ladder(xg, st8g, pg)[1]),
            ("moog_zdf state", lambda: moog_ops.moog_zdf(
                xg.detach(), st8g.clone().requires_grad_(), pg)[0])]:
        out = call()
        carried[label] = type(out.grad_fn).__name__ if out.grad_fn else None
    with torch.no_grad():
        _, y_ng = envscan.envelope_scan_kernel(torch.abs(xg), zg, zg + 0.1,
                                               zg + 0.01)
        y_st, _ = bqmod.biquad_cascade(xg, cascade.runtime_sos, cascade.gain,
                                       st_bq)
    print(f"check fault 1 (requires_grad on the card): refused by "
          f"{', '.join(refused)}; grad_fn {json.dumps(carried)}; under "
          f"no_grad runs {tuple(y_ng.shape)} and {tuple(y_st.shape)}")
    assert len(refused) == 2 and all(carried.values()), (refused, carried)
    assert y_ng.shape == xg.shape and y_st.shape == xg.shape
    # Fault 2: a float64 Compressor with sidechain prefilters on the card
    comp_sc = convert.compressor_from_config({
        "sample_rate": SR, "sidechain_low_cut_hz": 80.0,
        "sidechain_high_cut_hz": 6000.0})
    x_sc = randn(2, 4096).double()
    _, y_sc = comp_sc.process(comp_sc.init_state((2,), torch.float64), x_sc)
    _, y_sc_p = comp_sc.process(comp_sc.init_state((2,), torch.float64, "cpu"),
                                x_sc.cpu())
    snr_sc = snr_db(y_sc_p.numpy(), host(y_sc))
    print(f"check fault 2 (float64 Compressor, 80 Hz / 6 kHz prefilters, "
          f"2x4096 on the card): {y_sc.dtype}, SNR vs plain CPU path "
          f"{snr_sc:.1f} dB")
    assert y_sc.dtype == torch.float64 and snr_sc >= 100
    # and the gradient of a float32 one in x: with a gradient wanted the
    # prefilter takes the blocked engine (the kernel's explicit-state call
    # has no backward), the envelope its Function; against the CPU path in
    # float64
    x_sg = randn(2, 4096).requires_grad_()
    _, y_sg = comp_sc.process(comp_sc.init_state((2,)), x_sg)
    torch.mean(y_sg * y_sg).backward()
    x_sg64 = x_sg.detach().cpu().double().requires_grad_()
    _, y_sg64 = comp_sc.process(
        comp_sc.init_state((2,), torch.float64, "cpu"), x_sg64)
    torch.mean(y_sg64 * y_sg64).backward()
    snr_sg = snr_db(x_sg64.grad.numpy(), host(x_sg.grad))
    print(f"check fault 2 (float32 Compressor, 80 Hz / 6 kHz prefilters, "
          f"2x4096 on the card): d mean(y^2) / dx vs the CPU path in float64 "
          f"{snr_sg:.1f} dB")
    assert snr_sg >= 80
    # Fault 3: a 70-section float32 chain in auto mode takes the blocked
    # engine (the cascade kernel takes at most 64 sections)
    chain70 = BiquadChain(np.concatenate([butterworth_lp(2000.0, 10, SR)] * 14))
    x70 = randn(CHANNELS, 4096)
    bqmod.biquad_cascade.launches = 0
    y70 = chain70.process(x70)
    launched = bqmod.biquad_cascade.launches
    y70_p = chain70.process(x70.cpu())
    snr70 = snr_db(y70_p.numpy(), host(y70))
    print(f"check fault 3 ({chain70.num_runtime_sections}-section float32 "
          f"chain, auto mode {chain70._auto_mode(x70)}): cascade launches "
          f"{launched}, SNR vs plain CPU path {snr70:.1f} dB")
    assert chain70.num_runtime_sections == 70 and launched == 0
    assert snr70 >= 100
    # Fault 4: envelope_scan with T = 0 returns env0 and an empty
    # trajectory, as on the CPU
    env0 = torch.tensor([0.3, 0.5], device=dev)
    ef0, tr0 = envscan.envelope_scan(torch.zeros(2, 0, device=dev), env0,
                                     0.1, 0.01)
    print(f"check fault 4 (envelope_scan T=0 on the card): env_final "
          f"{host(ef0).tolist()}, trajectory {tuple(tr0.shape)}")
    assert torch.equal(ef0, env0) and tr0.shape == (2, 0)
    assert tr0.device.type == "cuda"

    # -- 3. flagship forward ---------------------------------------------------
    pipe = convert.flagship_from_numpy(flag)
    x_np = np.random.default_rng(1).standard_normal(
        (CHANNELS, N_FLAGSHIP)).astype(np.float32)
    x = torch.as_tensor(x_np, device=dev)
    state = pipe.init_state(CHANNELS)
    for k in kernels.values():
        k["wrapper"].launches = 0
    k4.reset_counts()
    y, power = pipe.forward(x, state)
    torch.cuda.synchronize()
    launches = {name: k["wrapper"].launches for name, k in kernels.items()}
    for k in kernels.values():
        k["by_path"] = {"flagship": k["wrapper"].launches}
    env_counts = {"flagship": k4.counts()}
    print(f"flagship launches per forward: {json.dumps(launches)}; envelope "
          f"counts {json.dumps(env_counts['flagship'])}")
    assert launches == {"biquad_cascade": 2, "envelope": 1, "fdl_conv": 1,
                        "moog_ladder": 0, "moog_zdf": 0,
                        "envelope_adjoint": 0, "fdl_spectra_adjoint": 0,
                        "moog_ladder_adjoint": 0, "moog_zdf_adjoint": 0}, launches
    assert env_counts["flagship"]["exact_walks"] == 0

    pipe_cpu = convert.flagship_from_numpy(flag, device="cpu")
    t0 = time.perf_counter()
    y_cpu, power_cpu = pipe_cpu.forward(torch.as_tensor(x_np),
                                        pipe_cpu.init_state(CHANNELS, device="cpu"))
    cpu_s = time.perf_counter() - t0
    y_h = host(y)
    assert y_h.shape == (CHANNELS, N_FLAGSHIP) and np.all(np.isfinite(y_h))
    snr = snr_db(y_cpu.numpy(), y_h)
    p_rel = float(np.max(np.abs(host(power) - power_cpu.numpy())
                         / np.abs(power_cpu.numpy())))
    print(f"flagship 8x48128 vs plain CPU path: SNR {snr:.1f} dB, power "
          f"max rel err {p_rel:.2e} (plain CPU path {cpu_s:.2f} s)")
    assert snr >= 100 and p_rel < 1e-4

    # -- 4. effect chain ----------------------------------------------------------
    raw = json.dumps(CHAIN_GRAPH)
    chain = Chain(SR)
    report = chain.load_graph(raw)
    print(f"chain fusion report: {report}")
    assert [m for m, _ in report] == [["eq", "verb"]], report
    n_chain = CHAIN_BLOCKS * CHAIN_BLOCK
    xc_np = (0.5 * np.random.default_rng(2).standard_normal(
        (CHAIN_CH, n_chain))).astype(np.float32)
    xc = torch.as_tensor(xc_np, device=dev)
    c_state0 = chain.init_state((CHAIN_CH,))
    for k in kernels.values():
        k["wrapper"].launches = 0
    k4.reset_counts()
    _, yc = chain.process_blocks(c_state0, xc)
    torch.cuda.synchronize()
    launches = {name: k["wrapper"].launches for name, k in kernels.items()}
    for k in kernels.values():
        k["by_path"]["chain"] = k["wrapper"].launches
    env_counts["chain"] = k4.counts()
    print(f"chain launches over {CHAIN_BLOCKS} blocks of {CHAIN_CH}x"
          f"{CHAIN_BLOCK}: {json.dumps(launches)}; envelope counts "
          f"{json.dumps(env_counts['chain'])}")
    assert env_counts["chain"]["exact_walks"] == 0
    assert launches == {"biquad_cascade": CHAIN_BLOCKS,
                        "envelope": CHAIN_BLOCKS, "fdl_conv": CHAIN_BLOCKS,
                        "moog_ladder": CHAIN_BLOCKS, "moog_zdf": 0,
                        "envelope_adjoint": 0, "fdl_spectra_adjoint": 0,
                        "moog_ladder_adjoint": 0, "moog_zdf_adjoint": 0}, launches
    n8 = 8 * CHAIN_BLOCK
    chain_cpu = Chain(SR)
    chain_cpu.load_graph(raw)
    t0 = time.perf_counter()
    _, yc_cpu = chain_cpu.process_blocks(
        chain_cpu.init_state((CHAIN_CH,), device="cpu"),
        torch.as_tensor(xc_np[:, :n8]))
    cpu_s = time.perf_counter() - t0
    yc_h = host(yc)
    assert yc_h.shape == (CHAIN_CH, n_chain) and np.all(np.isfinite(yc_h))
    snr = snr_db(yc_cpu.numpy(), yc_h[:, :n8])
    print(f"chain {CHAIN_CH}x{n8} (8 blocks) vs plain CPU path: SNR "
          f"{snr:.1f} dB (plain CPU path {cpu_s:.2f} s)")
    assert snr >= 100

    # -- 5. ZDF Moog driven directly ---------------------------------------------
    zdf = MoogFilter(SR, variant=MoogVariant.ZDF, cutoff_hz=1200.0,
                     resonance=2.0, drive=2.0, newton_iters=4)
    xz_np = (0.5 * np.random.default_rng(3).standard_normal(
        (CHAIN_CH, n_chain))).astype(np.float32)
    xz = torch.as_tensor(xz_np, device=dev)
    z_state0 = zdf.init_state((CHAIN_CH,))
    for k in kernels.values():
        k["wrapper"].launches = 0
    _, yz = streaming.scan_blocks(zdf.process, z_state0, xz,
                                  block_size=CHAIN_BLOCK)
    torch.cuda.synchronize()
    launches = {name: k["wrapper"].launches for name, k in kernels.items()}
    for k in kernels.values():
        k["by_path"]["moog_zdf_direct"] = k["wrapper"].launches
    print(f"ZDF MoogFilter launches over {CHAIN_BLOCKS} blocks of "
          f"{CHAIN_CH}x{CHAIN_BLOCK}: {json.dumps(launches)}")
    assert launches == {"biquad_cascade": 0, "envelope": 0, "fdl_conv": 0,
                        "moog_ladder": 0, "moog_zdf": CHAIN_BLOCKS,
                        "envelope_adjoint": 0, "fdl_spectra_adjoint": 0,
                        "moog_ladder_adjoint": 0, "moog_zdf_adjoint": 0}, launches
    _, yz_cpu = streaming.scan_blocks(
        zdf.process, zdf.init_state((CHAIN_CH,), device="cpu"),
        torch.as_tensor(xz_np[:, :n8]), block_size=CHAIN_BLOCK)
    yz_h = host(yz)
    assert np.all(np.isfinite(yz_h))
    snr = snr_db(yz_cpu.numpy(), yz_h[:, :n8])
    print(f"ZDF MoogFilter {CHAIN_CH}x{n8} (8 blocks) vs plain CPU path: "
          f"SNR {snr:.1f} dB")
    assert snr >= 100

    # -- 6. timing ---------------------------------------------------------------
    fwd_ms = time_ms(torch, lambda: pipe.forward(x, state), reps=20)
    print(f"time flagship forward 8x48128: {fwd_ms:.4f} ms mean of 20 "
          f"({CHANNELS * N_FLAGSHIP / fwd_ms * 1e3:.4e} samples/s) ({gpu})")

    fold = FoldedPipeline.from_numpy(folded_params(seed=0))
    n_bench = 1 << 24
    xb = randn(CHANNELS, n_bench)
    bo = fold.reverb.bulk_block_order(n_bench)
    fdlconv.fdl_conv.launches = 0
    yb = fold.forward(xb)
    torch.cuda.synchronize()
    assert fdlconv.fdl_conv.launches == 1
    hb = fold.reverb._hspec(bo, dev)
    yb_p = fdlconv.fdl_conv_plain(xb, hb, 1 << bo)
    torch.cuda.synchronize()
    snr_b = snr_db(host(yb_p), host(yb))
    print(f"check folded 8x2^24: taps={fold.reverb.kernel_len} B=2^{bo} "
          f"P={hb.shape[0]} SNR vs plain {snr_b:.1f} dB, finite "
          f"{bool(torch.isfinite(yb).all())}")
    assert snr_b >= 110 and bool(torch.isfinite(yb).all())
    del yb_p
    fold_ms = time_ms(torch, lambda: fold.forward(xb), reps=5)
    print(f"time folded pipeline 8x2^24: {fold_ms:.4f} ms mean of 5 "
          f"({CHANNELS * n_bench / fold_ms * 1e3:.4e} samples/s) ({gpu})")
    # K1 alone at the folded shape, beside one big-FFT convolution of the
    # same input with the folded IR (the library call of the flagship's
    # K1 timing below)
    Bb = 1 << bo
    fold_k1 = graph_ms(torch, lambda: fdlconv.fdl_conv(xb, hb, Bb), 3)
    h_fold = torch.as_tensor(fold.reverb.kernel, dtype=torch.float32, device=dev)
    size = 1 << (n_bench + h_fold.numel() - 1).bit_length()
    fold_lib = graph_ms(torch, lambda: torch.fft.irfft(
        torch.fft.rfft(xb, size) * torch.fft.rfft(h_fold, size),
        size)[..., :n_bench], 3)
    fold_b, fold_by = bound(*fdl_work(CHANNELS, n_bench, Bb, hb.shape[0]))
    print(f"time fdl_conv folded 8x2^24 B={Bb} P={hb.shape[0]}: kernel "
          f"{fold_k1:.4f} ms (graph replay), library {fold_lib:.4f} ms, "
          f"bound {fold_b:.6f} ms ({fold_by}) ({gpu})")

    xw = randn(512, 1 << 16)
    k3_ms = graph_ms(torch, lambda: bqmod.biquad_cascade(xw, sos15), reps=5)
    k3_call = time_ms(torch, lambda: bqmod.biquad_cascade(xw, sos15), reps=5)
    k3_plain = time_ms(torch, lambda: bqmod.biquad_cascade_plain(xw, sos15), reps=3)
    k3_b, k3_by = bound(*biquad_work(512, 1 << 16, 15))
    print(f"time biquad_cascade 512x2^16 S=15: kernel {k3_ms:.4f} ms (graph "
          f"replay; {k3_call:.4f} ms as back-to-back calls), plain "
          f"{k3_plain:.4f} ms, bound {k3_b:.4f} ms ({k3_by}) ({gpu})")

    # per kernel, summed over its launches in one flagship forward
    y1 = cascade.process(x)
    y2 = weighting.process(y1)
    src = torch.abs(y2)
    zeros = torch.zeros(CHANNELS, device=dev)
    att = torch.full((CHANNELS,), a_main, device=dev)
    rel = torch.full((CHANNELS,), r_main, device=dev)
    b_main = pipe.reverb.bulk_block_order(N_FLAGSHIP)
    hs = pipe.reverb._hspec(b_main, dev)
    B = 1 << b_main
    kb = kernels["biquad_cascade"]
    k3_calls = [lambda: bqmod.biquad_cascade(x, cascade.runtime_sos),
                lambda: bqmod.biquad_cascade(y1, weighting.runtime_sos, weighting.gain)]
    kb["ms"] = sum(graph_ms(torch, f, 20) for f in k3_calls)
    kb["call_ms"] = sum(time_ms(torch, f, 20) for f in k3_calls)
    kb["plain_ms"] = (
        time_ms(torch, lambda: bqmod.biquad_cascade_plain(x, cascade.runtime_sos), 5)
        + time_ms(torch, lambda: bqmod.biquad_cascade_plain(
            y1, weighting.runtime_sos, weighting.gain), 5))
    w1 = biquad_work(CHANNELS, N_FLAGSHIP, cascade.num_runtime_sections)
    w2 = biquad_work(CHANNELS, N_FLAGSHIP, weighting.num_runtime_sections)
    kb["bound_ms"], kb["bound_by"] = bound(w1[0] + w2[0], w1[1] + w2[1])
    kb["library_ms"] = None
    ke = kernels["envelope"]
    k4_call = lambda: envscan.envelope_scan_kernel(src, zeros, att, rel)
    ke["ms"] = graph_ms(torch, k4_call, 20)
    ke["call_ms"] = time_ms(torch, k4_call, 20)
    ke["plain_ms"] = time_ms(
        torch, lambda: envscan.envelope_scan_plain(src, zeros, att, rel), 1, warmup=0)
    ke["bound_ms"], ke["bound_by"] = bound(*envelope_work(CHANNELS, N_FLAGSHIP))
    ke["library_ms"] = None
    k4.reset_counts()
    k4_call()
    ke["counts_by_path"] = env_counts
    print(f"envelope at the flagship shape: {json.dumps(k4.counts())}")
    kf = kernels["fdl_conv"]
    k1_call = lambda: fdlconv.fdl_conv(src, hs, B)
    kf["ms"] = graph_ms(torch, k1_call, 20)
    kf["call_ms"] = time_ms(torch, k1_call, 20)
    kf["plain_ms"] = time_ms(torch, lambda: fdlconv.fdl_conv_plain(src, hs, B), 20)
    kf["bound_ms"], kf["bound_by"] = bound(
        *fdl_work(CHANNELS, N_FLAGSHIP, B, hs.shape[0]))
    h_t = torch.as_tensor(ir, device=dev)
    size = 1 << (N_FLAGSHIP + ir.size - 1).bit_length()
    kf["library_ms"] = graph_ms(torch, lambda: torch.fft.irfft(
        torch.fft.rfft(src, size) * torch.fft.rfft(h_t, size), size)[..., :N_FLAGSHIP], 20)
    for name in ("biquad_cascade", "envelope", "fdl_conv"):
        k = kernels[name]
        k["ms_at"] = "per flagship forward, 8 x 48128"
        print(f"time {name} per flagship forward: kernel {k['ms']:.4f} ms "
              f"(graph replay; {k['call_ms']:.4f} ms as back-to-back calls) "
              f"x{k['by_path']['flagship']} wrapper calls, bound "
              f"{k['bound_ms']:.6f} ms "
              f"({k['bound_by']}), plain {k['plain_ms']:.4f} ms, library "
              f"{k['library_ms']} ms ({gpu})")

    # the adjoint kernels at the shapes the trainer gives them:
    # envelope_adjoint per flagship backward, fdl_spectra_adjoint per
    # IR-learning step (beside the torch.fft call that makes its dV, the
    # backward's one library call, which computes another function)
    ka = kernels["envelope_adjoint"]
    _, tr_t = envscan.envelope_scan_kernel(src, zeros, att, rel)
    adj_t = (src, tr_t, zeros, att, rel, randn(CHANNELS, N_FLAGSHIP), zeros)
    ka_call = lambda: envscan.envelope_adjoint(*adj_t)
    ka["ms"] = graph_ms(torch, ka_call, 20)
    ka["call_ms"] = time_ms(torch, ka_call, 20)
    ka["plain_ms"] = time_ms(
        torch, lambda: envscan.envelope_adjoint_plain(*adj_t), 1, warmup=0)
    ka["bound_ms"], ka["bound_by"] = bound(*envelope_adjoint_work(
        CHANNELS, N_FLAGSHIP))
    ka["library_ms"] = None
    ka["ms_at"] = "per flagship backward, 8 x 48128"
    kd = kernels["fdl_spectra_adjoint"]
    B_ir, P_ir = IR_BLOCK, IR_PARTS
    nf_ir = N_FLAGSHIP // B_ir
    _, X_t = fdlconv._launch(randn(CHANNELS, N_FLAGSHIP), torch.as_tensor(
        fdlconv.kernel_spectra(ir, B_ir), device=dev), B_ir,
        fdlconv.mac_plan(CHANNELS, nf_ir, B_ir)[0])
    g_ir = randn(CHANNELS, N_FLAGSHIP)
    dV_t = fdlconv.cotangent_spectra(g_ir, B_ir)
    kd_call = lambda: fdlconv.fdl_spectra_adjoint(X_t, dV_t, P_ir)
    kd["ms"] = graph_ms(torch, kd_call, 20)
    kd["call_ms"] = time_ms(torch, kd_call, 20)
    kd["plain_ms"] = time_ms(
        torch, lambda: fdlconv.fdl_spectra_adjoint_plain(X_t, dV_t, P_ir), 5)
    kd["bound_ms"], kd["bound_by"] = bound(*spectra_adjoint_work(
        CHANNELS, nf_ir, B_ir, P_ir))
    kd["library_ms"] = None
    kd["dv_fft_ms"] = graph_ms(
        torch, lambda: fdlconv.cotangent_spectra(g_ir, B_ir), 20)
    kd["ms_at"] = (f"per IR-learning step, {CHANNELS} x {N_FLAGSHIP}, "
                   f"B = {B_ir}, P = {P_ir}")
    for name in ("envelope_adjoint", "fdl_spectra_adjoint"):
        k = kernels[name]
        print(f"time {name} {k['ms_at']}: kernel {k['ms']:.4f} ms (graph replay; "
              f"{k['call_ms']:.4f} ms as back-to-back calls), bound "
              f"{k['bound_ms']:.6f} ms ({k['bound_by']}), plain "
              f"{k['plain_ms']:.4f} ms, library none"
              + (f"; the torch.fft of dV {k['dv_fft_ms']:.4f} ms"
                 if "dv_fft_ms" in k else "") + f" ({gpu})")
    for label, (call, prefixes) in {
            "envelope_adjoint flagship": (ka_call, ("envelope_adjoint",)),
            "fdl_spectra_adjoint IR learning": (kd_call, ("fdl_spectra",))}.items():
        parts = kernel_breakdown(torch, call, 20, prefixes)
        print(f"time {label} by launch (profiler, device ms per call): "
              + (", ".join(f"{k} {t:.4f}" for k, t in parts.items())
                 or "not measured") + f" ({gpu})")

    # streaming reverb: time both continuation paths of process_stream
    # (each call as the caller sees it), at the flagship IR and at a
    # quarter of it, beside the path the dispatch picks
    for taps in (ir.size, ir.size // 4):
        rv = convert.convolver_from_numpy(ir[:taps], 10)
        span = rv.num_parts * rv.block
        for rows in (8, 64):
            st_w, _ = rv._process_stream_depthwise(rv.init_state((rows,)),
                                                   randn(rows, span))
            for n in (span // 4, span, 4 * span):
                xs = randn(rows, n)
                if rows == 8 and n == span:
                    st_a, y_a = rv._process_stream_depthwise(st_w, xs)
                    st_b, y_b = rv._process_stream_rehistory(st_w, xs)
                    torch.cuda.synchronize()
                    snr_y = snr_db(host(y_a), host(y_b))
                    snr_s = snr_db(host(st_a["fdl"]), host(st_b["fdl"]))
                    print(f"check stream paths P={rv.num_parts} {rows}x{n}: "
                          f"output SNR {snr_y:.1f} dB, state SNR {snr_s:.1f} dB")
                    assert snr_y >= 100 and snr_s >= 100
                t_d = time_ms(torch, lambda: rv._process_stream_depthwise(st_w, xs), 5)
                t_r = time_ms(torch, lambda: rv._process_stream_rehistory(st_w, xs), 5)
                pick = "rehistory" if rv.stream_rehistory(n) else "depthwise"
                print(f"time process_stream {rows} x {n} (P={rv.num_parts}, "
                      f"B={rv.block}): depthwise {t_d:.4f} ms, rehistory "
                      f"{t_r:.4f} ms, dispatch picks {pick} ({gpu})")

    # the chain per block: wall time over the 94 blocks of
    # process_blocks, and the device time of each kernel at the shape a
    # chain block gives it
    chain_ms = time_ms(torch, lambda: chain.process_blocks(c_state0, xc),
                       reps=3, warmup=1) / CHAIN_BLOCKS
    block_ms = CHAIN_BLOCK / SR * 1e3
    print(f"time chain per block ({CHAIN_CH}x{CHAIN_BLOCK}, mean over 3 x "
          f"{CHAIN_BLOCKS} blocks of process_blocks): {chain_ms:.4f} ms, "
          f"real-time factor {block_ms / chain_ms:.2f} ({gpu})")
    lp, moog_fx = chain.runtimes["lp"].effect, chain.runtimes["moog"].effect
    fir = chain.runtimes["eq"].effect
    xb1 = randn(CHAIN_CH, CHAIN_BLOCK)
    ext = randn(CHAIN_CH, fir.num_taps - 1 + CHAIN_BLOCK)
    Bc = fdlconv.pick_block(fir.num_taps, ext.shape[-1])
    nc = -(-(ext.shape[-1] + fir.num_taps - 1) // Bc) * Bc
    xfdl = torch.nn.functional.pad(ext, (0, nc - ext.shape[-1])).contiguous()
    hc = fir._spectra(Bc, dev)
    xm = 0.3 * randn(CHAIN_CH, CHAIN_BLOCK)
    st8m = torch.zeros(8, CHAIN_CH, device=dev)
    zc = torch.zeros(CHAIN_CH, device=dev)
    comp_core = chain.runtimes["comp"].effect.core
    ac = torch.full((CHAIN_CH,), comp_core.attack_coeff, device=dev)
    rc = torch.full((CHAIN_CH,), 1.0 - comp_core.release_coeff, device=dev)
    block_calls = {
        "biquad_cascade": lambda: bqmod.biquad_cascade(xb1, lp.runtime_sos, lp.gain),
        "moog_ladder": lambda: moog_call(moog_ops, moog_fx, xm, st8m),
        "envelope": lambda: envscan.envelope_scan_kernel(torch.abs(xb1), zc, ac, rc),
        "fdl_conv": lambda: fdlconv.fdl_conv(xfdl, hc, Bc)}
    per_block = {name: graph_ms(torch, f, 20) for name, f in block_calls.items()}
    h_fir = torch.as_tensor(fir.coeffs, dtype=torch.float32, device=dev)
    size = 1 << (nc + fir.num_taps - 1).bit_length()
    chain_lib = graph_ms(torch, lambda: torch.fft.irfft(
        torch.fft.rfft(xfdl, size) * torch.fft.rfft(h_fir, size),
        size)[..., :nc], 20)
    chain_b, chain_by = bound(*fdl_work(CHAIN_CH, nc, Bc, hc.shape[0]))
    print(f"time fdl_conv chain block {CHAIN_CH}x{nc} B={Bc} P={hc.shape[0]}: "
          f"kernel {per_block['fdl_conv']:.4f} ms (graph replay), library "
          f"{chain_lib:.4f} ms, bound {chain_b:.6f} ms ({chain_by}) ({gpu})")
    # the MAC's frame group G at the three shapes: with G = 1 a frame
    # spectrum is read P times per output frame, as by a MAC fused with
    # each frame's inverse FFT; with G, (G + P - 1) / G times
    for label, (xg, hg, bg) in {"flagship": (src, hs, B),
                                "chain": (xfdl, hc, Bc),
                                "folded": (xb, hb, Bb)}.items():
        planned = fdlconv.mac_plan(xg.shape[0], xg.shape[1] // bg, bg)[0]
        by_g = {g: graph_ms(torch, lambda g=g: fdlconv._launch(xg, hg, bg, g),
                            3 if label == "folded" else 20)
                for g in (1, 2, 4, 8, 16)}
        print(f"time fdl_conv by MAC group at the {label} shape (planned "
              f"G={planned}): " + ", ".join(
                  f"G={g} {t:.4f} ms" for g, t in by_g.items()) + f" ({gpu})")
    # where each shape's time goes: the FDL's three launches, and the
    # envelope at the flagship and chain shapes
    for label, (call, reps, prefixes) in {
            "fdl_conv flagship": (lambda: fdlconv.fdl_conv(src, hs, B), 20, ("fdl_",)),
            "fdl_conv chain block": (lambda: fdlconv.fdl_conv(xfdl, hc, Bc), 20, ("fdl_",)),
            "fdl_conv folded": (lambda: fdlconv.fdl_conv(xb, hb, Bb), 3, ("fdl_",)),
            "envelope flagship": (k4_call, 20, ("envelope_",)),
            "envelope chain block": (block_calls["envelope"], 20, ("envelope_",)),
            "biquad_cascade flagship (both calls)": (
                lambda: [f() for f in k3_calls], 20, ("biquad_",)),
            "biquad_cascade chain block": (
                block_calls["biquad_cascade"], 20, ("biquad_",))}.items():
        parts = kernel_breakdown(torch, call, reps, prefixes)
        print(f"time {label} by launch (profiler, device ms per call): "
              + (", ".join(f"{k} {t:.4f}" for k, t in parts.items())
                 or "not measured") + f" ({gpu})")
    kb["ms_by_shape"] = {"flagship": kb["ms"],
                         "chain": per_block["biquad_cascade"],
                         "512x2^16 S=15": k3_ms}
    kf["library_ms_by_shape"] = {"flagship": kf["library_ms"],
                                 "chain": chain_lib, "folded": fold_lib}
    kf["ms_by_shape"] = {"flagship": kf["ms"], "chain": per_block["fdl_conv"],
                         "folded": fold_k1}
    print(f"time chain kernels per block (graph replay; FDL at B={Bc}, "
          f"N={nc}, P={hc.shape[0]}): "
          + ", ".join(f"{n} {t:.4f} ms" for n, t in per_block.items())
          + f"; sum {sum(per_block.values()):.4f} ms of {chain_ms:.4f} ms "
          f"wall ({gpu})")

    # the Moog kernels at the shapes their paths give them: one chain
    # block (K5, Huovilainen at oversampling 4) and one block of the
    # direct ZDF path (K6, newton_iters 4)
    km = kernels["moog_ladder"]
    km["ms_at"] = (f"per chain block, {CHAIN_CH} x {CHAIN_BLOCK} Huovilainen "
                   f"at oversampling {moog_fx.oversampling}")
    km["ms"] = per_block["moog_ladder"]
    km["call_ms"] = time_ms(torch, block_calls["moog_ladder"], 20)
    km["plain_ms"] = time_ms(torch, lambda: moog_call(
        moog_ops, moog_fx, xm, st8m, plain=True), 1, warmup=0)
    km["bound_ms"], km["bound_by"] = bound(*moog_work(
        CHAIN_CH, CHAIN_BLOCK, MOOG_STEP_OPS["huovilainen"],
        moog_fx.oversampling))
    km["library_ms"] = None
    kz = kernels["moog_zdf"]
    kz["ms_at"] = f"per direct ZDF block, {CHAIN_CH} x {CHAIN_BLOCK} newton 4"
    xz1 = 0.5 * randn(CHAIN_CH, CHAIN_BLOCK)
    k6_call = lambda: moog_call(moog_ops, zdf, xz1, st8m)
    kz["ms"] = graph_ms(torch, k6_call, 20)
    kz["call_ms"] = time_ms(torch, k6_call, 20)
    kz["plain_ms"] = time_ms(torch, lambda: moog_call(
        moog_ops, zdf, xz1, st8m, plain=True), 1, warmup=0)
    kz["bound_ms"], kz["bound_by"] = bound(*moog_work(
        CHAIN_CH, CHAIN_BLOCK, zdf_step_ops(4)))
    kz["library_ms"] = None
    for name in ("moog_ladder", "moog_zdf"):
        k = kernels[name]
        print(f"time {name} {k['ms_at']}: kernel {k['ms']:.4f} ms (graph "
              f"replay; {k['call_ms']:.4f} ms as back-to-back calls), bound "
              f"{k['bound_ms']:.6f} ms ({k['bound_by']}), plain "
              f"{k['plain_ms']:.4f} ms, library none ({gpu})")

    # the A4 adjoints at the shapes the gradient paths give them: one chain
    # block (Huovilainen at os 4) and one direct ZDF block (newton 4), with
    # the checkpoint scratch each allocates (one state8 a segment); their
    # plain reverse sweeps on the card at the same shapes, once
    def adjoint_scratch(mf, c, t):
        rec = (moog_ops.zdf_record(mf.newton_iters)
               if mf.variant.value == "zdf" else moog_ops.LADDER_RECORD)
        seg = moog_ops.adjoint_plan(rec, 4)
        return seg, -(-t * mf.oversampling // seg) * 8 * c * 4

    gy_m, gst_m = randn(CHAIN_CH, CHAIN_BLOCK), randn(8, CHAIN_CH)
    for name, fwd_name, mf, xa, ops in [
            ("moog_ladder_adjoint", "moog_ladder", moog_fx, xm,
             MOOG_STEP_OPS["huovilainen"] + MOOG_ADJ_REVERSE_OPS),
            ("moog_zdf_adjoint", "moog_zdf", zdf, xz1,
             zdf_step_ops(4) + zdf_adjoint_reverse_ops(4))]:
        k = kernels[name]
        adj = lambda mf=mf, xa=xa, plain=False: moog_adjoint_call(
            moog_ops, mf, xa, st8m, gy_m, gst_m, plain=plain)
        k["ms_at"] = kernels[fwd_name]["ms_at"]
        k["ms"] = graph_ms(torch, adj, 20)
        k["call_ms"] = time_ms(torch, adj, 20)
        k["plain_ms"] = time_ms(torch, lambda adj=adj: adj(plain=True), 1,
                                warmup=0)
        k["bound_ms"], k["bound_by"] = bound(*moog_adjoint_work(
            CHAIN_CH, CHAIN_BLOCK, ops, mf.oversampling))
        k["library_ms"] = None
        seg, k["scratch_bytes"] = adjoint_scratch(mf, CHAIN_CH, CHAIN_BLOCK)
        print(f"time {name} {k['ms_at']}: kernel {k['ms']:.4f} ms (graph "
              f"replay; {k['call_ms']:.4f} ms as back-to-back calls; "
              f"{k['ms'] / kernels[fwd_name]['ms']:.2f}x the forward's), "
              f"bound {k['bound_ms']:.6f} ms ({k['bound_by']}; {ops} "
              f"operations a step), plain {k['plain_ms']:.4f} ms, library "
              f"none; segments of {seg} steps, checkpoint scratch "
              f"{k['scratch_bytes']} bytes ({gpu})")

    # K5 (classic) and K6 at the JAX package's benchmark shape, 128 x 2^16
    # (benchmarks/run_benchmarks.py:396-405), and their adjoints; the plain
    # forward versions on the card at 128 x 256, one Python step per sample
    cm, tm = 128, 1 << 16
    xw = randn(cm, tm)
    stw = torch.zeros(8, cm, device=dev)
    gyw, gstw = randn(cm, tm), randn(8, cm)
    for label, mf, ops, adj_ops in [
            ("moog_ladder classic", MoogFilter(SR, cutoff_hz=2000.0,
                                               resonance=0.5),
             MOOG_STEP_OPS["classic"],
             MOOG_STEP_OPS["classic"] + MOOG_ADJ_REVERSE_OPS),
            ("moog_zdf newton 4", MoogFilter(
                SR, variant=MoogVariant.ZDF, cutoff_hz=2000.0, resonance=0.5,
                newton_iters=4), zdf_step_ops(4),
             zdf_step_ops(4) + zdf_adjoint_reverse_ops(4))]:
        t_graph = graph_ms(torch, lambda: moog_call(moog_ops, mf, xw, stw), 3)
        t_call = time_ms(torch, lambda: moog_call(moog_ops, mf, xw, stw), 3,
                         warmup=1)
        t_plain = time_ms(torch, lambda: moog_call(
            moog_ops, mf, xw[:, :256], stw, plain=True), 1, warmup=0)
        b_ms, b_by = bound(*moog_work(cm, tm, ops))
        print(f"time {label} {cm}x{tm}: kernel {t_graph:.4f} ms (graph "
              f"replay; {t_call:.4f} ms as back-to-back calls), "
              f"{t_graph / tm * 1e6:.2f} ns per dependent step, bound "
              f"{b_ms:.6f} ms ({b_by}; {ops} operations a step), plain "
              f"{t_plain:.4f} ms at {cm}x256 ({gpu})")
        adj = lambda: moog_adjoint_call(moog_ops, mf, xw, stw, gyw, gstw)
        a_graph = graph_ms(torch, adj, 3)
        a_b, a_by = bound(*moog_adjoint_work(cm, tm, adj_ops))
        seg, scratch = adjoint_scratch(mf, cm, tm)
        ka_w = kernels["moog_zdf_adjoint" if mf.variant.value == "zdf"
                       else "moog_ladder_adjoint"]
        ka_w["ms_by_shape"] = {"path block": ka_w["ms"], f"{cm}x{tm}": a_graph}
        print(f"time {label} adjoint {cm}x{tm}: kernel {a_graph:.4f} ms "
              f"(graph replay; {a_graph / t_graph:.2f}x the forward's), "
              f"{a_graph / tm * 1e6:.2f} ns per step, bound {a_b:.6f} ms "
              f"({a_by}), segments of {seg} steps, checkpoint scratch "
              f"{scratch} bytes ({gpu})")

    # -- 7. train: the trainer of examples/gradient_eq_fit.py ---------------------
    # Each driven part runs inside `counted`, which adds its launches to the
    # phase's counts; the comparisons with the CPU path and with the plain
    # versions run outside those windows.
    t_train = time.perf_counter()
    train_counts = {name: 0 for name in kernels}

    def counted(fn):
        before = {name: k["wrapper"].launches for name, k in kernels.items()}
        out = fn()
        torch.cuda.synchronize()
        delta = {name: k["wrapper"].launches - before[name]
                 for name, k in kernels.items()}
        for name, d in delta.items():
            train_counts[name] += d
        return out, delta

    @contextlib.contextmanager
    def plain_calls(targets):
        """Count the calls of the plain versions (module attributes) while
        the block runs."""
        calls = {name: 0 for _, name in targets}
        saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

        def wrap(name, fn):
            def counting(*args, **kwargs):
                calls[name] += 1
                return fn(*args, **kwargs)
            return counting

        for mod, name, fn in saved:
            setattr(mod, name, wrap(name, fn))
        try:
            yield calls
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)

    def events_ms(fn, reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    no_kernel = {name: 0 for name in kernels}

    # 7a. IR learning: the flagship's 2^15-tap IR recovered from 8 x 48128
    # samples of input and output, through kernel_spectra_torch and the FDL
    B_ir, P_ir, steps_ir = IR_BLOCK, IR_PARTS, 300
    assert ir.size == B_ir * P_ir
    x_ir = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (CHANNELS, N_FLAGSHIP)).astype(np.float32), device=dev)
    true_ir = torch.as_tensor(ir, device=dev)
    with torch.no_grad():
        y_obs = fdlconv.fdl_conv(x_ir, torch.as_tensor(
            fdlconv.kernel_spectra(ir, B_ir), device=dev), B_ir)

    def ir_loss(h, x_in, y_ref):
        y_ir = fdlconv.fdl_conv(x_in, fdlconv.kernel_spectra_torch(h, B_ir, P_ir),
                                B_ir)
        return torch.mean((y_ir - y_ref) ** 2)

    def ir_grad_cpu64(h):
        h64 = h.detach().cpu().double().requires_grad_()
        ir_loss(h64, x_ir.cpu().double(), y_obs.cpu().double()).backward()
        return h64.grad.numpy()

    h_ir = torch.zeros(P_ir * B_ir, device=dev, requires_grad=True)
    opt_ir = torch.optim.Adam([h_ir], lr=0.02)

    def ir_fwd_bwd():
        opt_ir.zero_grad()
        loss = ir_loss(h_ir, x_ir, y_obs)
        loss.backward()
        return loss.detach()

    loss0, per_step = counted(ir_fwd_bwd)
    snr_g0 = snr_db(ir_grad_cpu64(h_ir), host(h_ir.grad))
    counted(opt_ir.step)

    def ir_steps(n):
        for _ in range(n):
            ir_fwd_bwd()
            opt_ir.step()

    ir_ms, _ = counted(lambda: events_ms(lambda: ir_steps(1), steps_ir - 2))
    loss_last, _ = counted(ir_fwd_bwd)
    snr_gl = snr_db(ir_grad_cpu64(h_ir), host(h_ir.grad))
    counted(opt_ir.step)
    err_ir = host(h_ir) - ir
    ir_snr = 10.0 * math.log10(float(np.sum(ir.astype(np.float64) ** 2))
                               / float(np.sum(err_ir.astype(np.float64) ** 2)))
    print(f"train IR learning {CHANNELS}x{N_FLAGSHIP} B={B_ir} P={P_ir}, "
          f"{steps_ir} Adam steps at lr 0.02: loss {float(loss0):.6e} -> "
          f"{float(loss_last):.6e}, recovered IR at {ir_snr:.2f} dB SNR, "
          f"{ir_ms:.4f} ms per step (CUDA events over {steps_ir - 2} steps), "
          f"launches per step {json.dumps(per_step)}; dL/dh vs the CPU path "
          f"in float64: step 0 {snr_g0:.1f} dB, last step {snr_gl:.1f} dB "
          f"({gpu})")
    assert per_step == {**no_kernel, "fdl_conv": 1, "fdl_spectra_adjoint": 1}
    assert snr_g0 >= 80 and snr_gl >= 80 and float(loss_last) < float(loss0)

    # 7b. the flagship's gradient in x and in a scalar input gain (the
    # example's compressor gradient, on the whole pipeline)
    gain_f = torch.tensor(1.0, device=dev, requires_grad=True)
    x_f = x.clone().requires_grad_()
    state_f = pipe.init_state(CHANNELS)

    def flag_loss():
        y_fl, _ = pipe.forward(gain_f * x_f, state_f)
        return torch.mean(y_fl * y_fl)

    plain_targets = [(bqmod, "biquad_cascade_plain"), (linrec, "run_sections"),
                     (envscan, "envelope_scan_plain"),
                     (envscan, "envelope_adjoint_plain"),
                     (fdlconv, "fdl_conv_plain"), (fdlconv, "frame_spectra_plain"),
                     (fdlconv, "_fdl_from_spectra"),
                     (fdlconv, "fdl_spectra_adjoint_plain")]
    with plain_calls(plain_targets) as plain_n:
        loss_f, fwd_launches = counted(flag_loss)
        _, bwd_launches = counted(loss_f.backward)
    print(f"train flagship gradient {CHANNELS}x{N_FLAGSHIP}: launches forward "
          f"{json.dumps(fwd_launches)}, backward {json.dumps(bwd_launches)}; "
          f"plain versions called {sum(plain_n.values())} times")
    assert fwd_launches == {**no_kernel, "biquad_cascade": 2, "envelope": 1,
                            "fdl_conv": 1}
    assert bwd_launches == {**no_kernel, "biquad_cascade": 2,
                            "envelope_adjoint": 1, "fdl_conv": 1}
    assert not any(plain_n.values()), plain_n
    x64 = x.detach().cpu().double().requires_grad_()
    gain64 = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    y64f, _ = pipe_cpu.forward(gain64 * x64,
                               pipe_cpu.init_state(CHANNELS, torch.float64, "cpu"))
    torch.mean(y64f * y64f).backward()
    snr_dx = snr_db(x64.grad.numpy(), host(x_f.grad))
    snr_dg = snr_db([float(gain64.grad)], [float(gain_f.grad)])
    # selection ties: the attack/release selections of the card's float32
    # trajectory against the float64 one, and envelope_adjoint on the
    # card's own trajectory with the cotangent the pipeline gives it
    core_f = pipe.compressor.core
    with torch.no_grad():
        y2_f = pipe.weighting.process(pipe.cascade.process(x))
        src_f = torch.abs(y2_f)
        src64 = torch.abs(pipe_cpu.weighting.process(
            pipe_cpu.cascade.process(x.cpu().double())))
        _, tr_f = envscan.envelope_scan(src_f, 0.0, a_main, r_main)
        _, tr64 = envscan.envelope_scan(src64, 0.0, a_main, r_main)
    prev = lambda tr: torch.cat([torch.zeros_like(tr[:, :1]), tr[:, :-1]], -1)
    flips = int(torch.sum((src_f > prev(tr_f)).cpu() != (src64 > prev(tr64))))
    tr_r = tr_f.clone().requires_grad_()
    y_r = pipe.reverb.process(y2_f * core_f.gain_for_level(tr_r)
                              * core_f.makeup_gain_lin)
    (g_tr,) = torch.autograd.grad(torch.mean(y_r * y_r), tr_r)
    zeros_f = torch.zeros(CHANNELS, device=dev)
    adj_args = (src_f, tr_f, zeros_f, torch.full_like(zeros_f, a_main),
                torch.full_like(zeros_f, r_main), g_tr, zeros_f)
    own = envscan.envelope_adjoint(*adj_args)[0]
    own64 = envscan.envelope_adjoint_plain(*(v.cpu().double() for v in adj_args))[0]
    snr_own = snr_db(own64.numpy(), host(own))
    fwd_ms = time_ms(torch, flag_loss, reps=10)
    fb_ms = time_ms(torch, lambda: flag_loss().backward(), reps=10)
    print(f"train flagship gradient vs the CPU path in float64: dx "
          f"{snr_dx:.1f} dB, d/dgain {snr_dg:.1f} dB (gain grad "
          f"{float(gain_f.grad):.6e}); selections flipped between the card's "
          f"float32 and the float64 trajectory {flips} of "
          f"{CHANNELS * N_FLAGSHIP}; envelope_adjoint on the card's own "
          f"trajectory vs plain f64 {snr_own:.1f} dB; forward {fwd_ms:.4f} "
          f"ms, forward + backward {fb_ms:.4f} ms (means of 10) ({gpu})")
    assert snr_dx >= 80 and snr_dg >= 80 and snr_own >= 100

    # 7c. the example's 3-band EQ fit through diff.py's designers and
    # sos_magnitude_db, 800 Adam steps at lr 0.05
    freqs_eq = np.geomspace(30.0, 20000.0, 128)
    hidden = np.stack([design.low_shelf(150.0, 3.0, 0.8, SR),
                       design.peak(1200.0, -6.0, 2.0, SR),
                       design.high_shelf(8000.0, 4.5, 0.7, SR)])
    target_db = torch.as_tensor(20.0 * np.log10(np.abs(
        sos_response(hidden, freqs_eq, SR))), device=dev)
    freqs_t = torch.as_tensor(freqs_eq, device=dev)
    # diff.py runs on the card unless told otherwise: Python numbers
    # alone design there, and host coefficients follow the card's freqs
    assert diff.peak(1200.0, -6.0, 2.0, SR).device.type == "cuda"
    assert diff.sos_magnitude_db(hidden, freqs_t, SR).device == freqs_t.device

    def eq_build(raw):
        return torch.stack([
            diff.low_shelf(diff.constrain(raw[0], 40.0, 800.0),
                           12.0 * torch.tanh(raw[1]),
                           diff.constrain(raw[2], 0.3, 4.0), SR),
            diff.peak(diff.constrain(raw[3], 300.0, 6000.0),
                      12.0 * torch.tanh(raw[4]),
                      diff.constrain(raw[5], 0.3, 6.0), SR),
            diff.high_shelf(diff.constrain(raw[6], 2000.0, 16000.0),
                            12.0 * torch.tanh(raw[7]),
                            diff.constrain(raw[8], 0.3, 4.0), SR)])

    raw_eq = torch.zeros(9, device=dev, requires_grad=True)
    opt_eq = torch.optim.Adam([raw_eq], lr=0.05)

    def eq_step():
        opt_eq.zero_grad()
        loss = torch.mean((diff.sos_magnitude_db(eq_build(raw_eq), freqs_t, SR)
                           - target_db) ** 2)
        loss.backward()
        opt_eq.step()

    eq_ms, eq_launches = counted(lambda: events_ms(eq_step, 800))
    with torch.no_grad():
        eq_err = float(torch.max(torch.abs(diff.sos_magnitude_db(
            eq_build(raw_eq), freqs_t, SR) - target_db)))
    print(f"train EQ fit (3 bands, 128 frequencies), 800 Adam steps at lr "
          f"0.05: max response error {eq_err:.4f} dB, {eq_ms:.4f} ms per step "
          f"(CUDA events), kernel launches {sum(eq_launches.values())} ({gpu})")
    assert eq_err < 0.5

    for name, k in kernels.items():
        k["by_path"]["train"] = train_counts[name]
    print(f"train launches: {json.dumps(train_counts)}; phase "
          f"{time.perf_counter() - t_train:.2f} s")
    assert all(train_counts[name] > 0 for name in (
        "biquad_cascade", "envelope", "fdl_conv", "envelope_adjoint",
        "fdl_spectra_adjoint")), train_counts

    # -- 8. moog gradient: the Moog ladders differentiated on the card --------------
    # The chain's filter-moog node (Huovilainen at os 4) and the direct ZDF
    # ladder of phase 5, each streamed over 64 ch x 94 blocks of 512 under
    # autograd with the state carried from block to block, from a random
    # state; loss sum(y w) + sum(final stages v), differentiated in x and in
    # the initial state. Held: the float32 gradients against the card's
    # float64 run at 80 dB (tests/test_diff.py's bar), and the first 2
    # blocks against the CPU plain path in float64. Then a fit: a scalar
    # input gain in front of the chain's node, from 1.0 to the 1.7 that made
    # the target, over 8 streamed blocks with torch.optim.Adam. Only the
    # float32 runs on the card count as the path's launches.
    t_mg = time.perf_counter()
    mg_counts = {name: 0 for name in kernels}
    moog_plain = [(moog_ops, n) for n in (
        "moog_ladder_plain", "moog_zdf_plain", "moog_ladder_adjoint_plain",
        "moog_zdf_adjoint_plain")]

    def mg_counted(fn):
        before = {name: k["wrapper"].launches for name, k in kernels.items()}
        out = fn()
        torch.cuda.synchronize()
        delta = {name: k["wrapper"].launches - before[name]
                 for name, k in kernels.items()}
        for name, d in delta.items():
            mg_counts[name] += d
        return out, delta

    mg_rng = np.random.default_rng(5)
    x_mg = xc_np                       # the chain's input, 64 x 94 blocks
    w_mg = mg_rng.standard_normal(x_mg.shape).astype(np.float32)
    v_mg = mg_rng.standard_normal((CHAIN_CH, 4)).astype(np.float32)
    st_mg = {"stage": 0.2 * mg_rng.standard_normal((CHAIN_CH, 4)),
             "tanh_last": 0.2 * mg_rng.standard_normal((CHAIN_CH, 3)),
             "prev_out": 0.2 * mg_rng.standard_normal(CHAIN_CH)}

    def stream_loss(mf, blocks, device, dtype):
        """The streamed forward of the loss; returns (loss, x, state0)."""
        as_t = lambda v: torch.as_tensor(np.asarray(v), dtype=dtype,
                                         device=device)
        n = blocks * CHAIN_BLOCK
        x_t = as_t(x_mg[:, :n]).requires_grad_()
        st0 = {k: as_t(v).requires_grad_() for k, v in st_mg.items()}
        state = st0
        ys = []
        for b in range(blocks):
            state, y_b = mf.process(state, x_t[:, b * CHAIN_BLOCK:
                                               (b + 1) * CHAIN_BLOCK])
            ys.append(y_b)
        loss = (torch.sum(torch.cat(ys, -1) * as_t(w_mg[:, :n]))
                + torch.sum(state["stage"] * as_t(v_mg)))
        return loss, x_t, st0

    def grads(loss, x_t, st0):
        loss.backward()
        return [host(x_t.grad)] + [host(st0[k].grad) for k in
                                   ("stage", "tanh_last", "prev_out")]

    mg_names = ("dx", "dstage", "dtanh_last", "dprev_out")
    for label, mf, fwd_name in [("chain filter-moog node", moog_fx,
                                 "moog_ladder"),
                                ("ZDF MoogFilter", zdf, "moog_zdf")]:
        adj_name = fwd_name + "_adjoint"
        with plain_calls(moog_plain) as plain_n:
            (loss_m, x_t, st0), fwd_l = mg_counted(
                lambda: stream_loss(mf, CHAIN_BLOCKS, dev, torch.float32))
            g32, bwd_l = mg_counted(lambda: grads(loss_m, x_t, st0))
        print(f"moog grad {label} {CHAIN_CH}x{CHAIN_BLOCKS * CHAIN_BLOCK} in "
              f"{CHAIN_BLOCKS} blocks: launches forward {json.dumps(fwd_l)}, "
              f"backward {json.dumps(bwd_l)}; plain versions called "
              f"{sum(plain_n.values())} times")
        assert fwd_l == {**no_kernel, fwd_name: CHAIN_BLOCKS}, fwd_l
        assert bwd_l == {**no_kernel, adj_name: CHAIN_BLOCKS}, bwd_l
        assert not any(plain_n.values()), plain_n
        assert loss_m.grad_fn is not None
        g64 = grads(*stream_loss(mf, CHAIN_BLOCKS, dev, torch.float64))
        snr64 = [snr_db(r, g) for r, g in zip(g64, g32)]
        finite = all(np.all(np.isfinite(g)) for g in g32)
        g2 = grads(*stream_loss(mf, 2, dev, torch.float32))
        g2_cpu = grads(*stream_loss(mf, 2, "cpu", torch.float64))
        snr_cpu = [snr_db(r, g) for r, g in zip(g2_cpu, g2)]
        # Huovilainen never reads the tanh rows; ZDF passes them through to
        # a final state the loss does not weigh
        exact = not np.any(g32[2])
        mg_ms = time_ms(torch, lambda: grads(*stream_loss(
            mf, CHAIN_BLOCKS, dev, torch.float32)), 3, warmup=1)
        # ZDF's d(prev_out) is the sensitivity to the Newton starting guess,
        # ~0: its size is printed, not an SNR
        n_snr = 3 if fwd_name == "moog_zdf" else 4
        prev_size = ("" if n_snr == 4 else
                     f"; max|dprev_out| float32 {np.max(np.abs(g32[3])):.1e}, "
                     f"float64 {np.max(np.abs(g64[3])):.1e} (max|dx| "
                     f"{np.max(np.abs(g64[0])):.1e})")
        print(f"moog grad {label}: float32 vs the card's float64 "
              + ", ".join(f"{n} {v:.1f}" for n, v in
                          zip(mg_names[:n_snr], snr64))
              + " dB; first 2 blocks vs the CPU plain path in float64 "
              + ", ".join(f"{v:.1f}" for v in snr_cpu[:n_snr]) + " dB"
              + prev_size + f"; finite "
              f"{finite}; d(tanh_last) exactly 0 {exact}; forward + backward "
              f"{mg_ms:.4f} ms ({mg_ms / CHAIN_BLOCKS:.4f} ms per block, "
              f"mean of 3) ({gpu})")
        assert finite and exact
        assert min(snr64[:2]) >= 80 and min(snr_cpu[:2]) >= 80, (label,
                                                                   snr64)

    # the fit: y = node(g x) over 8 streamed blocks from zero state against
    # node(1.7 x); Adam on g from 1.0
    n_fit, steps_fit, g_true = 8 * CHAIN_BLOCK, 200, 1.7
    x_fit = torch.as_tensor(x_mg[:, :n_fit], device=dev)

    def node_stream(xv):
        return streaming.scan_blocks(moog_fx.process, moog_fx.init_state(
            (CHAIN_CH,)), xv, block_size=CHAIN_BLOCK)[1]

    with torch.no_grad():
        y_fit = node_stream(g_true * x_fit)
    g_fit = torch.tensor(1.0, device=dev, requires_grad=True)
    opt_fit = torch.optim.Adam([g_fit], lr=0.02)

    def fit_step():
        opt_fit.zero_grad()
        loss = torch.mean((node_stream(g_fit * x_fit) - y_fit) ** 2)
        loss.backward()
        opt_fit.step()
        return loss.detach()

    loss_f0, fit_l = mg_counted(fit_step)
    fit_ms, _ = mg_counted(lambda: events_ms(fit_step, steps_fit - 2))
    loss_fl, _ = mg_counted(fit_step)
    g_val = float(g_fit.detach())
    g_err = abs(g_val - g_true)
    print(f"moog grad fit of an input gain in front of the chain's node, "
          f"{CHAIN_CH}x{n_fit} in 8 blocks, {steps_fit} Adam steps at lr 0.02: "
          f"g {g_val:.6f}, |g - {g_true}| {g_err:.3e}, loss "
          f"{float(loss_f0):.6e} -> {float(loss_fl):.6e}, {fit_ms:.4f} ms per "
          f"step (CUDA events), launches per step {json.dumps(fit_l)} ({gpu})")
    assert fit_l == {**no_kernel, "moog_ladder": 8, "moog_ladder_adjoint": 8}
    assert g_err < 1e-3 and float(loss_fl) < float(loss_f0)

    for name, k in kernels.items():
        k["by_path"]["moog_grad"] = mg_counts[name]
        k["launches"] = sum(k["by_path"].values())
    print(f"moog grad launches: {json.dumps(mg_counts)}; phase "
          f"{time.perf_counter() - t_mg:.2f} s")
    assert all(mg_counts[name] > 0 for name in (
        "moog_ladder", "moog_zdf", "moog_ladder_adjoint",
        "moog_zdf_adjoint")), mg_counts

    # -- 9. kernel list ----------------------------------------------------------
    line = {"kernels": [{
        "name": name, "route": k["route"], "source": k["source"],
        "replaces": k["replaces"], "launches": k["launches"],
        "launches_by_path": k["by_path"],
        "max_abs_err": max(k["errs"]), "ms": k["ms"], "ms_at": k["ms_at"],
        "call_ms": k["call_ms"], "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
        "library_ms": k["library_ms"], "checked": True,
        **{key: k[key] for key in ("library_ms_by_shape", "ms_by_shape",
                                   "counts_by_path", "dv_fft_ms",
                                   "scratch_bytes") if key in k}}
        for name, k in kernels.items()]}
    print(json.dumps(line))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
