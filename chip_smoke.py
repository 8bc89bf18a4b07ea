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
               every B from 2 to 8192);
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
               chain's time per block and real-time factor, and the two
               Moog kernels at 128 ch x 2^16.
The line before the last is the card's name and power limit; the last is
{"ok": true, "device": {...}}. Any failed check exits non-zero. There is
no CPU fallback: without CUDA, or without the package beside this file,
the script fails.
"""

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


def moog_work(c, t, ops_per_step):
    """Bytes (x in, y out, state8 in and out) and operations of a Moog
    ladder over (C, T) float32."""
    return 8.0 * c * t + 64.0 * c, float(ops_per_step) * c * t


def moog_call(moog_ops, mf, x, st8, plain=False):
    """The K5 or K6 wrapper (or its plain version) for MoogFilter `mf`."""
    p = mf.kernel_params()
    if mf.variant.value == "zdf":
        fn = moog_ops.moog_zdf_plain if plain else moog_ops.moog_zdf
        return fn(x, st8, p, newton_iters=mf.newton_iters)
    fn = moog_ops.moog_ladder_plain if plain else moog_ops.moog_ladder
    return fn(x, st8, p, fast_tanh="lightweight" in mf.variant.value,
              huovilainen=mf.variant.value == "huovilainen")


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

    from algodsp_tpu_torch import _build, convert, streaming
    from algodsp_tpu_torch.chain import Chain
    from algodsp_tpu_torch.filters import BiquadChain
    from algodsp_tpu_torch.filters.design import butterworth_lp
    from algodsp_tpu_torch.filters.fir import FIRFilter
    from algodsp_tpu_torch.filters.moog import MoogFilter, MoogVariant
    from algodsp_tpu_torch.filters.weighting import WeightingType, weighting_chain
    from algodsp_tpu_torch.ops import biquad_cascade as bqmod
    from algodsp_tpu_torch.ops import envscan, fdlconv
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
    # chain's main shape (64 x 2048, a 512-sample block at
    # oversampling 4, zero-stuffed as MoogFilter.process does), C = 1
    # (T = 1024),
    # C = 3 with T = 1000 from a nonzero state, and the state-clip case
    # of tests/test_pallas.py (DC of 100, Vt = 20). Bars: atol 1e-5 on y
    # and the state (1e-4 in the clip case), the JAX package's bars
    # against its scan, and SNR >= 100 dB. The plain versions run on host
    # copies of the same inputs: one Python step per sample costs ~20 us
    # per tensor op on the card and a few on the host.
    def stuffed(c, n, os=4, amp=0.3):
        xs = torch.zeros(c, n * os, device=dev)
        xs[:, ::os] = os * amp * randn(c, n)
        return xs

    moog_cases = [
        ("main", dict(cutoff_hz=2000.0, resonance=2.0, thermal_voltage=0.5,
                      oversampling=4), lambda: stuffed(CHAIN_CH, CHAIN_BLOCK),
         False, 1e-5),
        ("C=1", dict(cutoff_hz=2000.0, resonance=2.0, thermal_voltage=0.5,
                     oversampling=4), lambda: stuffed(1, CHAIN_BLOCK // 2),
         False, 1e-5),
        ("C=3 T=1000 state", dict(cutoff_hz=2000.0, resonance=2.0,
                                  thermal_voltage=0.5),
         lambda: 0.3 * randn(3, 1000), True, 1e-5),
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
            s_k, y_k = moog_call(moog_ops, mf, xm, st8)
            s_p, y_p = moog_call(moog_ops, mf, xm.cpu(), st8.cpu(), plain=True)
            y_k, s_k = y_k.cpu(), s_k.cpu()
            err = float(torch.max(torch.abs(y_k - y_p)))
            s_err = float(torch.max(torch.abs(s_k - s_p)))
            snr = snr_db(y_p.numpy(), y_k.numpy())
            kernels[name]["errs"].append(err)
            print(f"check {name} {variant} (newton {iters}) {label}: "
                  f"C={xm.shape[0]} T={xm.shape[1]} max|err| y {err:.3e} "
                  f"state {s_err:.3e}, SNR vs plain {snr:.1f} dB")
            assert err <= atol and s_err <= atol and snr >= 100, \
                (name, variant, label)
    # one float64 call of each kernel: the same template in double; FMA
    # contraction is all that separates it from the plain version
    for variant in ("huovilainen", "zdf"):
        name = "moog_zdf" if variant == "zdf" else "moog_ladder"
        mf = MoogFilter(SR, variant=MoogVariant(variant), cutoff_hz=2000.0,
                        resonance=2.0, thermal_voltage=0.5, oversampling=4)
        xm = stuffed(CHAIN_CH, CHAIN_BLOCK).double()
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
    # distance from the float64 plain version is printed (on an H100:
    # 122.4 dB for K5, 105.1 dB for K6, at most 2.0e-6)
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
                        "moog_ladder": 0, "moog_zdf": 0}, launches
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
                        "moog_ladder": CHAIN_BLOCKS, "moog_zdf": 0}, launches
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
        k["launches"] = sum(k["by_path"].values())
    print(f"ZDF MoogFilter launches over {CHAIN_BLOCKS} blocks of "
          f"{CHAIN_CH}x{CHAIN_BLOCK}: {json.dumps(launches)}")
    assert launches == {"biquad_cascade": 0, "envelope": 0, "fdl_conv": 0,
                        "moog_ladder": 0, "moog_zdf": CHAIN_BLOCKS}, launches
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
    xm = stuffed(CHAIN_CH, CHAIN_BLOCK)
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
    km["ms_at"] = f"per chain block, {CHAIN_CH} x {4 * CHAIN_BLOCK} Huovilainen"
    km["ms"] = per_block["moog_ladder"]
    km["call_ms"] = time_ms(torch, block_calls["moog_ladder"], 20)
    km["plain_ms"] = time_ms(torch, lambda: moog_call(
        moog_ops, moog_fx, xm, st8m, plain=True), 1, warmup=0)
    km["bound_ms"], km["bound_by"] = bound(*moog_work(
        CHAIN_CH, 4 * CHAIN_BLOCK, MOOG_STEP_OPS["huovilainen"]))
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

    # K5 (classic) and K6 at the JAX package's benchmark shape, 128 x 2^16
    # (benchmarks/run_benchmarks.py:396-405); the plain versions on the
    # card at 128 x 256, one Python step per sample
    cm, tm = 128, 1 << 16
    xw = randn(cm, tm)
    stw = torch.zeros(8, cm, device=dev)
    for label, mf, ops in [
            ("moog_ladder classic", MoogFilter(SR, cutoff_hz=2000.0,
                                               resonance=0.5),
             MOOG_STEP_OPS["classic"]),
            ("moog_zdf newton 4", MoogFilter(
                SR, variant=MoogVariant.ZDF, cutoff_hz=2000.0, resonance=0.5,
                newton_iters=4), zdf_step_ops(4))]:
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

    # -- 7. kernel list ----------------------------------------------------------
    line = {"kernels": [{
        "name": name, "route": k["route"], "source": k["source"],
        "replaces": k["replaces"], "launches": k["launches"],
        "launches_by_path": k["by_path"],
        "max_abs_err": max(k["errs"]), "ms": k["ms"], "ms_at": k["ms_at"],
        "call_ms": k["call_ms"], "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
        "library_ms": k["library_ms"], "checked": True,
        **{key: k[key] for key in ("library_ms_by_shape", "ms_by_shape",
                                   "counts_by_path") if key in k}}
        for name, k in kernels.items()]}
    print(json.dumps(line))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
