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
               multiple, C = 65, a cluster at a T that is no part or
               chunk multiple and one block a channel at C = SMs/2 + 1,
               and 2^20 samples at C = 2 in float32, each run twice bit
               for bit; the FDL spectra adjoint with C = 1, an odd C,
               P > F, F = 1 and B = 8192 with a P that its G does not
               divide, bit-equal for every G and on a second run); the
               Moog adjoints (A4) at the chain
               block, the direct ZDF block, C = 65, T = 1, T = 333, os 1,
               2, 4 and 8, newton 1-8, float64, the clip case, a
               Huovilainen state whose tanh rows are not tanh(ds s) and
               NaN in x, each with its recomputed final state against
               the forward's bit for bit; on every Moog case the recording
               K5 / K6 bit-equal to K5 / K6, and the reverse kernels over
               their record bit-equal to the adjoints (ZDF: at the adjoints'
               bars, its quotients formed from 1 / J; bits printed); a
               block whose record passes the budget through the
               checkpoint adjoint, with the record route's gradients) and each
               autograd Function's
               gradients on the card against the CPU path's, then one
               check per fault of the port (ROADMAP.md section 3): the
               explicit-state cascade and the raw envelope kernel refuse
               a CUDA tensor that requires grad while the cascade,
               envelope, FDL, fftconvolve and Moog calls carry a grad_fn, a
               float64 Compressor with sidechain prefilters (and the
               gradient of a float32 one), a 70-section float32 chain in
               auto mode, and envelope_scan with T = 0; D1, the feedback
               dynamics kernel, against its plain version on the card and
               on the CPU (three compressors, float32 and float64, the
               chain block, C = 65 at T = 1 and 333, NaN and +-inf in x,
               two calls bit-equal to one); fault 6 (the blocked and
               whole-cascade engines under set_float32_matmul_precision(
               "high") bit-equal to the default, the setting restored);
               the whole-cascade engine against float64, streamed, and
               the three engines' times behind the auto dispatch;
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
               the training shapes, and the two Moog adjoints, the
               recording K5 / K6 and the two reverse kernels at the
               chain block, the ZDF block and 128 ch x 2^16 (record
               bytes and bounds); the two adjoint kernels' earlier
               times, shares of their bounds, the spectra adjoint's
               operations at the FP64 rate of its float64 sums, and its
               batched-matmul yardstick.
  7. train   — the trainer of examples/gradient_eq_fit.py at the
               flagship's width with torch.optim.Adam: IR learning of
               the flagship's 2^15-tap IR through kernel_spectra_torch
               and the FDL (8 ch x 48128, B = 1024, P = 32, 300 steps),
               the gradient of the flagship forward in x and in an input
               gain, and the 3-band EQ fit through diff.py (800 steps);
               each held against the CPU path in float64 or the
               example's own bar, with the launches of the backward;
               the step times beside their adjoint kernels' times;
  8. moog grad — the Moog gradient path: the chain's filter-moog node
               (Huovilainen, os 4) and the direct ZDF ladder streamed
               over 64 ch x 94 blocks of 512 under autograd with the
               state carried, differentiated in x and the initial state
               (a recording forward and one reverse launch a block, no
               checkpoint adjoint, no plain version), held against the
               card's float64 run and, for 2 blocks, the CPU plain path
               in float64; a fit of an input gain in front of the chain's
               node over 8 streamed blocks (Adam); and 8 blocks of each
               over the record budget (K5 / K6, then the checkpoint
               adjoint), against the record route's gradients;
  9. dynamics — the dynamics family through the effect chain: DYN_GRAPH
               (gate -> feedback compressor -> split-band de-esser ->
               3-band multiband compressor -> lookahead limiter) and
               SPLIT_GRAPH (split-freq -> transient shaper / expander ->
               limiter) over 64 ch x 94 blocks of 512, launches per block
               by kernel (K3, K4, D1; no plain version called), 8 blocks
               against the plain CPU path, the gate's decisions against
               the CPU path's, ms per block and real-time factor; the
               feedback Compressor called directly at 8 ch x 48128 in
               float32 and float64; D1's times beside its byte bound and
               the chain bound of its dependent walk;
 10. analysis — the analysis slice at full width: the OctaveAnalyzer
               (1/3 octave, 30 bands, order 4) streamed over 64 ch x 94
               blocks of 512 (K4 once a block on 1920 rows) and one-shot
               at 8 ch x 48128, the MultirateOctaveAnalyzer (order 10) at
               8 x 48128, the STFT path (stft -> istft, a 64-mel
               spectrogram, Goertzel at the 30 band centres), the default
               HilbertTransformer (its two allpass chains on K3) and 2^24
               samples of white and pink noise; each against the port's
               CPU path in float64, float32 and float64 on the card, with
               its bar, its time, its K3 and K4 launches and no plain
               version called; the TF32 check (mel, Goertzel, the banded
               engine and the resampler bit-equal under a caller's
               set_float32_matmul_precision("high") and
               cudnn.allow_tf32 = True);
 11. space — the delay feedback and reverb slice: R1-R3 (the Delay,
               Freeverb and FDN feedback loops) against their plain
               versions on the card (C = 65, the chain block, a ragged
               length, lags under 130 and under a chunk, float32 and
               float64, two calls bit-equal to one); SPACE_GRAPH (low-cut
               -> delay -> Freeverb -> FDN) streamed over 64 ch x 94
               blocks of 512 in float32 and float64 and fused (low-cut and
               delay in one FIR on K1), each with its first 32 blocks
               against the CPU path in float64, with its launches per
               block, no plain version called, ms per block, real-time
               factor and device time;
               Freeverb, the FDN and the Delay (retargeted mid-stream) as
               one-shot renders at 8 x 48128; direct, convolve, the
               overlap convolvers streamed, correlate (the peak lags) and
               deconvolve by all three methods at 8 x 48128, and direct
               under cuDNN's TF32 default; R1-R3's times and bounds;
 12. modulation — the modulation and waveshaping slice: M1 (the
               flanger's feedback loop) bit-equal to its plain version on
               the card (the chain's flanger, C = 65 with a ragged tail, a
               0.1 ms base delay in the per-sample form), M2 and M3 (the
               Phaser's and the AutoWah's affine scans) against theirs at
               the chain's and the one-shot shapes and a ragged tail, float32
               and float64; MOD_GRAPH (distortion -> chorus -> phaser ->
               flanger -> tremolo) and WAVE_GRAPH (bit crusher -> Chebyshev
               distortion -> transformer -> bass exciter -> ring modulator)
               over 64 ch x 94 blocks of 512 in float32 and float64, each
               against the CPU path in float64 with its launches per block
               (M1, M2, K3, K4), no plain version called, ms per block,
               real-time factor and busy share; the AutoWah, the
               FrequencyShifter at +-100 Hz and the Chorus, Phaser and
               Flanger (one call, then 94 blocks) at 8 x 48128; M1-M3's
               times beside their byte and chain bounds;
 13. voice — the last effects and the dither quantizer: W1 (the WSOLA
               alignment search) against its plain version on the card
               (the music preset at +3, -4 and +12 semitones and the
               pitch-time node at +3, 8 x 48128, -4 and +12 at 1 and 64
               channels, the tiled schedule at 192 kHz, float32 and
               float64; the starts equal, a second call equal, the
               smallest best/second score gap printed);
               Q1 (the quantizer's error-feedback loop) bit-equal to its
               plain version (codes and state, FIR and IIR shelf, float32
               and float64, the export block and a ragged shape; 94
               streamed blocks bit-equal to one call);
               VOICE_GRAPH (the input ring-modulated as the vocoder's
               carrier on port 1) over 64 ch x 94 blocks of 512 (K4 once a
               block on 2,048 band rows); the stereo strip on 32 pairs
               (widener with a 120 Hz bass-mono split, canceller,
               parametric simulator; K3) and a 4096-tap HRTF-set simulator
               in both routings (K1), streamed against one call; the
               mastering export (16-bit TPDF, FC9 and the 8 kHz IIR shelf;
               Q1) over 64 ch x 94 blocks and one-shot at 8 x 48128; at 8 x
               48128 PITCH_GRAPH (pitch-time +3 -> granular ->
               spectral-freeze), pitch-spectral at -4 and +1 and WSOLA at
               +3, -4 and +12 (two calls bit-equal); each against the CPU
               path in float64 with its launches, no plain version called,
               ms and real-time factor; W1's and Q1's times beside their
               byte, operation and chain bounds;
 14. kernels — the line of every kernel with its launches by path.
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
F64_FLOPS_PER_S = 34e12        # H100 SXM float64 outside the tensor cores
CHAIN_CH, CHAIN_BLOCK, CHAIN_BLOCKS = 64, 512, 94
IR_BLOCK, IR_PARTS = 1024, 32   # IR learning: the flagship's 2^15-tap IR
# the redesigned kernels' times before their redesign (graph replay, PERF.md
# section 6), printed beside this run's
EARLIER = {"envelope_adjoint": "0.1443 ms per flagship backward (first "
                               "design, chip_smoke.py, NVIDIA H100 80GB "
                               "HBM3, 700.00 W)",
           "fdl_spectra_adjoint": "0.0577 ms per IR-learning step (first "
                                  "design, chip_smoke.py, NVIDIA H100 80GB "
                                  "HBM3, 700.00 W)"}

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

# The dynamics family through the same chain at the same width: every
# processor of effects/dynamics and split-freq's two ports. DYN_GRAPH runs
# D1 (the feedback compressor), K4 (gate, de-esser, the three bands, the
# lookahead limiter) and K3 (the de-esser's detector and crossover, the
# 3 kHz crossover; the 250 Hz one has slow poles and takes the blocked
# engine); SPLIT_GRAPH runs K3 (the 1200 Hz split) and K4.
DYN_GRAPH = {
    "nodes": [
        {"id": "gate", "type": "dyn-gate",
         "params": {"thresholdDB": -45, "holdMs": 5, "rangeDB": -70}},
        {"id": "comp", "type": "dyn-compressor",
         "params": {"topology": "feedback", "detector": "rms",
                    "thresholdDB": -20, "ratio": 4, "rmsWindowMs": 5}},
        {"id": "deess", "type": "dyn-deesser",
         "params": {"mode": "splitband", "freqHz": 6500, "thresholdDB": -30}},
        {"id": "mb", "type": "dyn-multiband",
         "params": {"bands": 3, "order": 4}},
        {"id": "look", "type": "dyn-lookahead",
         "params": {"thresholdDB": -3, "lookaheadMs": 2}}],
    "connections": [{"from": "_input", "to": "gate"},
                    {"from": "gate", "to": "comp"},
                    {"from": "comp", "to": "deess"},
                    {"from": "deess", "to": "mb"},
                    {"from": "mb", "to": "look"},
                    {"from": "look", "to": "_output"}]}
SPLIT_GRAPH = {
    "nodes": [
        {"id": "split", "type": "split-freq",
         "params": {"freqHz": 1200, "order": 4}},
        {"id": "tr", "type": "dyn-transient",
         "params": {"attack": 0.5, "sustain": -0.3, "attackMs": 2}},
        {"id": "ex", "type": "dyn-expander",
         "params": {"thresholdDB": -40, "ratio": 2}},
        {"id": "lim", "type": "dyn-limiter", "params": {"thresholdDB": -6}}],
    "connections": [{"from": "_input", "to": "split"},
                    {"from": "split", "to": "tr", "fromPortIndex": 0},
                    {"from": "split", "to": "ex", "fromPortIndex": 1},
                    {"from": "tr", "to": "lim"},
                    {"from": "ex", "to": "lim"},
                    {"from": "lim", "to": "_output"}]}
# The dynamics graph's feedback compressor, as its node builds it
FB_GRAPH_KW = {"threshold_db": -20.0, "ratio": 4.0}
# Operations per D1 step, counting log2 and exp2 as one each (so the
# operation bound is a floor): the compare and the two branches (7), the
# level's guard (2), log2 and the threshold (2), the knee (8), the factor
# and exp2 (3), the level's select (2), the output and its magnitude (3).
D1_STEP_OPS = 27

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


# Operations a step of the reverse kernels does: the ladder's sweep (12
# multiplies and FMAs, the feedback's 2, 3 state updates, gy's add and
# dx's 2); the ZDF reverse above, whose two quotients an update are each a
# reciprocal, a multiply and two FMAs (5, counting the reciprocal as one).
MOOG_REVERSE_OPS = 12 + 2 + 3 + 1 + 2


def zdf_reverse_ops(newton_iters: int) -> int:
    return 23 * (newton_iters + 1) + (26 + 8) * newton_iters + 24


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


def bits_equal(torch, a, b) -> bool:
    """a and b hold the same bits (NaNs and signed zeros included)."""
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    return (a.shape == b.shape and a.dtype == b.dtype
            and bool(torch.equal(a.contiguous().view(ints[a.dtype]),
                                 b.contiguous().view(ints[b.dtype]))))


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


def device_activity(torch, fn, reps: int, prefixes=()) -> dict:
    """The device's own activities (kernels, copies, memsets) in one call
    of fn, from torch.profiler over `reps` calls after a warm-up call:
    {"by_name": {name: ms}, "ms": total ms, "count": activities, "h2d":
    host-to-device copies}, each a call, and "dropped", the records one
    session had and the other lacked; "by_name" only the names that
    start with one of `prefixes` where given; "ms" None where the
    profiler recorded no device time. Read from the profiler's raw
    activity records, not from its operators' totals, which count each
    activity again, and without the step annotations the schedule adds
    to the device's records. Late in this script a session can drop
    device records: six in every session of one run on the H100, all of
    one session's in another. So each session's warm-up step (32 small
    kernels and one call, device tracing already on) takes the first
    ones, and of two sessions the one with more records is kept."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    pad = torch.zeros(1, device="cuda")
    sessions = []
    for _ in range(2):
        recs = []
        sessions.append(recs)

        def ready(prof, recs=recs):
            recs.extend((e.name(), e.duration_ns())
                        for e in prof.profiler.kineto_results.events()
                        if e.device_type() == DeviceType.CUDA
                        and not e.is_user_annotation())

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=reps, repeat=1),
                     on_trace_ready=ready) as prof:
            for _ in range(32):
                pad.add_(1.0)
            for _ in range(reps + 1):
                fn()
                torch.cuda.synchronize()
                prof.step()
    recs = max(sessions, key=len)
    by_name = {}
    for name, ns in recs:
        name = name.split("(")[0].removeprefix("void ")
        by_name[name] = by_name.get(name, 0.0) + ns / 1e6 / reps
    ms = sum(by_name.values())
    if prefixes:
        by_name = {k: t for k, t in by_name.items() if k.startswith(tuple(prefixes))}
    return {"by_name": by_name, "ms": ms or None, "count": len(recs) / reps,
            "h2d": sum("HtoD" in name for name, _ in recs) / reps,
            "dropped": abs(len(sessions[0]) - len(sessions[1]))}


def bound(nbytes: float, flops: float):
    """The least time (ms) of the work and what bounds it: the bytes at
    the HBM rate or the operations at the float32 rate."""
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
    lags below nf only) of the FDL spectra adjoint. Its inputs and
    outputs are float32, so its bound takes the float32 rate; the kernel's
    float64 sums are a design choice, reported beside it at the FP64 rate."""
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


def moog_record_call(moog_ops, mf, x, st8):
    """The recording instance of K5 or K6 for MoogFilter `mf` at its
    oversampling: (new state8, y, record)."""
    p, os = mf.kernel_params(), mf.oversampling
    if mf.variant.value == "zdf":
        return moog_ops.moog_zdf_record(x, st8, p, newton_iters=mf.newton_iters,
                                        os=os)
    return moog_ops.moog_ladder_record(
        x, st8, p, fast_tanh="lightweight" in mf.variant.value,
        huovilainen=mf.variant.value == "huovilainen", os=os)


def moog_reverse_call(moog_ops, mf, rec, st8, gy, gst, plain=False):
    """The reverse kernel's wrapper (or its plain sweep) for MoogFilter
    `mf` over the record `rec`: (dx, dstate8)."""
    p, os = mf.kernel_params(), mf.oversampling
    if mf.variant.value == "zdf":
        fn = (moog_ops.moog_zdf_reverse_plain if plain
              else moog_ops.moog_zdf_reverse)
        return fn(rec, st8, p, gy, gst, newton_iters=mf.newton_iters, os=os)
    fn = (moog_ops.moog_ladder_reverse_plain if plain
          else moog_ops.moog_ladder_reverse)
    return fn(rec, st8, p, gy, gst, fast_tanh="lightweight" in mf.variant.value,
              huovilainen=mf.variant.value == "huovilainen", os=os)


def record_values(moog_ops, mf):
    return (moog_ops.zdf_record(mf.newton_iters) if mf.variant.value == "zdf"
            else moog_ops.LADDER_RECORD)


def moog_reverse_work(c, t, nv, ops_per_step, os=1):
    """Bytes (the record in, padding lanes included; gy in and dx out at
    the base rate; state8 and its cotangent in, dstate8 out) and
    operations (the reverse step's) of a reverse kernel over (C, T)
    float32 at oversampling os."""
    c_pad = -(-c // 32) * 32
    return (4.0 * c_pad * t * os * nv + 8.0 * c * t + 96.0 * c,
            float(ops_per_step) * c * t * os)


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


# Bars of the analysis phase, each from the JAX test that covers the
# function: float64 against the CPU path as the port's tests hold float64
# against the JAX package; float32 bands against float64 at
# tests/test_precision.py's float32 bar for the whole-cascade engine on its
# slowest high-pass (hp60_o4, 88 dB; the 25 Hz band is slower still); the
# STFT's round trip at tests/test_spectrum.py's 2e-5, and the spectra and
# mel powers at the SNR of that relative error (94 dB); the Hilbert
# transformer at tests/test_native.py's 120 dB; the Goertzel state at the
# float32 dot-product bound (the power formula itself cancels in float32
# near DC), its float64 power at tests/test_goertzel.py's rtol 1e-9; noise
# at tests/test_signal.py's statistics.
ANALYSIS_F64_DB = 200.0
ANALYSIS_BANDS_F32_DB = 88.0
ANALYSIS_STFT_ERR = 2e-5
ANALYSIS_STFT_F32_DB = 20.0 * math.log10(1.0 / ANALYSIS_STFT_ERR)
ANALYSIS_HILBERT_F32_DB = 120.0
ANALYSIS_NOISE_N = 1 << 24


def analysis_phase(torch, dev, gpu, kernels, plain_calls, bqmod, envscan) -> None:
    """The analysis slice on the card at full width: the streamed and
    one-shot OctaveAnalyzer, the MultirateOctaveAnalyzer, the STFT path
    (stft -> istft, mel spectrogram, Goertzel at the band centres), the
    HilbertTransformer and the noise generators. Each item against the
    port's CPU path in float64 (float32 and float64 on the card), its
    time from CUDA events, its K3 and K4 launches (added to the kernels'
    `by_path`) with no plain version called; then the TF32 check."""
    from algodsp_tpu_torch import signal, spectrum
    from algodsp_tpu_torch.filters.bank import (
        MultirateOctaveAnalyzer, OctaveAnalyzer, octave_band_specs)
    from algodsp_tpu_torch.filters.hilbert import HilbertTransformer
    from algodsp_tpu_torch.ops.envscan import envelope_scan
    from algodsp_tpu_torch.spectrum.goertzel import _basis_cached

    t_an = time.perf_counter()
    plain = [(bqmod, "biquad_cascade_plain"), (envscan, "envelope_scan_plain")]
    k4 = envscan.envelope_scan_kernel
    rng = np.random.default_rng(12)
    cpu64 = lambda a: torch.as_tensor(a, dtype=torch.float64)
    on_card = {dt: (lambda a, dt=dt: torch.as_tensor(a, dtype=dt, device=dev))
               for dt in (torch.float32, torch.float64)}
    block_ms = CHAIN_BLOCK / SR * 1e3

    def driven(path, fn):
        """fn() with every launch counter at 0 before and read after, the
        plain versions' calls counted; the launches go to `by_path`."""
        for k in kernels.values():
            k["wrapper"].launches = 0
        k4.reset_counts()
        with plain_calls(plain) as plain_n:
            out = fn()
            torch.cuda.synchronize()
        launches = {n: k["wrapper"].launches for n, k in kernels.items()}
        for n, k in kernels.items():
            k["by_path"][path] = launches[n]
        assert not any(plain_n.values()), (path, plain_n)
        used = {n: v for n, v in launches.items() if v}
        assert set(used) <= {"biquad_cascade", "envelope"}, (path, used)
        return out, used, k4.counts()

    def timed(label, fn, reps, per=1, note=""):
        """Print the wall time of fn (CUDA events, `reps` calls, divided
        by `per`) beside its device time and operations (profiler) and
        the device's busy share of the wall; return the wall ms."""
        ms = time_ms(torch, fn, reps=reps, warmup=1) / per
        act = device_activity(torch, fn, min(reps, 3))
        busy = ("device time not measured" if act["ms"] is None else
                f"device {act['ms'] / per:.4f} ms in {act['count'] / per:.0f} "
                f"kernels and copies ({act['h2d'] / per:.0f} host-to-device), "
                f"busy {100 * act['ms'] / per / ms:.1f}% of the wall (profiler; "
                f"{act['dropped']} records in one session only)")
        print(f"time analysis {label}: {ms:.4f} ms{note}; {busy} ({gpu})")
        return ms

    def bar_line(label, got, bar, unit="dB"):
        ok = got >= bar
        print(f"analysis {label}: {got:.1f} {unit} (bar >= {bar:.1f}) "
              f"{'ok' if ok else 'FAILED'}")
        assert ok, label

    def k4_check(label, targets, env_in, env_out):
        """K4 as the analyzer launches it (its wrapper on the analyzer's
        |bands| and entering state, leading dims flattened onto rows)
        against its plain version on host copies of the same inputs, at
        the envelope check's bars (float32: trajectory SNR >= 100 dB and
        env_final within 1e-5 of 1 + its scale; float64: both within
        1e-12 of the trajectory's scale). env_out, the analyzer's own
        state after the call, must be the wrapper's env_final bit for
        bit."""
        ef, tr = envelope_scan(targets, env_in, an.attack_coeff, an.release_coeff)
        ef_p, tr_p = envscan.envelope_scan_plain(
            targets.cpu(), env_in.cpu(), torch.tensor(an.attack_coeff, dtype=targets.dtype),
            torch.tensor(an.release_coeff, dtype=targets.dtype))
        tr, ef, tr_p, ef_p = (host(v) for v in (tr, ef, tr_p, ef_p))
        err = float(np.max(np.abs(tr - tr_p)))
        ef_err = float(np.max(np.abs(ef - ef_p)))
        snr = snr_db(tr_p, tr)
        same = bool(np.array_equal(ef, host(env_out)))
        if targets.dtype == torch.float64:
            scale = float(np.max(np.abs(tr_p)))
            ok = err <= 1e-12 * scale and ef_err <= 1e-12 * scale
            bars = f"bar max|err| <= {1e-12 * scale:.3e} on both"
        else:
            ef_scale = 1.0 + float(np.max(np.abs(ef_p)))
            ok = snr >= 100 and ef_err <= 1e-5 * ef_scale
            bars = f"bars SNR >= 100 dB, env_final <= {1e-5 * ef_scale:.3e}"
        print(f"analysis check envelope {label}: {targets.dtype} rows "
              f"{tr.size // tr.shape[-1]} (state {tuple(env_in.shape)}) "
              f"T={tr.shape[-1]} vs plain: SNR {snr:.1f} dB, max|err| "
              f"{err:.3e}, env_final max|err| {ef_err:.3e} ({bars}); the "
              f"analyzer's state is env_final bit for bit {same} "
              f"{'ok' if ok and same else 'FAILED'}")
        assert ok and same, label
        kernels["envelope"]["errs"].append(err)

    # 1. the streamed OctaveAnalyzer: 1/3 octave, 30 bands, order 4, 64 ch x
    # 94 blocks of 512 (the chain's block stream); K4 once a block on
    # 64 x 30 = 1920 rows
    an = OctaveAnalyzer(3, SR, order=4)
    nb = an.bank.num_bands
    assert nb == 30, nb
    n_stream = CHAIN_BLOCKS * CHAIN_BLOCK
    xs_np = rng.standard_normal((CHAIN_CH, n_stream)).astype(np.float32)
    blocks = {dt: [f(xs_np[:, b * CHAIN_BLOCK:(b + 1) * CHAIN_BLOCK])
                   for b in range(CHAIN_BLOCKS)] for dt, f in on_card.items()}

    def stream(dtype, n_blocks=CHAIN_BLOCKS, keep=0):
        st = an.init_state((CHAIN_CH,), dtype, dev)
        kept, envs = [], []
        for b in range(n_blocks):
            st, bands, levels = an.process(st, blocks[dtype][b])
            envs.append(st["env"])
            if b < keep:
                kept.append(bands)
        return st, levels, kept, envs

    (st32, lev32, kept32, envs32), used, counts = driven(
        "analysis_stream", lambda: stream(torch.float32, keep=8))
    print(f"analysis OctaveAnalyzer streamed {CHAIN_CH}x{CHAIN_BLOCK} x "
          f"{CHAIN_BLOCKS} blocks ({nb} bands, {CHAIN_CH * nb} envelope rows): "
          f"launches per block {json.dumps({n: v / CHAIN_BLOCKS for n, v in used.items()})}"
          f", plain versions called 0, envelope counts {json.dumps(counts)}")
    assert used == {"envelope": CHAIN_BLOCKS}, used
    _, _, kept64, envs64 = stream(torch.float64, n_blocks=8, keep=8)
    st_c = an.init_state((CHAIN_CH,), torch.float64, "cpu")
    ref, env_ref = [], []
    for b in range(CHAIN_BLOCKS):
        st_c, bands_c, _ = an.process(st_c, cpu64(xs_np[:, b * CHAIN_BLOCK:
                                                        (b + 1) * CHAIN_BLOCK]))
        env_ref.append(st_c["env"].numpy())
        if b < 8:
            ref.append(bands_c.numpy())
    ref, env_ref = np.concatenate(ref, -1), np.stack(env_ref)
    got32 = np.concatenate([host(v) for v in kept32], -1)
    got64 = np.concatenate([host(v) for v in kept64], -1)
    per_band = [snr_db(ref[:, b], got32[:, b]) for b in range(nb)]
    print(f"analysis OctaveAnalyzer streamed bands, 8 blocks vs the CPU path in "
          f"float64: float32 {snr_db(ref, got32):.1f} dB, worst band "
          f"{min(per_band):.1f} dB at {an.centers[int(np.argmin(per_band))]:.1f} "
          f"Hz (25-40 Hz: {', '.join(f'{v:.1f}' for v in per_band[:3])}); "
          f"float64 {snr_db(ref, got64):.1f} dB")
    bar_line("OctaveAnalyzer streamed float32 worst band", min(per_band),
             ANALYSIS_BANDS_F32_DB)
    bar_line("OctaveAnalyzer streamed float64", snr_db(ref, got64), ANALYSIS_F64_DB)
    # K4 at this launch shape (1920 rows x 512, the (64, 30) state carried
    # from block to block) against its plain version on the same inputs
    for dt, kept, envs in ((torch.float32, kept32, envs32),
                           (torch.float64, kept64, envs64)):
        for b in range(8):
            env_in = envs[b - 1] if b else torch.zeros_like(envs[0])
            k4_check(f"streamed block {b}", torch.abs(kept[b]), env_in, envs[b])
    # the analyzer's envelopes over all 94 blocks against the CPU path in
    # float64: the band error passes through the envelope, so the bands'
    # bars hold
    e32 = np.stack([host(v) for v in envs32])
    e64 = np.stack([host(v) for v in envs64])
    env_band = [snr_db(env_ref[..., b], e32[..., b]) for b in range(nb)]
    lev_ref = 20.0 * np.log10(np.maximum(env_ref[-1], 1e-10))
    lev = host(lev32)
    assert lev.shape == (CHAIN_CH, nb) and np.all(np.isfinite(lev))
    print(f"analysis OctaveAnalyzer streamed envelopes, {CHAIN_BLOCKS} blocks "
          f"x {CHAIN_CH} ch x {nb} bands vs the CPU path in float64: float32 "
          f"{snr_db(env_ref, e32):.1f} dB, worst band {min(env_band):.1f} dB at "
          f"{an.centers[int(np.argmin(env_band))]:.1f} Hz, final levels max "
          f"|err| {np.max(np.abs(lev - lev_ref)):.3e} dB; float64 (8 blocks) "
          f"{snr_db(env_ref[:8], e64):.1f} dB")
    bar_line("OctaveAnalyzer streamed envelopes float32 worst band",
             min(env_band), ANALYSIS_BANDS_F32_DB)
    bar_line("OctaveAnalyzer streamed envelopes float64",
             snr_db(env_ref[:8], e64), ANALYSIS_F64_DB)
    k4_ms = device_activity(torch, lambda: an.process(st32, blocks[torch.float32][0]),
                            10, ("envelope_",))["by_name"]
    ms = timed(f"OctaveAnalyzer streamed per block ({CHAIN_CH}x{CHAIN_BLOCK}, {nb} "
               f"bands, 3 x {CHAIN_BLOCKS} blocks)", lambda: stream(torch.float32),
               3, per=CHAIN_BLOCKS)
    print(f"time analysis OctaveAnalyzer streamed: real-time factor "
          f"{block_ms / ms:.2f}; K4 device time a block (profiler) "
          + (", ".join(f"{k} {t:.4f} ms" for k, t in k4_ms.items()) or "not measured")
          + f" ({gpu})")

    # 2. the one-shot OctaveAnalyzer, 8 ch x 48128 (the band tensor 8 x 30 x
    # 48128 float32, ~46 MB)
    x1_np = rng.standard_normal((CHANNELS, N_FLAGSHIP)).astype(np.float32)
    x1 = {dt: f(x1_np) for dt, f in on_card.items()}
    one = lambda dt: an.process(an.init_state((CHANNELS,), dt, dev), x1[dt])
    (so32, b32, l32), used, counts = driven("analysis_oneshot",
                                            lambda: one(torch.float32))
    so64, b64, l64 = one(torch.float64)
    st_c, bc, lc = an.process(an.init_state((CHANNELS,), torch.float64, "cpu"),
                              cpu64(x1_np))
    bc, g32, g64 = bc.numpy(), host(b32), host(b64)
    per_band = [snr_db(bc[:, b], g32[:, b]) for b in range(nb)]
    env_c, env32, env64 = st_c["env"].numpy(), host(so32["env"]), host(so64["env"])
    env_band = [snr_db(env_c[:, b], env32[:, b]) for b in range(nb)]
    lc = lc.numpy()
    print(f"analysis OctaveAnalyzer one-shot {CHANNELS}x{N_FLAGSHIP} "
          f"({b32.numel() * 4 / 1e6:.1f} MB of bands): launches "
          f"{json.dumps(used)}, plain versions called 0; vs the CPU path in "
          f"float64: float32 {snr_db(bc, g32):.1f} dB, worst band "
          f"{min(per_band):.1f} dB, envelopes {snr_db(env_c, env32):.1f} dB, "
          f"worst band {min(env_band):.1f} dB, levels max |err| "
          f"{np.max(np.abs(host(l32) - lc)):.3e} dB; float64 "
          f"{snr_db(bc, g64):.1f} dB, envelopes {snr_db(env_c, env64):.1f} dB, "
          f"levels max |err| {np.max(np.abs(host(l64) - lc)):.3e} dB")
    assert used == {"envelope": 1}, used
    bar_line("OctaveAnalyzer one-shot float32 worst band", min(per_band),
             ANALYSIS_BANDS_F32_DB)
    bar_line("OctaveAnalyzer one-shot float64", snr_db(bc, g64), ANALYSIS_F64_DB)
    bar_line("OctaveAnalyzer one-shot envelopes float32 worst band",
             min(env_band), ANALYSIS_BANDS_F32_DB)
    bar_line("OctaveAnalyzer one-shot envelopes float64", snr_db(env_c, env64),
             ANALYSIS_F64_DB)
    # K4 at this launch shape: 240 rows x 48128
    for dt, bands, st in ((torch.float32, b32, so32), (torch.float64, b64, so64)):
        k4_check("one-shot", torch.abs(bands), torch.zeros_like(st["env"]),
                 st["env"])
    ms = timed(f"OctaveAnalyzer one-shot {CHANNELS}x{N_FLAGSHIP} a call",
               lambda: one(torch.float32), 5)
    print(f"time analysis OctaveAnalyzer one-shot: {N_FLAGSHIP / SR * 1e3 / ms:.1f}x "
          f"real time ({gpu})")
    del b32, b64, bc, g32, g64

    # 3. the MultirateOctaveAnalyzer: 1/3 octave, order 10, analyze at
    # 8 x 48128 (752 x 64: every decimation factor divides it)
    mr = MultirateOctaveAnalyzer(3, SR, order=10)
    assert N_FLAGSHIP % mr.max_ds == 0
    p32, used, _ = driven("analysis_multirate", lambda: mr.analyze(x1[torch.float32]))
    p64 = host(mr.analyze(x1[torch.float64]))
    pc = mr.analyze(cpu64(x1_np)).numpy()
    p32 = host(p32)
    worst = min(snr_db(pc[:, b], p32[:, b]) for b in range(mr.num_bands))
    print(f"analysis MultirateOctaveAnalyzer analyze {CHANNELS}x{N_FLAGSHIP} "
          f"({mr.num_bands} bands, {len(mr._groups)} decimation groups, "
          f"factors up to {mr.max_ds}): launches {json.dumps(used)} (matrix "
          f"engines and the resampler's product only); peaks vs the CPU path "
          f"in float64: float32 {snr_db(pc, p32):.1f} dB, worst band "
          f"{worst:.1f} dB; float64 {snr_db(pc, p64):.1f} dB")
    assert used == {}, used
    bar_line("MultirateOctaveAnalyzer float32 worst band", worst,
             ANALYSIS_BANDS_F32_DB)
    bar_line("MultirateOctaveAnalyzer float64", snr_db(pc, p64), ANALYSIS_F64_DB)
    timed(f"MultirateOctaveAnalyzer analyze {CHANNELS}x{N_FLAGSHIP} a call",
          lambda: mr.analyze(x1[torch.float32]), 5)
    # where its host time goes: each decimation group's resampler,
    # band-pass and envelope chains alone, the chains on the whole-cascade
    # engine where the group's length is a block multiple, else on the
    # per-section one
    parts = []
    x32 = x1[torch.float32]
    for g, st in zip(mr._groups, mr.init_state((CHANNELS,), torch.float32, dev)):
        xg = x32 if g["resampler"] is None else g["resampler"].process_stream(
            st["resamp"], x32)[1]
        xb = xg[..., None, :].expand(xg.shape[:-1] + (g["bandpass"].n_bands,
                                                      xg.shape[-1]))
        ab = torch.abs(g["bandpass"].process_stream(st["bank"], xb)[1])
        calls = {"band-pass": lambda: g["bandpass"].process_stream(st["bank"], xb),
                 "envelope": lambda: g["envelope"].process_stream(st["env"], ab)}
        if g["resampler"] is not None:
            calls["resampler"] = lambda: g["resampler"].process_stream(st["resamp"], x32)
        got = {k: (time_ms(torch, fn, reps=5, warmup=1),
                   device_activity(torch, fn, 3)["count"]) for k, fn in calls.items()}
        sections = bool(xg.shape[-1] % g["bandpass"].block_size)
        parts.append((sections, sum(ms for ms, _ in got.values())))
        path = "per-section" if sections else "cascade"
        print(f"time analysis MultirateOctaveAnalyzer group x{g['ds']} ({xg.shape[-1]} "
              f"samples, {g['bandpass'].n_bands} bands, {g['bandpass'].n_sections} + "
              f"{g['envelope'].n_sections} sections, {path} engine): "
              + ", ".join(f"{k} {ms:.4f} ms in {n:.0f} device activities"
                          for k, (ms, n) in got.items()) + f" ({gpu})")
    print(f"time analysis MultirateOctaveAnalyzer groups: "
          f"{sum(ms for _, ms in parts):.4f} ms in all, the per-section groups "
          f"{sum(ms for sec, ms in parts if sec):.4f} ms ({gpu})")

    # 4. the STFT path, 8 x 48128: stft -> istft, mel spectrogram (2048 /
    # 512, 64 mels), Goertzel at the 30 band centres
    ri = lambda a: np.stack([a.real, a.imag])
    centres = [s[0] for s in octave_band_specs(3, SR)]

    def stft_path(dt):
        spec = spectrum.stft(x1[dt], 2048, 512)
        y = spectrum.istft(spec, 512, length=N_FLAGSHIP)
        mel = spectrum.mel_spectrogram(x1[dt], SR, n_mels=64, frame_size=2048,
                                       hop_size=512, log=False)
        g = spectrum.Goertzel(centres, SR)
        st = g.process_block(g.init_state((CHANNELS,), dt, dev), x1[dt])
        return spec, y, mel, st, g.power(st)

    out32, used, _ = driven("analysis_stft", lambda: stft_path(torch.float32))
    assert used == {}, used
    out64 = stft_path(torch.float64)
    spec_c = spectrum.stft(cpu64(x1_np), 2048, 512).numpy()
    mel_c = spectrum.mel_spectrogram(cpu64(x1_np), SR, n_mels=64, frame_size=2048,
                                     hop_size=512, log=False).numpy()
    gc = spectrum.Goertzel(centres, SR)
    st_c = gc.process_block(gc.init_state((CHANNELS,), torch.float64, "cpu"),
                            cpu64(x1_np))
    pow_c = gc.power(st_c).numpy()
    rt_err = float(np.max(np.abs(host(out32[1]) - x1_np)))
    basis, _ = _basis_cached(tuple(centres), SR, N_FLAGSHIP)
    xin = x1_np.astype(np.float64)
    g_bound = (N_FLAGSHIP + 2) * np.finfo(np.float32).eps / 2 * np.einsum(
        "cn,nks->cks", np.abs(xin), np.abs(basis))
    g_err = np.abs(host(out32[3]) - st_c.numpy())
    rows = {
        "stft spectra": (snr_db(ri(spec_c), ri(host(out32[0]))),
                         snr_db(ri(spec_c), ri(host(out64[0])))),
        "mel power": (snr_db(mel_c, host(out32[2])), snr_db(mel_c, host(out64[2]))),
        "goertzel power": (snr_db(pow_c, host(out32[4])),
                           snr_db(pow_c, host(out64[4]))),
    }
    print(f"analysis STFT path {CHANNELS}x{N_FLAGSHIP} (stft 2048/512, istft, "
          f"mel 64, Goertzel at {len(centres)} centres): launches none; vs the "
          f"CPU path in float64: " + "; ".join(
              f"{k} float32 {a:.1f} dB, float64 {b:.1f} dB"
              for k, (a, b) in rows.items())
          + f"; round trip float32 max |err| {rt_err:.3e}; Goertzel float32 "
          f"state error at most {float(np.max(g_err / g_bound)):.3f} of its "
          f"dot-product bound; float64 power max rel err "
          f"{float(np.max(np.abs(host(out64[4]) - pow_c) / np.abs(pow_c))):.3e}")
    assert rt_err < ANALYSIS_STFT_ERR, rt_err
    bar_line("stft float32", rows["stft spectra"][0], ANALYSIS_STFT_F32_DB)
    bar_line("mel float32", rows["mel power"][0], ANALYSIS_STFT_F32_DB)
    for k, (_, b) in rows.items():
        bar_line(f"{k} float64", b, ANALYSIS_F64_DB)
    assert np.all(g_err <= g_bound)
    np.testing.assert_allclose(host(out64[4]), pow_c, rtol=1e-9)
    for label, fn in (
            ("stft + istft", lambda: spectrum.istft(spectrum.stft(x32, 2048, 512),
                                                    512, length=N_FLAGSHIP)),
            ("mel_spectrogram", lambda: spectrum.mel_spectrogram(
                x32, SR, n_mels=64, frame_size=2048, hop_size=512)),
            ("goertzel_power", lambda: spectrum.goertzel_power(x32, centres, SR))):
        timed(f"{label} {CHANNELS}x{N_FLAGSHIP} float32 a call", fn, 10)

    # 5. the HilbertTransformer (default preset) on 8 x 48128: its two
    # allpass chains on K3, each one launch over both half-rate streams
    ht = HilbertTransformer()
    (a32, bq32), used, _ = driven("analysis_hilbert", lambda: ht.process(x1[torch.float32]))
    a64, bq64 = ht.process(x1[torch.float64])
    ac, bc = (v.numpy() for v in ht.process(cpu64(x1_np)))
    modes = {name: ch._auto_mode(x1[torch.float32][..., 0::2])
             for name, ch in (("chain_a", ht.chain_a), ("chain_b", ht.chain_b))}
    s32 = min(snr_db(ac, host(a32)), snr_db(bc, host(bq32)))
    s64 = min(snr_db(ac, host(a64)), snr_db(bc, host(bq64)))
    print(f"analysis HilbertTransformer ({ht.coeffs.size} coefficients, "
          f"transition {ht.transition}) {CHANNELS}x{N_FLAGSHIP}: auto dispatch "
          f"{json.dumps(modes)} (float64: blocked), launches {json.dumps(used)}, "
          f"plain versions called 0; a and b vs the CPU path in float64: "
          f"float32 {s32:.1f} dB, float64 {s64:.1f} dB")
    assert used == {"biquad_cascade": 2}, used
    assert set(modes.values()) == {"kernel"}, modes
    bar_line("HilbertTransformer float32", s32, ANALYSIS_HILBERT_F32_DB)
    bar_line("HilbertTransformer float64", s64, ANALYSIS_F64_DB)
    timed(f"HilbertTransformer {CHANNELS}x{N_FLAGSHIP} float32 a call",
          lambda: ht.process(x1[torch.float32]), 10)

    # 6. noise: 2^24 samples of each on the card
    def noise():
        return (signal.white_noise(1.0, ANALYSIS_NOISE_N, seed=1, device=dev),
                signal.pink_noise(1.0, ANALYSIS_NOISE_N, seed=1, device=dev))

    (wn, pn), used, _ = driven("analysis_noise", noise)
    assert used == {}, used
    w = host(wn).astype(np.float64)
    p = host(pn).astype(np.float64)
    spec_p = np.abs(np.fft.rfft(p[:1 << 16])) ** 2
    freqs = np.fft.rfftfreq(1 << 16, 1 / SR)
    band = lambda lo, hi: spec_p[(freqs >= lo) & (freqs < hi)].mean()
    slope = 10 * np.log10(band(1600, 3200) / band(100, 200)) / 4
    print(f"analysis noise {ANALYSIS_NOISE_N} samples on the card: white mean "
          f"{w.mean():.2e} (bar |.| < 0.01), variance {w.var():.5f} (bar within "
          f"0.01 of 1/3), max |x| {np.abs(w).max():.6f} (bar <= 1); pink "
          f"{slope:.2f} dB/octave (bar -4.5 .. -1.5), finite "
          f"{bool(np.all(np.isfinite(p)))}")
    assert np.all(np.abs(w) <= 1.0) and abs(w.mean()) < 0.01
    assert abs(w.var() - 1 / 3) < 0.01 and np.all(np.isfinite(p))
    assert -4.5 < slope < -1.5, slope
    same = torch.equal(wn, signal.white_noise(1.0, ANALYSIS_NOISE_N, seed=1,
                                               device=dev))
    assert same
    for label, fn in (("white_noise", lambda: signal.white_noise(
            1.0, ANALYSIS_NOISE_N, device=dev)), ("pink_noise", lambda: signal.pink_noise(
            1.0, ANALYSIS_NOISE_N, device=dev))):
        timed(f"{label} {ANALYSIS_NOISE_N} samples a call", fn, 5)

    # the TF32 check: under a caller's set_float32_matmul_precision("high")
    # and cudnn.allow_tf32 = True, the mel, Goertzel, banded-engine and
    # resampler outputs hold the default's bits (the pin, as check fault 6)
    from algodsp_tpu_torch.resample import Resampler
    rs = Resampler(1, 64)
    tf32_runs = {
        "mel": lambda: spectrum.mel_spectrogram(x32, SR, n_mels=64),
        "goertzel": lambda: spectrum.goertzel_power(x32, centres, SR),
        "banded engine (bank)": lambda: an.bank.process(x32),
        "resampler 1:64": lambda: rs.process(x32),
        "multirate analyzer": lambda: mr.analyze(x32),
    }
    default = {k: fn() for k, fn in tf32_runs.items()}
    caller = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)
    try:
        torch.set_float32_matmul_precision("high")
        torch.backends.cudnn.allow_tf32 = True
        high = {k: fn() for k, fn in tf32_runs.items()}
        kept = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)
    finally:
        torch.set_float32_matmul_precision(caller[0])
        torch.backends.cudnn.allow_tf32 = caller[1]
    equal = {k: bits_equal(torch, default[k], high[k]) for k in tf32_runs}
    print(f"analysis TF32 check (set_float32_matmul_precision('high'), "
          f"cudnn.allow_tf32 True): bit-equal to the default "
          f"{json.dumps(equal)}; the caller's settings after the calls "
          f"{kept}, restored to {caller}")
    assert all(equal.values()) and kept == ("high", True), equal
    print(f"analysis launches by path: "
          f"{json.dumps({p: {n: k['by_path'].get(p, 0) for n, k in kernels.items() if k['by_path'].get(p, 0)} for p in ('analysis_stream', 'analysis_oneshot', 'analysis_multirate', 'analysis_stft', 'analysis_hilbert', 'analysis_noise')})}"
          f"; phase {time.perf_counter() - t_an:.2f} s")


# The space send chain at full width: a low-cut, then the feedback delay
# (0.25 s, feedback 0.35, mix 0.25), Freeverb and the FDN reverb (the
# registry's defaults), the user's reverb sends on the chain cell's 64 ch
# at 48 kHz. Chain.fuse_lti folds runs of two or more LTI nodes (as the
# JAX chain does), so the low-cut in front of the delay is what lets the
# delay's echo train fold, with it, into one FIR (K1) in the fused form.
SPACE_GRAPH = {
    "nodes": [
        {"id": "lowcut", "type": "filter-highpass",
         "params": {"family": "butterworth", "freq": 120, "order": 2}},
        {"id": "echo", "type": "delay",
         "params": {"time": 0.25, "feedback": 0.35, "mix": 0.25}},
        {"id": "room", "type": "reverb-freeverb", "params": {}},
        {"id": "hall", "type": "reverb-fdn", "params": {}}],
    "connections": [{"from": "_input", "to": "lowcut"},
                    {"from": "lowcut", "to": "echo"},
                    {"from": "echo", "to": "room"},
                    {"from": "room", "to": "hall"},
                    {"from": "hall", "to": "_output"}]}
# Bars of the space phase: the kernels against their plain versions on the
# card, float32 >= 100 dB and float64 >= 200 dB (the JAX tests' bars for
# these effects are float64 parity). Every path against the port's CPU
# path in float64: float64 >= 200 dB; float32 >= 100 dB, or no more than
# 6 dB below the CPU path's own float32 reading where that is lower (the
# rule the port's CPU tests hold the reference's float32 class to: in
# 512-sample blocks the FDN accumulates its LFO phase in float32 a sample
# at a time, and a retargeted Delay's read positions round at its
# 96,128-sample ring's magnitude).
SPACE_DB = {"float32": 100.0, "float64": 200.0}
# The space chain's first 32 blocks (0.34 s: the 0.25 s delay's first echo
# included) are held against the CPU path: its 94 blocks took ~31 s a
# type on the CPU, which kept the whole script near its 600 s budget.
SPACE_CPU_BLOCKS = 32


def space_bar32(cpu32: float) -> float:
    """The float32 bar of a path whose CPU float32 run reads cpu32 dB
    against its CPU float64 run."""
    return min(SPACE_DB["float32"], cpu32 - 6.0)
# Operations per sample, counting sin and floor as one each (so the
# operation bound is a floor): R1 the position (3), its floor and
# fraction (2), the interpolation (4), the write (2) and the mix (3); R2
# eight combs (7 each: the one-pole's 3, the squelch's 2, the write's 2)
# with their sum (8), four allpasses (3 each), the input gain and the mix
# (4); R3 eight lines (12 each: the LFO's 4, the delay's 2, position and
# fraction 3, interpolation 3), their sum and the output (10), the
# Hadamard (120), eight dampings (3) and writes (3).
R_SAMPLE_OPS = {"delay_feedback": 14, "freeverb_feedback": 80,
                "fdn_feedback": 96 + 10 + 120 + 24 + 24}


def space_phase(torch, dev, gpu, kernels, plain_calls) -> None:
    """Phase 11: the delay feedback and reverb slice on the card. R1-R3
    against their plain versions on the card (C = 65, the chain block, a
    ragged length, lags under 130 and under a chunk, R3 on an 8 x 48000
    render whose blocked blocks and tail run in one call, float32 and
    float64, two calls bit-equal to one); SPACE_GRAPH streamed over 64 ch x 94
    blocks of 512 (float32 and float64) and fused (float32), the first
    SPACE_CPU_BLOCKS blocks against the CPU path in float64, with
    launches per block, no plain version called,
    ms per block, real-time factor and the profiler's device time; the
    one-shot renders at 8 x 48128; the conv items at 8 x 48128 with the
    cuDNN TF32 check; R1-R3's times beside their bounds. R1-R3 join the
    `kernels` line."""
    from algodsp_tpu_torch import conv
    from algodsp_tpu_torch.chain import Chain
    from algodsp_tpu_torch.effects.delay_effect import Delay
    from algodsp_tpu_torch.effects.reverb import FDNReverb, Freeverb
    from algodsp_tpu_torch.ops import dynfb, feedback

    t_ph = time.perf_counter()
    names = ("delay_feedback", "freeverb_feedback", "fdn_feedback")
    earlier = list(next(iter(kernels.values()))["by_path"])
    replaces = {
        "delay_feedback": "algodsp_tpu/effects/delay_effect.py:72-157 "
                          "(Delay._sample_scan, _ring_blocks, _linear_blocks; "
                          "lax.scans, no Pallas)",
        "freeverb_feedback": "algodsp_tpu/effects/reverb/freeverb.py:82-151 "
                             "(Freeverb._block_step, _sample_scan; lax.scans, "
                             "no Pallas)",
        "fdn_feedback": "algodsp_tpu/effects/reverb/fdn.py:166-253 "
                        "(FDNReverb._block_step, _sample_scan; lax.scans, no "
                        "Pallas)"}
    for name in names:
        kernels[name] = {"route": "cuda",
                         "source": "algodsp_tpu_torch/csrc/feedback.cu",
                         "replaces": replaces[name],
                         "wrapper": getattr(feedback, name), "errs": [],
                         "by_path": {p: 0 for p in earlier}}
    plain = [(feedback, n) for n in (
        "delay_feedback_plain", "delay_scan_plain", "freeverb_feedback_plain",
        "freeverb_scan_plain", "fdn_feedback_plain", "fdn_step_plain")]
    rng = np.random.default_rng(13)
    dtypes = (torch.float32, torch.float64)
    dname = lambda dt: str(dt)[6:]
    block_ms = CHAIN_BLOCK / SR * 1e3

    def tensors(st):
        """A state's tensors in a fixed order."""
        if torch.is_tensor(st):
            return [st]
        if isinstance(st, dict):
            return [t for k in sorted(st) for t in tensors(st[k])]
        return [t for v in st for t in tensors(v)]

    def clone(st):
        if torch.is_tensor(st):
            return st.clone()
        if isinstance(st, dict):
            return {k: clone(v) for k, v in st.items()}
        return [clone(v) for v in st]

    def compare(a, b):
        """(bit-equal, SNR of b's floats against a's, max |err|, integer
        parts equal) of two states or outputs."""
        ta, tb = tensors(a), tensors(b)
        fa = [host(t).ravel() for t in ta if t.is_floating_point()]
        fb = [host(t).ravel() for t in tb if t.is_floating_point()]
        ints = all(bool(torch.equal(u.cpu(), v.cpu())) for u, v in zip(ta, tb)
                   if not u.is_floating_point())
        bit = ints and all(bits_equal(torch, u, v) for u, v in zip(ta, tb)
                           if u.is_floating_point())
        fa, fb = np.concatenate(fa), np.concatenate(fb)
        return bit, snr_db(fa, fb), float(np.max(np.abs(fa - fb))), ints

    def driven(path, fn, allowed):
        """fn() with every launch counter at 0 before and read after, the
        plain versions' calls counted (none may be called); the launches
        go to `by_path`."""
        for k in kernels.values():
            k["wrapper"].launches = 0
        with plain_calls(plain) as plain_n:
            out = fn()
            torch.cuda.synchronize()
        launches = {n: k["wrapper"].launches for n, k in kernels.items()}
        for n, k in kernels.items():
            k["by_path"][path] = launches[n]
        used = {n: v for n, v in launches.items() if v}
        assert not any(plain_n.values()), (path, plain_n)
        assert set(used) <= set(allowed), (path, used)
        return out, used

    # -- R1-R3 against their plain versions on the card ---------------------
    def noise(*shape, scale=0.3):
        return scale * rng.standard_normal(shape)

    def delay_state(dl, c, dtype, write):
        st = dl.init_state((c,), dtype, dev)
        st["buf"] = torch.as_tensor(noise(c, dl.buf_len), dtype=dtype, device=dev)
        st["write"] = torch.tensor(write, dtype=torch.int32, device=dev)
        return st

    def freeverb_state(fv, c, dtype, step):
        st = fv.init_state((c,), dtype, dev)
        return {"combs": [torch.as_tensor(noise(*r.shape), dtype=dtype, device=dev)
                          for r in st["combs"]],
                "filter_store": torch.as_tensor(noise(c, 8, scale=0.05),
                                                dtype=dtype, device=dev),
                "allpasses": [torch.as_tensor(noise(*r.shape), dtype=dtype,
                                              device=dev) for r in st["allpasses"]],
                "step": torch.tensor(step, dtype=torch.int32, device=dev)}

    def fdn_state(rv, c, dtype, step, lfo):
        st = rv.init_state((c,), dtype, dev)
        return {"lines": torch.as_tensor(noise(c, 8, rv.line_len), dtype=dtype,
                                         device=dev),
                "pre": torch.as_tensor(noise(c, rv.pre_len), dtype=dtype, device=dev),
                "filter": torch.as_tensor(noise(c, 8, scale=0.05), dtype=dtype,
                                          device=dev),
                "lfo_phase": torch.tensor(lfo, dtype=dtype, device=dev),
                "step": torch.tensor(step, dtype=torch.int32, device=dev)}

    def delay_pair(dl, st, x, target=None):
        cur = dl.trajectory(st["current"], x.shape[-1], target)
        return (lambda s: feedback.delay_feedback(dl, s["buf"], s["write"], x, cur),
                lambda s: feedback.delay_feedback_plain(dl, s["buf"], s["write"],
                                                        x, cur))

    def fdn_pair(rv, x):
        inp = x * 0.5 + 0.1          # any pre-delayed input
        args = lambda s: (rv, s["lines"], s["filter"], s["lfo_phase"], s["step"],
                          x, inp)
        return (lambda s: feedback.fdn_feedback(*args(s)),
                lambda s: feedback.fdn_feedback_plain(*args(s)))

    fv_chain = Freeverb()
    rv_chain = FDNReverb(SR, wet=0.22, damp=0.45)     # the node's defaults
    dl_chain = Delay(SR)
    dl_96, dl_24 = Delay(SR, delay_seconds=0.002), Delay(SR, delay_seconds=0.0005)
    cases = []
    for dt in dtypes:
        xc = lambda c, n, dt=dt: torch.as_tensor(noise(c, n, scale=1.0), dtype=dt,
                                                 device=dev)
        cases += [
            ("delay_feedback", dt, "chain block 64x512, aligned cursor",
             delay_state(dl_chain, CHAIN_CH, dt, 1024), dl_chain, xc(CHAIN_CH, CHAIN_BLOCK)),
            ("delay_feedback", dt, "C=65 N=1000, cursor 777 (linear extension, "
             "tail, rotation)", delay_state(dl_chain, 65, dt, 777), dl_chain,
             xc(65, 1000)),
            ("delay_feedback", dt, "C=65 N=512, lag 96 (per-sample tier)",
             delay_state(dl_96, 65, dt, 5), dl_96, xc(65, 512)),
            ("delay_feedback", dt, "C=65 N=300, lag 24 (one lane a chunk)",
             delay_state(dl_24, 65, dt, 96000), dl_24, xc(65, 300)),
            ("freeverb_feedback", dt, "chain block 64x512",
             freeverb_state(fv_chain, CHAIN_CH, dt, 1000), fv_chain,
             xc(CHAIN_CH, CHAIN_BLOCK)),
            ("freeverb_feedback", dt, "C=65 N=333 (blocks and a tail)",
             freeverb_state(fv_chain, 65, dt, 5), fv_chain, xc(65, 333)),
            ("fdn_feedback", dt, "chain block 64x512 (per-sample form)",
             fdn_state(rv_chain, CHAIN_CH, dt, 3000, 1.3), rv_chain,
             xc(CHAIN_CH, CHAIN_BLOCK)),
            ("fdn_feedback", dt, "C=65 N=2500 (two blocks and a tail)",
             fdn_state(rv_chain, 65, dt, 77, 6.2), rv_chain, xc(65, 2500)),
            ("fdn_feedback", dt, f"render {CHANNELS}x48000 (46 blocks and an "
             f"896-sample tail in one call)", fdn_state(rv_chain, CHANNELS, dt, 5, 2.1),
             rv_chain, xc(CHANNELS, 48000)),
        ]
    for name, dt, label, st0, fx, x in cases:
        if name == "delay_feedback":
            run_k, run_p = delay_pair(fx, st0, x)
        elif name == "freeverb_feedback":
            run_k = lambda s, fx=fx, x=x: feedback.freeverb_feedback(fx, s, x)
            run_p = lambda s, fx=fx, x=x: feedback.freeverb_feedback_plain(fx, s, x)
        else:
            run_k, run_p = fdn_pair(fx, x)
        out_k = run_k(clone(st0))
        out_p = run_p(clone(st0))
        out_k2 = run_k(clone(st0))
        torch.cuda.synchronize()
        bit, snr, err, ints = compare(out_p, out_k)
        again = compare(out_k, out_k2)[0]
        y_snr = snr_db(host(out_p[-1]), host(out_k[-1]))
        ok = ints and again and (bit or (snr >= SPACE_DB[dname(dt)]
                                         and y_snr >= SPACE_DB[dname(dt)]))
        kernels[name]["errs"].append(err)
        print(f"space check {name} {dname(dt)} {label}: vs plain on the card "
              f"{'bit-equal' if bit else f'y SNR {y_snr:.1f} dB, state and y SNR {snr:.1f} dB'}"
              f", max|err| {err:.3e}, integers equal {ints}, second call "
              f"bit-equal {again} {'ok' if ok else 'FAILED'}")
        assert ok, (name, label)

    # two calls bit-equal to one, split where the reference's forms
    # coincide (Delay 512 + 512 on the aligned ring, Freeverb and the FDN
    # at an internal block boundary), so that the CPU path holds too
    for dt in dtypes:
        xs2 = torch.as_tensor(noise(CHAIN_CH, 2048, scale=1.0), dtype=dt, device=dev)
        for name, fx, st0, cut, n in (
                ("delay_feedback", dl_chain, delay_state(dl_chain, CHAIN_CH, dt, 0),
                 512, 1024),
                ("freeverb_feedback", fv_chain, freeverb_state(fv_chain, CHAIN_CH, dt, 9),
                 384, 1000),
                ("fdn_feedback", rv_chain, fdn_state(rv_chain, CHAIN_CH, dt, 11, 0.4),
                 1024, 2048)):
            s1, y1 = fx.process(clone(st0), xs2[:, :n])
            s2, ya = fx.process(clone(st0), xs2[:, :cut])
            s2, yb = fx.process(s2, xs2[:, cut:n])
            bit = compare(s1, s2)[0] and bits_equal(torch, y1, torch.cat([ya, yb], -1))
            print(f"space check {name} {dname(dt)} two calls ({cut} + {n - cut}) "
                  f"bit-equal to one ({n}): {bit} {'ok' if bit else 'FAILED'}")
            assert bit, name

    # -- the space chain: 64 ch x 94 blocks of 512 ----------------------------
    n_chain = CHAIN_BLOCKS * CHAIN_BLOCK
    burst = np.repeat(rng.uniform(0.0, 1.0, (CHAIN_CH, -(-n_chain // 4800))) > 0.6,
                      4800, axis=1)[:, :n_chain]
    xs_np = (rng.standard_normal((CHAIN_CH, n_chain)) * burst).astype(np.float32)
    raw = json.dumps(SPACE_GRAPH)
    n_cpu = SPACE_CPU_BLOCKS * CHAIN_BLOCK
    ch_cpu = Chain(SR)
    assert ch_cpu.load_graph(raw, auto_fuse=False) == []
    t0 = time.perf_counter()
    _, y_cpu = ch_cpu.process_blocks(
        ch_cpu.init_state((CHAIN_CH,), torch.float64, "cpu"),
        torch.as_tensor(xs_np[:, :n_cpu], dtype=torch.float64))
    cpu_s = time.perf_counter() - t0
    y_cpu = y_cpu.numpy()
    _, y_cpu32 = ch_cpu.process_blocks(
        ch_cpu.init_state((CHAIN_CH,), torch.float32, "cpu"),
        torch.as_tensor(xs_np[:, :n_cpu]))
    cpu32 = snr_db(y_cpu, y_cpu32.numpy())
    bars = {torch.float32: space_bar32(cpu32), torch.float64: SPACE_DB["float64"]}
    space_ms = {}
    for dt in dtypes:
        path = f"space_chain_{dname(dt)}"
        ch = Chain(SR)
        assert ch.load_graph(raw, auto_fuse=False) == []
        xs = torch.as_tensor(xs_np, dtype=dt, device=dev)
        st = ch.init_state((CHAIN_CH,), dt, dev)
        (_, ys), used = driven(path, lambda: ch.process_blocks(st, xs), names)
        assert used == {n: CHAIN_BLOCKS for n in names}, used
        yh = host(ys)
        assert yh.shape == (CHAIN_CH, n_chain) and np.all(np.isfinite(yh))
        s = snr_db(y_cpu, yh[:, :n_cpu])
        print(f"space {path} {CHAIN_CH}x{n_chain} ({CHAIN_BLOCKS} blocks): "
              f"launches per block {json.dumps({n: v / CHAIN_BLOCKS for n, v in used.items()})}"
              f", plain versions called 0; the first {SPACE_CPU_BLOCKS} blocks vs "
              f"the CPU path in float64 (its {cpu_s:.2f} s; its float32 run "
              f"{cpu32:.1f} dB) SNR {s:.1f} dB "
              f"(bar >= {bars[dt]:.1f}) {'ok' if s >= bars[dt] else 'FAILED'}")
        assert s >= bars[dt], path
        st_t = ch.init_state((CHAIN_CH,), dt, dev)
        space_ms[dt] = time_ms(torch, lambda: ch.process_blocks(st_t, xs), reps=3,
                               warmup=1) / CHAIN_BLOCKS
        act = device_activity(torch, lambda: ch.process(st_t, xs[:, :CHAIN_BLOCK]),
                              10, ("delay_feedback_", "freeverb_", "fdn_"))
        parts = ", ".join(f"{k} {t:.4f}" for k, t in act["by_name"].items())
        busy = ("device time not measured" if act["ms"] is None else
                f"device {act['ms']:.4f} ms a block in {act['count']:.0f} kernels "
                f"and copies ({parts}), busy {100 * act['ms'] / space_ms[dt]:.1f}% "
                f"of the wall (profiler; {act['dropped']} records in one session "
                f"only)")
        print(f"time {path} per block ({CHAIN_CH}x{CHAIN_BLOCK}, mean over 3 x "
              f"{CHAIN_BLOCKS} blocks of process_blocks): {space_ms[dt]:.4f} ms, "
              f"real-time factor {block_ms / space_ms[dt]:.2f}; {busy} ({gpu})")
    # the same graph with the fusion pass: low-cut and delay in one FIR (K1)
    ch_f = Chain(SR)
    report = ch_f.load_graph(raw)
    assert len(report) == 1 and report[0][0] == ["lowcut", "echo"], report
    xs = torch.as_tensor(xs_np, device=dev)
    st_f = ch_f.init_state((CHAIN_CH,), torch.float32, dev)
    (_, yf), used = driven("space_chain_fused", lambda: ch_f.process_blocks(st_f, xs),
                           ("fdl_conv", "freeverb_feedback", "fdn_feedback"))
    assert used == {"fdl_conv": CHAIN_BLOCKS, "freeverb_feedback": CHAIN_BLOCKS,
                    "fdn_feedback": CHAIN_BLOCKS}, used
    s = snr_db(y_cpu, host(yf)[:, :n_cpu])
    fused_ms = time_ms(torch, lambda: ch_f.process_blocks(st_f, xs), reps=1,
                       warmup=0) / CHAIN_BLOCKS
    print(f"space space_chain_fused float32 (fusion report {report}): launches "
          f"per block {json.dumps({n: v / CHAIN_BLOCKS for n, v in used.items()})}, "
          f"plain versions called 0; the first {SPACE_CPU_BLOCKS} blocks vs the "
          f"unfused CPU path in float64 SNR "
          f"{s:.1f} dB (bar >= {bars[torch.float32]:.1f}) "
          f"{'ok' if s >= bars[torch.float32] else 'FAILED'}; "
          f"{fused_ms:.4f} ms a block, real-time factor {block_ms / fused_ms:.2f} "
          f"({gpu})")
    assert s >= bars[torch.float32]

    # -- one-shot renders at 8 x 48128 --------------------------------------
    x_np = rng.standard_normal((CHANNELS, N_FLAGSHIP)) * 0.5
    half = N_FLAGSHIP // 2

    def delay_render(fx, st, x):
        st, ya = fx.process(st, x[..., :half])
        st, yb = fx.process(st, x[..., half:], target_delay_samples=0.1 * SR)
        return st, torch.cat([ya, yb], dim=-1)

    renders = [
        ("freeverb", "Freeverb.process", Freeverb,
         lambda fx, st, x: fx.process(st, x), "freeverb_feedback"),
        ("fdn", "FDNReverb.process", lambda: FDNReverb(SR),
         lambda fx, st, x: fx.process(st, x), "fdn_feedback"),
        ("fdn_blocks", "FDNReverb.process_blocks", lambda: FDNReverb(SR),
         lambda fx, st, x: fx.process_blocks(st, x), "fdn_feedback"),
        ("delay", "Delay.process, retarget to 0.1 s mid-stream",
         lambda: Delay(SR), delay_render, "delay_feedback")]
    for key, label, make, run, name in renders:
        fx = make()
        _, y_ref = run(fx, fx.init_state((CHANNELS,), torch.float64, "cpu"),
                       torch.as_tensor(x_np))
        y_ref = y_ref.numpy()
        _, y32 = run(fx, fx.init_state((CHANNELS,), torch.float32, "cpu"),
                     torch.as_tensor(x_np, dtype=torch.float32))
        cpu32 = snr_db(y_ref, y32.numpy())
        bars = {torch.float32: space_bar32(cpu32), torch.float64: SPACE_DB["float64"]}
        for dt in dtypes:
            xr = torch.as_tensor(x_np, dtype=dt, device=dev)
            path = f"render_{key}_{dname(dt)}"
            (_, yr), used = driven(path, lambda: run(fx, fx.init_state(
                (CHANNELS,), dt, dev), xr), names)
            n_exp = 2 if name == "delay_feedback" else 1
            assert used == {name: n_exp}, used
            s = snr_db(y_ref, host(yr))
            ms = time_ms(torch, lambda: run(fx, fx.init_state((CHANNELS,), dt, dev), xr),
                         reps=3, warmup=1)
            print(f"space render {label} {CHANNELS}x{N_FLAGSHIP} {dname(dt)}: "
                  f"{name} launches {used[name]}, vs the CPU path in float64 SNR "
                  f"{s:.1f} dB (bar >= {bars[dt]:.1f}; the CPU path's float32 "
                  f"{cpu32:.1f}) {'ok' if s >= bars[dt] else 'FAILED'}; "
                  f"{ms:.4f} ms, {N_FLAGSHIP / SR * 1e3 / ms:.1f}x real time ({gpu})")
            assert s >= bars[dt], (label, dt)

    # -- the conv items at 8 x 48128 ------------------------------------------
    xc_np = rng.standard_normal((CHANNELS, N_FLAGSHIP))
    h31, h32, h1000 = (rng.standard_normal(m) * 0.3 for m in (31, 32, 1000))
    tmpl = rng.standard_normal(4800)
    lags = 3000 + 5000 * np.arange(CHANNELS)
    xcor_np = xc_np.copy()
    for c, lag in enumerate(lags):
        xcor_np[c, lag:lag + tmpl.size] += 3.0 * tmpl
    h_dec = 0.8 ** np.arange(64)
    y_dec_np = np.stack([np.convolve(r, h_dec) for r in xc_np])

    def streamed(make, x, blk):
        cv = make()
        st = cv.init_state(x.shape[:-1], x.dtype, x.device)
        ys = []
        for b in range(x.shape[-1] // blk):
            st, yb = cv.process_stream(st, x[..., b * blk:(b + 1) * blk])
            ys.append(yb)
        return torch.cat(ys, dim=-1)

    # (label, input, function of the input on a device in a type)
    items = [
        ("direct 31 taps", xc_np, lambda x: conv.direct(x, h31)),
        ("convolve 31 taps (direct)", xc_np, lambda x: conv.convolve(x, h31)),
        ("convolve 32 taps (FFT)", xc_np, lambda x: conv.convolve(x, h32)),
        (f"OverlapSave 1000 taps streamed over {CHAIN_BLOCKS} blocks", xc_np,
         lambda x: streamed(lambda: conv.OverlapSave(h1000), x, CHAIN_BLOCK)),
        (f"OverlapAdd 1000 taps streamed over {CHAIN_BLOCKS} blocks", xc_np,
         lambda x: streamed(lambda: conv.OverlapAdd(h1000, CHAIN_BLOCK), x,
                            CHAIN_BLOCK)),
        ("correlate 4800-sample template", xcor_np,
         lambda x: conv.correlate(x, tmpl)),
    ] + [(f"deconvolve {m.value}", y_dec_np,
          lambda y, m=m: conv.deconvolve(y, h_dec, conv.DeconvOptions(method=m)))
         for m in conv.DeconvMethod]
    for label, x_in, fn in items:
        ref = host(fn(torch.as_tensor(x_in)))
        cpu32 = snr_db(ref, host(fn(torch.as_tensor(x_in, dtype=torch.float32))))
        got = {}
        for dt in dtypes:
            xd = torch.as_tensor(x_in, dtype=dt, device=dev)
            out = fn(xd)
            got[dt] = snr_db(ref, host(out))
            if label.startswith("correlate"):
                idx, _ = conv.find_peak(out)
                found = host(conv.lag_from_index(idx, tmpl.size))
                assert np.array_equal(found, lags), (found, lags)
            if dt == torch.float32:
                ms = time_ms(torch, lambda: fn(xd), reps=3)
        bar32 = cpu32 - 6.0
        ok = got[torch.float32] >= bar32 and got[torch.float64] >= 200.0
        print(f"space conv {label} {CHANNELS}x{x_in.shape[-1]}: vs the CPU path "
              f"in float64, float32 {got[torch.float32]:.1f} dB (bar >= "
              f"{bar32:.1f}: the CPU path's float32 {cpu32:.1f} less 6), float64 "
              f"{got[torch.float64]:.1f} dB (bar >= 200)"
              + (f", peak lags {lags.tolist()} found"
                 if label.startswith("correlate") else "")
              + f" {'ok' if ok else 'FAILED'}; float32 {ms:.4f} ms ({gpu})")
        assert ok, label
    # cuDNN's TF32 default: direct bit-equal under allow_tf32 True and False,
    # the caller's setting restored
    cudnn = torch.backends.cudnn
    saved = cudnn.allow_tf32
    xt = torch.as_tensor(xc_np, dtype=torch.float32, device=dev)
    outs = {}
    try:
        for flag in (True, False):
            cudnn.allow_tf32 = flag
            outs[flag] = conv.direct(xt, h31)
            assert cudnn.allow_tf32 is flag
    finally:
        cudnn.allow_tf32 = saved
    same = bits_equal(torch, outs[True], outs[False])
    print(f"space TF32 check: direct 31 taps float32 bit-equal under "
          f"cudnn.allow_tf32 True and False: {same}, the setting restored "
          f"{'ok' if same else 'FAILED'}")
    assert same

    # -- R1-R3's times beside their bounds -------------------------------------
    mhz = dynfb.sm_clock_mhz()
    cycles = {"freeverb_feedback": feedback.damp_step_cycles(fv_chain.damp, True),
              "fdn_feedback": feedback.damp_step_cycles(rv_chain.damp, False)}
    xg = torch.as_tensor(noise(CHAIN_CH, CHAIN_BLOCK, scale=1.0), dtype=torch.float32,
                         device=dev)
    ig = xg * 0.5
    st_d = delay_state(dl_chain, CHAIN_CH, torch.float32, 0)
    cur = dl_chain.trajectory(st_d["current"], CHAIN_BLOCK)
    st_v = freeverb_state(fv_chain, CHAIN_CH, torch.float32, 0)
    st_r = fdn_state(rv_chain, CHAIN_CH, torch.float32, 0, 0.0)
    calls = {
        "delay_feedback": (
            lambda: feedback.delay_feedback(dl_chain, st_d["buf"], st_d["write"], xg, cur),
            lambda: feedback.delay_feedback_plain(dl_chain, st_d["buf"], st_d["write"],
                                                  xg, cur)),
        "freeverb_feedback": (
            lambda: feedback.freeverb_feedback(fv_chain, st_v, xg),
            lambda: feedback.freeverb_feedback_plain(fv_chain, st_v, xg)),
        "fdn_feedback": (
            lambda: feedback.fdn_feedback(rv_chain, st_r["lines"], st_r["filter"],
                                          st_r["lfo_phase"], st_r["step"], xg, ig),
            lambda: feedback.fdn_feedback_plain(rv_chain, st_r["lines"],
                                                st_r["filter"], st_r["lfo_phase"],
                                                st_r["step"], xg, ig))}
    # bytes: x (and the FDN's pre-delayed input) read, y written, each ring
    # slot the walk reads (N + 1 a ring) and writes (N), the lag trajectory
    slots = {"delay_feedback": 1, "freeverb_feedback": 12, "fdn_feedback": 8}
    for name, (call, plain_call) in calls.items():
        k = kernels[name]
        c, n = CHAIN_CH, CHAIN_BLOCK
        nbytes = 4.0 * (c * n * (2 + (name == "fdn_feedback"))
                        + c * slots[name] * (2 * n + 1)
                        + (n if name == "delay_feedback" else 0))
        k["ms_at"] = (f"per space-chain block, {c} x {n} float32 (the graph's "
                      f"node)")
        k["ms"] = graph_ms(torch, call, 20)
        k["call_ms"] = time_ms(torch, call, 20)
        k["plain_ms"] = time_ms(torch, plain_call, 1, warmup=0)
        k["bound_ms"], k["bound_by"] = bound(nbytes, float(R_SAMPLE_OPS[name] * c * n))
        k["library_ms"] = None
        chain_txt = ""
        if name in cycles:
            k["step_cycles"] = {"float32": cycles[name]}
            k["sm_mhz"] = mhz
            k["chain_bound_ms"] = {"space block float32": n * cycles[name] / mhz * 1e-3}
            cb = k["chain_bound_ms"]["space block float32"]
            chain_txt = (f", chain bound {cb:.6f} ms ({n} damping steps x "
                         f"{cycles[name]:.1f} cycles / {mhz:.0f} MHz, "
                         f"{100 * cb / k['ms']:.1f}% of the kernel)")
        print(f"time {name} {k['ms_at']}: kernel {k['ms']:.4f} ms (graph replay; "
              f"{k['call_ms']:.4f} ms as back-to-back calls), bound "
              f"{k['bound_ms']:.6f} ms ({k['bound_by']}, "
              f"{100 * k['bound_ms'] / k['ms']:.1f}% of the kernel){chain_txt}, "
              f"plain {k['plain_ms']:.4f} ms, library none ({gpu})")
    for name in names:
        kernels[name]["launches"] = sum(kernels[name]["by_path"].values())
    print(f"space launches by path: "
          f"{json.dumps({n: {p: v for p, v in kernels[n]['by_path'].items() if v} for n in names})}"
          f"; phase {time.perf_counter() - t_ph:.2f} s")
    assert all(kernels[n]["by_path"].get("space_chain_float32") == CHAIN_BLOCKS
               for n in names)


# Phase 12: the modulation and waveshaping slice through the effect chain,
# at the chain cell's width. MOD_GRAPH is a guitar or synth bus's
# modulation strip (M1, M2 and the tremolo's smoothing on K3 a block);
# WAVE_GRAPH a lo-fi or colour strip (K3 for the Chebyshev DC bypass and
# the transformer's three 4x chains, K4 under the bass exciter's limiter;
# the slow 25, 40 and 80 Hz poles on the whole-cascade engine). The bit
# crusher leads, so it quantises the input itself. Both at the registry's
# defaults.
MOD_GRAPH = {
    "nodes": [
        {"id": "drive", "type": "distortion", "params": {"mode": "tanh",
                                                         "drive": 1.8}},
        {"id": "chorus", "type": "chorus", "params": {}},
        {"id": "phaser", "type": "phaser", "params": {}},
        {"id": "flanger", "type": "flanger", "params": {}},
        {"id": "tremolo", "type": "tremolo", "params": {}}],
    "connections": [{"from": "_input", "to": "drive"},
                    {"from": "drive", "to": "chorus"},
                    {"from": "chorus", "to": "phaser"},
                    {"from": "phaser", "to": "flanger"},
                    {"from": "flanger", "to": "tremolo"},
                    {"from": "tremolo", "to": "_output"}]}
WAVE_GRAPH = {
    "nodes": [
        {"id": "crush", "type": "bitcrusher", "params": {}},
        {"id": "cheb", "type": "dist-cheb", "params": {"order": 3,
                                                       "dcBypass": 1}},
        {"id": "iron", "type": "transformer", "params": {"quality": "high",
                                                         "oversampling": 4}},
        {"id": "bass", "type": "bass", "params": {}},
        {"id": "ring", "type": "ringmod", "params": {}}],
    "connections": [{"from": "_input", "to": "crush"},
                    {"from": "crush", "to": "cheb"},
                    {"from": "cheb", "to": "iron"},
                    {"from": "iron", "to": "bass"},
                    {"from": "bass", "to": "ring"},
                    {"from": "ring", "to": "_output"}]}
# Operations a step, counting floor as one (so the operation bound is a
# floor): M1 the read position and fraction (3), the two taps (4), the
# write (2) and the mix (3); M2 a d x d product and the offset (2 d^2);
# M3 two rows of two products and the offset (8).
M1_SAMPLE_OPS = 12
M3_STEP_OPS = 8


def modulation_phase(torch, dev, gpu, kernels, plain_calls, bqmod, envscan) -> None:
    """Phase 12: the modulation and waveshaping slice on the card. M1-M3
    against their plain versions on the card (M1 bit for bit: the chain's
    flanger, C = 65 with a ragged tail, a 0.1 ms base delay in the
    per-sample form; M2 and M3 at the chain's and the one-shot shapes and
    a ragged tail, float32 and float64); MOD_GRAPH and WAVE_GRAPH streamed
    over 64 ch x 94 blocks of 512 in float32 and float64 against the CPU
    path in float64, with launches per block, no plain version called, ms
    per block, real-time factor and the profiler's busy share; the
    AutoWah, the FrequencyShifter at +-100 Hz and the Chorus, Phaser and
    Flanger (one call, then 94 blocks) at 8 x 48128; M1-M3's times beside
    their bounds. M1-M3 join the `kernels` line."""
    from algodsp_tpu_torch.chain import Chain
    from algodsp_tpu_torch.effects import modulation as modfx
    from algodsp_tpu_torch.ops import dynfb, feedback, linrec

    t_ph = time.perf_counter()
    names = ("flanger_feedback", "affine_scan_nd", "affine2_scan")
    earlier = list(next(iter(kernels.values()))["by_path"])
    specs = {
        "flanger_feedback": (
            "algodsp_tpu_torch/csrc/feedback.cu", feedback.flanger_feedback,
            "algodsp_tpu/effects/modulation/modulation.py:233-299 (Flanger."
            "_sample_scan and the blocked scan of process; lax.scans, no "
            "Pallas)"),
        "affine_scan_nd": (
            "algodsp_tpu_torch/csrc/affine.cu", linrec.affine_scan_nd,
            "algodsp_tpu/ops/linrec.py:469 (affine_scan_nd, an "
            "associative_scan; no Pallas)"),
        "affine2_scan": (
            "algodsp_tpu_torch/csrc/affine.cu", linrec.affine2_scan,
            "algodsp_tpu/ops/linrec.py:428 (affine2_scan, an "
            "associative_scan; no Pallas)")}
    for name, (source, wrapper, repl) in specs.items():
        kernels[name] = {"route": "cuda", "source": source, "replaces": repl,
                         "wrapper": wrapper, "errs": [],
                         "by_path": {p: 0 for p in earlier}}
    plain = [(feedback, "flanger_feedback_plain"), (feedback, "flanger_scan_plain"),
             (linrec, "affine2_scan_plain"), (linrec, "affine_scan_nd_plain"),
             (bqmod, "biquad_cascade_plain"), (envscan, "envelope_scan_plain")]
    rng = np.random.default_rng(14)
    dtypes = (torch.float32, torch.float64)
    dname = lambda dt: str(dt)[6:]
    block_ms = CHAIN_BLOCK / SR * 1e3

    def driven(path, fn, allowed):
        """fn() with every launch counter at 0 before and read after, the
        plain versions' calls counted (none may be called); the launches
        go to `by_path`."""
        for k in kernels.values():
            k["wrapper"].launches = 0
        with plain_calls(plain) as plain_n:
            out = fn()
            torch.cuda.synchronize()
        launches = {n: k["wrapper"].launches for n, k in kernels.items()}
        for n, k in kernels.items():
            k["by_path"][path] = launches[n]
        used = {n: v for n, v in launches.items() if v}
        assert not any(plain_n.values()), (path, plain_n)
        assert set(used) <= set(allowed), (path, used)
        return out, used

    def captured(mod, name, fn):
        """fn() with the wrapper `mod.name` recording the arguments of
        each call (tensors cloned before the call: M1 updates its ring in
        place); returns (fn's result, the calls' arguments)."""
        seen, orig = [], getattr(mod, name)

        def recording(*args):
            seen.append([a.clone() if torch.is_tensor(a) else a for a in args])
            return orig(*args)
        # the wrapper counts its launches on the name it is bound to in its
        # module, which is this recorder while it stands in
        recording.launches = 0
        setattr(mod, name, recording)
        try:
            return fn(), seen
        finally:
            setattr(mod, name, orig)

    def noise(*shape, scale=1.0):
        return scale * rng.standard_normal(shape)

    def on(a, dt):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    # -- M1 against its plain version on the card, bit for bit ------------------
    fl_chain = modfx.Flanger(SR, rate_hz=0.25, base_delay_seconds=0.001,
                             depth_seconds=0.0015, feedback=0.25, mix=0.5)
    fl_short = modfx.Flanger(SR, rate_hz=0.25, base_delay_seconds=0.0001,
                             depth_seconds=0.0015, feedback=0.9, mix=0.5)
    for dt in dtypes:
        for label, fl, c, n, phase in (
                (f"chain block {CHAIN_CH}x{CHAIN_BLOCK} (46-sample blocks, a "
                 "per-sample tail)", fl_chain, CHAIN_CH, CHAIN_BLOCK, 1.3),
                ("C=65 N=1000 (21 blocks and a ragged tail)", fl_chain, 65, 1000,
                 5.0),
                ("C=65 N=700, base 0.1 ms (per-sample form, lags under a chunk)",
                 fl_short, 65, 700, 4.2)):
            x = on(noise(c, n), dt)
            buf = on(noise(c, fl.buf_len, scale=0.3), dt)
            w = torch.tensor(70000, dtype=torch.int32, device=dev)
            d = fl.lags(torch.tensor(phase, dtype=dt, device=dev), n, x)
            out_k = feedback.flanger_feedback(fl, buf.clone(), w, x, d)
            out_p = feedback.flanger_feedback_plain(fl, buf.clone(), w, x, d)
            out_k2 = feedback.flanger_feedback(fl, buf.clone(), w, x, d)
            torch.cuda.synchronize()
            bit = all(bits_equal(torch, a, b) for a, b in ((out_k[0], out_p[0]),
                                                           (out_k[2], out_p[2])))
            ints = int(out_k[1]) == int(out_p[1]) == 70000 + n
            again = all(bits_equal(torch, a, b) for a, b in ((out_k[0], out_k2[0]),
                                                             (out_k[2], out_k2[2])))
            err = float(torch.max(torch.abs(out_k[2] - out_p[2])))
            kernels["flanger_feedback"]["errs"].append(err)
            ok = bit and ints and again
            print(f"modulation check flanger_feedback {dname(dt)} {label}: y and "
                  f"ring bit-equal to the plain version on the card {bit}, "
                  f"counter {int(out_k[1])} equal {ints}, second call bit-equal "
                  f"{again} {'ok' if ok else 'FAILED'}")
            assert ok, label

    # -- M2 and M3 against their plain versions on the card -----------------------
    def scan_check(name, label, args):
        """The kernel and the plain version on the same inputs on the card,
        and the plain version in float64 of the same inputs: float64 >=
        200 dB; float32 >= 100 dB or no more than 6 dB under the plain
        version's own float32 reading against float64 (the kernel scans
        chunks over time, the plain version composes by doubling); a
        second call bit-equal to the first."""
        kern = getattr(linrec, name)
        plain_fn = getattr(linrec, f"{name}_plain")
        out_k = kern(*args)
        out_k2 = kern(*args)
        out_p = plain_fn(*args)
        ref = plain_fn(*(a.double() for a in args))
        torch.cuda.synchronize()
        again = all(bits_equal(torch, a, b) for a, b in zip(out_k, out_k2))
        cat = lambda o: np.concatenate([host(t).ravel() for t in o])
        got, want, r64 = cat(out_k), cat(out_p), cat(ref)
        s_kp = snr_db(want, got)
        dt = args[0].dtype
        if dt == torch.float64:
            bar, cls = 200.0, None
        else:
            cls = snr_db(r64, want)
            bar = min(100.0, cls - 6.0)
        k64 = snr_db(r64, got)
        err = float(np.max(np.abs(got - want)))
        kernels[name]["errs"].append(err)
        ok = s_kp >= bar and again
        extra = ("" if cls is None else
                 f"; against float64: the kernel {k64:.1f} dB, the plain "
                 f"version {cls:.1f} dB")
        print(f"modulation check {name} {dname(dt)} {label} (plan "
              f"{scan_plan(name, args)}): vs plain on the card SNR {s_kp:.1f} "
              f"dB (bar >= {bar:.1f}){extra}, max|err| {err:.3e}, second call "
              f"bit-equal {again} {'ok' if ok else 'FAILED'}")
        assert ok, (name, label)

    def scan_plan(name, args):
        """The kernel's schedule for these arguments, as its wrapper plans
        it on this card."""
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        if name == "affine2_scan":
            lead = torch.broadcast_shapes(args[0].shape[:-2], args[1].shape[:-2],
                                          args[2].shape[:-1])
            L, threads, B, tile = linrec.m3_plan(args[0].shape[-2], lead.numel(),
                                                 args[0].element_size(), sms)
            return (f"L {L}, {threads} threads, cluster {B}, "
                    f"{lead.numel() * B} blocks, tile {tile}")
        lead = torch.broadcast_shapes(args[1].shape[:-2], args[2].shape[:-1])
        G, K, L, threads, B = linrec.m2_plan(args[0].shape[0], lead.numel(),
                                             args[0].shape[-1],
                                             args[0].element_size(), sms)
        return (f"d {args[0].shape[-1]}, G {G}, K {K}, L {L}, {threads} threads, "
                f"cluster {B}, {-(-lead.numel() // G) * B} blocks")

    def synth_nd_args(c, n, d, dt):
        """M2's arguments without the Phaser (whose d is 2..13): per-step
        matrices of a decaying random walk (entries of deviation 0.9 /
        sqrt(d), shared by the channels), offsets and states from the
        seed."""
        a = noise(n, d, d, scale=0.9 / math.sqrt(d))
        return [on(a, dt), on(noise(c, n, d), dt), on(noise(c, d), dt)]

    def phaser_args(c, n, stages, dt):
        ph = modfx.Phaser(SR, stages=stages, rate_hz=0.4, feedback=0.2, mix=0.5)
        st = ph.init_state((c,), dt, dev)
        st = {"x1": on(noise(c, stages, scale=0.2), dt),
              "y1": on(noise(c, stages, scale=0.2), dt),
              "fb": on(noise(c, scale=0.2), dt), "phase": st["phase"] + 2.0}
        _, seen = captured(linrec, "affine_scan_nd",
                           lambda: ph.process(st, on(noise(c, n), dt)))
        return seen[0]

    def autowah_args(c, n, dt):
        aw = modfx.AutoWah(SR)
        levels = np.repeat(rng.uniform(0.02, 1.0, (c, -(-n // 1000))), 1000,
                           axis=1)[:, :n]
        _, seen = captured(linrec, "affine2_scan", lambda: aw.process(
            aw.init_state((c,), dt, dev), on(noise(c, n) * levels, dt)))
        return seen[0]

    for dt in dtypes:
        scan_check("affine_scan_nd", f"the chain's phaser {CHAIN_CH}x{CHAIN_BLOCK} "
                   "(6 stages: d = 7, N - 1 = 511 steps)",
                   phaser_args(CHAIN_CH, CHAIN_BLOCK, 6, dt))
        scan_check("affine_scan_nd", "C=65 N=333, 12 stages (d = 13)",
                   phaser_args(65, 333, 12, dt))
        scan_check("affine2_scan", f"the AutoWah {CHANNELS}x{N_FLAGSHIP}",
                   autowah_args(CHANNELS, N_FLAGSHIP, dt))
        scan_check("affine2_scan", f"{CHAIN_CH}x{CHAIN_BLOCK}",
                   autowah_args(CHAIN_CH, CHAIN_BLOCK, dt))
        scan_check("affine2_scan", "C=65 N=333", autowah_args(65, 333, dt))
        # ragged lengths: one step, a chunk and one either side
        for n in (1, linrec.M2_CHUNK - 1, linrec.M2_CHUNK + 1):
            scan_check("affine_scan_nd", f"C=65 N={n} steps, 6 stages (d = 7)",
                       phaser_args(65, n + 1, 6, dt))
        for n in (1, linrec.M3_CHUNK - 1, linrec.M3_CHUNK + 1):
            scan_check("affine2_scan", f"C=65 N={n}", autowah_args(65, n, dt))
        for d in (1, 32):
            scan_check("affine_scan_nd", f"C=65 N=333 steps, d = {d} (random "
                       "decaying matrices)", synth_nd_args(65, 333, d, dt))
        scan_check("affine2_scan", "128x2^16", autowah_args(128, 1 << 16, dt))

    # -- the two graphs: 64 ch x 94 blocks of 512 -------------------------------
    n_chain = CHAIN_BLOCKS * CHAIN_BLOCK
    levels = np.repeat(rng.uniform(0.05, 1.0, (CHAIN_CH, -(-n_chain // 4800))),
                       4800, axis=1)[:, :n_chain]
    xs_np = (0.5 * rng.standard_normal((CHAIN_CH, n_chain)) * levels).astype(np.float32)
    launches_expected = {
        ("mod", torch.float32): {"flanger_feedback": 1, "affine_scan_nd": 1,
                                 "biquad_cascade": 1},
        ("mod", torch.float64): {"flanger_feedback": 1, "affine_scan_nd": 1},
        ("wave", torch.float32): {"biquad_cascade": 4, "envelope": 1},
        ("wave", torch.float64): {"envelope": 1}}
    for gname, graph in (("mod", MOD_GRAPH), ("wave", WAVE_GRAPH)):
        raw = json.dumps(graph)
        ch_cpu = Chain(SR)
        assert ch_cpu.load_graph(raw) == []
        t0 = time.perf_counter()
        _, y_cpu = ch_cpu.process_blocks(
            ch_cpu.init_state((CHAIN_CH,), torch.float64, "cpu"),
            torch.as_tensor(xs_np, dtype=torch.float64))
        cpu_s = time.perf_counter() - t0
        y_cpu = y_cpu.numpy()
        _, y_cpu32 = ch_cpu.process_blocks(
            ch_cpu.init_state((CHAIN_CH,), torch.float32, "cpu"),
            torch.as_tensor(xs_np))
        cpu32 = snr_db(y_cpu, y_cpu32.numpy())
        bars = {torch.float32: min(100.0, cpu32 - 6.0), torch.float64: 200.0}
        for dt in dtypes:
            path = f"{gname}_chain_{dname(dt)}"
            ch = Chain(SR)
            assert ch.load_graph(raw) == []
            xs = torch.as_tensor(xs_np, dtype=dt, device=dev)
            st = ch.init_state((CHAIN_CH,), dt, dev)
            expect = launches_expected[(gname, dt)]
            (_, ys), used = driven(path, lambda: ch.process_blocks(st, xs), expect)
            assert used == {n: v * CHAIN_BLOCKS for n, v in expect.items()}, used
            yh = host(ys)
            assert yh.shape == (CHAIN_CH, n_chain) and np.all(np.isfinite(yh))
            s = snr_db(y_cpu, yh)
            print(f"modulation {path} {CHAIN_CH}x{n_chain} ({CHAIN_BLOCKS} blocks): "
                  f"launches per block "
                  f"{json.dumps({n: v / CHAIN_BLOCKS for n, v in used.items()})}, "
                  f"plain versions called 0; vs the CPU path in float64 (its "
                  f"{cpu_s:.2f} s; its float32 run {cpu32:.1f} dB) SNR {s:.1f} dB "
                  f"(bar >= {bars[dt]:.1f}) {'ok' if s >= bars[dt] else 'FAILED'}")
            assert s >= bars[dt], path
            st_t = ch.init_state((CHAIN_CH,), dt, dev)
            ms = time_ms(torch, lambda: ch.process_blocks(st_t, xs), reps=2,
                         warmup=1) / CHAIN_BLOCKS
            act = device_activity(torch, lambda: ch.process(st_t, xs[:, :CHAIN_BLOCK]),
                                  10, ("flanger_", "affine", "biquad_", "envelope"))
            parts = ", ".join(f"{k} {t:.4f}" for k, t in act["by_name"].items())
            busy = ("device time not measured" if act["ms"] is None else
                    f"device {act['ms']:.4f} ms a block in {act['count']:.0f} "
                    f"kernels and copies ({parts}), busy "
                    f"{100 * act['ms'] / ms:.1f}% of the wall (profiler; "
                    f"{act['dropped']} records in one session only)")
            print(f"time {path} per block ({CHAIN_CH}x{CHAIN_BLOCK}, mean over 2 x "
                  f"{CHAIN_BLOCKS} blocks of process_blocks): {ms:.4f} ms, "
                  f"real-time factor {block_ms / ms:.2f}; {busy} ({gpu})")

    # -- one-shot at 8 x 48128 ----------------------------------------------------
    x_np = 0.5 * rng.standard_normal((CHANNELS, N_FLAGSHIP)) * np.repeat(
        rng.uniform(0.02, 1.0, (CHANNELS, 47)), 1024, axis=1)[:, :N_FLAGSHIP]

    def trio():
        return (modfx.Chorus(SR, speed_hz=0.35, depth_seconds=0.003,
                             base_delay_seconds=0.02, mix=0.18),
                modfx.Phaser(SR, rate_hz=0.4, stages=6, feedback=0.2, mix=0.5),
                modfx.Flanger(SR, rate_hz=0.25, base_delay_seconds=0.001,
                              depth_seconds=0.0015, feedback=0.25, mix=0.5))

    def trio_run(x, blocks):
        fxs = trio()
        sts = [fx.init_state(x.shape[:-1], x.dtype, x.device) for fx in fxs]
        blk = x.shape[-1] // blocks
        outs = []
        for b in range(blocks):
            v = x[..., b * blk:(b + 1) * blk]
            for i, fx in enumerate(fxs):
                sts[i], v = fx.process(sts[i], v)
            outs.append(v)
        return torch.cat(outs, dim=-1)

    def shifter(shift):
        def run(x):
            fs = modfx.FrequencyShifter(SR, shift_hz=shift)
            _, (up, down) = fs.process(fs.init_state((), x.dtype, x.device), x)
            return torch.stack([up, down])
        return run

    def autowah(x):
        aw = modfx.AutoWah(SR)
        return aw.process(aw.init_state(x.shape[:-1], x.dtype, x.device), x)[1]

    both = lambda launches: {dt: launches for dt in dtypes}
    items = [("autowah", "AutoWah", autowah,
              both({"envelope": 1, "affine2_scan": 1})),
             ("shift_up", "FrequencyShifter +100 Hz", shifter(100.0),
              {torch.float32: {"biquad_cascade": 2}, torch.float64: {}}),
             ("shift_down", "FrequencyShifter -100 Hz", shifter(-100.0),
              {torch.float32: {"biquad_cascade": 2}, torch.float64: {}}),
             ("trio", "Chorus, Phaser, Flanger in one call", lambda x: trio_run(x, 1),
              both({"affine_scan_nd": 1, "flanger_feedback": 1})),
             ("trio_blocks", f"Chorus, Phaser, Flanger in {CHAIN_BLOCKS} blocks",
              lambda x: trio_run(x, CHAIN_BLOCKS),
              both({"affine_scan_nd": CHAIN_BLOCKS, "flanger_feedback": CHAIN_BLOCKS}))]
    for key, label, fn, expect in items:
        ref = host(fn(torch.as_tensor(x_np)))
        cpu32 = snr_db(ref, host(fn(torch.as_tensor(x_np, dtype=torch.float32))))
        bars = {torch.float32: min(100.0, cpu32 - 6.0), torch.float64: 200.0}
        for dt in dtypes:
            xd = torch.as_tensor(x_np, dtype=dt, device=dev)
            path = f"oneshot_{key}_{dname(dt)}"
            out, used = driven(path, lambda: fn(xd), expect[dt])
            assert used == expect[dt], (label, used)
            yh = host(out)
            assert yh.shape == ref.shape and np.all(np.isfinite(yh))
            s = snr_db(ref, yh)
            ms = time_ms(torch, lambda: fn(xd), reps=3, warmup=1)
            print(f"modulation oneshot {label} {CHANNELS}x{N_FLAGSHIP} {dname(dt)}: "
                  f"launches {json.dumps(used)}, vs the CPU path in float64 SNR "
                  f"{s:.1f} dB (bar >= {bars[dt]:.1f}; the CPU path's float32 "
                  f"{cpu32:.1f}) {'ok' if s >= bars[dt] else 'FAILED'}; {ms:.4f} ms, "
                  f"{N_FLAGSHIP / SR * 1e3 / ms:.1f}x real time ({gpu})")
            assert s >= bars[dt], (label, dt)

    # -- M1-M3's times beside their bounds -----------------------------------------
    mhz = dynfb.sm_clock_mhz()
    c, n = CHAIN_CH, CHAIN_BLOCK
    x32 = on(noise(c, n), torch.float32)
    fl = fl_chain
    buf = on(noise(c, fl.buf_len, scale=0.3), torch.float32)
    w0 = torch.zeros((), dtype=torch.int32, device=dev)
    d = fl.lags(torch.tensor(0.0, device=dev), n, x32)
    lag = int(math.floor(fl.base_delay * SR))
    chunk_cycles = feedback.ring_chunk_cycles(fl.buf_len, lag)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def m3_path(args):
        """M3's critical path in cycles and how it is formed: a pass takes
        a chunk's local pass and walk (L steps each), the scan's levels
        (five over the lanes, log2 of the warps over the warps), the
        cluster's fold and the two applications that give a chunk its
        entering state (B + 2 walk steps); the passes run in turn. The
        pieces are the latency probes' cycles in float64 (the kernel's
        maps and walk run in double)."""
        c3, n3 = args[0].shape[0], args[0].shape[-2]
        L, threads, B, tile = linrec.m3_plan(n3, c3, args[0].element_size(), sms)
        passes = -(-n3 // (B * tile))
        levels = 5 + max(0, math.ceil(math.log2(threads // 32)))
        loc = linrec.scan_step_cycles(2, torch.float64, kind=linrec.STEP_LOCAL_2)
        walk = linrec.scan_step_cycles(2, torch.float64)
        lev = linrec.scan_step_cycles(2, torch.float64, kind=linrec.SCAN_LEVEL_2)
        cyc = passes * (L * (loc + walk) + levels * lev + (B + 2) * walk)
        return cyc, (f"{passes} pass(es) x ({L} steps x ({loc:.1f} + {walk:.1f}) "
                     f"cycles + {levels} levels x {lev:.1f} + {B + 2} x {walk:.1f})")

    def m2_path(args):
        """M2's critical path in cycles: a pass takes a chunk's composite,
        its zero-state pass and its walk (L steps each), the carry over
        the K chunks, the cluster's fold over B ranks and a chunk's
        entering state (one step): (3 L + K + B + 1) steps of one thread's
        d-vector (the STEP_ND probe); the passes run in turn."""
        n2, d2 = args[0].shape[0], args[0].shape[-1]
        c2 = args[1].shape[0]
        G, K, L, threads, B = linrec.m2_plan(n2, c2, d2, args[0].element_size(),
                                             sms)
        passes = -(-n2 // (B * K * L))
        st = linrec.scan_step_cycles(d2, args[0].dtype, kind=linrec.STEP_ND)
        steps = 3 * L + K + B + 1
        return passes * steps * st, (f"{passes} pass(es) x {steps} steps x "
                                     f"{st:.1f} cycles")

    def nd_work(args):
        """M2's bytes (A once, w and s0 read, after and fin written) and
        operations (a d x d product and the offset a step a channel)."""
        n2, d2 = args[0].shape[0], args[0].shape[-1]
        c2 = args[1].shape[0]
        item = args[0].element_size()
        return (item * (n2 * d2 * d2 + 2 * c2 * n2 * d2 + 2 * c2 * d2),
                2 * d2 * d2 * c2 * n2)

    def two_work(args):
        c3, n3 = args[0].shape[0], args[0].shape[-2]
        item = args[0].element_size()
        return item * (8 * c3 * n3 + 4 * c3), M3_STEP_OPS * c3 * n3

    def walk_bound(name, args):
        """The walk in order's chain bound (the earlier design's), for
        comparison: N steps of the walk's dependent step in the type."""
        if name == "affine2_scan":
            n3 = args[0].shape[-2]
            cyc = linrec.scan_step_cycles(2, args[0].dtype)
        else:
            n3 = args[0].shape[0]
            cyc = linrec.scan_step_cycles(args[0].shape[-1], args[0].dtype)
        return n3 * cyc, f"{n3} steps x {cyc:.1f} cycles"

    nd_args = phaser_args(c, n, 6, torch.float32)
    two_args = autowah_args(CHANNELS, N_FLAGSHIP, torch.float32)
    fl_call = lambda: feedback.flanger_feedback(fl, buf, w0, x32, d)
    fl_plain = lambda: feedback.flanger_feedback_plain(fl, buf, w0, x32, d)
    k = kernels["flanger_feedback"]
    at = f"per mod-chain block, {c} x {n} float32 (the graph's flanger)"
    k["ms_at"] = at
    k["ms"] = graph_ms(torch, fl_call, 20)
    k["call_ms"] = time_ms(torch, fl_call, 20)
    k["plain_ms"] = time_ms(torch, fl_plain, 1, warmup=0)
    k["bound_ms"], k["bound_by"] = bound(
        4.0 * (2 * c * n + n + 2 * c * fl.buf_len), float(M1_SAMPLE_OPS * c * n))
    k["library_ms"] = None
    k["sm_mhz"] = mhz
    cyc = -(-n // 32) * chunk_cycles
    k["chain_bound_ms"] = {at: cyc / mhz * 1e-3}
    cb = k["chain_bound_ms"][at]
    print(f"time flanger_feedback {at}: kernel {k['ms']:.4f} ms (graph replay; "
          f"{k['call_ms']:.4f} ms as back-to-back calls), bound "
          f"{k['bound_ms']:.6f} ms ({k['bound_by']}, "
          f"{100 * k['bound_ms'] / k['ms']:.1f}% of the kernel), chain bound "
          f"{cb:.6f} ms ({-(-n // 32)} chunks x {chunk_cycles:.1f} cycles (one "
          f"warp's dependent ring load and store a chunk, lag {lag}) / {mhz:.0f} "
          f"MHz, {100 * cb / k['ms']:.1f}% of the kernel), plain "
          f"{k['plain_ms']:.4f} ms, library none ({gpu})")
    # M2 and M3: the main path's shape first (its numbers go to the kernels
    # line), then float64, M3 at the chain's width and M2 at d = 13
    scan_times = [
        ("affine_scan_nd", f"per mod-chain block, {c} x {n - 1} steps, d = 7, "
         f"float32 (the graph's phaser)", nd_args),
        ("affine2_scan", f"per AutoWah call, {CHANNELS} x {N_FLAGSHIP} float32",
         two_args),
        ("affine_scan_nd", f"per mod-chain block, {c} x {n - 1} steps, d = 7, "
         "float64", phaser_args(c, n, 6, torch.float64)),
        ("affine_scan_nd", f"{c} x {n - 1} steps, d = 13 (12 stages), float32",
         phaser_args(c, n, 12, torch.float32)),
        ("affine2_scan", f"per AutoWah call, {CHANNELS} x {N_FLAGSHIP} float64",
         autowah_args(CHANNELS, N_FLAGSHIP, torch.float64)),
        ("affine2_scan", f"{c} x {n} float32", autowah_args(c, n, torch.float32))]
    for name, at, args in scan_times:
        k = kernels[name]
        call = lambda: getattr(linrec, name)(*args)
        nbytes, ops = (two_work if name == "affine2_scan" else nd_work)(args)
        ms = graph_ms(torch, call, 20)
        call_ms = time_ms(torch, call, 20)
        bms, bby = bound(float(nbytes), float(ops))
        crit, crit_how = (m3_path if name == "affine2_scan" else m2_path)(args)
        walk, walk_how = walk_bound(name, args)
        crit_ms, walk_ms = crit / mhz * 1e-3, walk / mhz * 1e-3
        if "ms" not in k:
            k["ms_at"] = at
            k["ms"], k["call_ms"] = ms, call_ms
            k["plain_ms"] = time_ms(torch, lambda: getattr(
                linrec, f"{name}_plain")(*args), 1, warmup=0)
            k["bound_ms"], k["bound_by"] = bms, bby
            k["library_ms"] = None
            k["sm_mhz"] = mhz
            k["critical_path_ms"] = {at: crit_ms}
            k["chain_bound_ms"] = {at: walk_ms}
        print(f"time {name} {at}: kernel {ms:.4f} ms (graph replay; {call_ms:.4f} "
              f"ms as back-to-back calls), bound {bms:.6f} ms ({bby}, "
              f"{100 * bms / ms:.1f}% of the kernel), critical path "
              f"{crit_ms:.6f} ms ({crit_how} / {mhz:.0f} MHz, "
              f"{100 * crit_ms / ms:.1f}% of the kernel; plan "
              f"{scan_plan(name, args)}), the walk in order's chain bound "
              f"{walk_ms:.6f} ms ({walk_how}), "
              + (f"plain {k['plain_ms']:.4f} ms" if k["ms_at"] == at else
                 "plain timed at the first shape only")
              + f", library none ({gpu})")
    for name in names:
        kernels[name]["launches"] = sum(kernels[name]["by_path"].values())
    print(f"modulation launches by path: "
          f"{json.dumps({n: {p: v for p, v in kernels[n]['by_path'].items() if v} for n in names})}"
          f"; phase {time.perf_counter() - t_ph:.2f} s")
    assert all(kernels[n]["by_path"].get("mod_chain_float32", 0) == CHAIN_BLOCKS
               for n in ("flanger_feedback", "affine_scan_nd"))
    assert kernels["affine2_scan"]["by_path"]["oneshot_autowah_float32"] == 1


# Phase 13: the last effects and the dither quantizer, at the chain cell's
# width. VOICE_GRAPH is a vocal bus: the input ring-modulated at the
# registry's 440 Hz is the vocoder's carrier on port 1 (a robot voice),
# every node at the registry's defaults (K4 once a block on 64 x 32 band
# rows). PITCH_GRAPH is a one-shot pitch strip at the registry's defaults:
# pitch-time at +3 semitones (W1) -> granular -> spectral-freeze.
VOICE_GRAPH = {
    "nodes": [{"id": "ring", "type": "ringmod", "params": {}},
              {"id": "voc", "type": "vocoder", "params": {}}],
    "connections": [{"from": "_input", "to": "voc"},
                    {"from": "_input", "to": "ring"},
                    {"from": "ring", "to": "voc", "toPortIndex": 1},
                    {"from": "voc", "to": "_output"}]}
PITCH_GRAPH = {
    "nodes": [{"id": "shift", "type": "pitch-time", "params": {"semitones": 3}},
              {"id": "grain", "type": "granular", "params": {}},
              {"id": "freeze", "type": "spectral-freeze", "params": {}}],
    "connections": [{"from": "_input", "to": "shift"},
                    {"from": "shift", "to": "grain"},
                    {"from": "grain", "to": "freeze"},
                    {"from": "freeze", "to": "_output"}]}
STRIP_PAIRS = 32        # the stereo strip: 32 pairs, (32, 2, N)
HRTF_TAPS = 4096        # a binaural room response's length (85 ms)
CPU_BLOCKS = 8          # blocks of the chains held against the CPU path


def q1_step_ops(order: int) -> int:
    """Operations of a Q1 FIR step, counting floor as one (so the bound
    is a floor): a product and a sum a coefficient (2 order - 1), the
    subtraction, the dither's add, the floor, the clip's two compares and
    the error (6)."""
    return 2 * order - 1 + 6


def voice_material(rng, c: int, n: int):
    """Smoothed noise under a stepped level (correlation peaks well apart
    for the WSOLA search, as the JAX tests' material), float64."""
    x = np.stack([np.convolve(rng.standard_normal(n), np.ones(8) / 8.0,
                              mode="same") for _ in range(c)])
    return 1.5 * x * np.repeat(rng.uniform(0.1, 1.0, (c, -(-n // 1024))), 1024,
                               axis=1)[:, :n]


def hrtf_set(rng, taps: int) -> dict:
    """A synthetic 4-path binaural room response from a seed: a direct
    impulse and a decaying noise tail on the direct paths, a delayed
    (0.3 ms), weaker impulse and tail on the cross paths."""
    decay = np.exp(-np.arange(taps) / (0.2 * taps))

    def path(lead: int, gain: float):
        h = 0.05 * gain * rng.standard_normal(taps) * decay
        h[lead] += gain
        return h
    return {"left_direct": path(0, 1.0), "right_direct": path(0, 1.0),
            "left_cross": path(14, 0.5), "right_cross": path(14, 0.5)}


def voice_phase(torch, dev, gpu, kernels, plain_calls, bqmod, envscan,
                fdlconv) -> None:
    """Phase 13: the last effects and the dither quantizer on the card. W1
    against its plain version on the card (the music preset at +3, -4 and
    +12 semitones and the pitch-time node at +3, 8 x 48128, -4 and +12 at
    1 and 64 channels, and the tiled schedule at 192 kHz (the node's
    longest windows and a 60 ms search, 2 x 96256), float32 and float64:
    the starts equal, a second call equal, the smallest gap between the
    best and the second-best normalised score printed); Q1 bit-equal to
    its plain
    version (codes and state; the FIR at FC9 and the 8 kHz IIR shelf, the
    export block and a ragged shape; 94 streamed blocks bit-equal to one
    call); VOICE_GRAPH over 64 ch x 94 blocks of 512 and
    the stereo strip on 32 pairs (widener with a 120 Hz bass-mono split,
    canceller, parametric simulator) and the HRTF-set simulator in both
    routings, each in float32 and float64 against the CPU path in float64,
    with launches per block, no plain version called, ms per block,
    real-time factor and busy share, streamed against one call; the
    mastering export (16-bit TPDF at FC9 and with the IIR shelf) over 64
    ch x 94 blocks and one-shot at 8 x 48128; PITCH_GRAPH, pitch-spectral
    at -4 and +1 semitones and WSOLA at +3, -4 and +12 one-shot at 8 x
    48128 (two calls bit-equal); W1's and Q1's times beside their byte,
    operation and chain bounds (W1 also at -4 and +12). W1 and Q1 join
    the `kernels` line."""
    from algodsp_tpu_torch.chain import Chain
    from algodsp_tpu_torch.dither import Quantizer
    from algodsp_tpu_torch.effects import spatial
    from algodsp_tpu_torch.effects.pitch import WSOLAPitchShifter
    from algodsp_tpu_torch.ops import dither as q1mod
    from algodsp_tpu_torch.ops import dynfb
    from algodsp_tpu_torch.ops import wsola as w1mod

    t_ph = time.perf_counter()
    names = ("wsola_search", "error_feedback")
    earlier = list(next(iter(kernels.values()))["by_path"])
    specs = {
        "wsola_search": (
            "algodsp_tpu_torch/csrc/wsola.cu", w1mod.wsola_search,
            "algodsp_tpu/effects/pitch/wsola.py:112-141 (the segment search "
            "of WSOLAPitchShifter._time_stretch, a lax.scan; no Pallas)"),
        "error_feedback": (
            "algodsp_tpu_torch/csrc/dither.cu", q1mod.error_feedback,
            "algodsp_tpu/dither/quantizer.py:228-242 and :256-271 (Quantizer."
            "_process_codes and _process_codes_iir, lax.scans; no Pallas)")}
    for name, (source, wrapper, repl) in specs.items():
        kernels[name] = {"route": "cuda", "source": source, "replaces": repl,
                         "wrapper": wrapper, "errs": [],
                         "by_path": {p: 0 for p in earlier}}
    plain = [(w1mod, "wsola_search_plain"), (q1mod, "error_feedback_plain"),
             (bqmod, "biquad_cascade_plain"), (envscan, "envelope_scan_plain"),
             (fdlconv, "fdl_conv_plain")]
    rng = np.random.default_rng(15)
    dtypes = (torch.float32, torch.float64)
    dname = lambda dt: str(dt)[6:]
    block_ms = CHAIN_BLOCK / SR * 1e3
    n_chain = CHAIN_BLOCKS * CHAIN_BLOCK
    n_cpu = CPU_BLOCKS * CHAIN_BLOCK

    def driven(path, fn, allowed):
        """fn() with every launch counter at 0 before and read after, the
        plain versions' calls counted (none may be called); the launches
        go to `by_path`."""
        for k in kernels.values():
            k["wrapper"].launches = 0
        with plain_calls(plain) as plain_n:
            out = fn()
            torch.cuda.synchronize()
        launches = {n: k["wrapper"].launches for n, k in kernels.items()}
        for n, k in kernels.items():
            k["by_path"][path] = launches[n]
        used = {n: v for n, v in launches.items() if v}
        assert not any(plain_n.values()), (path, plain_n)
        assert set(used) <= set(allowed), (path, used)
        return out, used

    def on(a, dt):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    def busy_line(act, ms):
        parts = ", ".join(f"{k} {t:.4f}" for k, t in act["by_name"].items())
        if act["ms"] is None:
            return "device time not measured"
        return (f"device {act['ms']:.4f} ms a block in {act['count']:.0f} "
                f"kernels and copies ({parts}), busy {100 * act['ms'] / ms:.1f}% "
                f"of the wall (profiler; {act['dropped']} records in one "
                f"session only)")

    # -- W1 against its plain version on the card --------------------------------
    x8_np = voice_material(rng, CHANNELS, N_FLAGSHIP)
    music = lambda st: WSOLAPitchShifter(SR, pitch_ratio=2.0 ** (st / 12.0))
    node_ws = WSOLAPitchShifter(SR, pitch_ratio=2.0 ** (3 / 12.0),
                                sequence_ms=40.0, overlap_ms=10.0,
                                seek_window_ms=15.0)
    w1_args = {}
    x64_np = voice_material(rng, CHAIN_CH, N_FLAGSHIP)
    w1_cases = [("music preset +3", music(3), x8_np), ("music preset -4", music(-4), x8_np),
                ("music preset +12", music(12), x8_np),
                ("pitch-time node +3 (seq 40, ov 10, seek 15 ms)", node_ws, x8_np),
                ("music preset -4, 1 channel", music(-4), x8_np[:1]),
                ("music preset +12, 1 channel", music(12), x8_np[:1]),
                (f"music preset -4, {CHAIN_CH} channels", music(-4), x64_np),
                (f"music preset +12, {CHAIN_CH} channels", music(12), x64_np)]
    # the tiled schedule: the pitch-time node's longest windows at 192 kHz
    # (overlap 60 ms, search 40 ms: 6 tiles of j, the last ragged), and a
    # 60 ms search (two passes of offsets a block)
    x192_np = voice_material(rng, 2, 2 * N_FLAGSHIP)
    for seek_ms in (40.0, 60.0):
        ws = WSOLAPitchShifter(192000.0, pitch_ratio=2.0 ** (3 / 12.0),
                               sequence_ms=120.0, overlap_ms=60.0,
                               seek_window_ms=seek_ms)
        assert w1mod.plan(ws.seek, ws.overlap, 4)[2]
        w1_cases.append((f"192 kHz +3 (seq 120, ov 60, seek {seek_ms:.0f} ms), "
                         f"tiled", ws, x192_np))
    for dt in dtypes:
        for label, ws, xw in w1_cases:
            chans, n_w = xw.shape
            rs, edge, tail0, n_ext = ws.plan(n_w, 1.0 / ws.pitch_ratio)
            x2 = torch.nn.functional.pad(on(xw, dt), (0, n_ext - n_w))
            args = (x2, w1mod.energy_prefix(x2), rs, edge, ws.overlap, ws.seek,
                    ws.sequence - ws.overlap, tail0)
            s_k = w1mod.wsola_search(*args)
            s_p = w1mod.wsola_search_plain(*args)
            s_k2 = w1mod.wsola_search(*args)
            torch.cuda.synchronize()
            equal, again = torch.equal(s_k, s_p), torch.equal(s_k, s_k2)
            err = float(torch.max(torch.abs(s_k.long() - s_p.long())))
            kernels["wsola_search"]["errs"].append(err)
            # the smallest relative gap between the best and the second-best
            # normalised score along the kernel's walk (loud, non-boundary
            # steps): a float32 flip needs a gap near 1e-6
            tail = torch.full((chans,), tail0, dtype=torch.int64, device=dev)
            gaps = []
            for s, a in enumerate(rs.tolist()):
                score, norm2 = w1mod.step_scores(x2, args[1], a, tail, ws.overlap,
                                                 ws.seek)
                top = torch.topk(score, 2, dim=-1).values
                loud = ~(torch.amax(norm2, dim=-1) <= 1e-12)
                if not edge[s] and bool(loud.any()):
                    gaps.append(((top[:, 0] - top[:, 1]) / top[:, 0].abs())[loud])
                tail = s_k[s].long() + (ws.sequence - ws.overlap)
            gap = float(torch.cat(gaps).min())
            ok = equal and again
            tiled = w1mod.plan(ws.seek, ws.overlap, x2.element_size())[2]
            print(f"voice check wsola_search {dname(dt)} {label} {chans}x"
                  f"{n_w} (S={len(rs)}, seek {ws.seek}, ov {ws.overlap}, "
                  f"cluster {w1mod.CLUSTER}, {'tiled' if tiled else 'staged'}): "
                  f"starts equal to the plain version on the card {equal}, second "
                  f"call equal {again}, smallest best/second score gap "
                  f"{gap:.3e} (relative) {'ok' if ok else 'FAILED'}")
            assert ok, label
            w1_args[(label, dt)] = args

    # -- Q1 against its plain version on the card, bit for bit ---------------------
    quant = {"fir": Quantizer(SR), "iir": Quantizer(SR, iir_shelf_freq=8000.0)}

    def q1_args(kind, c, n, dt):
        qz = quant[kind]
        x = np.clip(voice_material(rng, c, n), -1.0, 1.0)
        noise = rng.uniform(0, 1, (c, n)) - rng.uniform(0, 1, (c, n))
        state = 0.3 * rng.standard_normal((c, qz.shaper.state_width()))
        return on(qz.bit_mul * x, dt), on(noise, dt), on(state, dt), qz.shaper

    # (the plain version walks a sample at a time, ~0.4 ms a step on the
    # card: the one-shot shape would take ~20 s; the streamed check below
    # ties the kernel's long call to its blocks)
    q1_cases = [("export block", CHAIN_CH, CHAIN_BLOCK), ("C=65 N=333", 65, 333)]
    for kind in quant:
        for dt in dtypes:
            for label, c, n in q1_cases:
                args = q1_args(kind, c, n, dt)
                q_k, s_k = q1mod.error_feedback(*args)
                q_p, s_p = q1mod.error_feedback_plain(*args)
                torch.cuda.synchronize()
                bit = bits_equal(torch, q_k, q_p) and bits_equal(torch, s_k, s_p)
                err = float(torch.max(torch.abs(q_k - q_p)))
                kernels["error_feedback"]["errs"].append(err)
                print(f"voice check error_feedback {kind} {dname(dt)} {label} "
                      f"{c}x{n}: codes and state bit-equal to the plain version "
                      f"on the card {bit} {'ok' if bit else 'FAILED'}")
                assert bit, (kind, dt, label)
    # streamed in the chain's blocks, the kernel equals its one call
    scaled, noise, state, p = q1_args("fir", CHAIN_CH, n_chain, torch.float32)
    q_one, s_one = q1mod.error_feedback(scaled, noise, state, p)
    st, parts = state, []
    for b in range(CHAIN_BLOCKS):
        cut = slice(b * CHAIN_BLOCK, (b + 1) * CHAIN_BLOCK)
        q_b, st = q1mod.error_feedback(scaled[:, cut], noise[:, cut], st, p)
        parts.append(q_b)
    streamed = bits_equal(torch, torch.cat(parts, -1), q_one) and bits_equal(
        torch, st, s_one)
    print(f"voice check error_feedback fir float32 {CHAIN_BLOCKS} blocks of "
          f"{CHAIN_CH}x{CHAIN_BLOCK} against one call: bit-equal {streamed} "
          f"{'ok' if streamed else 'FAILED'}")
    assert streamed

    # -- VOICE_GRAPH: 64 ch x 94 blocks of 512 ---------------------------------------
    xs_np = voice_material(rng, CHAIN_CH, n_chain).astype(np.float32)
    raw = json.dumps(VOICE_GRAPH)
    ch_cpu = Chain(SR)
    assert ch_cpu.load_graph(raw) == []
    t0 = time.perf_counter()
    _, y_cpu = ch_cpu.process_blocks(ch_cpu.init_state((CHAIN_CH,), torch.float64, "cpu"),
                                     torch.as_tensor(xs_np[:, :n_cpu], dtype=torch.float64))
    cpu_s = time.perf_counter() - t0
    y_cpu = y_cpu.numpy()
    _, y_cpu32 = ch_cpu.process_blocks(ch_cpu.init_state((CHAIN_CH,), torch.float32, "cpu"),
                                       torch.as_tensor(xs_np[:, :n_cpu]))
    cpu32 = snr_db(y_cpu, y_cpu32.numpy())
    bars = {torch.float32: min(100.0, cpu32 - 6.0), torch.float64: 200.0}
    for dt in dtypes:
        path = f"voice_chain_{dname(dt)}"
        ch = Chain(SR)
        assert ch.load_graph(raw) == []
        rows = CHAIN_CH * ch.runtimes["voc"].effect.num_bands
        xs = torch.as_tensor(xs_np, dtype=dt, device=dev)
        st = ch.init_state((CHAIN_CH,), dt, dev)
        (st_f, ys), used = driven(path, lambda: ch.process_blocks(st, xs),
                                  {"envelope"})
        assert used == {"envelope": CHAIN_BLOCKS}, used
        assert tuple(st_f["voc"]["env"].shape) == (CHAIN_CH, rows // CHAIN_CH)
        yh = host(ys)
        assert yh.shape == (CHAIN_CH, n_chain) and np.all(np.isfinite(yh))
        s = snr_db(y_cpu, yh[:, :n_cpu])
        print(f"voice {path} {CHAIN_CH}x{n_chain} ({CHAIN_BLOCKS} blocks): launches "
              f"per block {json.dumps({n: v / CHAIN_BLOCKS for n, v in used.items()})}"
              f" (K4 on {rows} band rows), plain versions called 0; the first "
              f"{CPU_BLOCKS} blocks vs the CPU path in float64 (its {cpu_s:.2f} s; "
              f"its float32 run {cpu32:.1f} dB) SNR {s:.1f} dB (bar >= "
              f"{bars[dt]:.1f}) {'ok' if s >= bars[dt] else 'FAILED'}")
        assert s >= bars[dt], path
        st_t = ch.init_state((CHAIN_CH,), dt, dev)
        ms = time_ms(torch, lambda: ch.process_blocks(st_t, xs), reps=2,
                     warmup=1) / CHAIN_BLOCKS
        act = device_activity(torch, lambda: ch.process(st_t, xs[:, :CHAIN_BLOCK]),
                              10, ("envelope",))
        print(f"time {path} per block ({CHAIN_CH}x{CHAIN_BLOCK}, mean over 2 x "
              f"{CHAIN_BLOCKS} blocks of process_blocks): {ms:.4f} ms, real-time "
              f"factor {block_ms / ms:.2f}; {busy_line(act, ms)} ({gpu})")

    # -- the stereo strip on 32 pairs, and the HRTF-set simulator ---------------------
    irs = hrtf_set(np.random.default_rng(15), HRTF_TAPS)

    def strip_fx():
        return [spatial.StereoWidener(SR, width=1.5, bass_mono_hz=120.0),
                spatial.CrosstalkCanceller(SR), spatial.CrosstalkSimulator(SR)]

    def run_fx(make, x, blocks):
        fxs = make()
        sts = [fx.init_state(x.shape[:-2], x.dtype, x.device) for fx in fxs]
        blk = x.shape[-1] // blocks
        outs = []
        for b in range(blocks):
            v = x[..., b * blk:(b + 1) * blk]
            for i, fx in enumerate(fxs):
                sts[i], v = fx.process(sts[i], v)
            outs.append(v)
        return torch.cat(outs, dim=-1)

    probe = strip_fx()
    k3_chains = [probe[0].lp, probe[0].hp, *probe[1].shelves, probe[2].shelf]
    k3_per_block = sum(not c.has_slow_poles for c in k3_chains)
    items = [("strip", "widener (120 Hz bass mono) -> canceller -> simulator",
              strip_fx, {"biquad_cascade": k3_per_block}),
             ("hrtf_crossfeed", f"HRTF-set simulator crossfeed_only ({HRTF_TAPS} taps)",
              lambda: [spatial.CrosstalkSimulator(SR, hrtf_irs=irs)], {"fdl_conv": 2}),
             ("hrtf_complete", f"HRTF-set simulator complete ({HRTF_TAPS} taps)",
              lambda: [spatial.CrosstalkSimulator(SR, hrtf_irs=irs,
                                                  hrtf_mode="complete")],
              {"fdl_conv": 4})]
    xst_np = voice_material(rng, 2 * STRIP_PAIRS, n_chain).reshape(
        STRIP_PAIRS, 2, n_chain)
    for key, label, make, per_block in items:
        ref = host(run_fx(make, torch.as_tensor(xst_np[..., :n_cpu]), CPU_BLOCKS))
        cpu32 = snr_db(ref, host(run_fx(make, torch.as_tensor(
            xst_np[..., :n_cpu], dtype=torch.float32), CPU_BLOCKS)))
        bars = {torch.float32: min(100.0, cpu32 - 6.0), torch.float64: 200.0}
        for dt in dtypes:
            path = f"stereo_{key}_{dname(dt)}"
            expect = per_block if dt == torch.float32 else {}
            xd = on(xst_np, dt)
            out, used = driven(path, lambda: run_fx(make, xd, CHAIN_BLOCKS), expect)
            want = {n: v * CHAIN_BLOCKS for n, v in expect.items() if v}
            assert used == want, (path, used)
            yh = host(out)
            assert yh.shape == xst_np.shape and np.all(np.isfinite(yh))
            s = snr_db(ref, yh[..., :n_cpu])
            one = run_fx(make, xd, 1)
            s_one = snr_db(host(one), yh)
            one_bar = 100.0 if dt == torch.float32 else 200.0
            ok = s >= bars[dt] and s_one >= one_bar
            ms = time_ms(torch, lambda: run_fx(make, xd, CHAIN_BLOCKS), reps=1,
                         warmup=0) / CHAIN_BLOCKS
            print(f"voice {path} {label} {STRIP_PAIRS}x2x{n_chain} ({CHAIN_BLOCKS} "
                  f"blocks): launches per block "
                  f"{json.dumps({n: v / CHAIN_BLOCKS for n, v in used.items()})}, "
                  f"plain versions called 0; the first {CPU_BLOCKS} blocks vs the "
                  f"CPU path in float64 SNR {s:.1f} dB (bar >= {bars[dt]:.1f}; the "
                  f"CPU path's float32 {cpu32:.1f}); streamed vs one call SNR "
                  f"{s_one:.1f} dB (bar >= {one_bar:.0f}) "
                  f"{'ok' if ok else 'FAILED'}; {ms:.4f} ms a block, real-time "
                  f"factor {block_ms / ms:.2f} ({gpu})")
            assert ok, path
        if key == "strip":
            xd = on(xst_np, torch.float32)
            fxs = strip_fx()
            sts = [fx.init_state((STRIP_PAIRS,), torch.float32, dev) for fx in fxs]

            def one_block():
                v = xd[..., :CHAIN_BLOCK]
                for i, fx in enumerate(fxs):
                    _, v = fx.process(sts[i], v)
                return v
            act = device_activity(torch, one_block, 10, ("biquad_",))
            ms = time_ms(torch, one_block, 20)
            print(f"time stereo_strip_float32 per block ({STRIP_PAIRS}x2x"
                  f"{CHAIN_BLOCK}): {ms:.4f} ms; {busy_line(act, ms)} ({gpu})")

    # -- the mastering export: 16-bit TPDF at FC9, and with the 8 kHz shelf --------
    xe_np = np.clip(voice_material(rng, CHAIN_CH, n_chain), -1.0, 1.0)
    for kind, qz in quant.items():
        for dt in dtypes:
            xe = on(xe_np, dt)

            def export_blocks():
                st = qz.init_state((CHAIN_CH,), dt, dev)
                ys = []
                for b in range(CHAIN_BLOCKS):
                    st, y = qz.process(st, xe[:, b * CHAIN_BLOCK:(b + 1) * CHAIN_BLOCK])
                    ys.append(y)
                return torch.cat(ys, dim=-1)

            path = f"export_{kind}_blocks_{dname(dt)}"
            y, used = driven(path, export_blocks, {"error_feedback"})
            assert used == {"error_feedback": CHAIN_BLOCKS}, used
            x_one = on(xe_np[:CHANNELS, :N_FLAGSHIP], dt)
            path1 = f"export_{kind}_oneshot_{dname(dt)}"
            (st1, y1), used1 = driven(path1, lambda: qz.process(
                qz.init_state((CHANNELS,), dt, dev), x_one), {"error_feedback"})
            assert used1 == {"error_feedback": 1}, used1
            _, y2 = qz.process(st1, x_one)
            checks = []
            for out, x in ((y, xe), (y1, x_one)):
                codes = out / qz.bit_div - 0.5
                # float64 rounds (q + 0.5) * bit_div and back exactly enough
                # to read the code; float32 to within 1e-2
                tol = 1e-6 if dt == torch.float64 else 1e-2
                integral = bool(torch.all(torch.abs(codes - torch.round(codes)) <= tol))
                in_range = bool(torch.all((codes >= qz.limit_lo - tol)
                                          & (codes <= qz.limit_hi + tol)))
                lsb = float(torch.sqrt(torch.mean((out - x).double() ** 2))) * qz.bit_mul
                checks.append((integral and in_range and bool(torch.all(torch.isfinite(out))), lsb))
            redraw = not torch.equal(y1, y2)
            ok = all(c for c, _ in checks) and redraw
            ms = time_ms(torch, export_blocks, reps=1, warmup=0) / CHAIN_BLOCKS
            ms1 = time_ms(torch, lambda: qz.process(qz.init_state((CHANNELS,), dt, dev),
                                                    x_one), reps=3, warmup=1)
            print(f"voice export {kind} {dname(dt)}: {CHAIN_CH}x{n_chain} in "
                  f"{CHAIN_BLOCKS} blocks (Q1 {used['error_feedback']} launches) "
                  f"and one-shot {CHANNELS}x{N_FLAGSHIP} (Q1 1): codes integral, in "
                  f"range and finite {all(c for c, _ in checks)}, error rms "
                  f"{checks[0][1]:.2f} / {checks[1][1]:.2f} LSB, a second call "
                  f"draws new dither {redraw} {'ok' if ok else 'FAILED'}; "
                  f"{ms:.4f} ms a block (real-time factor {block_ms / ms:.2f}), "
                  f"one-shot {ms1:.4f} ms ({gpu})")
            assert ok, (kind, dt)

    # -- one-shot at 8 x 48128: the pitch strip, pitch-spectral and WSOLA ---------------
    def chain_run(graph):
        raw_g = json.dumps(graph)

        def run(x):
            ch = Chain(SR)
            assert ch.load_graph(raw_g) == []
            return ch.process(ch.init_state(x.shape[:-1], x.dtype, x.device), x)[1]
        return run

    def spectral_node(semitones):
        return {"nodes": [{"id": "p", "type": "pitch-spectral",
                           "params": {"semitones": semitones}}],
                "connections": [{"from": "_input", "to": "p"},
                                {"from": "p", "to": "_output"}]}

    w1_once = {"wsola_search": 1}
    items = [("pitch_graph", "PITCH_GRAPH (pitch-time +3 -> granular -> "
              "spectral-freeze)", chain_run(PITCH_GRAPH), w1_once),
             ("pitch_spectral_down4", "pitch-spectral -4 semitones (stretch and "
              "resample)", chain_run(spectral_node(-4)), {}),
             ("pitch_spectral_up1", "pitch-spectral +1 semitone (bin shift)",
              chain_run(spectral_node(1)), {}),
             ("wsola_up3", "WSOLA music preset +3", music(3).process, w1_once),
             ("wsola_down4", "WSOLA music preset -4", music(-4).process, w1_once),
             ("wsola_up12", "WSOLA music preset +12", music(12).process, w1_once)]
    for key, label, fn, expect in items:
        ref = host(fn(torch.as_tensor(x8_np)))
        cpu32 = snr_db(ref, host(fn(torch.as_tensor(x8_np, dtype=torch.float32))))
        bars = {torch.float32: min(100.0, cpu32 - 6.0), torch.float64: 200.0}
        for dt in dtypes:
            xd = on(x8_np, dt)
            path = f"oneshot_{key}_{dname(dt)}"
            out, used = driven(path, lambda: fn(xd), expect)
            assert used == expect, (label, used)
            again = bits_equal(torch, out, fn(xd))
            yh = host(out)
            assert yh.shape == ref.shape and np.all(np.isfinite(yh))
            s = snr_db(ref, yh)
            ok = s >= bars[dt] and again
            ms = time_ms(torch, lambda: fn(xd), reps=3, warmup=1)
            print(f"voice oneshot {label} {CHANNELS}x{N_FLAGSHIP} {dname(dt)}: "
                  f"launches {json.dumps(used)}, vs the CPU path in float64 SNR "
                  f"{s:.1f} dB (bar >= {bars[dt]:.1f}; the CPU path's float32 "
                  f"{cpu32:.1f}), two calls bit-equal {again} "
                  f"{'ok' if ok else 'FAILED'}; {ms:.4f} ms, "
                  f"{N_FLAGSHIP / SR * 1e3 / ms:.1f}x real time ({gpu})")
            assert ok, (label, dt)

    # -- W1's and Q1's times beside their bounds ---------------------------------------
    mhz = dynfb.sm_clock_mhz()
    add_cycles = w1mod.sum_step_cycles()
    wargs = w1_args[("music preset +3", torch.float32)]
    x2, csq, rs, edge, ov, seek, flat, tail0 = wargs
    grid = (torch.as_tensor(np.asarray(rs, np.int32), device=dev),
            torch.as_tensor(np.asarray(edge, np.uint8), device=dev))
    s_count, c_w, n_ext = len(rs), x2.shape[0], x2.shape[1]
    qargs = q1_args("fir", CHAIN_CH, CHAIN_BLOCK, torch.float32)
    order = len(qargs[3].coeffs)
    q_cycles = q1mod.step_cycles(qargs[3])
    timings = {
        "wsola_search": (
            lambda: w1mod.launch(x2, csq, *grid, ov, seek, flat, tail0),
            lambda: w1mod.wsola_search_plain(*wargs),
            f"per WSOLA call, music preset +3 semitones, {c_w} x {N_FLAGSHIP} "
            f"float32 ({s_count} segments, seek {seek}, ov {ov})",
            4.0 * (2 * c_w * n_ext + 1 + s_count * c_w + 2 * s_count),
            2.0 * s_count * c_w * seek * ov + 5.0 * s_count * c_w * seek,
            s_count * ov * add_cycles,
            f"{s_count} segments x {ov} dependent product-and-sum steps x "
            f"{add_cycles:.1f} cycles"),
        "error_feedback": (
            lambda: q1mod.error_feedback(*qargs),
            lambda: q1mod.error_feedback_plain(*qargs),
            f"per export block, {CHAIN_CH} x {CHAIN_BLOCK} float32, FC9 (order "
            f"{order})",
            4.0 * (3 * CHAIN_CH * CHAIN_BLOCK + 2 * CHAIN_CH * order),
            q1_step_ops(order) * CHAIN_CH * CHAIN_BLOCK, CHAIN_BLOCK * q_cycles,
            f"{CHAIN_BLOCK} steps x {q_cycles:.1f} cycles")}
    for name, (call, plain_call, at, nbytes, ops, chain_cycles, how) in timings.items():
        k = kernels[name]
        k["ms_at"] = at
        k["ms"] = graph_ms(torch, call, 20)
        k["call_ms"] = time_ms(torch, call, 20)
        k["plain_ms"] = time_ms(torch, plain_call, 1, warmup=0)
        k["bound_ms"], k["bound_by"] = bound(nbytes, float(ops))
        k["library_ms"] = None
        k["sm_mhz"] = mhz
        k["chain_bound_ms"] = {at: chain_cycles / mhz * 1e-3}
        cb = k["chain_bound_ms"][at]
        print(f"time {name} {at}: kernel {k['ms']:.4f} ms (graph replay; "
              f"{k['call_ms']:.4f} ms as back-to-back calls), bound "
              f"{k['bound_ms']:.6f} ms ({k['bound_by']}, "
              f"{100 * k['bound_ms'] / k['ms']:.1f}% of the kernel), chain bound "
              f"{cb:.6f} ms ({how} / {mhz:.0f} MHz, {100 * cb / k['ms']:.1f}% of "
              f"the kernel), plain {k['plain_ms']:.4f} ms, library none ({gpu})")
    # W1 at the music preset's other two shifts, beside their chain bounds
    for label in ("music preset -4", "music preset +12"):
        x2w, csqw, rsw, edgew, ovw, seekw, flatw, tailw = w1_args[(label, torch.float32)]
        gw = (torch.as_tensor(np.asarray(rsw, np.int32), device=dev),
              torch.as_tensor(np.asarray(edgew, np.uint8), device=dev))
        ms = graph_ms(torch, lambda: w1mod.launch(x2w, csqw, *gw, ovw, seekw, flatw,
                                                  tailw), 20)
        cb = len(rsw) * ovw * add_cycles / mhz * 1e-3
        kernels["wsola_search"].setdefault("ms_other_shifts", {})[label] = ms
        print(f"time wsola_search per WSOLA call, {label}, {x2w.shape[0]} x "
              f"{N_FLAGSHIP} float32 ({len(rsw)} segments, {int(np.sum(edgew))} at "
              f"the boundary): kernel {ms:.4f} ms (graph replay), chain bound "
              f"{cb:.6f} ms ({len(rsw)} segments x {ovw} steps x {add_cycles:.1f} "
              f"cycles / {mhz:.0f} MHz, {100 * cb / ms:.1f}% of the kernel) ({gpu})")
    for name in names:
        kernels[name]["launches"] = sum(kernels[name]["by_path"].values())
    print(f"voice launches by path: "
          f"{json.dumps({n: {p: v for p, v in kernels[n]['by_path'].items() if v} for n in names})}"
          f"; phase {time.perf_counter() - t_ph:.2f} s")
    assert kernels["envelope"]["by_path"]["voice_chain_float32"] == CHAIN_BLOCKS
    assert kernels["wsola_search"]["by_path"]["oneshot_pitch_graph_float32"] == 1
    assert kernels["error_feedback"]["by_path"]["export_fir_blocks_float32"] == CHAIN_BLOCKS


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
    from algodsp_tpu_torch.effects.dynamics import Compressor, Topology, gate_hold
    from algodsp_tpu_torch.filters import BiquadChain, design
    from algodsp_tpu_torch.filters.biquad import sos_response
    from algodsp_tpu_torch.filters.design import butterworth_lp
    from algodsp_tpu_torch.filters.design.rbj import highpass
    from algodsp_tpu_torch.filters.fir import FIRFilter
    from algodsp_tpu_torch.filters.moog import MoogFilter, MoogVariant
    from algodsp_tpu_torch.filters.weighting import WeightingType, weighting_chain
    from algodsp_tpu_torch.ops import biquad_cascade as bqmod
    from algodsp_tpu_torch.ops import cascade as cascmod
    from algodsp_tpu_torch.ops import dynfb, envscan, fdlconv, linrec
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
        "moog_ladder_reverse": {"route": "cuda",
                                "source": "algodsp_tpu_torch/csrc/moog.cu",
                                "replaces": "algodsp_tpu/filters/moog.py:234 "
                                            "(the custom-VJP backward of K5, "
                                            "over the recording K5's record)",
                                "wrapper": moog_ops.moog_ladder_reverse,
                                "errs": []},
        "moog_zdf_reverse": {"route": "cuda",
                             "source": "algodsp_tpu_torch/csrc/moog.cu",
                             "replaces": "algodsp_tpu/filters/moog.py:234 "
                                         "(the custom-VJP backward of K6, "
                                         "over the recording K6's record)",
                             "wrapper": moog_ops.moog_zdf_reverse,
                             "errs": []},
        "dynamics_feedback": {"route": "cuda",
                              "source": "algodsp_tpu_torch/csrc/dynamics.cu",
                              "replaces": "algodsp_tpu/effects/dynamics/"
                                          "core.py:270 (DynamicsCore."
                                          "_process_feedback, a lax.scan; no "
                                          "Pallas)",
                              "wrapper": dynfb.dynamics_feedback, "errs": []},
    }
    # K5's and K6's recording launches (counted among their launches)
    recorders = {"moog_ladder": moog_ops.moog_ladder,
                 "moog_zdf": moog_ops.moog_zdf}

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
            s_r, y_r, _ = moog_record_call(moog_ops, mf, xm, st8)
            recorded = bits_equal(torch, y_r, y_k) and bits_equal(torch, s_r,
                                                                  s_k)
            s_p, y_p = moog_call(moog_ops, mf, xm.cpu(), st8.cpu(), plain=True)
            y_k, s_k = y_k.cpu(), s_k.cpu()
            err = float(torch.max(torch.abs(y_k - y_p)))
            s_err = float(torch.max(torch.abs(s_k - s_p)))
            snr = snr_db(y_p.numpy(), y_k.numpy())
            kernels[name]["errs"].append(err)
            print(f"check {name} {variant} (newton {iters}) {label}: "
                  f"C={xm.shape[0]} T={xm.shape[1]} os={mf.oversampling} "
                  f"max|err| y {err:.3e} state {s_err:.3e}, SNR vs plain "
                  f"{snr:.1f} dB; recording instance bit-equal {recorded}")
            assert err <= atol and s_err <= atol and snr >= 100, \
                (name, variant, label)
            assert recorded, (name, variant, label)
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
        s_r, y_r, _ = moog_record_call(moog_ops, mf, xm, st8)
        recorded = bits_equal(torch, y_r, y_k) and bits_equal(torch, s_r, s_k)
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
              f"finite y {err:.3e} state {s_err:.3e}; recording instance "
              f"bit-equal {recorded}")
        assert nan_same and bool(torch.isnan(y_k[0, 100:]).all()) and recorded
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
            s_r, y_r, _ = moog_record_call(moog_ops, mf, xm, st8)
            recorded = bits_equal(torch, y_r, y_f) and bits_equal(torch, s_r,
                                                                  s_f)
            xs = torch.zeros(CHAIN_CH, 300 * os_, device=dev)
            xs[:, ::os_] = xm * os_
            s_z, y_z = moog_call(moog_ops, mf, xs, st8, os=1)
            same = (torch.equal(y_f, y_z[:, os_ - 1::os_])
                    and torch.equal(s_f, s_z))
            print(f"check {name} {variant} fused os={os_} {CHAIN_CH}x300 vs "
                  f"the zero-stuffed {CHAIN_CH}x{300 * os_}: bit-equal {same}; "
                  f"recording instance bit-equal {recorded}")
            assert same and recorded, (name, variant, os_)
    # one float64 call of each kernel: the same template in double with
    # libm tanh and IEEE division
    for variant in ("huovilainen", "zdf"):
        name = "moog_zdf" if variant == "zdf" else "moog_ladder"
        mf = MoogFilter(SR, variant=MoogVariant(variant), **chain_moog)
        xm = 0.3 * randn(CHAIN_CH, CHAIN_BLOCK).double()
        st8 = torch.zeros(8, CHAIN_CH, dtype=torch.float64, device=dev)
        s_k, y_k = moog_call(moog_ops, mf, xm, st8)
        s_r, y_r, _ = moog_record_call(moog_ops, mf, xm, st8)
        recorded = bits_equal(torch, y_r, y_k) and bits_equal(torch, s_r, s_k)
        s_p, y_p = moog_call(moog_ops, mf, xm.cpu(), st8.cpu(), plain=True)
        err = float(torch.max(torch.abs(y_k.cpu() - y_p)))
        s_err = float(torch.max(torch.abs(s_k.cpu() - s_p)))
        print(f"check {name} {variant} float64 main: max|err| y {err:.3e} "
              f"state {s_err:.3e}; recording instance bit-equal {recorded}")
        assert y_k.dtype == torch.float64 and err <= 1e-9 and s_err <= 1e-9
        assert recorded
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
        # the record route on the same inputs: the reverse kernel over the
        # recording forward's record
        rev_name = name.replace("_adjoint", "_reverse")
        rec = moog_record_call(moog_ops, mf, xa, st8)[2]
        r_dx, r_dst = (v.cpu() for v in moog_reverse_call(moog_ops, mf, rec,
                                                          st8, gy, gst))
        rev_bits = bits_equal(torch, r_dx, dx) and bits_equal(torch, r_dst,
                                                              dst)
        snr_rev = snr_db(cat(p_dx, p_dst), cat(r_dx, r_dst))
        kernels[rev_name]["errs"].append(float(torch.max(torch.abs(
            r_dx - p_dx))))
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
        print(f"check {rev_name} {variant} (newton {mf.newton_iters}) "
              f"{label}: record {tuple(rec.shape)}, dx and dstate8 bit-equal "
              f"to {name}'s {rev_bits}, SNR vs plain {snr_rev:.1f} dB")
        bar = 100 if dtype == f32 else 200
        assert snr_all >= bar, (name, label)
        assert same_state and exact, (name, label)
        # the ZDF reverse forms its quotients by 1 / J from the Markstein
        # correction (IEEE division's rounding where nothing over- or
        # underflows): held at the plain sweep's bars, its bits printed
        assert (snr_rev >= bar if variant == "zdf" else rev_bits), \
            (rev_name, label)
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
        rev_name = name.replace("_adjoint", "_reverse")
        r_dx, r_dst = (v.cpu() for v in moog_reverse_call(
            moog_ops, mf, moog_record_call(moog_ops, mf, xa, st8)[2], st8, gy,
            gst))
        rev_bits = bits_equal(torch, r_dx, dx) and bits_equal(torch, r_dst,
                                                              dst)
        p_dx, p_dst = moog_adjoint_call(
            moog_ops, mf, *(v.cpu() for v in (xa, st8, gy, gst)), plain=True)
        nan_same = bool(torch.equal(torch.isnan(dx), torch.isnan(p_dx))
                        and torch.equal(torch.isnan(dst), torch.isnan(p_dst)))
        rest = bool(torch.isfinite(dx[1:]).all() and torch.isfinite(dst[:, 1:]).all())
        snr_rest = snr_db(cat(p_dx[1:], p_dst[:, 1:]), cat(dx[1:], dst[:, 1:]))
        r_nan = bool(torch.equal(torch.isnan(r_dx), torch.isnan(p_dx))
                     and torch.equal(torch.isnan(r_dst), torch.isnan(p_dst)))
        r_rest = snr_db(cat(p_dx[1:], p_dst[:, 1:]),
                        cat(r_dx[1:], r_dst[:, 1:]))
        print(f"check {name} {variant} NaN in x: NaN where plain has NaN "
              f"{nan_same} ({int(torch.isnan(dx).sum())} of dx's "
              f"{dx.numel()}), other channels finite {rest}, SNR vs plain "
              f"{snr_rest:.1f} dB; {rev_name} bit-equal {rev_bits}, NaN where "
              f"plain has NaN {r_nan}, other channels {r_rest:.1f} dB")
        assert nan_same and rest and snr_rest >= 100, (name, variant)
        assert (r_nan and r_rest >= 100 if variant == "zdf" else rev_bits), \
            (rev_name, variant)
    # The budget: a call whose record would pass RECORD_BUDGET_BYTES takes
    # the checkpoint route through the Function. At the chain block and the
    # ZDF block, the Function's gradient (autograd) with the budget as it
    # is (the record route: one recording launch, one reverse launch) and
    # with the budget set one byte under the block's record (K5 / K6
    # without recording, one checkpoint-adjoint launch), on the same inputs
    budget = moog_ops.RECORD_BUDGET_BYTES
    for label, mf in [("chain block", chain_moog_node(MoogFilter, MoogVariant)),
                      ("ZDF block", MoogFilter(SR, variant=MoogVariant.ZDF,
                                               **zdf_kw, newton_iters=4))]:
        fwd = "moog_zdf" if mf.variant.value == "zdf" else "moog_ladder"
        xa, gy = randn(CHAIN_CH, CHAIN_BLOCK), randn(CHAIN_CH, CHAIN_BLOCK)
        st8, gst = 0.2 * randn(8, CHAIN_CH), randn(8, CHAIN_CH)

        def route():
            xg, sg = xa.clone().requires_grad_(), st8.clone().requires_grad_()
            before = {n: k["wrapper"].launches for n, k in kernels.items()}
            rec0 = recorders[fwd].record_launches
            s_out, y = moog_call(moog_ops, mf, xg, sg)
            g = [v.cpu() for v in torch.autograd.grad((s_out, y), (xg, sg),
                                                      (gst, gy))]
            delta = {n: k["wrapper"].launches - before[n]
                     for n, k in kernels.items()
                     if k["wrapper"].launches != before[n]}
            return g, delta, recorders[fwd].record_launches - rec0

        g_rec, l_rec, r_rec = route()
        size = moog_ops.record_bytes(CHAIN_CH, CHAIN_BLOCK, mf.oversampling,
                                     record_values(moog_ops, mf), 4)
        moog_ops.RECORD_BUDGET_BYTES = size - 1
        try:
            g_ck, l_ck, r_ck = route()
        finally:
            moog_ops.RECORD_BUDGET_BYTES = budget
        same = all(bits_equal(torch, a, b) for a, b in zip(g_rec, g_ck))
        snr_routes = snr_db(cat(*g_ck), cat(*g_rec))
        print(f"check budget {label}: record {size} bytes; within the budget "
              f"launches {json.dumps(l_rec)} (recording {r_rec}), one byte "
              f"over it {json.dumps(l_ck)} (recording {r_ck}); gradients "
              f"bit-equal {same}, SNR {snr_routes:.1f} dB")
        assert l_rec == {fwd: 1, fwd + "_reverse": 1} and r_rec == 1, l_rec
        assert l_ck == {fwd: 1, fwd + "_adjoint": 1} and r_ck == 0, l_ck
        assert same if fwd == "moog_ladder" else snr_routes >= 100, label

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
    # of ~15 from carries composed in float64. Each case runs the kernel
    # twice on the same inputs: the two results hold the same bits.
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
         rng.uniform(0.01, 0.5, 65), rng.uniform(1e-5, 0.05, 65)),
        ("cluster, T=48131 (no part or chunk multiple)", CHANNELS, 48131,
         0.1, a_main, r_main),
        (f"one block a channel, C={sms // 2 + 1}", sms // 2 + 1, N_FLAGSHIP,
         rng.uniform(0, 1, sms // 2 + 1), a_main, r_main)]
    # a part of several segments: float32 only, the plain walk over 2^20
    # samples taking about a minute
    env_adj_long = [("C=2 T=2^20 (segments a block)", 2, 1 << 20, 0.0, a_main,
                     r_main)]

    def env_plan(c, t, dtype):
        return envscan.adjoint_plan(t, c, sms, np.dtype(dtype).itemsize)

    assert env_plan(CHANNELS, N_FLAGSHIP, np.float32)[3] > 1
    assert env_plan(CHANNELS, N_FLAGSHIP, np.float64)[3] > 1
    seg_c, len_c, _, b_c = env_plan(CHANNELS, 48131, np.float32)
    assert b_c > 1 and 48131 % -(-48131 // b_c) and seg_c % len_c
    assert env_plan(sms // 2 + 1, N_FLAGSHIP, np.float32)[3] == 1
    seg_l, _, _, b_l = env_plan(2, 1 << 20, np.float32)
    assert -(-(1 << 20) // b_l) > seg_l
    assert 15361 % env_plan(4, 15361, np.float32)[1]
    for dtype, label, c, t, e0v, av, rv in (
            [(d, *case) for d in (np.float32, np.float64)
             for case in env_adj_cases]
            + [(np.float32, *case) for case in env_adj_long]):
        xa, e0a, aa, ra = env_case(c, np.abs(rng.standard_normal((c, t))),
                                   e0v, av, rv, dtype)
        _, tra = k4(xa, e0a, aa, ra)
        ga = torch.as_tensor(rng.standard_normal((c, t)).astype(dtype),
                             device=dev)
        gfa = torch.as_tensor(rng.standard_normal(c).astype(dtype),
                              device=dev)
        args = (xa, tra, e0a, aa, ra, ga, gfa)
        out = envscan.envelope_adjoint(*args)
        again = envscan.envelope_adjoint(*args)
        same_bits = all(bits_equal(torch, a, b) for a, b in zip(out, again))
        long_case = t >= 1 << 20
        p_same = envscan.envelope_adjoint_plain(
            *(v.cpu() for v in args))
        p64 = (p_same if dtype == np.float64 or long_case else
               envscan.envelope_adjoint_plain(*(v.cpu().double()
                                                for v in args)))
        out = [v.cpu() for v in out]
        snr64 = [snr_or_inf(r.numpy(), o.numpy()) for r, o in zip(p64, out)]
        snr_same = [snr_or_inf(r.numpy(), o.numpy())
                    for r, o in zip(p_same, out)]
        err = max(float(torch.max(torch.abs(o.double() - r.double())))
                  for o, r in zip(out, p64))
        kernels["envelope_adjoint"]["errs"].append(err)
        bar = 100 if dtype == np.float32 else 200
        seg, length, threads, blocks = env_plan(c, t, dtype)
        print(f"check envelope_adjoint {label}: {np.dtype(dtype).name} "
              f"C={c} T={t} plan segment {seg} L={length} threads "
              f"{threads} blocks a channel {blocks}; SNR vs plain "
              f"{np.dtype(dtype).name} " + ", ".join(
                  f"{n} {v:.1f}" for n, v in zip(adj_names, snr_same))
              + " dB; " + ("" if long_case else "vs plain f64 on the same "
                           "inputs " + ", ".join(f"{v:.1f}" for v in snr64)
                           + " dB; ") + f"max|err| {err:.3e}; two runs "
              f"bit-equal {same_bits}")
        assert min(snr_same) >= bar and same_bits, (label, dtype)

    # the FDL spectra adjoint on K1's own frame spectra (its first launch's
    # scratch, kept as the Function keeps it) and the cotangent spectra,
    # against the plain version in float64 on the same float32 inputs; the
    # kernel sums in float64, in an order that does not depend on its G
    # lags a thread: every G it takes gives the same bits, and so do two
    # runs
    spec_cases = [("IR learning main", CHANNELS, N_FLAGSHIP, 1024, 32),
                  ("C=1", 1, 8 * 1024, 1024, 3),
                  ("C=3 odd", 3, 6 * 1024, 1024, 5),
                  ("C=5 P > F", 5, 4 * 256, 256, 10),
                  ("F=1", 4, 1024, 1024, 3),
                  ("B=8192 P=13 (no multiple of G)", 2, 40 * 8192, 8192, 13),
                  ("B=8192 chain block", CHANNELS, 6 * 8192, 8192, 5)]
    assert fdlconv.spectra_adjoint_plan(40, 8192, 13, sms)[0] in (2, 4, 8)
    assert 13 % fdlconv.spectra_adjoint_plan(40, 8192, 13, sms)[0]
    for label, c, n, b, p in spec_cases:
        xa = randn(c, n)
        hs_a = torch.as_tensor(fdlconv.kernel_spectra(
            np.resize(ir, p * b), b), device=dev)
        _, Xa = fdlconv._launch(xa, hs_a, b, fdlconv.mac_plan(c, n // b, b)[0])
        dVa = fdlconv.cotangent_spectra(randn(c, n), b)
        dH = fdlconv.fdl_spectra_adjoint(Xa, dVa, p)
        g_plan = fdlconv.spectra_adjoint_plan(n // b, b, p, sms)[0]
        same_bits = all(bits_equal(torch, dH, fdlconv._spectra_adjoint_launch(
            Xa, dVa, p, g)) for g in (1, 2, 4, 8))
        dH64 = fdlconv.fdl_spectra_adjoint_plain(Xa.double(), dVa.double(), p)
        dH32 = fdlconv.fdl_spectra_adjoint_plain(Xa, dVa, p)
        nf = n // b
        unseen_zero = bool(torch.all(dH[nf:] == 0)) if p > nf else None
        edges_zero = bool(torch.all(dH[:, [0, b], 1] == 0))
        snr64, snr32 = snr_db(host(dH64), host(dH)), snr_db(host(dH32), host(dH))
        err = float(torch.max(torch.abs(dH.double() - dH64)))
        kernels["fdl_spectra_adjoint"]["errs"].append(err)
        print(f"check fdl_spectra_adjoint {label}: C={c} F={nf} B={b} P={p} "
              f"G={g_plan} SNR vs plain f64 {snr64:.1f} dB, vs plain f32 "
              f"{snr32:.1f} dB, max|err| {err:.3e}, rows p >= F zero "
              f"{unseen_zero}, DC and Nyquist imaginary parts zero "
              f"{edges_zero}; bit-equal for G = 1, 2, 4, 8 and on a second "
              f"run {same_bits}")
        assert snr64 >= 100 and edges_zero and unseen_zero in (None, True), label
        assert same_bits, label

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

    # D1, the feedback dynamics detector (csrc/dynamics.cu), against its
    # plain version on the card (the same step in PyTorch, launched step by
    # step) and on the CPU: the dynamics graph's compressor, the same with
    # feedback_ratio_scale, and a hard-knee 10:1 one with makeup; float32
    # (>= 100 dB on y and the gain) and float64 (>= 200 dB); the chain
    # block, C = 65 at T = 1 and 333, NaN and +-inf in x (non-finite
    # where the plain version's); two calls bit-equal to one
    kdyn = kernels["dynamics_feedback"]
    fb_cfgs = {"graph": FB_GRAPH_KW,
               "ratio-scaled": {**FB_GRAPH_KW, "feedback_ratio_scale": True},
               "hard knee": {"threshold_db": -12.0, "ratio": 10.0,
                             "knee_db": 0.0, "attack_ms": 1.0,
                             "release_ms": 50.0, "makeup_gain_db": 3.0}}

    def finite_cmp(ref, got):
        """(SNR over the finite samples, non-finite samples alike, max|err|
        over the finite samples)."""
        ref, got = host(ref), host(got)
        fin = np.isfinite(ref) & np.isfinite(got)
        alike = (np.array_equal(np.isnan(ref), np.isnan(got))
                 and np.array_equal(np.where(np.isinf(ref), ref, 0),
                                    np.where(np.isinf(got), got, 0)))
        err = float(np.max(np.abs(ref[fin] - got[fin]), initial=0.0))
        return snr_db(ref[fin], got[fin]), alike, err

    d1_rng = np.random.default_rng(11)
    for label, cfg in fb_cfgs.items():
        p_fb = Compressor(SR, topology=Topology.FEEDBACK,
                          **cfg).core.feedback_params()
        for dtype in (torch.float32, torch.float64):
            bar = 100.0 if dtype == torch.float32 else 200.0
            for c, t in ((CHAIN_CH, CHAIN_BLOCK), (65, 1), (65, 333)):
                level = np.repeat(d1_rng.uniform(0.01, 2.0, (c, -(-t // 64))),
                                  64, axis=1)[:, :t]
                x_np = d1_rng.standard_normal((c, t)) * level
                special = label == "hard knee" and t == 333
                if special:
                    x_np[3, 100], x_np[5, 7], x_np[6, 200] = (np.nan, np.inf,
                                                              -np.inf)
                xd = torch.as_tensor(x_np, dtype=dtype, device=dev)
                e0, a0 = (torch.as_tensor(d1_rng.uniform(0.0, 1.0, c),
                                          dtype=dtype, device=dev)
                          for _ in range(2))
                out = dynfb.dynamics_feedback(xd, e0, a0, p_fb)
                ref_card = dynfb.dynamics_feedback_plain(xd, e0, a0, p_fb)
                ref_cpu = dynfb.dynamics_feedback_plain(xd.cpu(), e0.cpu(),
                                                        a0.cpu(), p_fb)
                cmp = [finite_cmp(r, o) for r, o in zip(ref_card, out)]
                cmp_cpu = [finite_cmp(r, o) for r, o in zip(ref_cpu, out)]
                kdyn["errs"].append(max(e for _, _, e in cmp))
                print(f"check dynamics_feedback {label} {dtype} C={c} T={t}"
                      f"{' NaN/+-inf' if special else ''}: y SNR vs plain "
                      f"{cmp[0][0]:.1f} dB (CPU plain {cmp_cpu[0][0]:.1f}), "
                      f"gain {cmp[1][0]:.1f} dB (CPU {cmp_cpu[1][0]:.1f}), "
                      f"env_final {cmp[2][0]:.1f} dB, max|err| "
                      f"{max(e for _, _, e in cmp):.3e}, non-finite where the "
                      f"plain version's {all(a for _, a, _ in cmp + cmp_cpu)}")
                assert all(a for _, a, _ in cmp + cmp_cpu), label
                assert min(v for v, _, _ in cmp[:2] + cmp_cpu[:2]) >= bar, label
        xd = randn(CHAIN_CH, CHAIN_BLOCK)
        zd = torch.zeros(CHAIN_CH, device=dev)
        whole = dynfb.dynamics_feedback(xd, zd, zd, p_fb)
        first = dynfb.dynamics_feedback(xd[:, :200].contiguous(), zd, zd, p_fb)
        second = dynfb.dynamics_feedback(xd[:, 200:].contiguous(), first[2],
                                         first[3], p_fb)
        same = all(bits_equal(torch, torch.cat([a, b], dim=-1), w) for a, b, w
                   in zip(first[:2], second[:2], whole[:2]))
        print(f"check dynamics_feedback {label} two calls (200 + "
              f"{CHAIN_BLOCK - 200}) vs one: bit-equal {same}")
        assert same and bits_equal(torch, second[2], whole[2])

    # Fault 6: the matrix engines' float32 products run in full float32
    # whatever the caller set. A 60/90/120 Hz high-pass chain in float32
    # through the blocked and whole-cascade engines, against float64, by
    # default and under set_float32_matmul_precision("high") (TF32 on this
    # card); the caller's setting is back after each call. Printed beside
    # it, the same call with the pin taken out (what the engines did before)
    hp_chain = BiquadChain(np.vstack([highpass(f, 0.707, SR)
                                      for f in (60.0, 90.0, 120.0)]))
    x6 = randn(CHANNELS, N_FLAGSHIP)
    ref6 = host(hp_chain.process(x6.double(), mode="blocked"))
    caller = torch.get_float32_matmul_precision()
    for mode in ("blocked", "cascade"):
        y_def = hp_chain.process(x6, mode=mode)
        torch.set_float32_matmul_precision("high")
        try:
            y_high = hp_chain.process(x6, mode=mode)
            kept = torch.get_float32_matmul_precision()
            pins = (linrec.full_float32, cascmod.full_float32)
            linrec.full_float32 = cascmod.full_float32 = contextlib.nullcontext
            try:
                y_unpinned = hp_chain.process(x6, mode=mode)
            finally:
                linrec.full_float32, cascmod.full_float32 = pins
        finally:
            torch.set_float32_matmul_precision(caller)
        s_def, s_high = snr_db(ref6, host(y_def)), snr_db(ref6, host(y_high))
        print(f"check fault 6 ({mode} engine, 60/90/120 Hz high-pass float32 "
              f"{CHANNELS}x{N_FLAGSHIP}): vs float64 {s_def:.1f} dB by "
              f"default, {s_high:.1f} dB under set_float32_matmul_precision("
              f"'high') (bit-equal {bits_equal(torch, y_def, y_high)}; the "
              f"caller's setting after the call {kept!r}, restored to "
              f"{torch.get_float32_matmul_precision()!r}); without the pin "
              f"{snr_db(ref6, host(y_unpinned)):.1f} dB")
        assert kept == "high" and torch.get_float32_matmul_precision() == caller
        assert bits_equal(torch, y_def, y_high) and s_high >= 85

    # check cascade: the whole-cascade engine on the card against float64,
    # streamed with its state, and the three engines' times (back-to-back
    # calls, host included: the blocked engine uploads its tables each
    # call) and accuracy behind the auto dispatch, for a slow-pole float32
    # chain, a float64 chain and a chain over 64 runtime sections
    disp_chains = {
        "slow-pole float32 (60/90/120 Hz high-pass)": (hp_chain, torch.float32),
        "float64 (10th-order Butterworth low-pass)": (cascade, torch.float64),
        f"float32, {chain70.num_runtime_sections} runtime sections": (
            chain70, torch.float32)}
    disp_bars = {torch.float32: 85.0, torch.float64: 200.0}
    for label, (chd, dtype) in disp_chains.items():
        xd = randn(CHANNELS, N_FLAGSHIP).to(dtype)
        ref = chd.process(xd.double().cpu(), mode="blocked").numpy()
        row = {}
        for mode in ("kernel", "blocked", "cascade"):
            try:
                y_m = chd.process(xd, mode=mode)
            except (ValueError, RuntimeError) as exc:
                row[mode] = f"n/a ({str(exc).split(':')[0][:60]})"
                continue
            row[mode] = (time_ms(torch, lambda m=mode: chd.process(xd, mode=m),
                                 10), snr_db(ref, host(y_m)))
        print(f"check cascade dispatch {label} {CHANNELS}x{N_FLAGSHIP}, auto "
              f"takes {chd._auto_mode(xd)}: " + "; ".join(
                  f"{m} {v}" if isinstance(v, str) else
                  f"{m} {v[0]:.4f} ms, {v[1]:.1f} dB vs float64"
                  for m, v in row.items()) + f" ({gpu})")
        assert row["cascade"][1] >= disp_bars[dtype], label
    st_c = hp_chain.init_state((CHANNELS,))
    parts = []
    for a, b in ((0, 16384), (16384, N_FLAGSHIP)):
        st_c, y_p = hp_chain.process_stream(st_c, x6[:, a:b], mode="cascade")
        parts.append(y_p)
    s_stream = snr_db(ref6, host(torch.cat(parts, dim=-1)))
    print(f"check cascade process_stream (two blocks, state carried) float32 "
          f"{CHANNELS}x{N_FLAGSHIP}: {s_stream:.1f} dB vs float64")
    assert s_stream >= 85

    # -- 3. flagship forward ---------------------------------------------------
    pipe = convert.flagship_from_numpy(flag)
    x_np = np.random.default_rng(1).standard_normal(
        (CHANNELS, N_FLAGSHIP)).astype(np.float32)
    x = torch.as_tensor(x_np, device=dev)
    state = pipe.init_state(CHANNELS)
    for k in kernels.values():
        k["wrapper"].launches = 0
    for f in recorders.values():
        f.record_launches = 0
    k4.reset_counts()
    y, power = pipe.forward(x, state)
    torch.cuda.synchronize()
    launches = {name: k["wrapper"].launches for name, k in kernels.items()}
    for k in kernels.values():
        k["by_path"] = {"flagship": k["wrapper"].launches}
    rec_by_path = {"flagship": {n: f.record_launches
                                for n, f in recorders.items()}}
    env_counts = {"flagship": k4.counts()}
    print(f"flagship launches per forward: {json.dumps(launches)}; envelope "
          f"counts {json.dumps(env_counts['flagship'])}")
    assert launches == {"biquad_cascade": 2, "envelope": 1, "fdl_conv": 1,
                        "moog_ladder": 0, "moog_zdf": 0,
                        "envelope_adjoint": 0, "fdl_spectra_adjoint": 0,
                        "moog_ladder_adjoint": 0, "moog_zdf_adjoint": 0,
                        "moog_ladder_reverse": 0, "moog_zdf_reverse": 0,
                        "dynamics_feedback": 0}, launches
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
    for f in recorders.values():
        f.record_launches = 0
    k4.reset_counts()
    _, yc = chain.process_blocks(c_state0, xc)
    torch.cuda.synchronize()
    launches = {name: k["wrapper"].launches for name, k in kernels.items()}
    for k in kernels.values():
        k["by_path"]["chain"] = k["wrapper"].launches
    rec_by_path["chain"] = {n: f.record_launches for n, f in recorders.items()}
    env_counts["chain"] = k4.counts()
    print(f"chain launches over {CHAIN_BLOCKS} blocks of {CHAIN_CH}x"
          f"{CHAIN_BLOCK}: {json.dumps(launches)}; envelope counts "
          f"{json.dumps(env_counts['chain'])}")
    assert env_counts["chain"]["exact_walks"] == 0
    assert launches == {"biquad_cascade": CHAIN_BLOCKS,
                        "envelope": CHAIN_BLOCKS, "fdl_conv": CHAIN_BLOCKS,
                        "moog_ladder": CHAIN_BLOCKS, "moog_zdf": 0,
                        "envelope_adjoint": 0, "fdl_spectra_adjoint": 0,
                        "moog_ladder_adjoint": 0, "moog_zdf_adjoint": 0,
                        "moog_ladder_reverse": 0, "moog_zdf_reverse": 0,
                        "dynamics_feedback": 0}, launches
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
    for f in recorders.values():
        f.record_launches = 0
    _, yz = streaming.scan_blocks(zdf.process, z_state0, xz,
                                  block_size=CHAIN_BLOCK)
    torch.cuda.synchronize()
    launches = {name: k["wrapper"].launches for name, k in kernels.items()}
    for k in kernels.values():
        k["by_path"]["moog_zdf_direct"] = k["wrapper"].launches
    rec_by_path["moog_zdf_direct"] = {n: f.record_launches
                                      for n, f in recorders.items()}
    # no path so far wants a gradient, so none records
    assert not any(v for r in rec_by_path.values() for v in r.values()), \
        rec_by_path
    print(f"ZDF MoogFilter launches over {CHAIN_BLOCKS} blocks of "
          f"{CHAIN_CH}x{CHAIN_BLOCK}: {json.dumps(launches)}")
    assert launches == {"biquad_cascade": 0, "envelope": 0, "fdl_conv": 0,
                        "moog_ladder": 0, "moog_zdf": CHAIN_BLOCKS,
                        "envelope_adjoint": 0, "fdl_spectra_adjoint": 0,
                        "moog_ladder_adjoint": 0, "moog_zdf_adjoint": 0,
                        "moog_ladder_reverse": 0, "moog_zdf_reverse": 0,
                        "dynamics_feedback": 0}, launches
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
    sa_bytes, sa_flops = spectra_adjoint_work(CHANNELS, nf_ir, B_ir, P_ir)
    kd["bound_ms"], kd["bound_by"] = bound(sa_bytes, sa_flops)
    # the design's own limit: its float64 sums at the FP64 rate (a note,
    # not the bound: the function's inputs and outputs are float32)
    f64_ops_ms = sa_flops / F64_FLOPS_PER_S * 1e3
    # the yardstick: one batched complex matmul of the lag-unfolded conj(X),
    # (B+1, P, C nf), by dV as (B+1, C nf, 1), the unfold built outside the
    # timed call (the sums without the weight w_k, in float32)
    Xc_t, Vc_t = torch.view_as_complex(X_t), torch.view_as_complex(dV_t)
    unfold = torch.zeros((B_ir + 1, P_ir, CHANNELS, nf_ir),
                         dtype=Xc_t.dtype, device=dev)
    for q in range(min(P_ir, nf_ir)):
        unfold[:, q, :, q:] = torch.conj(Xc_t[:, :nf_ir - q]).permute(2, 0, 1)
    unfold = unfold.reshape(B_ir + 1, P_ir, CHANNELS * nf_ir)
    v_cols = Vc_t.permute(2, 0, 1).reshape(B_ir + 1, CHANNELS * nf_ir, 1)
    lib_call = lambda: torch.matmul(unfold, v_cols)
    kd["library_ms"] = graph_ms(torch, lib_call, 20)
    w_ir = torch.full((B_ir + 1,), 1.0 / B_ir, dtype=torch.float64, device=dev)
    w_ir[0] = w_ir[B_ir] = 0.5 / B_ir
    lib_dh = lib_call()[..., 0].T.to(torch.complex128) * w_ir
    lib_dh = torch.view_as_real(lib_dh).clone()
    lib_dh[:, [0, B_ir], 1] = 0.0
    lib_snr = snr_db(host(fdlconv.fdl_spectra_adjoint_plain(
        X_t.double(), dV_t.double(), P_ir)), host(lib_dh))
    del unfold, v_cols
    kd["dv_fft_ms"] = graph_ms(
        torch, lambda: fdlconv.cotangent_spectra(g_ir, B_ir), 20)
    kd["ms_at"] = (f"per IR-learning step, {CHANNELS} x {N_FLAGSHIP}, "
                   f"B = {B_ir}, P = {P_ir}, G = "
                   f"{fdlconv.spectra_adjoint_plan(nf_ir, B_ir, P_ir, sms)[0]}")
    for name in ("envelope_adjoint", "fdl_spectra_adjoint"):
        k = kernels[name]
        lib = ("none" if k["library_ms"] is None else
               f"{k['library_ms']:.4f} ms (one batched complex matmul over "
               f"the lag-unfolded conj(X); its result vs plain f64 "
               f"{lib_snr:.1f} dB)")
        print(f"time {name} {k['ms_at']}: kernel {k['ms']:.4f} ms (graph replay; "
              f"{k['call_ms']:.4f} ms as back-to-back calls; earlier "
              f"{EARLIER[name]}), bound {k['bound_ms']:.6f} ms "
              f"({k['bound_by']}), "
              f"share {100 * k['bound_ms'] / k['ms']:.1f}%, plain "
              f"{k['plain_ms']:.4f} ms, library {lib}"
              + (f"; the torch.fft of dV {k['dv_fft_ms']:.4f} ms; its "
                 f"float64 sums' operations at the FP64 rate "
                 f"{f64_ops_ms:.6f} ms" if "dv_fft_ms" in k else "")
              + f" ({gpu})")
    for label, (call, prefixes) in {
            "envelope_adjoint flagship": (ka_call, ("envelope_adjoint",)),
            "fdl_spectra_adjoint IR learning": (kd_call, ("fdl_spectra",))}.items():
        parts = device_activity(torch, call, 20, prefixes)["by_name"]
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
        parts = device_activity(torch, call, reps, prefixes)["by_name"]
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
    for name, fwd_name, mf, xa, ops, rev_ops in [
            ("moog_ladder_adjoint", "moog_ladder", moog_fx, xm,
             MOOG_STEP_OPS["huovilainen"] + MOOG_ADJ_REVERSE_OPS,
             MOOG_REVERSE_OPS),
            ("moog_zdf_adjoint", "moog_zdf", zdf, xz1,
             zdf_step_ops(4) + zdf_adjoint_reverse_ops(4),
             zdf_reverse_ops(4))]:
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
        # the record route at the same block: the recording forward and the
        # reverse kernel over its record
        kf, kr = kernels[fwd_name], kernels[name.replace("_adjoint",
                                                          "_reverse")]
        rec_call = lambda mf=mf, xa=xa: moog_record_call(moog_ops, mf, xa,
                                                         st8m)
        rec = rec_call()[2]
        rev = lambda mf=mf, rec=rec, plain=False: moog_reverse_call(
            moog_ops, mf, rec, st8m, gy_m, gst_m, plain=plain)
        nv = record_values(moog_ops, mf)
        kf["record_ms"] = graph_ms(torch, rec_call, 20)
        kf["record_bound_ms"] = bound(
            moog_work(CHAIN_CH, CHAIN_BLOCK, 0)[0] + rec.numel() * 4.0, 0.0)[0]
        kr["ms_at"] = kf["ms_at"]
        kr["ms"] = graph_ms(torch, rev, 20)
        kr["call_ms"] = time_ms(torch, rev, 20)
        kr["plain_ms"] = time_ms(torch, lambda rev=rev: rev(plain=True), 1,
                                 warmup=0)
        kr["bound_ms"], kr["bound_by"] = bound(*moog_reverse_work(
            CHAIN_CH, CHAIN_BLOCK, nv, rev_ops, mf.oversampling))
        kr["library_ms"] = None
        kr["record_bytes"] = rec.numel() * 4
        print(f"time {kr['ms_at']} record route: recording forward "
              f"{kf['record_ms']:.4f} ms ({kf['record_ms'] / kf['ms']:.3f}x "
              f"the forward's {kf['ms']:.4f}; bound {kf['record_bound_ms']:.6f}"
              f" ms, bytes with the record), reverse kernel {kr['ms']:.4f} ms "
              f"(graph replay; {kr['call_ms']:.4f} ms as back-to-back calls), "
              f"bound {kr['bound_ms']:.6f} ms ({kr['bound_by']}; {rev_ops} "
              f"operations a step, record {kr['record_bytes']} bytes), plain "
              f"{kr['plain_ms']:.4f} ms, library none; gradient block kernels "
              f"{kf['record_ms'] + kr['ms']:.4f} ms against the checkpoint "
              f"route's {kf['ms'] + k['ms']:.4f} ({gpu})")
        del rec

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
        # the record route at this shape
        rec_w = moog_record_call(moog_ops, mf, xw, stw)[2]
        f_graph = graph_ms(torch, lambda: moog_record_call(moog_ops, mf, xw,
                                                           stw), 3)
        r_graph = graph_ms(torch, lambda: moog_reverse_call(
            moog_ops, mf, rec_w, stw, gyw, gstw), 3)
        kr_w = kernels[ka_w["wrapper"].__name__.replace("_adjoint",
                                                        "_reverse")]
        kr_w["ms_by_shape"] = {"path block": kr_w["ms"], f"{cm}x{tm}": r_graph}
        r_ops = (zdf_reverse_ops(4) if mf.variant.value == "zdf"
                 else MOOG_REVERSE_OPS)
        r_b, r_by = bound(*moog_reverse_work(cm, tm, record_values(moog_ops,
                                                                   mf),
                                             r_ops))
        print(f"time {label} record route {cm}x{tm}: recording forward "
              f"{f_graph:.4f} ms ({f_graph / t_graph:.3f}x the forward's), "
              f"reverse kernel {r_graph:.4f} ms ({r_graph / tm * 1e6:.2f} ns "
              f"per step, bound {r_b:.6f} ms ({r_by}), record "
              f"{rec_w.numel() * 4} bytes); gradient kernels "
              f"{f_graph + r_graph:.4f} ms against the checkpoint route's "
              f"{t_graph + a_graph:.4f} ({gpu})")
        del rec_w

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
    ka_ms, kd_ms = (kernels[n]["ms"] for n in ("envelope_adjoint",
                                               "fdl_spectra_adjoint"))
    print(f"train step times: flagship forward + backward {fb_ms:.4f} ms, "
          f"its envelope_adjoint {ka_ms:.4f} ms ({100 * ka_ms / fb_ms:.1f}%); "
          f"IR-learning step {ir_ms:.4f} ms, its fdl_spectra_adjoint "
          f"{kd_ms:.4f} ms ({100 * kd_ms / ir_ms:.1f}%) ({gpu})")

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
    # float32 runs on the card count as the path's launches. Every block's
    # record fits RECORD_BUDGET_BYTES, so each forward is the recording
    # K5 / K6 and each backward the reverse kernel ("name.record" counts the
    # recording launches among name's). Last, the path "moog_grad over
    # budget": the same gradients over 8 blocks with the budget under a
    # block's record, so each block takes the checkpoint route (K5 / K6,
    # then the checkpoint adjoint), against the record route's.
    t_mg = time.perf_counter()
    mg_keys = list(kernels) + [n + ".record" for n in recorders]
    mg_counts = {name: 0 for name in mg_keys}
    over_counts = {name: 0 for name in mg_keys}
    no_mg = {name: 0 for name in mg_keys}
    moog_plain = [(moog_ops, n) for n in (
        "moog_ladder_plain", "moog_zdf_plain", "moog_ladder_adjoint_plain",
        "moog_zdf_adjoint_plain", "moog_ladder_reverse_plain",
        "moog_zdf_reverse_plain")]

    def mg_launches():
        return {**{name: k["wrapper"].launches for name, k in kernels.items()},
                **{n + ".record": f.record_launches
                   for n, f in recorders.items()}}

    def mg_counted(fn, into=mg_counts):
        before = mg_launches()
        out = fn()
        torch.cuda.synchronize()
        delta = {name: v - before[name] for name, v in mg_launches().items()}
        for name, d in delta.items():
            into[name] += d
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
        rev_name = fwd_name + "_reverse"
        with plain_calls(moog_plain) as plain_n:
            (loss_m, x_t, st0), fwd_l = mg_counted(
                lambda: stream_loss(mf, CHAIN_BLOCKS, dev, torch.float32))
            g32, bwd_l = mg_counted(lambda: grads(loss_m, x_t, st0))
        print(f"moog grad {label} {CHAIN_CH}x{CHAIN_BLOCKS * CHAIN_BLOCK} in "
              f"{CHAIN_BLOCKS} blocks: launches forward {json.dumps(fwd_l)}, "
              f"backward {json.dumps(bwd_l)}; plain versions called "
              f"{sum(plain_n.values())} times")
        assert fwd_l == {**no_mg, fwd_name: CHAIN_BLOCKS,
                         fwd_name + ".record": CHAIN_BLOCKS}, fwd_l
        assert bwd_l == {**no_mg, rev_name: CHAIN_BLOCKS}, bwd_l
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
    assert fit_l == {**no_mg, "moog_ladder": 8, "moog_ladder.record": 8,
                     "moog_ladder_reverse": 8}, fit_l
    assert g_err < 1e-3 and float(loss_fl) < float(loss_f0)

    # over the budget: 8 blocks of each ladder through the checkpoint route
    budget = moog_ops.RECORD_BUDGET_BYTES
    for label, mf, fwd_name in [("chain filter-moog node", moog_fx,
                                 "moog_ladder"),
                                ("ZDF MoogFilter", zdf, "moog_zdf")]:
        g_rec = grads(*stream_loss(mf, 8, dev, torch.float32))
        moog_ops.RECORD_BUDGET_BYTES = moog_ops.record_bytes(
            CHAIN_CH, CHAIN_BLOCK, mf.oversampling, record_values(moog_ops, mf),
            4) - 1
        try:
            with plain_calls(moog_plain) as plain_n:
                (loss_o, x_o, st_o), fwd_l = mg_counted(
                    lambda: stream_loss(mf, 8, dev, torch.float32),
                    over_counts)
                g_ck, bwd_l = mg_counted(lambda: grads(loss_o, x_o, st_o),
                                         over_counts)
        finally:
            moog_ops.RECORD_BUDGET_BYTES = budget
        same = all(np.array_equal(a, b) for a, b in zip(g_rec, g_ck))
        snr_routes = min(snr_db(a, b) for a, b in zip(g_rec[:2], g_ck[:2]))
        print(f"moog grad over budget {label} {CHAIN_CH}x{8 * CHAIN_BLOCK} in 8 "
              f"blocks: launches forward {json.dumps(fwd_l)}, backward "
              f"{json.dumps(bwd_l)}; plain versions called "
              f"{sum(plain_n.values())} times; gradients against the record "
              f"route's bit-equal {same}, dx and dstage {snr_routes:.1f} dB")
        assert fwd_l == {**no_mg, fwd_name: 8}, fwd_l
        assert bwd_l == {**no_mg, fwd_name + "_adjoint": 8}, bwd_l
        assert not any(plain_n.values()), plain_n
        assert same if fwd_name == "moog_ladder" else snr_routes >= 100

    for name, k in kernels.items():
        k["by_path"]["moog_grad"] = mg_counts[name]
        k["by_path"]["moog_grad_over_budget"] = over_counts[name]
    rec_by_path["moog_grad"] = {n: mg_counts[n + ".record"]
                                for n in recorders}
    rec_by_path["moog_grad_over_budget"] = {n: over_counts[n + ".record"]
                                            for n in recorders}
    for n in recorders:
        kernels[n]["record_launches_by_path"] = {
            path: r[n] for path, r in rec_by_path.items()}
    print(f"moog grad launches: {json.dumps(mg_counts)}; over budget "
          f"{json.dumps(over_counts)}; phase "
          f"{time.perf_counter() - t_mg:.2f} s")
    assert all(mg_counts[name] > 0 for name in (
        "moog_ladder", "moog_zdf", "moog_ladder_reverse",
        "moog_zdf_reverse")), mg_counts
    assert not (mg_counts["moog_ladder_adjoint"]
                or mg_counts["moog_zdf_adjoint"]), mg_counts
    assert all(over_counts[name] > 0 for name in (
        "moog_ladder_adjoint", "moog_zdf_adjoint")), over_counts

    # -- 9. dynamics: the dynamics family through the effect chain ----------------
    # DYN_GRAPH and SPLIT_GRAPH streamed over 64 ch x 94 blocks of 512 through
    # Chain.process_blocks, the launches of each block counted by kernel
    # with every plain version's calls counted too (none may be called),
    # held against the port's plain CPU path over 8 blocks; the gate's
    # decisions against the CPU path's; ms per block and the real-time
    # factor. Then the feedback Compressor called directly at the
    # flagship's width in float32 and float64, and D1's times and bounds.
    t_dyn = time.perf_counter()
    dyn_plain = [(bqmod, "biquad_cascade_plain"),
                 (envscan, "envelope_scan_plain"),
                 (dynfb, "dynamics_feedback_plain")]
    dyn_rng = np.random.default_rng(5)
    n_chain = CHAIN_BLOCKS * CHAIN_BLOCK
    n8 = 8 * CHAIN_BLOCK
    # noise whose level steps every 1/8 s across the gate's, the
    # compressors' and the expander's thresholds, with a 7 kHz tone for the
    # de-esser where it is loud
    dyn_level = np.repeat(dyn_rng.uniform(0.002, 1.5, (CHAIN_CH, -(-n_chain // 6000))),
                          6000, axis=1)[:, :n_chain]
    xs_np = (dyn_rng.standard_normal((CHAIN_CH, n_chain)) * dyn_level
             + 0.2 * np.sin(2 * np.pi * 7000.0 * np.arange(n_chain) / SR)
             * (dyn_level > 0.3)).astype(np.float32)
    xs = torch.as_tensor(xs_np, device=dev)
    dyn_ms = {}
    for path, graph in (("dyn_chain", DYN_GRAPH), ("split_chain", SPLIT_GRAPH)):
        raw_d = json.dumps(graph)
        chd = Chain(SR)
        report = chd.load_graph(raw_d)
        print(f"{path} fusion report: {report}")
        assert report == [], report
        st_d = chd.init_state((CHAIN_CH,))
        for k in kernels.values():
            k["wrapper"].launches = 0
        k4.reset_counts()
        with plain_calls(dyn_plain) as plain_n:
            _, yd = chd.process_blocks(st_d, xs)
            torch.cuda.synchronize()
        launches = {name: k["wrapper"].launches for name, k in kernels.items()}
        for name, k in kernels.items():
            k["by_path"][path] = launches[name]
        per_block = {name: v / CHAIN_BLOCKS for name, v in launches.items() if v}
        env_counts[path] = k4.counts()
        print(f"{path} launches per block of {CHAIN_CH}x{CHAIN_BLOCK} over "
              f"{CHAIN_BLOCKS} blocks: {json.dumps(per_block)}; plain versions "
              f"called {sum(plain_n.values())} times; envelope counts "
              f"{json.dumps(env_counts[path])}")
        assert not any(plain_n.values()), plain_n
        assert all(v % CHAIN_BLOCKS == 0 for v in launches.values()), launches
        assert launches["biquad_cascade"] > 0 and launches["envelope"] > 0
        assert launches["dynamics_feedback"] == (
            CHAIN_BLOCKS if path == "dyn_chain" else 0), launches
        assert set(per_block) <= {"biquad_cascade", "envelope",
                                  "dynamics_feedback"}, per_block
        assert env_counts[path]["exact_walks"] == 0
        chd_cpu = Chain(SR)
        chd_cpu.load_graph(raw_d)
        t0 = time.perf_counter()
        _, yd_cpu = chd_cpu.process_blocks(
            chd_cpu.init_state((CHAIN_CH,), device="cpu"),
            torch.as_tensor(xs_np[:, :n8]))
        cpu_s = time.perf_counter() - t0
        yd_h = host(yd)
        assert yd_h.shape == (CHAIN_CH, n_chain) and np.all(np.isfinite(yd_h))
        snr = snr_db(yd_cpu.numpy(), yd_h[:, :n8])
        print(f"{path} {CHAIN_CH}x{n8} (8 blocks) vs plain CPU path: SNR "
              f"{snr:.1f} dB (plain CPU path {cpu_s:.2f} s)")
        assert snr >= 100
        dyn_ms[path] = time_ms(torch, lambda: chd.process_blocks(st_d, xs),
                               reps=3, warmup=1) / CHAIN_BLOCKS
        print(f"time {path} per block ({CHAIN_CH}x{CHAIN_BLOCK}, mean over 3 x "
              f"{CHAIN_BLOCKS} blocks of process_blocks): {dyn_ms[path]:.4f} "
              f"ms, real-time factor {CHAIN_BLOCK / SR * 1e3 / dyn_ms[path]:.2f}"
              f" ({gpu})")
        parts = device_activity(
            torch, lambda: chd.process(st_d, xs[:, :CHAIN_BLOCK]), 10,
            ("biquad_", "envelope_", "dynamics_"))["by_name"]
        print(f"time {path} kernels per block by launch (profiler, device ms): "
              + (", ".join(f"{k} {t:.4f}" for k, t in parts.items())
                 or "not measured")
              + (f"; sum {sum(parts.values()):.4f} ms of {dyn_ms[path]:.4f} "
                 f"ms wall" if parts else "") + f" ({gpu})")
        # host time by node: each node's process between two
        # synchronizations, over 8 blocks
        node_ms = {nid: 0.0 for nid in chd.runtimes}
        untimed = {nid: rt.process for nid, rt in chd.runtimes.items()}

        def timed(nid, fn):
            def run(st_n, x_n, sc_n):
                torch.cuda.synchronize()
                t_n = time.perf_counter()
                out = fn(st_n, x_n, sc_n)
                torch.cuda.synchronize()
                node_ms[nid] += (time.perf_counter() - t_n) * 1e3 / 8
                return out
            return run

        for nid, rt in chd.runtimes.items():
            rt.process = timed(nid, untimed[nid])
        try:
            chd.process_blocks(st_d, xs[:, :n8])
        finally:
            for nid, rt in chd.runtimes.items():
                rt.process = untimed[nid]
        print(f"time {path} per node a block (synchronized around each node, "
              f"8 blocks): " + ", ".join(f"{nid} {t:.4f} ms"
                                        for nid, t in node_ms.items())
              + f" ({gpu})")
        if path == "dyn_chain":
            # the same chain with auto dispatch keeping float32 slow-pole
            # chains on the blocked engine (the rule the whole-cascade
            # engine replaced for them): here the 250 Hz crossover
            auto_rule = BiquadChain._auto_mode
            BiquadChain._auto_mode = lambda self, x_a: (
                "kernel" if x_a.dtype == torch.float32
                and not self.has_slow_poles
                and self.num_runtime_sections <= bqmod.MAX_SECTIONS
                else "blocked")
            try:
                blocked_ms = time_ms(
                    torch, lambda: chd.process_blocks(st_d, xs), reps=3,
                    warmup=1) / CHAIN_BLOCKS
            finally:
                BiquadChain._auto_mode = auto_rule
            print(f"time dyn_chain per block with slow-pole float32 chains on "
                  f"the blocked engine: {blocked_ms:.4f} ms, real-time factor "
                  f"{CHAIN_BLOCK / SR * 1e3 / blocked_ms:.2f} ({gpu})")
        if path != "dyn_chain":
            # the transient shaper alone: its envelope runs on K4, whose
            # selection fixpoint stops within 4 ulps, and that error
            # enters its gain through delta / (env + 1e-9)
            ts = chd.runtimes["tr"].effect
            _, y_ts = streaming.scan_blocks(
                ts.process, ts.init_state((CHAIN_CH,)), xs[:, :n8],
                block_size=CHAIN_BLOCK)
            _, y_ts_cpu = streaming.scan_blocks(
                ts.process, ts.init_state((CHAIN_CH,), device="cpu"),
                torch.as_tensor(xs_np[:, :n8]), block_size=CHAIN_BLOCK)
            g_ts, g_ts_cpu = host(y_ts) / xs_np[:, :n8], y_ts_cpu.numpy() / xs_np[:, :n8]
            print(f"split_chain transient shaper alone {CHAIN_CH}x{n8} through "
                  f"K4 vs the plain CPU path: y SNR {snr_db(y_ts_cpu.numpy(), host(y_ts)):.1f}"
                  f" dB, gain SNR {snr_db(g_ts_cpu, g_ts):.1f} dB, max |gain "
                  f"err| {float(np.max(np.abs(g_ts - g_ts_cpu))):.3e}")
            assert snr_db(y_ts_cpu.numpy(), host(y_ts)) >= 100
            continue
        # The gate's reset (expansion gain >= 1) is a discrete decision: a
        # level within ulps of the knee's edge can flip it between the card
        # (K4 stops within 4 ulps) and the CPU path, and a flip moves the
        # hold window. Count the samples whose gated gain is unity on one
        # side only, then rerun the CPU side on the card's detector levels.
        gate = chd.runtimes["gate"].effect

        def gate_gains(device, levels=None):
            st_g = gate.init_state((CHAIN_CH,), torch.float32, device)
            gains, seen = [], []
            for b in range(8):
                xb = torch.as_tensor(xs_np[:, b * CHAIN_BLOCK:(b + 1) * CHAIN_BLOCK],
                                     device=device)
                st_n, level = gate.core.detector(st_g, xb)
                if levels is not None:
                    level = levels[b].to(device)
                g_b, hold = gate_hold(gate._gain(level), st_g["hold"],
                                      gate.hold_samples)
                st_g = {**st_n, "hold": hold}
                gains.append(host(g_b))
                seen.append(level)
            return np.concatenate(gains, axis=-1), seen

        g_card, lv_card = gate_gains(dev)
        g_cpu, _ = gate_gains("cpu")
        g_given, _ = gate_gains("cpu", lv_card)
        flips = int(np.sum((g_card == 1.0) != (g_cpu == 1.0)))
        flips_given = int(np.sum((g_card == 1.0) != (g_given == 1.0)))
        print(f"dyn_chain gate decisions over 8 blocks ({CHAIN_CH}x{n8} "
              f"samples, {int(np.sum(g_card == 1.0))} at unity gain): differ "
              f"from the CPU path at {flips}; given the card's detector levels "
              f"at {flips_given}")
        assert flips_given == 0

    # the feedback Compressor called directly at the flagship's width:
    # float32 and float64, one D1 launch a call, against the CPU path
    direct = {}
    for dtype in (torch.float32, torch.float64):
        comp_fb = Compressor(SR, topology=Topology.FEEDBACK, **FB_GRAPH_KW)
        x_fb_np = (np.random.default_rng(6).standard_normal((CHANNELS, N_FLAGSHIP))
                   * np.repeat(np.random.default_rng(7).uniform(
                       0.01, 2.0, (CHANNELS, 47)), 1024, axis=1)[:, :N_FLAGSHIP])
        x_fb = torch.as_tensor(x_fb_np, dtype=dtype, device=dev)
        st_fb = comp_fb.init_state((CHANNELS,), dtype)
        dynfb.dynamics_feedback.launches = 0
        _, y_fb = comp_fb.process(st_fb, x_fb)
        torch.cuda.synchronize()
        n_launch = dynfb.dynamics_feedback.launches
        kdyn["by_path"][f"feedback_direct_{str(dtype)[6:]}"] = n_launch
        _, y_fb_cpu = comp_fb.process(
            comp_fb.init_state((CHANNELS,), dtype, "cpu"), x_fb.cpu())
        s_fb = snr_db(y_fb_cpu.numpy(), host(y_fb))
        p_fb = comp_fb.core.feedback_params()
        zf = torch.zeros(CHANNELS, dtype=dtype, device=dev)
        call = lambda: dynfb.dynamics_feedback(x_fb, zf, zf, p_fb)
        direct[dtype] = (graph_ms(torch, call, 5), time_ms(torch, call, 5))
        print(f"feedback Compressor {dtype} {CHANNELS}x{N_FLAGSHIP} on the card:"
              f" D1 launches {n_launch}, SNR vs the CPU path {s_fb:.1f} dB")
        assert n_launch == 1 and s_fb >= (100 if dtype == torch.float32 else 200)

    # D1's time beside its bounds: the bytes (x in, y and the gain out,
    # four (C,) states) and operations at the card's rates, and the chain
    # bound of its dependent walk, T steps of a step's cycles (one thread,
    # clock64, csrc/dynamics.cu::dynamics_latency_kernel) at the SM clock
    # of a one-thread kernel
    mhz = dynfb.sm_clock_mhz()
    p_graph = Compressor(SR, topology=Topology.FEEDBACK,
                         **FB_GRAPH_KW).core.feedback_params()
    cycles = {dt: dynfb.step_cycles(p_graph, dt)
              for dt in (torch.float32, torch.float64)}
    xg1 = randn(CHAIN_CH, CHAIN_BLOCK)
    zg1 = torch.zeros(CHAIN_CH, device=dev)
    d1_call = lambda: dynfb.dynamics_feedback(xg1, zg1, zg1, p_graph)
    kdyn["ms_at"] = (f"per dyn_chain block, {CHAIN_CH} x {CHAIN_BLOCK} float32 "
                     f"(the graph's feedback compressor)")
    kdyn["ms"] = graph_ms(torch, d1_call, 20)
    kdyn["call_ms"] = time_ms(torch, d1_call, 20)
    kdyn["plain_ms"] = time_ms(torch, lambda: dynfb.dynamics_feedback_plain(
        xg1, zg1, zg1, p_graph), 1, warmup=0)

    def d1_work(c, t, itemsize):
        return (3.0 * itemsize * c * t + 4.0 * itemsize * c,
                float(D1_STEP_OPS * c * t))

    kdyn["bound_ms"], kdyn["bound_by"] = bound(*d1_work(CHAIN_CH, CHAIN_BLOCK, 4))
    kdyn["library_ms"] = None
    kdyn["step_cycles"] = {str(dt)[6:]: cyc for dt, cyc in cycles.items()}
    kdyn["sm_mhz"] = mhz
    kdyn["chain_bound_ms"] = {
        "chain block float32": CHAIN_BLOCK * cycles[torch.float32] / mhz * 1e-3,
        "direct float32": N_FLAGSHIP * cycles[torch.float32] / mhz * 1e-3,
        "direct float64": N_FLAGSHIP * cycles[torch.float64] / mhz * 1e-3}
    kdyn["ms_by_shape"] = {"chain block float32": kdyn["ms"],
                           "direct float32": direct[torch.float32][0],
                           "direct float64": direct[torch.float64][0]}
    b_direct = {dt: bound(*d1_work(CHANNELS, N_FLAGSHIP, 4 if dt == torch.float32
                                   else 8))[0] for dt in direct}
    print(f"time dynamics_feedback {kdyn['ms_at']}: kernel {kdyn['ms']:.4f} ms "
          f"(graph replay; {kdyn['call_ms']:.4f} ms as back-to-back calls), "
          f"bound {kdyn['bound_ms']:.6f} ms ({kdyn['bound_by']}), chain bound "
          f"{kdyn['chain_bound_ms']['chain block float32']:.4f} ms "
          f"({CHAIN_BLOCK} steps x {cycles[torch.float32]:.1f} cycles / "
          f"{mhz:.0f} MHz, {100 * kdyn['chain_bound_ms']['chain block float32'] / kdyn['ms']:.0f}%"
          f" of the kernel), plain {kdyn['plain_ms']:.4f} ms, library none "
          f"({gpu})")
    for dt, (g_ms, c_ms) in direct.items():
        key = f"direct {str(dt)[6:]}"
        print(f"time dynamics_feedback direct {CHANNELS}x{N_FLAGSHIP} {dt}: "
              f"kernel {g_ms:.4f} ms (graph replay; {c_ms:.4f} ms as "
              f"back-to-back calls), byte bound {b_direct[dt]:.6f} ms, chain "
              f"bound {kdyn['chain_bound_ms'][key]:.4f} ms ({N_FLAGSHIP} steps "
              f"x {cycles[dt]:.1f} cycles, "
              f"{100 * kdyn['chain_bound_ms'][key] / g_ms:.0f}% of the kernel)"
              f" ({gpu})")
    kdyn["counts_by_path"] = {p: env_counts[p] for p in ("dyn_chain",
                                                          "split_chain")}
    for name, k in kernels.items():
        k["launches"] = sum(k["by_path"].values())
    print(f"dynamics launches by path: "
          f"{json.dumps({p: {n: k['by_path'].get(p, 0) for n, k in kernels.items() if k['by_path'].get(p, 0)} for p in ('dyn_chain', 'split_chain', 'feedback_direct_float32', 'feedback_direct_float64')})}"
          f"; phase {time.perf_counter() - t_dyn:.2f} s")
    assert all(kernels[n]["by_path"]["dyn_chain"] > 0 for n in (
        "biquad_cascade", "envelope", "dynamics_feedback"))

    # -- 10. analysis: the analysis slice (analyzers, STFT path, Hilbert, noise) ----
    analysis_phase(torch, dev, gpu, kernels, plain_calls, bqmod, envscan)
    for name, k in kernels.items():
        k["launches"] = sum(k["by_path"].values())
    assert kernels["envelope"]["by_path"]["analysis_stream"] == CHAIN_BLOCKS
    assert kernels["biquad_cascade"]["by_path"]["analysis_hilbert"] > 0

    # -- 11. space: delay feedback and reverb through the chain (R1-R3) ------------
    space_phase(torch, dev, gpu, kernels, plain_calls)
    for name, k in kernels.items():
        k["launches"] = sum(k["by_path"].values())

    # -- 12. modulation: the modulation and waveshaping families (M1-M3) -----------
    modulation_phase(torch, dev, gpu, kernels, plain_calls, bqmod, envscan)
    for name, k in kernels.items():
        k["launches"] = sum(k["by_path"].values())

    # -- 13. voice: the last effects and the dither quantizer (W1, Q1) -------------
    voice_phase(torch, dev, gpu, kernels, plain_calls, bqmod, envscan, fdlconv)
    for name, k in kernels.items():
        k["launches"] = sum(k["by_path"].values())

    # -- 14. kernel list ----------------------------------------------------------
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
                                   "scratch_bytes", "record_bytes",
                                   "record_ms", "record_bound_ms",
                                   "record_launches_by_path",
                                   "chain_bound_ms", "critical_path_ms",
                                   "step_cycles", "sm_mhz")
                   if key in k}}
        for name, k in kernels.items()]}
    print(json.dumps(line))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
