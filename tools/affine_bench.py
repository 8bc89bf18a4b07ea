#!/usr/bin/env python3
"""The PyTorch/CUDA port's affine scans (M2 `affine_scan_nd`, M3
`affine2_scan`, `csrc/affine.cu`) alone, on one card.

    python3 tools/affine_bench.py [ROOT ...] [--tune] [--paths]

Each ROOT is a checkout whose `algodsp_tpu_torch` is measured (default:
this one), one process each and in the order given, so that two versions
are timed in one run on one card (give PARENT . . PARENT). Prints the
device time of one call by CUDA-graph replay of 20 calls at the main
path's shapes and beside them: M3 at the AutoWah's 8 x 48128 in float32
and float64, at 64 x 512 and at 128 x 2^16; M2 at the mod chain's
phaser block, 64 x 511 steps with d = 7 in float32 and float64, with
d = 13, and the one-shot trio's 8 x 48127. The inputs are made from a
seed (an AutoWah-like DF2T whose centre sweeps 300-2800 Hz; a 6- or
12-stage Phaser's reduced matrices) and are the same in every ROOT.

--tune   also times M3 at 8 x 48128 and M2 at 64 x 511 with the chunk
         lengths 7-31 and 3-9 (`linrec.M3_CHUNK`, `linrec.M2_CHUNK`;
         a checkout that plans its chunks).
--paths  also times the paths the two kernels serve, as chip_smoke.py
         does: the AutoWah one-shot at 8 x 48128 float32 (ms a call, 3
         calls back to back) and chip_smoke.MOD_GRAPH over 64 ch x 94
         blocks of 512 float32 (ms a block, 2 runs); builds every kernel.
Needs CUDA and nvcc; exits non-zero without them.
"""

import json
import os
import subprocess
import sys

import numpy as np

SR = 48000.0


def m3_inputs(c, n, rng):
    """A DF2T band-pass at Q 2 whose centre sweeps 300-2800 Hz, driven by
    level-stepped noise: A (c, n, 4), w (c, n, 2), s0 (c, 2)."""
    x = rng.standard_normal((c, n)) * np.repeat(
        rng.uniform(0.02, 1.0, (c, -(-n // 1000))), 1000, axis=1)[:, :n]
    f = 300.0 + 2500.0 * (0.5 + 0.5 * np.sin(np.arange(n) / 3000.0
                                             + rng.uniform(0, 6, (c, 1))))
    w0 = 2 * np.pi * f / SR
    alpha = np.sin(w0) / 4.0
    inv = 1.0 / (1.0 + alpha)
    b0, a1, a2 = alpha * inv, -2.0 * np.cos(w0) * inv, (1.0 - alpha) * inv
    A = np.stack([-a1, np.ones_like(a1), -a2, np.zeros_like(a1)], -1)
    w = np.stack([-a1 * b0 * x, (-alpha * inv - a2 * b0) * x], -1)
    return A, w, 0.1 * rng.standard_normal((c, 2))


def m2_inputs(c, n, d, rng):
    """A (d - 1)-stage Phaser's reduced matrices (all-pass coefficient
    swept by an LFO, feedback 0.2): A (n, d, d), w (c, n, d), s0 (c, d)."""
    a = 0.5 * np.sin(np.arange(n) / 500.0) - 0.2
    A = np.zeros((n, d, d))
    A[:, 0, d - 1] = 0.2
    for i in range(d - 1):
        A[:, i + 1] = a[:, None] * A[:, i]
        A[:, i + 1, i] += 1.0
        A[:, i + 1, i + 1] -= a
    return A, rng.standard_normal((c, n, d)), rng.standard_normal((c, d))


def main() -> int:
    args = sys.argv[1:]
    flags = [a for a in ("--tune", "--paths") if a in args]
    tune, paths = "--tune" in flags, "--paths" in flags
    roots = [a for a in args if a not in flags]
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if len(roots) > 1:
        for r in roots:
            cmd = [sys.executable, os.path.abspath(__file__), r] + flags
            if subprocess.run(cmd).returncode:
                return 1
        return 0
    root = os.path.abspath(roots[0]) if roots else here
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("affine_bench: CUDA is not available", file=sys.stderr)
        return 1
    from algodsp_tpu_torch import _build
    from algodsp_tpu_torch.ops import linrec

    sys.path.insert(1, here)
    from chip_smoke import MOD_GRAPH, card, graph_ms as graph_ms_of, time_ms

    dev = torch.device("cuda", 0)
    gpu = card()
    _build.build_all(_build.KERNEL_SOURCES if paths else ("affine",))
    rng = np.random.default_rng(0)

    def on(arrays, dt):
        return [torch.as_tensor(a, dtype=dt, device=dev) for a in arrays]

    def graph_ms(fn):
        return graph_ms_of(torch, fn, 20)

    f32, f64 = torch.float32, torch.float64
    m3 = {(8, 48128): m3_inputs(8, 48128, rng), (64, 512): m3_inputs(64, 512, rng),
          (128, 1 << 16): m3_inputs(128, 1 << 16, rng)}
    m2 = {(64, 511, 7): m2_inputs(64, 511, 7, rng),
          (64, 511, 13): m2_inputs(64, 511, 13, rng),
          (8, 48127, 7): m2_inputs(8, 48127, 7, rng)}
    cases = {
        "M3 8x48128 f32": ("affine2_scan", on(m3[8, 48128], f32)),
        "M3 8x48128 f64": ("affine2_scan", on(m3[8, 48128], f64)),
        "M3 64x512 f32": ("affine2_scan", on(m3[64, 512], f32)),
        "M3 128x2^16 f32": ("affine2_scan", on(m3[128, 1 << 16], f32)),
        "M2 64x511 d7 f32": ("affine_scan_nd", on(m2[64, 511, 7], f32)),
        "M2 64x511 d7 f64": ("affine_scan_nd", on(m2[64, 511, 7], f64)),
        "M2 64x511 d13 f32": ("affine_scan_nd", on(m2[64, 511, 13], f32)),
        "M2 8x48127 d7 f32": ("affine_scan_nd", on(m2[8, 48127, 7], f32))}
    out = {label: graph_ms(lambda: getattr(linrec, name)(*a))
           for label, (name, a) in cases.items()}
    print(f"affine {root} ms (graph replay of 20 calls): {json.dumps(out)} "
          f"({gpu})", flush=True)
    if tune and hasattr(linrec, "M3_CHUNK"):
        res = {}
        a3, a2 = cases["M3 8x48128 f32"][1], cases["M2 64x511 d7 f32"][1]
        for L in (7, 11, 15, 23, 31):
            linrec.M3_CHUNK = L
            res[f"M3 L={L} {linrec.m3_plan(48128, 8, 4)}"] = graph_ms(
                lambda: linrec.affine2_scan(*a3))
        linrec.M3_CHUNK = 15
        for L in (3, 5, 7, 9):
            linrec.M2_CHUNK = L
            res[f"M2 L={L} {linrec.m2_plan(511, 64, 7, 4)}"] = graph_ms(
                lambda: linrec.affine_scan_nd(*a2))
        linrec.M2_CHUNK = 5
        print(f"affine tune ms: {json.dumps(res)} ({gpu})", flush=True)
    if paths:
        from algodsp_tpu_torch.chain import Chain
        from algodsp_tpu_torch.effects.modulation import AutoWah
        x = torch.as_tensor(0.5 * rng.standard_normal((8, 48128)), dtype=f32,
                            device=dev)
        aw = AutoWah(SR)
        wah = lambda: aw.process(aw.init_state((8,), f32, dev), x)
        ch = Chain(SR)
        ch.load_graph(json.dumps(MOD_GRAPH))
        xs = torch.as_tensor(0.5 * rng.standard_normal((64, 94 * 512)),
                             dtype=f32, device=dev)
        st = ch.init_state((64,), f32, dev)
        res = {"AutoWah one-shot 8x48128 f32 ms a call": time_ms(torch, wah, 3, 1),
               "MOD chain 64x512 f32 ms a block": time_ms(
                   torch, lambda: ch.process_blocks(st, xs), 2, 1) / 94}
        print(f"affine paths {root}: {json.dumps(res)} ({gpu})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
