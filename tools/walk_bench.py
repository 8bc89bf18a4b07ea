#!/usr/bin/env python3
"""The PyTorch/CUDA port's WSOLA search (W1, `csrc/wsola.cu`) and FDN
loop (R3, `csrc/feedback.cu::fdn_kernel`) alone, on one card.

    python3 tools/walk_bench.py [ROOT ...] [--paths]

Each ROOT is a checkout whose `algodsp_tpu_torch` is measured (default:
this one), one process each and in the order given, so that two versions
are timed in one run on one card (give PARENT . . PARENT). Prints the
device time of one call by CUDA-graph replay of 20 calls at the main
path's shapes: W1 per WSOLA call of the music preset at +3, -4 and +12
semitones over 8 x 48128 (float32; +3 also float64), R3 per space-chain
block (64 x 512, the node's defaults, float32 and float64) and per FDN
render of 8 x 48128 (float32: 47 blocks of 1024 in the blocked tier);
beside them the chain bounds from the kernels' latency probes
(`wsola.sum_step_cycles`, `feedback.damp_step_cycles`) and the SM clock.
The inputs are made from a seed and are the same in every ROOT.

--paths  also times the paths the two kernels serve, as chip_smoke.py
         does: the WSOLA one-shots (+3, -4, +12) and PITCH_GRAPH at 8 x
         48128 float32 (ms a call, 3 calls back to back) and
         chip_smoke.SPACE_GRAPH over 64 ch x 94 blocks of 512 float32 (ms
         a block, 2 runs); builds every kernel.
Needs CUDA and nvcc; exits non-zero without them.
"""

import json
import os
import subprocess
import sys

import numpy as np

SR = 48000.0


def main() -> int:
    args = sys.argv[1:]
    flags = [a for a in ("--paths",) if a in args]
    paths = "--paths" in flags
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
        print("walk_bench: CUDA is not available", file=sys.stderr)
        return 1
    from algodsp_tpu_torch import _build
    from algodsp_tpu_torch.effects.pitch import WSOLAPitchShifter
    from algodsp_tpu_torch.effects.reverb import FDNReverb
    from algodsp_tpu_torch.ops import dynfb, feedback
    from algodsp_tpu_torch.ops import wsola as w1

    sys.path.insert(1, here)
    from chip_smoke import (CHAIN_BLOCK, CHAIN_BLOCKS, CHAIN_CH, CHANNELS,
                            N_FLAGSHIP, PITCH_GRAPH, SPACE_GRAPH, card,
                            graph_ms, time_ms, voice_material)

    dev = torch.device("cuda", 0)
    gpu = card()
    _build.build_all(_build.KERNEL_SOURCES if paths else ("wsola", "feedback",
                                                          "dynamics"))
    rng = np.random.default_rng(0)
    f32, f64 = torch.float32, torch.float64
    x8 = voice_material(rng, CHANNELS, N_FLAGSHIP)
    mhz = dynfb.sm_clock_mhz()
    add_cycles = w1.sum_step_cycles()
    out, bounds = {}, {}

    def music(st):
        return WSOLAPitchShifter(SR, pitch_ratio=2.0 ** (st / 12.0))

    def w1_call(st, dt):
        ws = music(st)
        rs, edge, tail0, n_ext = ws.plan(N_FLAGSHIP, 1.0 / ws.pitch_ratio)
        x2 = torch.nn.functional.pad(torch.as_tensor(x8, dtype=dt, device=dev),
                                     (0, n_ext - N_FLAGSHIP))
        csq = w1.energy_prefix(x2)
        grid = (torch.as_tensor(np.asarray(rs, np.int32), device=dev),
                torch.as_tensor(np.asarray(edge, np.uint8), device=dev))
        chain = len(rs) * ws.overlap * add_cycles / mhz * 1e-3
        return (lambda: w1.launch(x2, csq, *grid, ws.overlap, ws.seek,
                                  ws.sequence - ws.overlap, tail0)), chain

    for st, dt in ((3, f32), (-4, f32), (12, f32), (3, f64)):
        label = f"W1 {st:+d} 8x48128 {str(dt)[6:]}"
        call, bounds[label] = w1_call(st, dt)
        out[label] = graph_ms(torch, call, 20)

    rv = FDNReverb(SR, wet=0.22, damp=0.45)   # the chain node's defaults
    damp_cycles = feedback.damp_step_cycles(rv.damp, False)

    def r3_call(c, n, dt):
        st = rv.init_state((c,), dt, dev)
        st["lines"] = torch.as_tensor(0.3 * rng.standard_normal(
            (c, 8, rv.line_len)), dtype=dt, device=dev)
        x = torch.as_tensor(rng.standard_normal((c, n)), dtype=dt, device=dev)
        inp = 0.5 * x
        return lambda: feedback.fdn_feedback(rv, st["lines"], st["filter"],
                                             st["lfo_phase"], st["step"], x, inp)

    for c, n, dt, what in ((CHAIN_CH, CHAIN_BLOCK, f32, "space block"),
                           (CHAIN_CH, CHAIN_BLOCK, f64, "space block"),
                           (CHANNELS, N_FLAGSHIP, f32, "render")):
        label = f"R3 {what} {c}x{n} {str(dt)[6:]}"
        out[label] = graph_ms(torch, r3_call(c, n, dt), 20)
        bounds[label] = n * damp_cycles / mhz * 1e-3
    print(f"walk {root} ms (graph replay of 20 calls): {json.dumps(out)}; "
          f"chain bounds ms {json.dumps(bounds)} (sum step {add_cycles:.2f}, "
          f"damping step {damp_cycles:.2f} cycles, SM {mhz:.0f} MHz) ({gpu})",
          flush=True)
    if paths:
        from algodsp_tpu_torch.chain import Chain
        xd = torch.as_tensor(x8, dtype=f32, device=dev)

        def chain_once(graph):
            def run():
                ch = Chain(SR)
                ch.load_graph(json.dumps(graph))
                return ch.process(ch.init_state((CHANNELS,), f32, dev), xd)
            return run

        res = {f"WSOLA {st:+d} one-shot 8x48128 f32 ms a call":
               time_ms(torch, lambda st=st: music(st).process(xd), 3, 1)
               for st in (3, -4, 12)}
        res["PITCH_GRAPH one-shot 8x48128 f32 ms a call"] = time_ms(
            torch, chain_once(PITCH_GRAPH), 3, 1)
        ch = Chain(SR)
        ch.load_graph(json.dumps(SPACE_GRAPH), auto_fuse=False)
        xs = torch.as_tensor(0.5 * rng.standard_normal(
            (CHAIN_CH, CHAIN_BLOCKS * CHAIN_BLOCK)), dtype=f32, device=dev)
        st = ch.init_state((CHAIN_CH,), f32, dev)
        res["space chain 64x512 f32 ms a block"] = time_ms(
            torch, lambda: ch.process_blocks(st, xs), 2, 1) / CHAIN_BLOCKS
        print(f"walk paths {root}: {json.dumps(res)} ({gpu})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
