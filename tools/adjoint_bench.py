#!/usr/bin/env python3
"""The PyTorch/CUDA port's two adjoint kernels alone, on one card.

    python3 tools/adjoint_bench.py [ROOT ...] [--tune]

Times `envelope_adjoint` (A3, csrc/envelope.cu) and
`fdl_spectra_adjoint` (A1's dH, csrc/fdlconv.cu) by CUDA-graph replay,
through their wrappers, at the shapes of the training paths and at one
large shape each:
  A3   per flagship backward (8 x 48128 float32) and 64 x 2^20 float32;
  A1   per IR-learning step (C 8, nf 47, B 1024, P 32) and at the folded
       shape (C 8, nf 2048, B 8192, P 17).
Each ROOT is a checkout whose `algodsp_tpu_torch` is measured (default:
this one), in a process of its own, in the order given, so that two
versions are compared in one run on one card: give the parent's
unpacked copy as PARENT . . PARENT. The inputs come from a fixed seed,
the same for every ROOT. Prints a line per ROOT and shape, then one JSON
line of all the times.

--tune   also times A1 at every G the kernel takes (the lags a thread
         holds; `fdlconv.spectra_adjoint_plan` picks one), for a ROOT
         that has `fdlconv._spectra_adjoint_launch`.
Needs CUDA and nvcc; exits non-zero without them.
"""

import json
import os
import subprocess
import sys

import numpy as np

A3_SHAPES = {"flagship backward": (8, 48128), "64 x 2^20": (64, 1 << 20)}
A1_SHAPES = {"IR-learning step": (8, 47, 1024, 32),
             "folded": (8, 2048, 8192, 17)}


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def measure(root: str, tune: bool) -> dict:
    """Times (ms) of ROOT's two adjoint kernels at every shape."""
    sys.path.insert(0, root)
    import torch
    from algodsp_tpu_torch import _build
    from algodsp_tpu_torch.ops import envscan, fdlconv

    dev = torch.device("cuda", 0)
    _build.build_all(("envelope", "fdlconv"))
    rng = np.random.default_rng(0)

    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    out = {}
    for label, (c, t) in A3_SHAPES.items():
        x = tensor(np.abs(rng.standard_normal((c, t))))
        env0 = tensor(np.zeros(c))
        att, rel = tensor(np.full(c, 0.2)), tensor(np.full(c, 0.01))
        with torch.no_grad():
            _, traj = envscan.envelope_scan_kernel(x, env0, att, rel)
        args = (x, traj, env0, att, rel, tensor(rng.standard_normal((c, t))),
                tensor(rng.standard_normal(c)))
        reps = 20 if t < 1 << 20 else 5
        out[f"A3 {label}"] = graph_ms(
            torch, lambda: envscan.envelope_adjoint(*args), reps)
        del x, traj, args
    for label, (c, nf, b, p) in A1_SHAPES.items():
        X = tensor(rng.standard_normal((c, nf, b + 1, 2)))
        dV = tensor(rng.standard_normal((c, nf, b + 1, 2)))
        reps = 20 if nf < 1000 else 3
        out[f"A1 {label}"] = graph_ms(
            torch, lambda: fdlconv.fdl_spectra_adjoint(X, dV, p), reps)
        if tune and hasattr(fdlconv, "_spectra_adjoint_launch"):
            for g in (1, 2, 4, 8):
                out[f"A1 {label} G={g}"] = graph_ms(
                    torch, lambda g=g: fdlconv._spectra_adjoint_launch(
                        X, dV, p, g), reps)
        del X, dV
    return out


def graph_ms(torch, fn, reps):
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
    return a.elapsed_time(b) / reps


def main() -> int:
    args = sys.argv[1:]
    tune = "--tune" in args
    args = [a for a in args if a != "--tune"]
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if args and args[0] == "--one":
        import torch
        if not torch.cuda.is_available():
            print("adjoint_bench: CUDA is not available", file=sys.stderr)
            return 1
        print(json.dumps(measure(os.path.abspath(args[1]), tune)))
        return 0
    roots = [os.path.abspath(r) for r in args] or [here]
    gpu = card()
    runs = []
    for root in roots:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", root]
            + (["--tune"] if tune else []), capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        times = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append({"root": root, "ms": times})
        for label, ms in times.items():
            print(f"{label}: {ms:.4f} ms (graph replay) [{root}] ({gpu})")
    print(json.dumps({"card": gpu, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
