#!/usr/bin/env python3
"""The PyTorch/CUDA port's biquad cascade kernel (K3) alone, on one card.

    python3 tools/k3_bench.py [ROOT] [--tune] [--phases DIR]

ROOT is a checkout whose `algodsp_tpu_torch` is measured (default: this
one), so that two versions can be timed in one run, one process each.
Prints the device time of the kernel by CUDA-graph replay at the main
path's shapes: the flagship's two calls (8 x 48128, Butterworth S = 5
and A-weighting S = 6), the Butterworth call alone, the chain block
(64 x 512, S = 2) and 512 x 2^16 with S = 15.

--tune   also times the flagship with clusters of at most 2, 4, 6 and 8
         blocks a channel and the chain block with chunks of at least
         3, 7, 15 and 31 samples (the plan's MAX_CLUSTER and MIN_CHUNK).
--phases copies ROOT's package into DIR with clock64() stamps at the
         kernel's phase boundaries (block 1, threads 0 and 448), builds
         it, and prints the cycles of each phase at the flagship,
         chain-block and 512 x 2^16 shapes: staging, the first section's
         zero-state walk, then per section the scan, the cluster barrier,
         the cluster exchange, the walk, the barrier and the step to the
         next section; then the store.
Needs CUDA and nvcc; exits non-zero without them.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np

SR = 48000.0

# phase stamps: PROF(pi++) goes before each anchor in csrc/biquad_cascade.cu
_STAMP = ("#define PROF(i) do { const int pj_ = (i); if (blockIdx.x == 1 && "
          "(tid == 0 || tid == 448) && pj_ < 512) ((long long*)(tab + S * "
          "BQ_TAB))[(tid == 0 ? 0 : 512) + pj_] = clock64(); } while (0)\n")
_ANCHORS = ["  const float* xc = x + (size_t)c * n;\n",
            "    const int start = min(tid * L, len), end",
            "      carry_scan(w1, w2,",
            "        cluster.sync();\n",
            "      if (next)\n        walk<true>",
            "      __syncthreads();\n      if (last) {",
            "    for (int i = tid; i < len; i += nt) yc[base + i]"]


def instrument(root: str, dst: str) -> str:
    """A copy of root's package in dst with phase stamps; the stamps go to
    1024 int64 after the kernel's table (the table tensor is grown)."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(root, "algodsp_tpu_torch"),
                    os.path.join(dst, "algodsp_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build"))
    cu = os.path.join(dst, "algodsp_tpu_torch", "csrc", "biquad_cascade.cu")
    s = open(cu).read()
    s = s.replace("namespace cg = cooperative_groups;\n",
                  "namespace cg = cooperative_groups;\n" + _STAMP, 1)
    s = s.replace(_ANCHORS[0],
                  "  int pi = 0;\n  PROF(pi++);\n" + _ANCHORS[0], 1)
    for a in _ANCHORS[1:]:
        assert a in s, a
        s = s.replace(a, "PROF(pi++);\n" + a, 1)
    s = s.replace("        cluster.sync();\n",
                  "        cluster.sync();\nPROF(pi++);\n", 1)
    s = s.replace("      __syncthreads();\n      if (last) {",
                  "      __syncthreads();\nPROF(pi++);\n      if (last) {", 1)
    open(cu, "w").write(s)
    py = os.path.join(dst, "algodsp_tpu_torch", "ops", "biquad_cascade.py")
    s = open(py).read()
    old = ("    return torch.as_tensor(section_tables(sos, length, seg))"
           ".to(device)")
    assert old in s
    s = s.replace(old, "    t = torch.as_tensor(section_tables(sos, length, "
                       "seg)).reshape(-1)\n    return torch.cat([t, torch."
                       "zeros(1024, dtype=torch.float64)]).to(device)")
    open(py, "w").write(s)
    return dst


def main() -> int:
    args = sys.argv[1:]
    phases = None
    if "--phases" in args:
        phases = args[args.index("--phases") + 1]
        del args[args.index("--phases"):args.index("--phases") + 2]
    tune = "--tune" in args
    args = [a for a in args if a != "--tune"]
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = os.path.abspath(args[0]) if args else here
    if phases:
        root = instrument(root, os.path.abspath(phases))
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("k3_bench: CUDA is not available", file=sys.stderr)
        return 1
    from algodsp_tpu_torch import _build
    from algodsp_tpu_torch.filters import BiquadChain
    from algodsp_tpu_torch.filters.design import butterworth_lp
    from algodsp_tpu_torch.filters.weighting import (
        WeightingType, weighting_chain)
    from algodsp_tpu_torch.ops import biquad_cascade as bq

    dev = torch.device("cuda", 0)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    _build.build_all(("biquad_cascade",))
    rng = np.random.default_rng(0)

    def randn(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=dev)

    def graph_ms(fn, reps):
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

    cascade = BiquadChain(butterworth_lp(2000.0, 10, SR))
    weighting = weighting_chain(WeightingType.A, SR)
    lp = BiquadChain(butterworth_lp(12000.0, 4, SR))
    sos15 = np.concatenate([cascade.runtime_sos, weighting.runtime_sos,
                            butterworth_lp(8000.0, 8, SR)])
    xf, xc, xw = randn(8, 48128), randn(64, 512), randn(512, 1 << 16)
    y1 = bq.biquad_cascade(xf, cascade.runtime_sos, cascade.gain)[0]
    flagship = lambda: (
        bq.biquad_cascade(xf, cascade.runtime_sos, cascade.gain),
        bq.biquad_cascade(y1, weighting.runtime_sos, weighting.gain))
    shapes = {"flagship both calls": (flagship, 20),
              "flagship Butterworth": (lambda: bq.biquad_cascade(
                  xf, cascade.runtime_sos, cascade.gain), 20),
              "chain block": (lambda: bq.biquad_cascade(
                  xc, lp.runtime_sos, lp.gain), 20),
              "512x2^16 S=15": (lambda: bq.biquad_cascade(xw, sos15), 5)}
    if phases:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for label, x, sos, gain in [
                ("flagship Butterworth", xf, cascade.runtime_sos, cascade.gain),
                ("chain block", xc, lp.runtime_sos, lp.gain),
                ("512x2^16 S=15", xw, sos15, 1.0)]:
            bq.biquad_cascade(x, sos, gain)
            bq.biquad_cascade(x, sos, gain)
            torch.cuda.synchronize()
            plan = bq.segment_plan(x.shape[1], x.shape[0], sms)
            tab = bq._device_tables(np.ascontiguousarray(sos).tobytes(),
                                    sos.shape[0], plan[1], plan[0], str(dev))
            t = tab[-1024:].cpu().numpy().view(np.int64).reshape(2, 512)
            for row, tid in zip(t, (0, 448)):
                k = int(np.argmax(row == 0)) if (row == 0).any() else 512
                if k:
                    print(f"phases {label} plan {plan} thread {tid} (cycles): "
                          f"{[int(d) for d in np.diff(row[:k])]}")
        return 0
    out = {k: graph_ms(f, r) for k, (f, r) in shapes.items()}
    print(f"k3 {os.path.basename(root)} ms (graph replay): "
          f"{json.dumps(out)} ({gpu})")
    if tune:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        res = {}
        for m in (2, 4, 6, 8):
            bq.MAX_CLUSTER = m
            res[f"flagship B<={m}"] = graph_ms(flagship, 20)
        bq.MAX_CLUSTER = 8
        for m in (3, 7, 15, 31):
            bq.MIN_CHUNK = m
            plan = bq.segment_plan(512, 64, sms)
            res[f"chain MIN_CHUNK={m} {plan}"] = graph_ms(
                lambda: bq.biquad_cascade(xc, lp.runtime_sos, lp.gain), 20)
        bq.MIN_CHUNK = 3
        print(f"k3 tune ms: {json.dumps(res)} ({gpu})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
