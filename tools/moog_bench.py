#!/usr/bin/env python3
"""The PyTorch/CUDA port's Moog ladder kernels (K5, K6) alone, on one card.

    python3 tools/moog_bench.py [ROOT ...] [--latency] [--sass DIR]
    python3 tools/moog_bench.py --adjoint [ROOT ...]
    python3 tools/moog_bench.py --reverse-parts

Each ROOT is a checkout whose `algodsp_tpu_torch` is measured (default:
this one), in its own process, in the order given, so that two versions
can be timed in turns in one run (PARENT . . PARENT). Prints the device
time of each kernel by CUDA-graph replay, ns per dependent step, and the
byte/operation bound, at:
  - the chain block: the effect chain's `filter-moog` node (Huovilainen,
    1200 Hz, oversampling 4) on 64 x 512 samples, 2048 steps a channel.
    A ROOT whose kernels take no oversampling factor runs them on the
    64 x 2048 zero-stuffed block, as its `MoogFilter.process` did;
  - the direct ZDF block: `MoogFilter(variant=ZDF)`, newton 4, 64 x 512;
  - 128 x 2^16 (the JAX package's benchmark shape): classic,
    Huovilainen and ZDF newton 4.
--latency  builds tools/moog_latency.cu against this checkout's
           csrc/moog.cu and prints, in cycles (median and slowest of 32
           lanes): the dependent-chain latency of each primitive (FFMA,
           FMUL, the clips, ex2.approx, IEEE division against rcp.approx
           and an FMA, each float32 tanh candidate as a ladder stage
           uses it), of one kernel step in a loop (Huovilainen, classic,
           ZDF newton 4) and of the kernels' walk of a tile row; the
           kernel's own cycles against those inside its walk (clock64
           stamps in a copy of the ladder kernel); the worst error of
           each tanh candidate on a dense grid; the SM clock of a
           one-warp kernel (clock64 cycles over CUDA-event time, beside
           what `nvidia-smi --query-gpu=clocks.sm` reads); and the chain
           bound of each timed shape, steps x the cycles of a step / that
           clock, beside this checkout's kernel time.
--sass DIR writes `cuobjdump -sass` of each ROOT's built libmoog.so to
           DIR and prints the instruction mix of each kernel.
--adjoint  times the Moog gradient instead, ROOTs in turn as above: the
           gradient block, `moog_ladder` / `moog_zdf` under autograd and
           torch.autograd.grad of both outputs (forward under grad +
           backward, whichever route the ROOT takes), by graph replay
           (device time) and as back-to-back calls, beside the no-grad
           forward, at the chain block, the direct ZDF block and
           128 x 2^16 (classic, ZDF newton 4); each with the launches one
           gradient block made. A ROOT with the record route also times
           its parts alone (the recording forward, the reverse kernel,
           the checkpoint adjoint) and the record's bytes. With this
           checkout among the ROOTs, it also builds tools/moog_latency.cu
           and times K5 whose record goes to a shared-memory ring
           instead of device memory (ladder_record_probe): what a
           recording forward that stages its record through shared memory
           could save at most.
--reverse-parts  builds two copies of this checkout's csrc/moog.cu beside
           it, one whose reverse ring asks for no record copy and one
           that also stages no gy and flushes no dx (the walking warp
           alone: the results are garbage, only the times count), and
           times the reverse kernels of the three in turns at the chain
           block, the ZDF block, 64 x 2048 classic at os 1 and 64 x 512
           at os 4 (the same steps and record) and 128 x 2^14 classic;
           then counts the instructions of the ladder reverse's walk loop
           (float32, Huovilainen, os 4) in its SASS.
Needs CUDA and nvcc; exits non-zero without them.
"""

import ctypes
import inspect
import json
import os
import re
import subprocess
import sys
from collections import Counter

import numpy as np

SR = 48000.0
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# operations a step, counting a tanh as one (as chip_smoke.py does)
STEP_OPS = {"classic": 26, "huovilainen": 34, "zdf4": 8 + 1 + 42 * 4 + 37 + 8 + 1}
LATENCY_NAMES = [
    "FFMA", "FMUL", "FFMA + clip (max.NaN/min.NaN)",
    "FFMA + clip (compare-select)", "FFMA + clip (fminf/fmaxf)",
    "ex2.approx + FADD", "IEEE division", "rcp.approx + FMA quotient",
    "tanh stage: tanhf", "tanh stage: ex2/rcp + polynomial (kept)",
    "tanh stage: rational", "tanh stage: tanh.approx.f32",
    "Huovilainen step", "classic step", "ZDF step newton 4",
    "FFMA, loop not unrolled",
    "Huovilainen walk of a tile row, os 4 fixed, folded parameters",
    "Huovilainen walk of a tile row, os 4 at run time, folded parameters",
    "classic walk of a tile row, os 1 fixed, folded parameters",
    "Huovilainen walk of a tile row, os 4 fixed, the chain block's parameters",
    "classic walk of a tile row, os 1 fixed, the 128x2^16 parameters"]
# the effect chain's filter-moog node as chip_smoke.py's chain has it
CHAIN_MOOG = {
    "nodes": [{"id": "moog", "type": "filter-moog",
               "params": {"freq": 1200, "q": 2.0, "gain": 6, "order": 8}}],
    "connections": [{"from": "_input", "to": "moog"},
                    {"from": "moog", "to": "_output"}]}
TANH_NAMES = ["tanhf", "ex2/rcp + polynomial (kept)", "rational",
              "tanh.approx.f32"]


def card(fields="name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def graph_ms(torch, fn, reps: int) -> float:
    """Device ms of one call: reps calls in one CUDA graph, replayed
    between two CUDA events."""
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


def shapes():
    """(label, variant, channels, base samples, oversampling, step-ops key)."""
    return [("chain block", "huovilainen", 64, 512, 4, "huovilainen"),
            ("ZDF block", "zdf", 64, 512, 1, "zdf4"),
            ("128x2^16 classic", "classic", 128, 1 << 16, 1, "classic"),
            ("128x2^16 huovilainen", "huovilainen", 128, 1 << 16, 1,
             "huovilainen"),
            ("128x2^16 ZDF newton 4", "zdf", 128, 1 << 16, 1, "zdf4")]


def bound_ms(c, n, steps, ops):
    """The larger of bytes (x in and y out at the base rate, n samples,
    state8 in and out) over HBM and operations (steps ladder steps) over
    the float32 peak."""
    return max((8.0 * c * n + 64.0 * c) / HBM_BYTES_PER_S,
               float(ops) * c * steps / F32_FLOPS_PER_S) * 1e3


def time_root(root: str) -> dict:
    """Time ROOT's kernels at every shape; runs in its own process."""
    sys.path.insert(0, root)
    import torch
    from algodsp_tpu_torch import _build
    from algodsp_tpu_torch.chain import Chain
    from algodsp_tpu_torch.filters.moog import MoogFilter, MoogVariant
    from algodsp_tpu_torch.ops import moog as moog_ops

    dev = torch.device("cuda", 0)
    _build.build_all(("moog",))
    fused = "os" in inspect.signature(moog_ops.moog_ladder).parameters
    rng = np.random.default_rng(0)
    chain = Chain(SR)
    chain.load_graph(json.dumps(CHAIN_MOOG))
    filters = {
        "chain block": chain.runtimes["moog"].effect,
        "ZDF block": MoogFilter(SR, variant=MoogVariant.ZDF, cutoff_hz=1200.0,
                                resonance=2.0, drive=2.0, newton_iters=4),
        "128x2^16 classic": MoogFilter(SR, cutoff_hz=2000.0, resonance=0.5),
        "128x2^16 huovilainen": MoogFilter(
            SR, variant=MoogVariant.HUOVILAINEN, cutoff_hz=2000.0,
            resonance=0.5),
        "128x2^16 ZDF newton 4": MoogFilter(
            SR, variant=MoogVariant.ZDF, cutoff_hz=2000.0, resonance=0.5,
            newton_iters=4)}
    out = {}
    for label, variant, c, n, os_, ops in shapes():
        mf = filters[label]
        assert mf.variant.value == variant and mf.oversampling == os_, label
        x = torch.as_tensor(0.5 * rng.standard_normal((c, n)),
                            dtype=torch.float32, device=dev)
        st8 = torch.zeros(8, c, device=dev)
        p = mf.kernel_params()
        kw = {}
        if os_ > 1 and fused:
            kw["os"] = os_
        elif os_ > 1:
            xs = torch.zeros(c, n * os_, device=dev)
            xs[:, ::os_] = x * os_
            x = xs
        if variant == "zdf":
            call = lambda: moog_ops.moog_zdf(x, st8, p,
                                             newton_iters=mf.newton_iters, **kw)
        else:
            call = lambda: moog_ops.moog_ladder(
                x, st8, p, huovilainen=variant == "huovilainen", **kw)
        ms = graph_ms(torch, call, 20 if n <= 512 else 3)
        steps = n * os_
        out[label] = {"ms": ms, "ns_per_step": ms / steps * 1e6,
                      "bound_ms": bound_ms(c, n, steps, STEP_OPS[ops]),
                      "steps": steps, "input": list(x.shape)}
    return {"root": root, "fused_os": fused, "shapes": out,
            "clocks.sm": card("clocks.sm,clocks.max.sm")}


def adjoint_root(root: str) -> dict:
    """Time ROOT's Moog gradient block at the adjoint shapes; runs in its
    own process."""
    sys.path.insert(0, root)
    import torch
    from algodsp_tpu_torch import _build
    from algodsp_tpu_torch.chain import Chain
    from algodsp_tpu_torch.filters.moog import MoogFilter, MoogVariant
    from algodsp_tpu_torch.ops import moog as moog_ops

    dev = torch.device("cuda", 0)
    _build.build_all(("moog",))
    recorded = hasattr(moog_ops, "moog_ladder_reverse")
    rng = np.random.default_rng(0)
    chain = Chain(SR)
    chain.load_graph(json.dumps(CHAIN_MOOG))
    cases = [
        ("chain block", chain.runtimes["moog"].effect, 64, 512),
        ("ZDF block", MoogFilter(SR, variant=MoogVariant.ZDF, cutoff_hz=1200.0,
                                 resonance=2.0, drive=2.0, newton_iters=4),
         64, 512),
        ("128x2^16 classic", MoogFilter(SR, cutoff_hz=2000.0, resonance=0.5),
         128, 1 << 16),
        ("128x2^16 ZDF newton 4", MoogFilter(
            SR, variant=MoogVariant.ZDF, cutoff_hz=2000.0, resonance=0.5,
            newton_iters=4), 128, 1 << 16)]
    counters = [("moog_ladder", moog_ops.moog_ladder),
                ("moog_zdf", moog_ops.moog_zdf),
                ("moog_ladder_adjoint", moog_ops.moog_ladder_adjoint),
                ("moog_zdf_adjoint", moog_ops.moog_zdf_adjoint)]
    if recorded:
        counters += [("moog_ladder_reverse", moog_ops.moog_ladder_reverse),
                     ("moog_zdf_reverse", moog_ops.moog_zdf_reverse)]
    out = {}
    for label, mf, c, n in cases:
        p, os_ = mf.kernel_params(), mf.oversampling
        zdf = mf.variant.value == "zdf"
        kw = (dict(newton_iters=mf.newton_iters, os=os_) if zdf else
              dict(huovilainen=mf.variant.value == "huovilainen", os=os_))
        fwd = moog_ops.moog_zdf if zdf else moog_ops.moog_ladder
        x = torch.as_tensor(0.5 * rng.standard_normal((c, n)),
                            dtype=torch.float32, device=dev)
        st8 = torch.as_tensor(0.2 * rng.standard_normal((8, c)),
                              dtype=torch.float32, device=dev)
        if mf.variant.value == "huovilainen":
            st8[4:7] = torch.tanh(p[1] * st8[:3])
        gy = torch.randn(c, n, device=dev)
        gst = torch.randn(8, c, device=dev)
        xg, sg = x.clone().requires_grad_(), st8.clone().requires_grad_()

        def grad_block():
            s_out, y = fwd(xg, sg, p, **kw)
            return torch.autograd.grad((s_out, y), (xg, sg), (gst, gy))

        reps = 20 if n <= 512 else 3
        before = {k: getattr(f, "launches") for k, f in counters}
        rec0 = fwd.__dict__.get("record_launches", 0)
        grad_block()
        torch.cuda.synchronize()
        launches = {k: f.launches - before[k] for k, f in counters
                    if f.launches - before[k]}
        if recorded:
            launches["record_launches"] = fwd.record_launches - rec0
        row = {"launches": launches,
               "forward_ms": graph_ms(torch, lambda: fwd(x, st8, p, **kw),
                                      reps)}
        try:
            row["grad_ms"] = graph_ms(torch, grad_block, reps)
        except RuntimeError as exc:     # the ROOT's backward would not capture
            row["grad_ms"] = None
            row["graph_error"] = str(exc)[:200]
        row["grad_call_ms"] = events_ms(torch, grad_block, reps)
        if recorded:
            rec_fn = moog_ops.moog_zdf_record if zdf else \
                moog_ops.moog_ladder_record
            rev_fn = moog_ops.moog_zdf_reverse if zdf else \
                moog_ops.moog_ladder_reverse
            adj_fn = moog_ops.moog_zdf_adjoint if zdf else \
                moog_ops.moog_ladder_adjoint
            rec = rec_fn(x, st8, p, **kw)[2]
            row["record_ms"] = graph_ms(torch, lambda: rec_fn(x, st8, p, **kw),
                                        reps)
            row["reverse_ms"] = graph_ms(
                torch, lambda: rev_fn(rec, st8, p, gy, gst, **kw), reps)
            row["adjoint_ms"] = graph_ms(
                torch, lambda: adj_fn(x, st8, p, gy, gst, **kw), reps)
            row["record_bytes"] = rec.numel() * rec.element_size()
        out[label] = row
    return {"root": root, "recorded": recorded, "shapes": out,
            "clocks.sm": card("clocks.sm,clocks.max.sm")}


def events_ms(torch, fn, reps: int) -> float:
    """Host-visible ms of one call: reps calls back to back between two
    CUDA events, after two warm-up calls."""
    for _ in range(2):
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


def record_probe(torch) -> dict:
    """ms of K5 (Huovilainen os 4 at the chain block, classic os 1 at
    128 x 2^16), of its recording instance, and of ladder_record_probe
    (tools/moog_latency.cu: the same record stored to a shared-memory
    ring), in turns, by graph replay."""
    from algodsp_tpu_torch.chain import Chain
    from algodsp_tpu_torch.filters.moog import MoogFilter
    from algodsp_tpu_torch.ops import moog as moog_ops
    lib = latency_lib()
    lib.moog_record_probe.argtypes = ([ctypes.c_void_p] * 4
                                      + [ctypes.c_int, ctypes.c_longlong,
                                         ctypes.c_int, ctypes.c_void_p,
                                         ctypes.c_void_p])
    chain = Chain(SR)
    chain.load_graph(json.dumps(CHAIN_MOOG))
    out = {}
    for label, m, c, t, huov in [
            ("chain block", chain.runtimes["moog"].effect, 64, 512, 1),
            ("128x2^16 classic", MoogFilter(SR, cutoff_hz=2000.0,
                                            resonance=0.5), 128, 1 << 16, 0)]:
        x = torch.as_tensor(0.5 * np.random.default_rng(0).standard_normal(
            (c, t)), dtype=torch.float32, device="cuda")
        st = torch.zeros(8, c, device="cuda")
        y = torch.empty_like(x)
        so = torch.empty_like(st)
        q = (ctypes.c_double * 6)(*m.kernel_params(), m.oversampling)
        kw = dict(huovilainen=bool(huov), os=m.oversampling)
        p = m.kernel_params()

        def probe():
            assert lib.moog_record_probe(
                x.data_ptr(), st.data_ptr(), so.data_ptr(), y.data_ptr(), c,
                t, huov, ctypes.addressof(q),
                torch.cuda.current_stream().cuda_stream) == 0
        probe()
        torch.cuda.synchronize()
        s_k, y_k = moog_ops.moog_ladder(x, st, p, **kw)
        same = bool(torch.equal(y, y_k) and torch.equal(so, s_k))
        reps = 20 if t <= 512 else 3
        runs = {"K5": lambda: moog_ops.moog_ladder(x, st, p, **kw),
                "recording K5": lambda: moog_ops.moog_ladder_record(
                    x, st, p, **kw),
                "record to shared (probe)": probe}
        ms = {k: [] for k in runs}
        for _ in range(2):
            for k, fn in runs.items():
                ms[k].append(graph_ms(torch, fn, reps))
        out[label] = {"ms": ms, "probe_bit_equal_to_K5": same}
    return out


_LATENCY_LIB = []


def latency_lib():
    """tools/moog_latency.cu (with this checkout's csrc/moog.cu), built
    once a process, loaded."""
    if not _LATENCY_LIB:
        from algodsp_tpu_torch import _build
        build = os.path.join(HERE, "algodsp_tpu_torch", "_build")
        os.makedirs(build, exist_ok=True)
        lib_path = os.path.join(build, "libmoog_latency.so")
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                        *_build.EXTRA_FLAGS["moog"], "-o", lib_path,
                        os.path.join(HERE, "tools", "moog_latency.cu")],
                       check=True, timeout=600)
        _LATENCY_LIB.append(ctypes.CDLL(lib_path))
    return _LATENCY_LIB[0]


def latency(torch) -> dict:
    """Build tools/moog_latency.cu (with this checkout's csrc/moog.cu) and
    return the cycles a link of each chain and the tanh errors."""
    lib = latency_lib()
    lib.moog_latency.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_void_p]
    lib.moog_tanh_error.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.moog_spin.argtypes = [ctypes.c_longlong, ctypes.c_void_p]
    lib.moog_probe.argtypes = ([ctypes.c_void_p] * 4
                               + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_void_p])
    n, count = 4096, 32
    cyc = torch.zeros(32, count, dtype=torch.int64, device="cuda")
    sink = torch.zeros(32, dtype=torch.float32, device="cuda")
    from algodsp_tpu_torch.chain import Chain
    from algodsp_tpu_torch.filters.moog import MoogFilter
    chain = Chain(SR)
    chain.load_graph(json.dumps(CHAIN_MOOG))
    walks = [chain.runtimes["moog"].effect, MoogFilter(SR, cutoff_hz=2000.0,
                                                        resonance=0.5)]
    prm = [(ctypes.c_double * 6)(*m.kernel_params(), m.oversampling)
           for m in walks]
    for _ in range(2):      # the first run warms the instruction cache
        assert lib.moog_latency(cyc.data_ptr(), sink.data_ptr(), n, count,
                                ctypes.addressof(prm[0]),
                                ctypes.addressof(prm[1])) == 0
        torch.cuda.synchronize()
    per = cyc.cpu().numpy()[:, :len(LATENCY_NAMES)] / n
    acc = torch.zeros(12, dtype=torch.int32, device="cuda")
    assert lib.moog_tanh_error(acc.data_ptr(), 1 << 24) == 0
    torch.cuda.synchronize()
    a = acc.cpu().numpy()
    errs = {name: {"max_abs": float(a[3 * i:3 * i + 1].view(np.float32)[0]),
                   "max_ulp": float(a[3 * i + 1:3 * i + 2].view(np.float32)[0]),
                   "nan_inf_zero_ok": bool(a[3 * i + 2])}
            for i, name in enumerate(TANH_NAMES)}
    # the SM clock of a one-warp kernel: clock64() cycles over event time
    spun = torch.zeros(1, dtype=torch.int64, device="cuda")
    mhz = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        assert lib.moog_spin(400_000_000, spun.data_ptr()) == 0
        ev[1].record()
        ev[1].synchronize()
        mhz.append(int(spun.item()) / (ev[0].elapsed_time(ev[1]) * 1e3))
    # the kernels' loop with clock64 stamps: whole kernel against the walk
    probes = {}
    for label, m, c, t, huov in [("chain block", walks[0], 64, 512, 1),
                                 ("128x2^16 classic", walks[1], 128, 1 << 16, 0)]:
        xp = torch.as_tensor(0.5 * np.random.default_rng(0).standard_normal(
            (c, t)), dtype=torch.float32, device="cuda")
        sp = torch.zeros(8, c, device="cuda")
        yp = torch.empty_like(xp)
        stamps = torch.zeros(3, dtype=torch.int64, device="cuda")
        q = (ctypes.c_double * 6)(*m.kernel_params(), m.oversampling)
        for _ in range(2):
            assert lib.moog_probe(xp.data_ptr(), sp.data_ptr(), yp.data_ptr(),
                                  ctypes.addressof(q), c, t, huov,
                                  stamps.data_ptr()) == 0
            torch.cuda.synchronize()
        total, walk = (int(v) for v in stamps.cpu()[:2])
        steps = t * m.oversampling
        probes[label] = {"cycles": total, "walk_cycles": walk,
                         "cycles_per_step": total / steps,
                         "walk_cycles_per_step": walk / steps}
    return {"probes": probes, "cycles": {name: {"max": float(per[:, i].max()),
                              "median": float(np.median(per[:, i]))}
                       for i, name in enumerate(LATENCY_NAMES)},
            "tanh_error": errs, "sm_mhz": mhz}


def sass(root: str, out_dir: str, tag: str) -> None:
    """Write cuobjdump -sass of root's libmoog.so to out_dir and print
    each kernel's instruction mix."""
    from algodsp_tpu_torch import _build
    lib = os.path.join(root, "algodsp_tpu_torch", "_build", "libmoog.so")
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not (os.path.exists(lib) and os.path.exists(tool)):
        print(f"sass {tag}: no {lib} or no cuobjdump")
        return
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300).stdout
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"moog_{tag}.sass"), "w") as fh:
        fh.write(text)
    for fn in re.split(r"\n\s*Function : ", text)[1:]:
        name = fn.split("\n", 1)[0].strip()
        ops = Counter(m.group(1).split(".")[0] for m in re.finditer(
            r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", fn))
        top = ", ".join(f"{k} {v}" for k, v in ops.most_common(14))
        print(f"sass {tag} {name}: {sum(ops.values())} instructions: {top}")


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--one"]:
        print("MOOG_BENCH " + json.dumps(time_root(os.path.abspath(args[1]))))
        return 0
    if args[:1] == ["--one-adjoint"]:
        print("MOOG_BENCH " + json.dumps(adjoint_root(os.path.abspath(
            args[1]))))
        return 0
    if "--adjoint" in args:
        return adjoint_main([a for a in args if a != "--adjoint"])
    if "--reverse-parts" in args:
        sys.path.insert(0, HERE)
        import torch
        if not torch.cuda.is_available():
            print("moog_bench: CUDA is not available", file=sys.stderr)
            return 1
        reverse_parts(torch)
        return 0
    sass_dir = None
    if "--sass" in args:
        sass_dir = os.path.abspath(args[args.index("--sass") + 1])
        del args[args.index("--sass"):args.index("--sass") + 2]
    do_latency = "--latency" in args
    roots = [os.path.abspath(a) for a in args if a != "--latency"] or [HERE]
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("moog_bench: CUDA is not available", file=sys.stderr)
        return 1
    gpu = card()
    results = []
    for root in roots:
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", root], capture_output=True, text=True,
                             timeout=900)
        line = [s for s in run.stdout.splitlines()
                if s.startswith("MOOG_BENCH ")]
        if run.returncode or not line:
            print(run.stdout[-4000:], run.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(line[0][len("MOOG_BENCH "):])
        results.append(res)
        for label, v in res["shapes"].items():
            print(f"moog {res['root']} {label} {v['input']}: {v['ms']:.4f} "
                  f"ms, {v['ns_per_step']:.2f} ns a step, bound "
                  f"{v['bound_ms']:.6f} ms (fused os {res['fused_os']}; "
                  f"clocks.sm, max {res['clocks.sm']}) ({gpu})")
    if sass_dir:
        for i, root in enumerate(roots):
            sass(root, sass_dir, f"{i}_{os.path.basename(root) or 'root'}")
    if do_latency:
        lat = latency(torch)
        for name, c in lat["cycles"].items():
            print(f"latency {name}: {c['median']:.1f} cycles a link "
                  f"(slowest lane {c['max']:.1f}) ({gpu})")
        for label, pr in lat["probes"].items():
            print(f"probe {label}: kernel {pr['cycles']} cycles "
                  f"({pr['cycles_per_step']:.1f} a step), inside walk_row "
                  f"{pr['walk_cycles']} ({pr['walk_cycles_per_step']:.1f} a "
                  f"step), lane 0 of block 0 ({gpu})")
        for name, e in lat["tanh_error"].items():
            print(f"tanh error {name}: max |err| {e['max_abs']:.3e}, "
                  f"{e['max_ulp']:.2f} ulp, NaN/inf/-0 right "
                  f"{e['nan_inf_zero_ok']}")
        mhz = float(np.median(lat["sm_mhz"]))
        print(f"SM clock of a one-warp kernel (clock64 over CUDA events): "
              f"{', '.join(f'{m:.1f}' for m in lat['sm_mhz'])} MHz; "
              f"nvidia-smi clocks.sm, clocks.max.sm after it: "
              f"{card('clocks.sm,clocks.max.sm')} ({gpu})")
        step = {"huovilainen": lat["cycles"]["Huovilainen step"]["max"],
                "classic": lat["cycles"]["classic step"]["max"],
                "zdf": lat["cycles"]["ZDF step newton 4"]["max"]}
        here = [r for r in results if r["root"] == HERE]
        for label, variant, c, n, os_, _ in shapes():
            cyc = step[variant]
            chain_ms = n * os_ * cyc / (mhz * 1e6) * 1e3
            kernel = (f"; kernel {here[-1]['shapes'][label]['ms']:.4f} ms"
                      if here else "")
            print(f"chain bound {label}: {n * os_} steps x {cyc:.1f} cycles "
                  f"/ {mhz:.0f} MHz = {chain_ms:.4f} ms{kernel} ({gpu})")
    return 0


# the reverse ring's statements that --reverse-parts drops, and what
# takes their place (csrc/moog.cu::reverse_ring)
RING_RECORD_COPY = """        mbar_arrive_tx(&full[s], bytes);
        bulk_load(dst, rec_b + start * step_elems, bytes, &full[s]);"""
RING_GY = """        async_load(&dst[gy_at + j * (W + 1) + r],
                   gy + static_cast<size_t>(c0 + r) * Tn + n0 + j);"""
RING_DX = """        dx[static_cast<size_t>(c0 + r) * Tn + n0 + j] = src[j * (W + 1) + r];"""


def reverse_parts(torch) -> None:
    """--reverse-parts (see the module docstring)."""
    from algodsp_tpu_torch import _build
    from algodsp_tpu_torch.filters.moog import MoogFilter, MoogVariant
    from algodsp_tpu_torch.ops import moog as moog_ops
    gpu = card()
    src_path = os.path.join(HERE, "algodsp_tpu_torch", "csrc", "moog.cu")
    src = open(src_path).read()
    variants = {
        "whole": [],
        "no record copy": [(RING_RECORD_COPY, "        mbar_arrive(&full[s]);")],
        "walk alone": [(RING_RECORD_COPY, "        mbar_arrive(&full[s]);"),
                       (RING_GY, "        (void)r, (void)j;"),
                       (RING_DX, "        (void)r, (void)j, (void)src;")]}
    build = os.path.join(HERE, "algodsp_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    libs, procs = {}, []
    for i, (name, subs) in enumerate(variants.items()):
        text = src
        for old, new in subs:
            assert old in text, f"csrc/moog.cu no longer has: {old}"
            text = text.replace(old, new)
        cu = os.path.join(build, f"moog_parts{i}.cu")
        with open(cu, "w") as fh:
            fh.write(text)
        so = os.path.join(build, f"libmoog_parts{i}.so")
        procs.append((name, so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS,
             *_build.EXTRA_FLAGS["moog"], "-o", so, cu])))
    for name, so, proc in procs:
        assert proc.wait(timeout=900) == 0, name
        lib = ctypes.CDLL(so)
        for sym in ("moog_ladder_reverse_f32", "moog_zdf_reverse_f32"):
            getattr(lib, sym).argtypes = moog_ops._REV_ARGTYPES
            getattr(lib, sym).restype = ctypes.c_int
        libs[name] = lib
    _build.build_all(("moog",))
    mhz = float(card("clocks.max.sm").split()[0])
    rng = np.random.default_rng(0)
    chain = MoogFilter(SR, variant=MoogVariant.HUOVILAINEN, oversampling=4,
                       cutoff_hz=1200.0, resonance=2.0, drive=10 ** 0.3,
                       normalize_output=True)
    zdf = MoogFilter(SR, variant=MoogVariant.ZDF, cutoff_hz=1200.0,
                     resonance=2.0, drive=2.0, newton_iters=4)
    classic = MoogFilter(SR, cutoff_hz=2000.0, resonance=0.5)
    classic4 = MoogFilter(SR, cutoff_hz=2000.0, resonance=0.5, oversampling=4)
    for label, mf, c, n in [("chain block", chain, 64, 512),
                            ("ZDF block", zdf, 64, 512),
                            ("64x2048 classic os 1", classic, 64, 2048),
                            ("64x512 classic os 4", classic4, 64, 512),
                            ("128x2^14 classic os 1", classic, 128, 1 << 14)]:
        p, os_ = mf.kernel_params(), mf.oversampling
        x = torch.as_tensor(0.5 * rng.standard_normal((c, n)),
                            dtype=torch.float32, device="cuda")
        st8 = torch.zeros(8, c, device="cuda")
        gy, gst = torch.randn(c, n, device="cuda"), torch.randn(8, c,
                                                               device="cuda")
        if mf.variant.value == "zdf":
            rec = moog_ops.moog_zdf_record(x, st8, p, newton_iters=4, os=os_)[2]
            sym, last = "moog_zdf_reverse_f32", 4
        else:
            huov = mf.variant.value == "huovilainen"
            rec = moog_ops.moog_ladder_record(x, st8, p, huovilainen=huov,
                                              os=os_)[2]
            sym, last = "moog_ladder_reverse_f32", 2 if huov else 0
        dx, dst = torch.empty_like(x), torch.empty_like(st8)
        row = []
        for name, lib in libs.items():
            fn = getattr(lib, sym)
            call = lambda fn=fn: fn(
                rec.data_ptr(), st8.data_ptr(), gy.data_ptr(), gst.data_ptr(),
                dx.data_ptr(), dst.data_ptr(), *p, c, n, last, os_,
                torch.cuda.current_stream().cuda_stream)
            assert call() == 0, name
            ms = events_ms(torch, call, 10 if n * os_ <= 2048 else 3)
            row.append(f"{name} {ms:.4f} ms ({ms * 1e3 * mhz / (n * os_):.1f}"
                       f" cycles a step)")
        print(f"reverse parts {label} ({n * os_} steps): " + ", ".join(row)
              + f" (back-to-back calls; cycles at the {mhz:.0f} MHz maximum "
              f"SM clock) ({gpu})")
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", os.path.join(build, "libmoog.so")],
                          capture_output=True, text=True, timeout=300).stdout
    for fn in re.split(r"\n\s*Function : ", text)[1:]:
        if "moog_ladder_reverse_kernelIfLi2ELi4E" not in fn.split("\n", 1)[0]:
            continue
        # (address, mnemonic, branch target or None) of each instruction
        ins = []
        for m in re.finditer(r"/\*([0-9a-f]{4})\*/\s+([^;]*);", fn):
            words = m.group(2).split()
            op = words[1] if words[0].startswith("@") else words[0]
            tgt = re.search(r"0x([0-9a-f]+)", m.group(2)) if "BRA" in op \
                else None
            ins.append((int(m.group(1), 16), op,
                        int(tgt.group(1), 16) if tgt else None))
        # the walk: the shortest loop with a ladder step's 14 FP operations
        best = None
        for addr, _, tgt in ins:
            if tgt is None or tgt >= addr:
                continue
            body = [op for a, op, _ in ins if tgt <= a <= addr]
            fp = sum(op.startswith(("FFMA", "FMUL", "FADD")) for op in body)
            if fp >= 14 and (best is None or len(body) < best[0]):
                best = (len(body), fp, Counter(op.split(".")[0] for op in body))
        if best:
            print(f"reverse walk loop (moog_ladder_reverse float32, "
                  f"Huovilainen, os 4): {best[0]} instructions, {best[1]} "
                  f"FFMA/FMUL/FADD; "
                  + ", ".join(f"{k} {v}" for k, v in best[2].most_common(8))
                  + f" ({gpu})")


def adjoint_main(args) -> int:
    """--adjoint: each ROOT's gradient block in its own process, in the
    order given, then the record-store probe of this checkout."""
    roots = [os.path.abspath(a) for a in args] or [HERE]
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("moog_bench: CUDA is not available", file=sys.stderr)
        return 1
    gpu = card()
    for root in roots:
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one-adjoint", root], capture_output=True,
                             text=True, timeout=900)
        line = [s for s in run.stdout.splitlines()
                if s.startswith("MOOG_BENCH ")]
        if run.returncode or not line:
            print(run.stdout[-4000:], run.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(line[0][len("MOOG_BENCH "):])
        for label, v in res["shapes"].items():
            grad = ("not captured" if v["grad_ms"] is None
                    else f"{v['grad_ms']:.4f} ms")
            parts = ("" if not res["recorded"] else
                     f"; recording forward {v['record_ms']:.4f} ms, reverse "
                     f"{v['reverse_ms']:.4f}, checkpoint adjoint "
                     f"{v['adjoint_ms']:.4f}, record {v['record_bytes']} B")
            print(f"moog adjoint {res['root']} {label}: gradient block {grad} "
                  f"(graph replay; {v['grad_call_ms']:.4f} ms as back-to-back "
                  f"calls), no-grad forward {v['forward_ms']:.4f} ms, "
                  f"launches {json.dumps(v['launches'])}{parts} "
                  f"(clocks.sm, max {res['clocks.sm']}) ({gpu})")
            if "graph_error" in v:
                print(f"  graph capture: {v['graph_error']}")
    if HERE in roots:
        for label, v in record_probe(torch).items():
            print(f"moog record store {label}: "
                  + ", ".join(f"{k} {' / '.join(f'{t:.4f}' for t in ts)} ms"
                              for k, ts in v["ms"].items())
                  + f" (graph replay, in turns); probe bit-equal to K5 "
                  f"{v['probe_bit_equal_to_K5']} ({gpu})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
