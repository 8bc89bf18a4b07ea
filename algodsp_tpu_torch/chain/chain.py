"""Effect-chain execution: JSON DAG -> per-block walk over node runtimes
(counterpart of `algodsp_tpu/chain/chain.py`).

Capability parity with `dsp/effectchain/chain.go` + `chain_process.go`:
LoadGraph (JSON -> topo-sorted nodes + instantiated runtimes), Process
(walk topo order with per-node output buffers, fan-in mixing, sidechain
edges on input port 1, bypass passthrough), and the LTI fusion pass.

The JAX package traces the walk into one XLA program per block shape;
PyTorch runs it eagerly, node by node, and each node's runtime launches
its kernels on the card (biquad cascade, Moog ladder, envelope, FDL
convolution). Per-node state is one dict keyed by node id.
"""

from __future__ import annotations

import numpy as np
import torch

from algodsp_tpu_torch._device import resolve_device
from algodsp_tpu_torch.chain.graph import (
    INPUT_NODE_ID, OUTPUT_NODE_ID, CompiledGraph, parse_graph)
from algodsp_tpu_torch.chain.registry import (
    Context, NodeRuntime, Registry, default_registry, empty_state)
from algodsp_tpu_torch.conv.ltifold import fold_chain_into_kernel
from algodsp_tpu_torch.filters.fir import FIRFilter
from algodsp_tpu_torch.streaming import scan_blocks


class Chain:
    def __init__(self, sample_rate: float, *, block_size: int = 512,
                 registry: Registry | None = None):
        if not isinstance(sample_rate, (int, float)) or not sample_rate > 0:
            raise ValueError(
                f"chain: sample_rate must be a positive number, got "
                f"{sample_rate!r} — construct with Chain(sample_rate) and "
                f"pass the graph JSON to load_graph()")
        self.ctx = Context(sample_rate=sample_rate, block_size=block_size)
        self.registry = registry or default_registry()
        self.graph: CompiledGraph = parse_graph("")
        self.runtimes: dict[str, NodeRuntime] = {}

    def load_graph(self, raw: str, *, auto_fuse: bool = True,
                   fuse_tol_db: float = 150.0):
        """Parse the graph and instantiate runtimes (`chain.go:60-99`).

        auto_fuse (default True): run the LTI fusion pass (`fuse_lti`)
        after instantiation, so maximal straight-line runs of adjacent
        LTI nodes compile to one FIR convolution. Returns the fusion
        report ([(member_ids, kernel_len)] per fused run; [] when
        nothing fused or fusion is off)."""
        graph = parse_graph(raw)
        runtimes = {}
        for nid in graph.order:
            node = graph.nodes[nid]
            factory = self.registry.lookup(node.type)
            runtimes[nid] = factory(self.ctx, node.params)
        self.graph = graph
        self.runtimes = runtimes
        if auto_fuse:
            return self.fuse_lti(tol_db=fuse_tol_db)
        return []

    def init_state(self, batch_shape=(), dtype=torch.float32, device=None):
        """Every node's state, on the CUDA card unless `device` says
        otherwise."""
        device = resolve_device(device)
        return {nid: rt.init_state(batch_shape, dtype, device)
                for nid, rt in self.runtimes.items()}

    def fuse_lti(self, *, tol_db: float = 150.0,
                 max_kernel_len: int = 1 << 19) -> list[tuple[list[str], int]]:
        """LTI fusion pass: collapse maximal linear runs of LTI nodes
        into one FIR convolution per run (`conv/ltifold.py` algebra).

        A run is a straight-line path n1 -> n2 -> ... -> nk where every
        interior link is the sole port-0 edge between its endpoints and
        every member is LTI (`NodeRuntime.lti`) or bypassed. The
        members' combined impulse response (IIR tails truncated below
        -tol_db of peak) becomes one `FIRFilter` at the first active
        member; the rest become identities. Node ids and state keys are
        unchanged; `init_state` must be called after fusing. Runs whose
        combined kernel would exceed `max_kernel_len` stay unfused.
        Returns [(member_ids, kernel_len)] for each fused run.
        """
        g = self.graph

        def fusable(nid: str) -> bool:
            rt = self.runtimes.get(nid)
            if rt is None or rt.n_outputs != 1:
                return False
            return rt.lti is not None or g.nodes[nid].bypassed

        def linked(a: str, b: str) -> bool:
            outs = g.outgoing.get(a, [])
            ins = g.incoming.get(b, [])
            return (len(outs) == 1 and outs[0].dst == b
                    and outs[0].from_port == 0 and outs[0].to_port == 0
                    and len(ins) == 1 and ins[0].src == a)

        report: list[tuple[list[str], int]] = []
        used: set[str] = set()
        for start in g.order:
            if start in used or not fusable(start):
                continue
            run = [start]
            cur = start
            while True:
                outs = g.outgoing.get(cur, [])
                if len(outs) != 1:
                    break
                nxt = outs[0].dst
                if (nxt in used or nxt not in g.nodes or not fusable(nxt)
                        or not linked(cur, nxt)):
                    break
                run.append(nxt)
                cur = nxt
            used.update(run)
            active = [n for n in run if not g.nodes[n].bypassed]
            if len(active) < 2:
                continue
            h = np.ones(1)
            too_long = False
            for nid in active:
                kind, payload = self.runtimes[nid].lti
                if kind == "chain":
                    h = fold_chain_into_kernel(payload, h, tol_db=tol_db)
                elif kind == "kernel_fn":
                    k = np.asarray(payload(tol_db), np.float64).reshape(-1)
                    if h.size + k.size - 1 > max_kernel_len:
                        too_long = True
                        break
                    h = np.convolve(h, k)
                else:
                    raise ValueError(
                        f"chain: unknown lti descriptor {kind!r} on {nid}")
                if h.size > max_kernel_len:
                    too_long = True
                    break
            if too_long:
                continue
            # trim the sub-noise-floor tail the folds accumulated
            peak = np.max(np.abs(h))
            if peak > 0.0:
                keep = np.nonzero(
                    np.abs(h) > peak * 10.0 ** (-tol_db / 20.0))[0]
                h = h[:int(keep[-1]) + 1] if keep.size else h[:1]
            fir = FIRFilter(h)
            self.runtimes[active[0]] = NodeRuntime(
                init_state=fir.init_state,
                process=lambda st, x, sc, _f=fir: _f.process_stream(st, x),
                effect=fir,
                lti=("kernel_fn", lambda tol, _h=h: _h))
            identity = NodeRuntime(
                init_state=empty_state,
                process=lambda st, x, sc: (st, x),
                lti=("kernel_fn", lambda tol: np.ones(1)))
            for nid in active[1:]:
                self.runtimes[nid] = identity
            report.append((active, int(h.size)))
        return report

    def process(self, state, x):
        """(state, x:(..., N)) -> (state, y).

        Mirrors `chain_process.go:11-33`: mix fan-in edges per input
        port, run each node in topo order, sum everything reaching
        `_output`. An empty graph yields the input unchanged; no path to
        `_output` yields silence.
        """
        if not self.graph.nodes and not self.graph.incoming:
            return state, x

        # per-(node, port) output buffers
        outputs: dict[tuple[str, int], torch.Tensor] = {(INPUT_NODE_ID, 0): x}
        new_state = dict(state)

        def mix_inputs(nid: str, port: int):
            total = None
            for e in self.graph.incoming.get(nid, []):
                if e.to_port != port:
                    continue
                src = outputs.get((e.src, e.from_port))
                if src is None:
                    continue
                total = src if total is None else total + src
            return total

        for nid in self.graph.order:
            node = self.graph.nodes[nid]
            rt = self.runtimes[nid]
            main_in = mix_inputs(nid, 0)
            if main_in is None:
                main_in = torch.zeros_like(x)
            if node.bypassed:
                for port in range(rt.n_outputs):
                    outputs[(nid, port)] = main_in
                continue
            sidechain = mix_inputs(nid, 1)
            st, out = rt.process(state[nid], main_in, sidechain)
            new_state[nid] = st
            if rt.n_outputs == 1:
                outputs[(nid, 0)] = out
            else:
                for port, o in enumerate(out):
                    outputs[(nid, port)] = o

        y = mix_inputs(OUTPUT_NODE_ID, 0)
        if y is None:
            y = torch.zeros_like(x)
        return new_state, y

    def process_blocks(self, state, x, *, block_size: int | None = None,
                       unroll: int = 1):
        """Stream the whole graph over many latency blocks: `process`
        block by block with every node's state carried
        (`streaming.scan_blocks`). x: (..., N) with N a multiple of the
        block size (the chain's own unless given). `unroll` is accepted
        for the reference's signature and ignored: it tunes the
        unrolling of the reference's `lax.scan` over blocks, and the
        port calls `process` block by block with nothing to unroll."""
        bs = self.ctx.block_size if block_size is None else block_size
        return scan_blocks(self.process, state, x, block_size=bs)
