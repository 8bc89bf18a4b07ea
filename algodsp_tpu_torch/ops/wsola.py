"""The WSOLA alignment search, W1 (counterpart of the `lax.scan` over
segments in `algodsp_tpu/effects/pitch/wsola.py::WSOLAPitchShifter.
_time_stretch`, :112-141; no Pallas).

Segment i scores the `seek` candidate offsets of its region, which
starts at the static position a_i, against the `ov` samples of x at the
previous segment's tail:

    scores[k] = sum_{j < ov} x2[a_i + k + j] * ref[j]
    norm2[k]  = csq[a_i + ov + k] - csq[a_i + k]
    best      = first argmax of scores / sqrt(norm2 + 1e-12)

and takes `seek // 2` instead where every norm2 <= 1e-12 or the segment
is a boundary one. Its start is a_i + best and the next tail start + flat,
so each step reads from where the last one landed.

The CUDA kernel `csrc/wsola.cu` walks a channel's segments on one
thread-block cluster of `CLUSTER` blocks, each block scoring its share of
a step's offsets (`plan`: staged in shared memory, or in tiles where the
seek and overlap are long) and the cluster reducing the argmax through
distributed shared memory; `wsola_search_plain` is the same walk in plain
PyTorch, a loop over the segments on (C, seek) tensors whose scores are
summed over j in order with each product and sum rounded by itself, as
the kernel sums them, so the two agree bit for bit. (Elementwise
products: no TF32 setting reaches them.) A CUDA tensor runs the kernel (or raises); a CPU tensor
runs the plain version. The starts are integers, so the search needs no
gradient: it runs on detached tensors, and a gradient with respect to x
flows through the gather of the segments that follows it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from algodsp_tpu_torch import _build

_EPS = 1e-12
_SYMBOLS = {torch.float32: "wsola_search_f32", torch.float64: "wsola_search_f64"}
# wsola_search_f{32,64}(x, csq, region_starts, boundary, starts, C, n_ext, S,
#                       ov, seek, flat, tail0, threads, tiled, stream)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong] \
    + [ctypes.c_int] * 7 + [ctypes.c_void_p]
# blocks a channel's cluster (csrc/wsola.cu's kCluster: the portable size)
CLUSTER = 8
# consecutive offsets a thread sums at once (csrc/wsola.cu's kGroup)
GROUP = 2
# the H100's shared memory a block, less the kernel's static inboxes
_SMEM_BYTES = 232448 - 12288


def plan(seek: int, ov: int, itemsize: int):
    """The kernel's schedule: (offsets a block, threads a block, tiled).
    Block r of a channel's cluster scores offsets [r pb, (r + 1) pb) of
    each step, summing thread t the groups of GROUP consecutive offsets t,
    t + threads - 32, ... of its share; the last warp copies. The staged
    schedule keeps in shared memory the step's reference copied to an
    aligned place (ov samples), and two stages of the window the next
    reference lies in (seek - 1 + ov), the block's region slice (pb - 1 +
    ov, and room for its last pair's loads) and its energies (2 pb), each
    part on 16 bytes. Where those do not fit, the tiled schedule takes the
    offsets in passes and j in tiles (csrc/wsola.cu), with the same
    threads and reductions."""
    pb = -(-seek // CLUSTER)
    pb2 = -(-pb // GROUP) * GROUP
    threads = min(512, -(-(pb2 // GROUP) // 32) * 32 + 32)
    up4 = lambda n: -(-n // 4) * 4
    staged = (up4(ov) + 2 * (up4(seek + ov - 1) + up4(pb2 + ov) + up4(2 * pb2))) \
        * itemsize
    return pb, threads, staged > _SMEM_BYTES


def energy_prefix(x2):
    """The energy prefix of x2 (C, n): (C, n + 1), zero first, then the
    float32 cumulative sum of x2 * x2 stored in x2's type, as the
    reference keeps it (`wsola.py:102-104`) also for a float64 input."""
    cs = torch.cumsum((x2 * x2).to(torch.float32), dim=-1).to(x2.dtype)
    return torch.cat([x2.new_zeros(x2.shape[:-1] + (1,)), cs], dim=-1)


def step_scores(x2, csq, a: int, tail, ov: int, seek: int):
    """One step's normalised scores (C, seek) and energies norm2 (C, seek)
    of the region at a against the reference at the per-channel tail
    starts `tail` (C,): the plain version's arithmetic."""
    idx = tail.long()[:, None] + torch.arange(ov, device=x2.device)
    ref = torch.gather(x2, -1, idx)
    acc = x2.new_zeros(x2.shape[0], seek)
    for j in range(ov):
        acc = acc + x2[:, a + j:a + j + seek] * ref[:, j:j + 1]
    norm2 = csq[:, a + ov:a + ov + seek] - csq[:, a:a + seek]
    return acc / torch.sqrt(norm2 + _EPS), norm2


def wsola_search_plain(x2, csq, region_starts, boundary, ov: int, seek: int,
                       flat: int, tail0: int):
    """Plain PyTorch version of W1: (S, C) int32 starts."""
    c = x2.shape[0]
    tail = torch.full((c,), int(tail0), dtype=torch.int64, device=x2.device)
    starts = []
    for a, edge in zip(np.asarray(region_starts).tolist(),
                       np.asarray(boundary).tolist()):
        score, norm2 = step_scores(x2, csq, a, tail, ov, seek)
        best = torch.argmax(score, dim=-1)
        if edge:
            best = torch.full_like(best, seek // 2)
        else:
            silent = torch.amax(norm2, dim=-1) <= _EPS
            best = torch.where(silent, seek // 2, best)
        start = a + best
        starts.append(start.to(torch.int32))
        tail = start + flat
    return torch.stack(starts)


def _check(x2, csq, region_starts, ov: int, seek: int, flat: int, tail0: int):
    """Raise unless every read of the walk lies inside x2: a region of
    seek - 1 + ov samples at each region start, a reference of ov at
    each tail (a start + flat, a start at most a region start + seek -
    1)."""
    c, n = x2.shape
    if tuple(csq.shape) != (c, n + 1) or csq.dtype != x2.dtype:
        raise ValueError("wsola_search: csq must be (C, n + 1) of x2's type")
    rs = np.asarray(region_starts)
    if ov < 1 or seek < 1 or flat < 1 or rs.size == 0 or rs.min() < 0 \
            or tail0 < 0:
        raise ValueError("wsola_search: needs ov, seek, flat >= 1, a segment "
                         "and no negative position")
    far = int(rs.max()) + seek + flat + ov - 1
    if max(far, tail0 + ov) > n:
        raise ValueError(f"wsola_search: x2 holds {n} samples, the walk may "
                         f"read up to {max(far, tail0 + ov)}")


def wsola_search(x2, csq, region_starts, boundary, ov: int, seek: int,
                 flat: int, tail0: int):
    """The starts (S, C) int32 of the walk over x2 (C, n_ext) with its
    energy prefix csq (C, n_ext + 1), the static region starts (S,) and
    boundary flags (S,) (host arrays): the kernel for a CUDA tensor
    (float32 or float64), the plain version for a CPU one. `launches`
    counts the kernel's launches, one a call."""
    x2, csq = x2.detach(), csq.detach()
    _check(x2, csq, region_starts, ov, seek, flat, tail0)
    if x2.device.type == "cpu":
        return wsola_search_plain(x2, csq, region_starts, boundary, ov, seek,
                                  flat, tail0)
    if x2.device.type != "cuda":
        raise ValueError(f"wsola_search: unsupported device {x2.device}")
    _entry(x2.dtype)
    grid = (torch.as_tensor(np.asarray(region_starts, np.int32), device=x2.device),
            torch.as_tensor(np.asarray(boundary, np.uint8), device=x2.device))
    return launch(x2.contiguous(), csq.contiguous(), *grid, ov, seek, flat, tail0)


def _entry(dtype):
    """The kernel entry for `dtype` (the library built and loaded)."""
    symbol = _SYMBOLS.get(dtype)
    if symbol is None:
        raise ValueError(f"wsola_search: takes float32 or float64, got {dtype}")
    return _build.entry("wsola", symbol, _ARGTYPES)


def launch(x2, csq, starts_dev, boundary_dev, ov: int, seek: int, flat: int,
           tail0: int):
    """W1 on checked, contiguous CUDA tensors, with the grid already on the
    card (int32 region starts, uint8 boundary flags): no host copy, so a
    CUDA graph can capture it. A refused cluster launch raises."""
    fn = _entry(x2.dtype)
    c, n = x2.shape
    s_count = starts_dev.shape[0]
    _, threads, tiled = plan(seek, ov, x2.element_size())
    starts = torch.empty((s_count, c), dtype=torch.int32, device=x2.device)
    with torch.cuda.device(x2.device):
        code = fn(*(_build.ptr(t) for t in (x2, csq, starts_dev, boundary_dev,
                                             starts)),
                  c, n, s_count, ov, seek, flat, int(tail0), threads,
                  int(tiled), _build.stream_of(x2))
        wsola_search.launches += 1
    _build.check("wsola", code, "wsola_search")
    return starts


wsola_search.launches = 0


def sum_step_cycles(n: int = 1 << 16, device="cuda") -> float:
    """SM cycles of one dependent step of a score's float32 sum on the
    card (a product and a sum, each rounded, one thread, clock64 stamps
    around n steps): W1's walk takes at least S x ov of them in a row."""
    fn = _build.entry("wsola", "wsola_sum_latency",
                      [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p])
    cycles = torch.zeros(1, dtype=torch.int64, device=device)
    sink = torch.zeros(1, dtype=torch.float32, device=device)
    for _ in range(2):      # the first run warms the instruction cache
        code = fn(n, _build.ptr(cycles), _build.ptr(sink), _build.stream_of(cycles))
        _build.check("wsola", code, "wsola_sum_latency")
        torch.cuda.synchronize(cycles.device)
    return int(cycles.item()) / n
