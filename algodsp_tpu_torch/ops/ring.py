"""Ring-buffer <-> shift-register layout conversion (counterpart of
`algodsp_tpu/ops/ring.py`).

A ring of length L whose write pointer is `step mod L` reorders into
shift-register layout (oldest sample first, newest last) and back. The
step is a tensor on the ring's device (the effects carry it in their
state), so the rotation is one gather along the last axis at indices
computed on the device: nothing waits for the step on the host.
"""

from __future__ import annotations

import torch


def _offset(step, L: int, device) -> torch.Tensor:
    return torch.remainder(torch.as_tensor(step, dtype=torch.int64,
                                           device=device), L)


def ring_to_linear(buf, step):
    """Reorder a ring buffer (write pointer = step mod L) into
    shift-register layout: oldest sample first, newest last."""
    L = buf.shape[-1]
    idx = torch.remainder(torch.arange(L, device=buf.device)
                          + _offset(step, L, buf.device), L)
    return buf.index_select(-1, idx)


def linear_to_ring(lin, step):
    """Inverse of ring_to_linear for the given (new) step count."""
    L = lin.shape[-1]
    idx = torch.remainder(torch.arange(L, device=lin.device)
                          - _offset(step, L, lin.device), L)
    return lin.index_select(-1, idx)
