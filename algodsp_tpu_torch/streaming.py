"""Multi-block streaming (counterpart of `algodsp_tpu/streaming.py`).

The reference's real-time contract is block-at-a-time processing with
carried state. `scan_blocks` runs a stateful per-block processor over
consecutive blocks of a long signal and reassembles the outputs: the
same floats as calling it block by block, because it is exactly that
loop. The JAX package's `lax.scan` traces the loop into one program;
here PyTorch runs it eagerly, one block after another.

    state, y = scan_blocks(chain.process, state, x, block_size=512)
"""

from __future__ import annotations

import torch


def split_blocks(x, block_size: int):
    """(..., N) -> (nb, ..., block_size) with N % block_size == 0."""
    n = x.shape[-1]
    if n % block_size:
        raise ValueError(
            f"streaming: signal length {n} is not a multiple of the "
            f"block size {block_size} — pad or trim on the host")
    lead = x.shape[:-1]
    return torch.movedim(x.reshape(lead + (n // block_size, block_size)), -2, 0)


def merge_blocks(yb):
    """(nb, ..., B) -> (..., nb*B): inverse of `split_blocks`."""
    nb, b = yb.shape[0], yb.shape[-1]
    y = torch.movedim(yb, 0, -2)
    return y.reshape(y.shape[:-2] + (nb * b,))


def _merge_tree(outs):
    """Concatenate a list of per-block outputs (tensors, or tuples, lists
    or dicts of them) along time."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: _merge_tree([o[k] for o in outs]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_merge_tree([o[i] for o in outs])
                           for i in range(len(first)))
    return torch.cat(outs, dim=-1)


def scan_blocks(process_fn, state, *signals, block_size: int,
                unroll: int = 1):
    """Stream `process_fn` over consecutive blocks.

    Args:
      process_fn: `(state, *block_signals) -> (new_state, out)`, any
        stateful per-block processor; `out` is a (..., B) tensor or a
        tuple, list or dict of them (multi-port nodes).
      state: the processor's carried state.
      *signals: one or more (..., N) inputs, cut along the last axis into
        N // block_size blocks each (all must share N).
      block_size: the latency block length.
      unroll: accepted for the reference's signature and ignored: it
        tunes the unrolling of the reference's `lax.scan`, and this
        loop calls `process_fn` block by block with nothing to unroll.

    Returns:
      (final_state, outputs), every output reassembled to
      (..., nb * block_size) in block order.
    """
    blocks = [split_blocks(s, block_size) for s in signals]
    nb = blocks[0].shape[0]
    if any(b.shape[0] != nb for b in blocks):
        raise ValueError("streaming: signals must share their length")
    if nb == 0:
        raise ValueError("streaming: no block to process")
    outs = []
    for i in range(nb):
        state, out = process_fn(state, *(b[i] for b in blocks))
        outs.append(out)
    return state, _merge_tree(outs)
