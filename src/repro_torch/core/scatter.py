"""Masked index writes: the port's form of JAX's out-of-bounds ``mode="drop"``.

The reference routes no-op lanes of a scatter to an out-of-bounds index and
lets XLA drop them.  Here the array is extended by one trash row, no-op
lanes write there, and the row is cut off again — no boolean indexing, so
no host synchronisation on the card.
"""
from __future__ import annotations

import torch


def scatter_drop(arr: torch.Tensor, idx: torch.Tensor,
                 vals) -> torch.Tensor:
    """``arr.at[idx].set(vals, mode="drop")`` along dim 0, for ``idx`` in
    ``[0, len(arr)]``: entries equal to ``len(arr)`` are dropped.  Returns a
    new tensor.  Where two kept lanes share an index their values must be
    equal (every caller guarantees this, as the reference's do)."""
    n = arr.shape[0]
    ext = torch.cat([arr, arr.new_zeros((1,) + tuple(arr.shape[1:]))])
    ext[idx.long()] = torch.as_tensor(vals, dtype=arr.dtype, device=arr.device)
    return ext[:n]
