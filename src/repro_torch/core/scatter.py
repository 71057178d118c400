"""JAX's out-of-bounds index rules, for the port's page-indexed arrays.

The reference routes no-op lanes of a scatter to an out-of-bounds index and
lets XLA drop them (``mode="drop"``).  Here the array is extended by one
trash row, every lane at or past the end writes there, and the row is cut
off again — no boolean indexing, so no host synchronisation on the card.

A gather past the end reads the last entry in JAX (its default clamp).  No
page id the reference computes should be out of range, but one stream does
it (ROADMAP C4), so the page tables are read through :func:`gather_clamped`
and the port follows the reference there too.
"""
from __future__ import annotations

import torch


def scatter_drop(arr: torch.Tensor, idx: torch.Tensor,
                 vals) -> torch.Tensor:
    """``arr.at[idx].set(vals, mode="drop")`` along dim 0, for ``idx >= 0``:
    entries at or past ``len(arr)`` are dropped.  Returns a new tensor.
    Where two kept lanes share an index their values must be equal (every
    caller guarantees this, as the reference's do)."""
    n = arr.shape[0]
    ext = torch.cat([arr, arr.new_zeros((1,) + tuple(arr.shape[1:]))])
    ext[idx.long().clamp_max(n)] = torch.as_tensor(vals, dtype=arr.dtype,
                                                   device=arr.device)
    return ext[:n]


def gather_clamped(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``arr[idx]`` along dim 0 for ``idx >= 0``, an index past the end
    reading the last entry, as a JAX gather does."""
    return arr[idx.long().clamp_max(arr.shape[0] - 1)]
