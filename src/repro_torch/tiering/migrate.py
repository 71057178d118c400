"""The migration data plane: real byte movement behind ``apply_migration``.

Port of ``repro/tiering/migrate.py`` (synchronous plane, ``none`` codec).
A resource that binds payload data gets a :class:`TierBuffers` set
(DESIGN.md §8):

  * ``fast``: ``(num_slots, *row_shape)`` — promoted copies, on the device;
  * ``slow``: ``(num_pages, *row_shape)`` — the full backing store.  For a
    CUDA resource it lives in pinned host memory (the slow tier of
    DESIGN.md §7, as the reference's ``pinned_host`` memory kind); on the
    CPU the split is logical.  Rows cross between the two with
    ``.to(device, non_blocking=True)`` from pinned staging buffers.

Each daemon epoch applies one copy (:func:`migrate`): victims are written
back to their old slow pages, then the promoted pages land in the freed
fast slots.  Unlike the reference's donated functional copies, the verbs
here update both buffers IN PLACE (the fast buffer is the only copy the
device holds) and return the same :class:`TierBuffers`.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.tiering import codec as codec_lib


class TierBuffers(NamedTuple):
    """Payload buffers for one resource: fast copies over a slow store."""

    fast: torch.Tensor   # (num_slots, *row_shape) — native dtype, device
    slow: torch.Tensor   # (num_pages, *row_shape) — full store, slow tier
    scale: torch.Tensor | None = None   # int8 codec only (not yet ported)


def row_bytes(buffers: TierBuffers) -> int:
    """WIRE bytes of one page row (the migration byte unit)."""
    return math.prod(buffers.slow.shape[1:]) * buffers.slow.element_size()


def place_slow(x: torch.Tensor, device) -> torch.Tensor:
    """Place a backing store in the slow tier of ``device``: pinned host
    memory for a CUDA device, the tensor itself on the CPU."""
    if torch.device(device).type != "cuda":
        return x.to(device)
    x = x.cpu()
    return x if x.is_pinned() else x.pin_memory()


def init_buffers(slow_data: torch.Tensor, num_slots: int, codec: str = "none",
                 *, device="cuda") -> TierBuffers:
    """Build the buffer set around an existing (native-dtype) payload."""
    payload, scale = codec_lib.encode_rows(codec, slow_data)
    slow = place_slow(payload, device)
    fast = torch.zeros((num_slots,) + tuple(slow.shape[1:]),
                       dtype=slow_data.dtype, device=device)
    return TierBuffers(fast=fast, slow=slow, scale=scale)


def _host(x) -> np.ndarray:
    """Small index vectors to the host (the daemon's verbs are host-side)."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _slow_gather(slow: torch.Tensor, ids: np.ndarray, device) -> torch.Tensor:
    """Gather slow rows and move them to ``device``: through a pinned
    staging buffer and an asynchronous copy when the store is pinned."""
    idx = torch.as_tensor(ids, dtype=torch.long)
    if not slow.is_pinned():
        return slow[idx.to(slow.device)].to(device)
    rows = torch.empty((len(ids),) + tuple(slow.shape[1:]), dtype=slow.dtype,
                       pin_memory=True)
    torch.index_select(slow, 0, idx, out=rows)
    return rows.to(device, non_blocking=True)


def _slow_scatter(slow: torch.Tensor, ids: np.ndarray,
                  rows: torch.Tensor) -> None:
    """Write rows into the slow store (blocking device-to-host copy)."""
    idx = torch.as_tensor(ids, dtype=torch.long, device=slow.device)
    slow[idx] = rows.to(slow.device, slow.dtype)


def migrate(buffers: TierBuffers, promoted, victims, evicted,
            codec: str = "none") -> tuple[TierBuffers, int, int]:
    """Apply one promotion batch: ``promoted[i]`` is copied into fast slot
    ``victims[i]`` after the slot's previous occupant ``evicted[i]`` is
    written back (-1 = no-op lane everywhere).  Returns the buffers and
    the promoted / demoted row counts actually moved."""
    codec_lib.check_codec(codec)
    promoted, victims, evicted = _host(promoted), _host(victims), _host(evicted)
    ok = (promoted >= 0) & (victims >= 0)
    ev_ok = ok & (evicted >= 0)
    fast, slow = buffers.fast, buffers.slow
    # gather the promoted rows BEFORE the write-back (a page promoted in this
    # batch is never also evicted in it, but the order documents it)
    up = codec_lib.decode_rows(_slow_gather(slow, promoted[ok], fast.device),
                               None, fast.dtype)
    slots_ev = torch.as_tensor(victims[ev_ok], dtype=torch.long, device=fast.device)
    down, _ = codec_lib.encode_rows(codec, fast[slots_ev])
    _slow_scatter(slow, evicted[ev_ok], down)
    fast[torch.as_tensor(victims[ok], dtype=torch.long, device=fast.device)] = up
    return buffers, int(ok.sum()), int(ev_ok.sum())


def read_rows(fast: torch.Tensor, slow: torch.Tensor, slots: torch.Tensor,
              page_ids: torch.Tensor, scale=None) -> torch.Tensor:
    """Serve a batch of page reads: fast copy when resident, slow fallback.
    Rows for invalid page ids (< 0) read slow page 0 — callers mask them."""
    slots = slots.to(fast.device).long()
    hit = slots >= 0
    safe = _host(torch.where(page_ids >= 0, page_ids, 0)).reshape(-1)
    slow_rows = codec_lib.decode_rows(
        _slow_gather(slow, safe, fast.device), scale, fast.dtype)
    slow_rows = slow_rows.reshape(tuple(slots.shape) + tuple(fast.shape[1:]))
    mask = hit.reshape(tuple(hit.shape) + (1,) * (fast.dim() - 1))
    return torch.where(mask, fast[torch.where(hit, slots, 0)], slow_rows)


def lookup_rows(fast: torch.Tensor, slow: torch.Tensor,
                page_slot: torch.Tensor, page_ids, scale=None) -> torch.Tensor:
    """Placement lookup + dual-tier gather for ``page_ids`` of any shape."""
    page_ids = torch.as_tensor(page_ids, dtype=torch.long,
                               device=page_slot.device)
    slots = torch.where(page_ids >= 0, page_slot[page_ids.clamp_min(0)], -1)
    return read_rows(fast, slow, slots, page_ids, scale=scale)


def write_rows(buffers: TierBuffers, page_ids, slots, rows: torch.Tensor,
               codec: str = "none") -> TierBuffers:
    """Refresh page payloads in BOTH tiers: the slow store always takes the
    write, promoted pages (``slots[i] >= 0``) get their fast copy refreshed
    too.  -1 page ids are dropped lanes."""
    ids, slots = _host(page_ids), _host(slots)
    keep = ids >= 0
    keep_t = torch.as_tensor(keep, device=rows.device)
    payload, _ = codec_lib.encode_rows(codec, rows[keep_t])
    _slow_scatter(buffers.slow, ids[keep], payload)
    hot = keep & (slots >= 0)
    fast = buffers.fast
    fast[torch.as_tensor(slots[hot], dtype=torch.long, device=fast.device)] = \
        rows[torch.as_tensor(hot, device=rows.device)].to(fast.dtype)
    return buffers


def _pages_to_rows(k_pages: torch.Tensor, v_pages: torch.Tensor) -> torch.Tensor:
    # ring layout (G, L, S, T, hkv, d) -> page-row layout (L*S, G, T, hkv, d)
    rows = torch.cat([k_pages, v_pages], dim=-1).movedim(0, 2)
    return rows.reshape((-1,) + tuple(rows.shape[2:]))


def write_pages(buffers: TierBuffers, page_ids, slots, k_pages, v_pages,
                codec: str = "none") -> TierBuffers:
    """Bulk KV-page write: flush paged-ring slots (G, L, S, T, hkv, d) into
    the tier store; ``page_ids`` is the (L*S,) slot -> page map (-1 =
    unchanged/dropped slot), ``slots`` its placement lookup."""
    return write_rows(buffers, page_ids, slots,
                      _pages_to_rows(k_pages, v_pages), codec=codec)
